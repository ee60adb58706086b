"""Finish a paper protocol run from its saved artifacts (the JAX package's
``scripts/paper_protocol_finish.py``).

For a run whose battery reached its LSD populations but not the verdict:
loads the saved ``log_spectral_distances_*_n{n_lsd}.npy`` (full
populations) or their ``*_subsample.npy`` with the exact medians of
``log_spectral_distances_summary_n{n_lsd}.json`` (the device reduction),
draws the KDE plot, takes the medians, and writes
``WORKDIR/paper_protocol_summary.json`` with the verdict assembled from the
arguments and ``WORKDIR/data/crps_results.json``.

    python -m prdisagg_torch.protocols.paper_finish WORKDIR PEAK_EPOCH CORR
        KS_FRAC [n_lsd=1000] [--no-plots]

The KDE plot needs matplotlib and seaborn; ``--no-plots`` leaves it out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

#: population file keys and their plot labels
LABELS = {
    "real": "obs", "gen": "generated",
    "gen_rainfarm": "generated rainfarm",
    "between_gen_real": "between obs and generated",
    "between_gen_rainfarm_real": "between obs and generated rainfarm",
}
#: points of the KDE: a stride subsample of each population
KDE_CAP = 2_000_000


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m prdisagg_torch.protocols.paper_finish",
        description=__doc__.split("\n\n")[0])
    p.add_argument("workdir")
    p.add_argument("peak_epoch", type=int)
    p.add_argument("corr", type=float)
    p.add_argument("ks_frac", type=float)
    p.add_argument("n_lsd", nargs="?", type=int, default=1000)
    p.add_argument("--no-plots", dest="no_plots", action="store_true",
                   help="no KDE plot (it needs matplotlib and seaborn)")
    return p.parse_args(argv)


def lsd_medians(datadir: str, n_lsd: int) -> tuple:
    """({key: median rounded to 4 places}, {key: finite KDE subsample}).

    One n everywhere: the populations, the subsamples and the summary of
    exact medians."""
    summary_fn = os.path.join(
        datadir, f"log_spectral_distances_summary_n{n_lsd}.json")
    summary = {}
    if os.path.exists(summary_fn):
        with open(summary_fn) as f:
            summary = json.load(f)
    medians, subs = {}, {}
    for k in LABELS:
        fn = f"log_spectral_distances_{k}_n{n_lsd}.npy"
        path = os.path.join(datadir, fn)
        if not os.path.exists(path):
            path = os.path.join(datadir, fn.replace(".npy", "_subsample.npy"))
        v = np.load(path, mmap_mode="r")
        sub = np.asarray(v[:: max(1, len(v) // KDE_CAP + 1)])
        subs[k] = sub[np.isfinite(sub)]
        if k in summary:
            # the device reduction's exact median
            medians[k] = round(float(summary[k]["median"]), 4)
        else:
            # the stride subsample's median: unbiased, and stable to 4
            # places where the full median would take minutes
            medians[k] = round(float(np.median(subs[k])), 4)
    return medians, subs


def kde_plot(subs: dict, workdir: str, n_lsd: int) -> str:
    from prdisagg_torch.utils.plotting import _pyplot

    _, plt = _pyplot()
    import seaborn as sns

    sns.set_palette("colorblind")
    plt.figure()
    for k, sub in subs.items():
        if len(sub):
            sns.kdeplot(sub, label=LABELS[k])
    plt.xlabel("log spectral distance")
    plt.legend()
    sns.despine()
    plotdir = os.path.join(workdir, "plots")
    os.makedirs(plotdir, exist_ok=True)
    path = os.path.join(plotdir, f"log_spectral_distances_n{n_lsd}.svg")
    plt.savefig(path)
    plt.close("all")
    return path


def run(args) -> dict:
    """Writes and returns {"verdict": ...}."""
    from prdisagg_torch.cli import _refuse_missing

    if not args.no_plots:
        _refuse_missing([(mod, "the KDE plot", "--no-plots")
                         for mod in ("matplotlib", "seaborn")])
    datadir = os.path.join(args.workdir, "data")
    medians, subs = lsd_medians(datadir, args.n_lsd)
    if not args.no_plots:
        kde_plot(subs, args.workdir, args.n_lsd)
    with open(os.path.join(datadir, "crps_results.json")) as f:
        crps = json.load(f)
    verdict = {
        "peak_epoch": args.peak_epoch,
        "heldout_daily_cycle_corr": args.corr,
        "crps": {k: round(float(crps[k]), 5)
                 for k in ("gan", "random", "rainfarm")},
        "gan_beats_random": crps["gan"] < crps["random"],
        "gan_beats_rainfarm": crps["gan"] < crps["rainfarm"],
        "ttest_p_gan_vs_random": crps["ttest_p_gan_vs_random"],
        "bootstrap_diff_ci98": crps["bootstrap_diff"],
        "lsd_medians": medians,
        "lsd_gan_closer_to_obs_than_rainfarm":
            medians["between_gen_real"]
            < medians["between_gen_rainfarm_real"],
        "ks_frac_distinct_p05": args.ks_frac,
    }
    out = {"verdict": verdict}
    with open(os.path.join(args.workdir, "paper_protocol_summary.json"),
              "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(verdict, indent=2))
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
