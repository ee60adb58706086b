"""The held-out quality curve over per-epoch generator exports, and the
paper protocol's epoch selection (the JAX package's
``scripts/epoch_curve_eval.py`` and ``scripts/paper_protocol.py``'s
selection rule).

The reference picks its evaluation epoch by eye (epoch 20 of 50,
generate_and_evaluate.py:49-52).  The curve makes that quantitative: the
daily-cycle correlation of every export ``gen_*_{epoch:04d}.{h5,npz}`` on
fresh held-out :func:`make_scale_dataset` days (HELDOUT_DAYS of 88 x 88,
seed 7).

    python -m prdisagg_torch.protocols.epoch_curve MODEL_DIR [epochs ...]
        [--device cuda] [--export-format h5|npz]

EMA exports (``gen_ema_*``) are scored as their own candidates, labelled
``ema:E``, never in place of the raw export of their epoch.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from prdisagg_torch.protocols import export_ext, load_export

#: held-out samples a candidate is scored on
N_STAT_SAMPLES = 300
#: held-out days the samples are drawn from
HELDOUT_DAYS = 300


def select_epoch(curve: dict):
    """The paper protocol's pick among scored exports: `curve` maps a label
    ("E" or "ema:E") to {"corr", "crps"}.  The correlation is a sanity
    floor (drop checkpoints with a broken daily cycle), not a band: among
    the labels within 80% of the best correlation, the lowest probe CRPS
    wins.  Where no label clears the floor or the best correlation is not
    positive, the CRPS alone decides.

    Returns (label, best correlation, whether the floor was active)."""
    max_corr = max(v["corr"] for v in curve.values())
    eligible = {k: v for k, v in curve.items()
                if v["corr"] >= 0.8 * max_corr}
    gated = bool(eligible) and max_corr > 0
    if not gated:
        eligible = eligible or curve
    return min(eligible, key=lambda k: eligible[k]["crps"]), max_corr, gated


def candidates(model_dir: str, export_format: str) -> dict:
    """{label: path} of the generator exports in `model_dir`."""
    out = {}
    ext = export_ext(export_format)
    for name in sorted(os.listdir(model_dir)):
        if not (name.startswith("gen_") and name.endswith("." + ext)):
            continue
        e = int(os.path.splitext(name)[0].rsplit("_", 1)[1])
        label = f"ema:{e}" if name.startswith("gen_ema_") else str(e)
        out[label] = os.path.join(model_dir, name)
    return out


def score_corr(path: str, exp, ds, device, workdir: str,
               n_samples: int = N_STAT_SAMPLES) -> tuple:
    """(generator, held-out daily-cycle correlation) of one export, from
    the large-sample statistics alone (no map grids, lines or KS)."""
    from prdisagg_torch.eval import Evaluator, daily_cycle_correlation

    pg = load_export(path, device)
    epoch = int(os.path.splitext(path)[0].rsplit("_", 1)[1])
    ev = Evaluator(exp, ds, pg, workdir=workdir, epoch=epoch)
    res = ev.sample_statistics(n_samples=n_samples, save_fields=False,
                               make_plots=False)
    return pg, float(daily_cycle_correlation(res))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m prdisagg_torch.protocols.epoch_curve",
        description=__doc__.split("\n\n")[0])
    p.add_argument("model_dir")
    p.add_argument("epochs", nargs="*", type=int,
                   default=[5, 10, 20, 30, 40, 50])
    p.add_argument("--device", default="cuda")
    p.add_argument("--export-format", dest="export_format", default="h5",
                   choices=["h5", "npz"])
    return p.parse_args(argv)


def run(args) -> dict:
    """The curve {label: corr} over the asked epochs; prints it and the
    best."""
    from prdisagg_torch.core.config import DataConfig, ExperimentConfig
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.data.synthetic import make_scale_dataset

    dcfg = DataConfig()
    data, idx = make_scale_dataset(HELDOUT_DAYS, 88, 88, 7, dcfg)
    ds = DeviceDataset.from_numpy(data, idx, dcfg, device=args.device)
    exp = ExperimentConfig(data=dcfg, name="epoch_curve")
    found = candidates(args.model_dir, args.export_format)
    curve = {}
    with tempfile.TemporaryDirectory(prefix="epoch_curve-") as tmp:
        for e in args.epochs:
            labels = [k for k in found if k.split(":")[-1] == str(e)]
            if not labels:
                print(f"epoch {e:2d}: no export found", flush=True)
                continue
            for label in sorted(labels, key=lambda k: k.startswith("ema:")):
                _, curve[label] = score_corr(found[label], exp, ds,
                                             args.device, tmp)
                print(f"epoch {label:>7s}: daily-cycle corr "
                      f"{curve[label]:.4f}", flush=True)
    if curve:
        best = max(curve, key=curve.get)
        print(f"best: epoch {best} (corr {curve[best]:.4f})", flush=True)
    return curve


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
