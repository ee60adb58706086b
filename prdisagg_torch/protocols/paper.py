"""The complete paper protocol on one device (the JAX package's
``scripts/paper_protocol.py``): train at reference scale, select the
epoch quantitatively, run the reference's whole evaluation battery on it,
and publish the verdict.

The reference spreads this over a 3-day V100 training job and five
evaluation scripts run by hand:

  * training          gan_train_cwgangp_pixelnorm.py (50 epochs, 2009-2016)
  * epoch selection   generate_and_evaluate.py:49-52 (by eye; here the
                      held-out daily-cycle correlation and a CRPS probe of
                      every export, epoch_curve.select_epoch)
  * phases 1-5        generate_and_evaluate.py:204-604
  * RainFARM          rainfarm/rainfarm_calibrate.py + rainfarm_generate.py
  * CRPS              generate_and_evaluate_crps.py:161-195 (GAN, random
                      baseline, RainFARM) + analyze_crps_results.py:9-47
  * LSD               log_spectral_distance.py:86-130

:func:`make_scale_dataset` stands in for the SMHI archive at its real
dimensions (2900 days, 88 x 88, regime days unless ``--plain-data``); the
evaluation uses held-out days of another seed, as the reference's
2017-2018 split.

Stage resume: every battery stage marks its scalars in
``WORKDIR/protocol_state.json`` (utils/stagecache.py), so a rerun in the
same workdir, after a crash or under ``cli supervise``, skips what is done
and prints ``cached: True`` for it with the same values; training resumes
from its checkpoint.  A second live run in one workdir is refused (the
workdir lock).  A changed configuration clears the cache, and refuses to
start while the old configuration's exports are in the workdir.

    python -m prdisagg_torch.protocols.paper [--smoke | --mini]
        [--reuse-train] [--n-days 2900] [--heldout-days 500] [--epochs 50]
        [--model-scale 1.0] [--ema-decay 0.0] [--lsd-full] [--plain-data]
        [--workdir W] [--device cuda] [--export-format h5|npz|both]
        [--no-plots]

Writes ``WORKDIR/paper_protocol_summary.json`` (``config``, ``stages``,
``verdict``, the JAX driver's keys) and the artifact tree.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from prdisagg_torch.protocols import add_run_args, load_export, refuse_missing
from prdisagg_torch.protocols.epoch_curve import (
    candidates,
    score_corr,
    select_epoch,
)

#: the battery's sizes: n_crps, n_members, n_lsd, n_stat, ks_pairs,
#: ks_members, n_map, rf_calib, rf_repeats, n_bootstrap
SIZES = {
    "smoke": (40, 20, 24, 100, 2, 50, 2, 100, 2, 500),
    "mini": (1000, 200, 200, 2000, 5, 200, 5, 1000, 2, 2000),
    # EvalConfig's reference defaults (generate_and_evaluate*.py)
    "full": (10_000, 1000, 1000, 10_000, 20, 1000, 20, 5000, 10, 10_000),
}
#: --smoke's n_days, heldout_days and epochs
SMOKE_RUN = (30, 20, 2)
#: the fields of the configuration a cache is valid for
FINGERPRINT = ("n_days", "heldout_days", "epochs", "smoke", "mini",
               "model_scale", "ema_decay", "plain_data", "export_format")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m prdisagg_torch.protocols.paper",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--n-days", type=int, default=2900)
    p.add_argument("--heldout-days", type=int, default=500)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--workdir",
                   default=os.path.join("artifacts", "paper_protocol_torch"))
    p.add_argument("--reuse-train", action="store_true",
                   help="skip training when the workdir already has every "
                        "per-epoch generator export")
    p.add_argument("--smoke", action="store_true",
                   help="tiny counts everywhere (a plumbing check)")
    p.add_argument("--mini", action="store_true",
                   help="an intermediate battery: 1k x 200 CRPS, 200-sample "
                        "LSD, 5 x 200 KS")
    p.add_argument("--model-scale", type=float, default=1.0,
                   help="width multiplier on every channel count and the "
                        "latent dim (flagship = 1.0)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="track an EMA generator (gen_ema_* exports compete "
                        "in the epoch selection)")
    p.add_argument("--lsd-full", action="store_true",
                   help="save the full pairwise-LSD populations (the "
                        "reference's files); by default they are reduced "
                        "on the device to exact medians and subsamples")
    p.add_argument("--plain-data", action="store_true",
                   help="one fixed daily cycle on every day, instead of "
                        "make_scale_dataset's day regimes")
    add_run_args(p, preset=False)
    return p.parse_args(argv)


def model_override(args):
    """The smoke architecture, a width-scaled flagship, or None."""
    from prdisagg_torch.core.config import ModelConfig

    if args.smoke:
        return ModelConfig(ndomain=16, latent_dim=8, gen_channels=(8, 8, 8),
                           base_channels=8, critic_channels=(8, 8, 8, 8))
    if args.model_scale == 1.0:
        return None
    s, base = args.model_scale, ModelConfig()
    return ModelConfig(
        latent_dim=max(8, int(base.latent_dim * s)),
        gen_channels=tuple(max(8, int(c * s)) for c in base.gen_channels),
        base_channels=max(8, int(base.base_channels * s)),
        critic_channels=tuple(max(8, int(c * s))
                              for c in base.critic_channels))


def run(args) -> dict:
    """The protocol, holding the workdir's lock: one live run per workdir,
    since two would race on checkpoints, hist.csv and the stage cache.
    Returns the summary it writes."""
    from prdisagg_torch.utils.watchdog import acquire_workdir_lock

    refuse_missing(args)
    lock = acquire_workdir_lock(args.workdir)
    try:
        return _protocol(args)
    finally:
        os.close(lock)


def _protocol(args) -> dict:
    import torch

    from prdisagg_torch.baselines.rainfarm.pipeline import (
        calibrate,
        generate_and_plot,
        generate_for_daily_sums,
    )
    from prdisagg_torch.core.config import (
        DataConfig,
        ExperimentConfig,
        RainFarmConfig,
        TrainConfig,
    )
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.data.synthetic import make_scale_dataset
    from prdisagg_torch.eval import Evaluator, daily_cycle_correlation
    from prdisagg_torch.eval.crps import crps_gan, run_crps_evaluation
    from prdisagg_torch.eval.lsd import run_lsd_evaluation
    from prdisagg_torch.train.loop import Trainer
    from prdisagg_torch.utils.stagecache import StageCache

    if args.smoke:
        args.n_days, args.heldout_days, args.epochs = SMOKE_RUN
    (n_crps, n_members, n_lsd, n_stat, ks_pairs, ks_members, n_map,
     rf_calib, rf_rep, n_boot) = SIZES[
        "smoke" if args.smoke else "mini" if args.mini else "full"]
    plots = not args.no_plots
    dev = args.device

    datadir = os.path.join(args.workdir, "data")
    summary = {"config": vars(args).copy(), "stages": {}}
    t_all = time.perf_counter()

    def mark(stage, t0, **extra):
        dt = time.perf_counter() - t0
        summary["stages"][stage] = {"seconds": round(dt, 1), **extra}
        print(f"[{stage}] {dt:.1f}s {extra if extra else ''}", flush=True)

    cache = StageCache(os.path.join(args.workdir, "protocol_state.json"))
    fingerprint = {k: vars(args)[k] for k in FINGERPRINT}
    stored_cfg = cache.get("config")
    if stored_cfg is not None and stored_cfg.get("fp") != fingerprint:
        # the workdir's checkpoints and exports belong to the old
        # configuration: resuming or globbing them would publish results
        # of another model under this one
        stale = os.path.join(args.workdir, "trained_models")
        if os.path.isdir(stale) and os.listdir(stale):
            raise SystemExit(
                f"protocol config changed (was {stored_cfg.get('fp')}, "
                f"now {fingerprint}) but {stale} holds the old config's "
                f"training artifacts; use a fresh --workdir or delete "
                f"them first")
        print("[resume] protocol config changed; clearing stage cache",
              flush=True)
        cache.clear()
    cache.mark("config", fp=fingerprint)

    # ---- stage 1: datasets (train + held-out split), built lazily so a
    # fully cached rerun never makes them
    t0 = time.perf_counter()
    dcfg = DataConfig()
    regime = not args.plain_data
    _ds_memo: dict = {}

    def _build_ds(which: str):
        if which not in _ds_memo:
            n, seed = ((args.n_days, 0) if which == "train"
                       else (args.heldout_days, 7))
            data, indices = make_scale_dataset(n, 88, 88, seed, dcfg,
                                               regime=regime)
            _ds_memo[which] = (DeviceDataset.from_numpy(data, indices, dcfg,
                                                        device=dev),
                               len(indices))
        return _ds_memo[which]

    def get_ds_train():
        return _build_ds("train")[0]

    def get_ds_eval():
        return _build_ds("eval")[0]

    ds_cached = cache.get("datasets")
    if ds_cached is None:
        n_train_patches = _build_ds("train")[1]
        payload = cache.mark("datasets", train_patches=n_train_patches,
                             heldout_patches=_build_ds("eval")[1])
        mark("datasets", t0, **payload)
    else:
        n_train_patches = ds_cached["train_patches"]
        mark("datasets", t0, cached=True,
             train_patches=ds_cached["train_patches"],
             heldout_patches=ds_cached["heldout_patches"])

    # ---- stage 2: training
    exp = ExperimentConfig(
        data=dcfg,
        train=TrainConfig(schedule=((args.epochs, 32),), seed=0,
                          log_every_steps=100, ema_decay=args.ema_decay),
        name="paper_protocol", model_override=model_override(args))
    model_dir = os.path.join(args.workdir, "trained_models", exp.name)
    have = [k for k in (candidates(model_dir, args.export_format)
                        if os.path.isdir(model_dir) else {})
            if not k.startswith("ema:")]
    t0 = time.perf_counter()
    if args.reuse_train and len(have) >= args.epochs:
        print(f"[train] reusing {len(have)} exports in {model_dir}",
              flush=True)
        summary["stages"]["train"] = {"seconds": 0.0, "reused": True}
    else:
        tr = Trainer(exp, get_ds_train(), workdir=args.workdir,
                     plot_every_epochs=int(plots),
                     export_format=args.export_format)
        resumed_epoch = 0
        if tr.maybe_resume():
            resumed_epoch = tr.epoch
            print(f"[train] resumed at epoch {tr.epoch}", flush=True)
        tr.fit(progress=True)
        # seconds add up over the launches that reached this mark;
        # steps/s is the last launch's that trained epochs
        elapsed = time.perf_counter() - t0
        spe = max(1, n_train_patches // 32)
        prior = cache.get("train") or {}
        epochs_run = args.epochs - resumed_epoch
        payload = cache.mark(
            "train", epochs=args.epochs, steps=args.epochs * spe,
            seconds_cumulative=round(
                prior.get("seconds_cumulative", 0.0) + elapsed, 1),
            steps_per_sec=(round(epochs_run * spe / elapsed, 1)
                           if epochs_run > 0
                           else prior.get("steps_per_sec", 0.0)))
        mark("train", t0, **payload)
        del tr

    # ---- stage 3: epoch selection on the held-out split: every export's
    # daily-cycle correlation and a CRPS probe (100 samples x 100 members),
    # scored candidates kept in the cache one by one
    t0 = time.perf_counter()
    _sel_memo: dict = {}

    def get_sel_reals():
        if "r" not in _sel_memo:
            g = torch.Generator(device=get_ds_eval().device).manual_seed(991)
            _sel_memo["r"] = get_ds_eval().sample_patches_raw(
                min(100, n_crps), g).cpu().numpy()
        return _sel_memo["r"]

    probe_members = min(100, n_members)
    stored_curve = cache.get("epoch_curve")
    curve = dict(stored_curve["curve"]) if stored_curve else {}
    paths_by_key = candidates(model_dir, args.export_format)
    for key, path in paths_by_key.items():
        if key in curve:
            continue
        pg, corr = score_corr(path, exp, get_ds_eval(), dev,
                              os.path.join(args.workdir, "epoch_curve"),
                              n_samples=min(500, n_stat))
        probe = float(crps_gan(pg, get_sel_reals(), n_members=probe_members,
                               member_batch=probe_members, seed=354).mean())
        curve[key] = {"corr": round(corr, 4), "crps": round(probe, 5)}
        cache.mark("epoch_curve", curve=curve)
        print(f"  epoch {key:>7s}: corr {corr:.4f}  probe-CRPS {probe:.5f}",
              flush=True)
    # only among exports that still exist: the cache may hold pruned ones
    selectable = {k: v for k, v in curve.items() if k in paths_by_key}
    peak_key, max_corr, gated = select_epoch(selectable)
    if not gated:
        print(f"[epoch-curve] corr gate inactive (max_corr {max_corr:.4f}); "
              f"selecting on probe-CRPS alone", flush=True)
    peak_epoch = int(peak_key.split(":")[-1])
    peak_corr = curve[peak_key]["corr"]
    print(f"[epoch-curve] selected epoch {peak_key} "
          f"(corr {peak_corr:.4f}, probe-CRPS "
          f"{curve[peak_key]['crps']:.5f}; best corr {max_corr:.4f})",
          flush=True)
    mark("epoch_curve", t0, curve=curve, peak_epoch=peak_key,
         peak_corr=peak_corr)

    pg = load_export(paths_by_key[peak_key], dev)
    # another selected checkpoint invalidates every later stage
    sel = cache.get("selection")
    if sel is not None and sel.get("peak_key") != peak_key:
        print(f"[resume] peak changed {sel.get('peak_key')} -> {peak_key}; "
              f"clearing battery stages", flush=True)
        cache.clear("eval", "rainfarm", "crps", "lsd")
    cache.mark("selection", peak_key=peak_key)

    # ---- stage 4a: evaluation phases 1-5 on the selected export
    t0 = time.perf_counter()
    gen_npy = os.path.join(datadir, "generated_samples.npy")
    real_npy = os.path.join(datadir, "real_samples.npy")
    ev_cached = cache.get("eval")
    _fields: dict = {}

    def fields(name: str, path: str):
        if name not in _fields:
            _fields[name] = np.load(path)
        return _fields[name]

    if (ev_cached is not None and os.path.exists(gen_npy)
            and os.path.exists(real_npy)):
        held_corr = ev_cached["daily_cycle_corr"]
        ks_frac_distinct = ev_cached["ks_frac_distinct_p05"]
        mark("eval_phases_1to5", t0, cached=True, **ev_cached)
    else:
        ev = Evaluator(exp, get_ds_eval(), pg, workdir=args.workdir,
                       epoch=peak_epoch)
        res, pvals = ev.run_all(
            make_plots=plots, n_map_conditions=n_map, n_stat_samples=n_stat,
            n_ks_conditions=ks_pairs, n_ks_members=ks_members)
        held_corr = float(daily_cycle_correlation(res))
        ks = np.asarray(pvals)  # (pairs, 24)
        # do different conditions give different conditional distributions:
        # the share of (pair, hour) cells distinguishable at 5%
        ks_frac_distinct = float((ks < 0.05).mean())
        payload = cache.mark("eval",
                             daily_cycle_corr=round(held_corr, 4),
                             ks_frac_distinct_p05=round(ks_frac_distinct, 4),
                             ks_median_p=float(np.median(ks)))
        mark("eval_phases_1to5", t0, **payload)
        _fields["reals"] = res["real_samples"]  # (n_stat, 24, nd, nd) mm/h
        _fields["gens"] = res["generated_samples"]

    # ---- stage 4b: the RainFARM baseline (calibrate, generate, plots)
    t0 = time.perf_counter()
    rf_cfg = RainFarmConfig(n_calib=rf_calib, n_repeat=rf_rep)
    rf_npy = os.path.join(datadir, "rainfarm_fields_for_lsd.npy")
    rf_cached = cache.get("rainfarm")
    if rf_cached is not None and os.path.exists(rf_npy):
        alpha, beta = rf_cached["alpha"], rf_cached["beta"]
        mark("rainfarm", t0, cached=True, **rf_cached)
    else:
        slopes = calibrate(get_ds_train(), rf_cfg, outdir=datadir)
        alpha, beta = slopes[0]
        reals = fields("reals", real_npy)
        if plots:
            generate_and_plot(
                reals[:n_map], alpha, beta, rf_cfg,
                plotdir=os.path.join(args.workdir,
                                     "plots_generated_rainfarm"),
                datadir=datadir, device=dev)
        else:
            print("[rainfarm] plots off: generate_and_plot's figures and "
                  "generated_samples_rainfarm.npy left out", flush=True)
        _fields["rf"] = np.asarray(generate_for_daily_sums(
            reals[:n_lsd].sum(axis=1), alpha, beta, rf_cfg, seed=1,
            device=dev), dtype=np.float32)
        np.save(rf_npy, _fields["rf"])
        payload = cache.mark("rainfarm", alpha=round(float(alpha), 3),
                             beta=round(float(beta), 3))
        mark("rainfarm", t0, **payload)

    # ---- stage 4c: CRPS, GAN against the random baseline and RainFARM
    t0 = time.perf_counter()
    crps_cached = cache.get("crps")
    if crps_cached is not None:
        crps_summary = crps_cached["summary"]
        mark("crps", t0, cached=True,
             **{k: crps_summary[k] for k in ("gan", "random", "rainfarm")})
    else:
        crps_reals = fields("reals", real_npy)[:n_crps]
        baseline = np.load(os.path.join(datadir,
                                        "rainfarm_calibration_data.npy"))
        crps_res = run_crps_evaluation(
            pg, crps_reals, baseline, n_members=n_members, outdir=datadir,
            seed=354, rainfarm=(alpha, beta, rf_cfg), n_bootstrap=n_boot)
        crps_summary = crps_res["analysis"]
        cache.mark("crps", summary={
            k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
            for k, v in crps_summary.items()})
        mark("crps", t0, n_samples=len(crps_reals), n_members=n_members,
             gan=round(crps_summary["gan"], 5),
             random=round(crps_summary["random"], 5),
             rainfarm=round(crps_summary["rainfarm"], 5),
             ttest_p=crps_summary["ttest_p_gan_vs_random"],
             bootstrap_diff=crps_summary["bootstrap_diff"],
             gan_samples_per_sec=round(
                 len(crps_reals) / crps_res["gan_seconds"], 1),
             random_samples_per_sec=round(
                 len(crps_reals) / max(crps_res["random_seconds"], 1e-9), 1))

    # ---- stage 4d: log-spectral distances
    t0 = time.perf_counter()
    lsd_cached = cache.get("lsd")
    if lsd_cached is not None:
        lsd_medians = lsd_cached["medians"]
        mark("lsd", t0, cached=True, medians=lsd_medians)
    else:
        if "rf" not in _fields:
            _fields["rf"] = np.load(rf_npy)
        dists = run_lsd_evaluation(
            fields("reals", real_npy)[:n_lsd], fields("gens", gen_npy)[:n_lsd],
            _fields["rf"], n_samples=n_lsd, outdir=datadir,
            plotdir=os.path.join(args.workdir, "plots"), make_plot=plots,
            reduction="full" if args.lsd_full else "device", device=dev)
        lsd_medians = {k: round(v, 4) for k, v in dists.medians.items()}
        cache.mark("lsd", medians=lsd_medians)
        mark("lsd", t0, medians=lsd_medians)

    # ---- the verdict
    wall = time.perf_counter() - t_all
    summary["verdict"] = {
        "peak_epoch": peak_key,
        "heldout_daily_cycle_corr": round(held_corr, 4),
        "crps": {k: round(float(crps_summary[k]), 5)
                 for k in ("gan", "random", "rainfarm")},
        "gan_beats_random": bool(crps_summary["gan"]
                                 < crps_summary["random"]),
        "gan_beats_rainfarm": bool(crps_summary["gan"]
                                   < crps_summary["rainfarm"]),
        "ttest_p_gan_vs_random": crps_summary["ttest_p_gan_vs_random"],
        "bootstrap_diff_ci98": crps_summary["bootstrap_diff"],
        "lsd_medians": lsd_medians,
        # generated fields spectrally closer to the observations than
        # RainFARM's
        "lsd_gan_closer_to_obs_than_rainfarm": bool(
            lsd_medians["between_gen_real"]
            < lsd_medians["between_gen_rainfarm_real"]),
        "ks_frac_distinct_p05": round(ks_frac_distinct, 4),
        "total_wall_clock_minutes": round(wall / 60, 1),
    }
    with open(os.path.join(args.workdir, "paper_protocol_summary.json"),
              "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary["verdict"], indent=2), flush=True)
    print(f"TOTAL {wall / 60:.1f} min; artifacts in "
          f"{os.path.abspath(args.workdir)}", flush=True)
    return summary


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
