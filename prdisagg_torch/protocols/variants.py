"""The doy and lon conditioning variants at flagship width, end to end (the
JAX package's ``scripts/variants_tpu.py``).

The reference trains them as full experiments
(revision1/additional_inputs/gan_train_cwgangp_pixelnorm_doy.py:135,173-184
and ..._lon.py:136).  For each variant this driver

* trains the flagship architecture for a few epochs on
  :func:`make_scale_dataset` days (88 x 88, seed 11; B 32) and prints the
  steady steps/s;
* evaluates the held-out daily-cycle correlation and the conservation of
  the daily sum on 120 held-out days (seed 13), 1000 samples;
* round-trips the last per-epoch export: the loaded export's float32
  forward against the live generator's on the same latents and
  conditions (``.h5``, or ``.npz`` with ``--export-format npz``).

    python -m prdisagg_torch.protocols.variants [n_days=400] [epochs=5]
        [--workdir W] [--device cuda] [--export-format h5|npz|both]
        [--model-preset flagship|tiny]

The lines also go to ``WORKDIR/variants.txt``; each variant's run is in
``WORKDIR/variant_{doy,lon}/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from prdisagg_torch.protocols import (
    Lines,
    add_run_args,
    export_paths,
    load_export,
    refuse_missing,
    with_preset,
)

#: held-out samples of the daily-cycle and conservation check
N_STAT_SAMPLES = 1000
#: samples of the export round trip
N_ROUND_TRIP = 8
#: held-out days of the evaluation
HELDOUT_DAYS = 120


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m prdisagg_torch.protocols.variants",
        description=__doc__.split("\n\n")[0])
    p.add_argument("n_days", nargs="?", type=int, default=400)
    p.add_argument("epochs", nargs="?", type=int, default=5)
    p.add_argument("--workdir",
                   default=os.path.join("artifacts", "variants_torch"))
    add_run_args(p, plots=False)
    return p.parse_args(argv)


def _doy(n_days: int, exp):
    from prdisagg_torch.core.config import Conditioning

    if exp.data.conditioning != Conditioning.DOY:
        return None
    return (np.arange(n_days, dtype=np.float32) % 365.0) + 1.0


def run_variant(factory, args, emit) -> dict:
    """Train, evaluate and round-trip one variant; returns its numbers."""
    import torch

    from prdisagg_torch.api.pretrained import PretrainedGenerator
    from prdisagg_torch.core.config import TrainConfig
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.data.synthetic import make_scale_dataset
    from prdisagg_torch.eval import Evaluator, daily_cycle_correlation
    from prdisagg_torch.train.loop import Trainer

    exp = dataclasses.replace(factory(), train=TrainConfig(
        schedule=((args.epochs, 32),), seed=0, log_every_steps=100))
    exp = with_preset(exp, args.model_preset)
    variant, dcfg = exp.data.conditioning, exp.data
    data, indices = make_scale_dataset(args.n_days, 88, 88, 11, dcfg)
    ds = DeviceDataset.from_numpy(data, indices, dcfg,
                                  doy=_doy(args.n_days, exp),
                                  device=args.device)
    del data
    eval_data, eval_idx = make_scale_dataset(HELDOUT_DAYS, 88, 88, 13,
                                             dcfg)
    ds_eval = DeviceDataset.from_numpy(eval_data, eval_idx, dcfg,
                                       doy=_doy(HELDOUT_DAYS, exp),
                                       device=args.device)
    del eval_data

    workdir = os.path.join(args.workdir, f"variant_{variant}")
    os.makedirs(workdir, exist_ok=True)
    marks = {}

    def on_epoch_end(tr):
        if tr.epoch == 1 and "t1" not in marks:
            marks["t1"] = time.perf_counter()

    tr = Trainer(exp, ds, workdir=workdir, on_epoch_end=on_epoch_end,
                 plot_every_epochs=0, export_format=args.export_format)
    resumed = tr.maybe_resume()
    if resumed:
        # the steady rate of a partial run means nothing, so it is nan
        print(f"[{variant}] resumed at epoch {tr.epoch}", flush=True)
        marks["t1"] = time.perf_counter()
    t0 = time.perf_counter()
    tr.fit(progress=True)
    t_end = time.perf_counter()
    spe = max(1, len(indices) // 32)
    steady = ((args.epochs - 1) * spe / (t_end - marks["t1"])
              if args.epochs > 1 and not resumed else float("nan"))
    emit(f"[{variant}] {args.epochs} epochs x {spe} steps "
         f"({len(indices)} patches): total {t_end - t0:.1f}s, "
         f"steady {steady:.1f} steps/s (excl. the first epoch)")

    # held-out evaluation with the variant's conditioning
    params = {k: v.detach().clone() for k, v in
              tr.state.gen.state_dict().items()}
    pg = PretrainedGenerator(params, exp.model(), seed=354,
                             device=args.device)
    ev = Evaluator(exp, ds_eval, pg, workdir=workdir, epoch=tr.epoch)
    res = ev.sample_statistics(n_samples=N_STAT_SAMPLES, save_fields=True,
                               make_plots=False)
    corr = daily_cycle_correlation(res)
    # each generated field's daily sum must equal the condition's
    gen, real = res["generated_samples"], res["real_samples"]
    cons = float(np.max(np.abs(gen.sum(axis=1) - real.sum(axis=1))
                        / (real.sum(axis=1) + 1e-6)))
    emit(f"[{variant}] held-out daily-cycle corr {corr:.4f}, "
         f"max rel conservation err {cons:.2e}")

    # the export round trip: weights are stored in float32 either way, so
    # both forwards run in float32
    exports = export_paths(tr.outdir, args.export_format)
    if not exports:
        raise FileNotFoundError(f"no generator exports in {tr.outdir}")
    pg2 = load_export(exports[-1], args.device,
                      n_cond_channels=dcfg.n_cond_channels)
    if pg2.cfg.n_cond_channels != dcfg.n_cond_channels:
        raise AssertionError(pg2.cfg)
    cfg_f32 = dataclasses.replace(exp.model(), compute_dtype="float32")
    pg_f32 = PretrainedGenerator(params, cfg_f32, seed=354,
                                 device=args.device)
    g = torch.Generator(device=ds_eval.device).manual_seed(5)
    lat = torch.randn((N_ROUND_TRIP, cfg_f32.latent_dim), generator=g,
                      device=ds_eval.device)
    _, cond = ds_eval.sample_real(N_ROUND_TRIP, g)
    a = pg_f32.predict_fractions(lat, cond).cpu().numpy()
    b = pg2.predict_fractions(lat, cond).cpu().numpy()
    err = float(np.max(np.abs(a - b)))
    emit(f"[{variant}] {os.path.splitext(exports[-1])[1]} round-trip: "
         f"max|a-b| {err:.2e} (export {os.path.basename(exports[-1])})")
    return {"variant": variant, "patches": len(indices), "steps": spe,
            "steady_steps_per_s": steady, "corr": corr,
            "conservation": cons, "round_trip_max_abs": err,
            "round_trip_max": float(np.abs(a).max()),
            "export": exports[-1]}


def run(args) -> dict:
    """Both variants; writes WORKDIR/variants.txt.  Returns
    {variant: numbers}."""
    from prdisagg_torch.core.config import doy_experiment, lon_experiment

    refuse_missing(args)
    os.makedirs(args.workdir, exist_ok=True)
    emit = Lines()
    out = {}
    for factory in (doy_experiment, lon_experiment):
        r = run_variant(factory, args, emit)
        out[r["variant"]] = r
    path = os.path.join(args.workdir, "variants.txt")
    emit.write(path)
    print("wrote", path, flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
