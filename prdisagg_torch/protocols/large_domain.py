"""The 64x64 large-domain variant end to end: the abbreviated reference
protocol (the JAX package's ``scripts/large_domain_tpu.py``).

The reference's alternative_domains experiment trains the 64x64,
n_thresh 40 configuration and evaluates it at epoch 8 with 15 fakes per
real and the magma_r fraction colormap
(gan_train_cwgangp_pixelnorm_largedomain.py:59,65,
generate_and_evaluate_largedomain.py:50-51,205,237).  This driver trains
``large_domain_experiment()`` at flagship width on
:func:`make_scale_dataset` days (128 x 128, seed 17), then evaluates the
last epoch's export, not the live model, with the eval preset (map grids
of 5 conditions, ``sample_statistics(500)``) on held-out days (seed 19),
and prints the ``[data]``, ``[train]``, ``[eval]`` and ``[artifacts]``
lines, the steady steps/s among them.

    python -m prdisagg_torch.protocols.large_domain [n_days=300] [epochs=8]
        [batch=32 | schedule "4:32,4:128"] [chunks=1] [export_every]
        [--workdir W] [--device cuda] [--export-format h5|npz|both]
        [--no-plots] [--model-preset flagship|tiny]

`chunks` is ``TrainConfig.hoisted_chunks`` (with a schedule,
``hoisted_chunk_samples``); `export_every` defaults to every epoch up to
batch 64 and to the last epoch above it.  The lines also go to
``WORKDIR/large_domain[_bBATCHcCHUNKS].txt``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import glob
import os
import sys
import time

import numpy as np

from prdisagg_torch.protocols import (
    Lines,
    add_run_args,
    export_ext,
    load_export,
    refuse_missing,
    with_preset,
)

#: the eval preset's sizes: map grids of 5 conditions, 500 samples
N_MAP_CONDITIONS, N_STAT_SAMPLES = 5, 500
#: held-out days of the evaluation
HELDOUT_DAYS = 80


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m prdisagg_torch.protocols.large_domain",
        description=__doc__.split("\n\n")[0])
    p.add_argument("n_days", nargs="?", type=int, default=300)
    p.add_argument("epochs", nargs="?", type=int, default=8)
    p.add_argument("batch", nargs="?", default="32",
                   help="batch size, or a schedule EPOCHS:BATCH[,...]")
    p.add_argument("chunks", nargs="?", type=int, default=1)
    p.add_argument("export_every", nargs="?", type=int, default=None)
    p.add_argument("--workdir",
                   default=os.path.join("artifacts", "large_domain_torch"))
    add_run_args(p)
    return p.parse_args(argv)


def train_config(args):
    """(TrainConfig, epochs, last batch) of the arguments."""
    from prdisagg_torch.core.config import TrainConfig, parse_schedule

    tkw = dict(seed=0, log_every_steps=50)
    if ":" in args.batch:
        schedule = parse_schedule(args.batch)
        tkw.update(schedule=schedule, hoisted_chunk_samples=(
            args.chunks if args.chunks > 1 else None))
        return TrainConfig(**tkw), sum(e for e, _ in schedule), schedule[-1][1]
    batch = int(args.batch)
    tkw.update(schedule=((args.epochs, batch),), hoisted_chunks=args.chunks)
    return TrainConfig(**tkw), args.epochs, batch


def run(args) -> dict:
    """Train, evaluate the last export, write the summary lines; returns
    the numbers the lines print."""
    from prdisagg_torch.core.config import large_domain_experiment
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.data.synthetic import make_scale_dataset
    from prdisagg_torch.eval import Evaluator, daily_cycle_correlation
    from prdisagg_torch.train.loop import Trainer

    refuse_missing(args)
    tcfg, epochs, batch = train_config(args)
    export_every = args.export_every or (1 if batch <= 64 else epochs)
    exp = dataclasses.replace(large_domain_experiment(), train=tcfg)
    exp = with_preset(exp, args.model_preset)
    dcfg = exp.data
    os.makedirs(args.workdir, exist_ok=True)
    emit = Lines()

    data, indices = make_scale_dataset(args.n_days, 128, 128, 17, dcfg)
    ds = DeviceDataset.from_numpy(data, indices, dcfg, device=args.device)
    n_train = len(indices)
    del data
    eval_data, eval_idx = make_scale_dataset(HELDOUT_DAYS, 128, 128, 19,
                                             dcfg)
    ds_eval = DeviceDataset.from_numpy(eval_data, eval_idx, dcfg,
                                       device=args.device)
    del eval_data
    emit(f"[data] {n_train} train / {len(eval_idx)} held-out 64x64 patches "
         f"(n_thresh={dcfg.n_thresh})")

    marks = {}

    def on_epoch_end(tr):
        if tr.epoch == 1 and "t1" not in marks:
            marks["t1"] = time.perf_counter()

    tr = Trainer(exp, ds, workdir=args.workdir, on_epoch_end=on_epoch_end,
                 plot_every_epochs=0, export_weights_every_epochs=export_every,
                 export_format=args.export_format)
    resumed = tr.maybe_resume()
    if resumed:
        # a relaunch continues instead of retraining; the steady rate of a
        # partial run means nothing, so it is nan
        print(f"[resume] at epoch {tr.epoch}", flush=True)
        marks["t1"] = time.perf_counter()
    t0 = time.perf_counter()
    tr.fit(progress=True)
    t_end = time.perf_counter()
    stages = exp.train.schedule

    def spe_of(b):
        return max(1, n_train // b)

    total_steps = sum(e * spe_of(b) for e, b in stages)
    steps_desc = " + ".join(f"{e}x{spe_of(b)}@b{b}" for e, b in stages)
    steady = ((total_steps - spe_of(stages[0][1])) / (t_end - marks["t1"])
              if epochs > 1 and not resumed else float("nan"))
    emit(f"[train] {steps_desc} steps: total {t_end - t0:.1f}s, "
         f"steady {steady:.2f} steps/s "
         f"({tr.model_cfg.compute_dtype}, excl. the first epoch)")

    # the reference evaluates the saved weights of the epoch, not the live
    # model; the trainer and its dataset go first, so that evaluation owns
    # the device's memory
    model_dir = tr.outdir
    del tr, ds
    gc.collect()
    path = glob.glob(os.path.join(
        model_dir, f"gen_*_{epochs:04d}.{export_ext(args.export_format)}"))[0]
    pg = load_export(path, args.device)
    if pg.cfg.ndomain != 64:
        raise AssertionError(f"{path} holds a {pg.cfg.ndomain}x"
                             f"{pg.cfg.ndomain} generator")
    ev = Evaluator(exp, ds_eval, pg, workdir=args.workdir, epoch=epochs)
    t0 = time.perf_counter()
    # 15 fakes per real and magma_r come from the eval preset
    ev.map_grids(n_conditions=N_MAP_CONDITIONS, save=not args.no_plots)
    res = ev.sample_statistics(n_samples=N_STAT_SAMPLES,
                               make_plots=not args.no_plots)
    corr = daily_cycle_correlation(res)
    gen, real = res["generated_samples"], res["real_samples"]
    cons = float(np.max(np.abs(gen.sum(axis=1) - real.sum(axis=1))
                        / (real.sum(axis=1) + 1e-6)))
    emit(f"[eval] preset artifacts in {time.perf_counter() - t0:.1f}s; "
         f"held-out daily-cycle corr {corr:.4f}, "
         f"max rel conservation err {cons:.2e}")
    grids = glob.glob(os.path.join(
        ev.plotdir, f"generated_fractions_*_{epochs:04d}_*_allhours.*"))
    emit(f"[artifacts] {len(grids)} map grids (epoch-{epochs} stamp, "
         f"{exp.eval.fraction_cmap}, {exp.eval.n_fake_per_real} fakes/real)"
         + ("" if args.no_plots else " + ECDF/daily-cycle plots")
         + f" in {ev.plotdir}")

    suffix = ("" if (args.batch, args.chunks) == ("32", 1) else
              f"_b{args.batch.replace(':', '-').replace(',', '_')}"
              f"c{args.chunks}")
    emit.write(os.path.join(args.workdir, f"large_domain{suffix}.txt"))
    return {"n_train": n_train, "n_heldout": len(eval_idx),
            "steps": total_steps, "steady_steps_per_s": steady,
            "corr": corr, "conservation": cons, "export": path,
            "map_grids": len(grids), "lines": emit.lines}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
