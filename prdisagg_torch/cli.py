"""Command-line interface of the port (the JAX package's cli.py, subcommand
for subcommand as they are ported):

  python -m prdisagg_torch.cli train --synthetic --epochs 2
  python -m prdisagg_torch.cli train --data d.npy --indices i.pkl
  python -m prdisagg_torch.cli train --synthetic --device cpu --model-preset tiny
  python -m prdisagg_torch.cli train ... --resume
  python -m prdisagg_torch.cli evaluate --synthetic --weights g.npz --smoke
  python -m prdisagg_torch.cli crps --weights g.npz --real data/real_samples.npy \\
      --baseline rainfarm_calibration_data.npy
  python -m prdisagg_torch.cli lsd --real r.npy --generated g.npy --reduction device
  python -m prdisagg_torch.cli crps-analyze --results data/crps_results_n_sample10000.pkl
  python -m prdisagg_torch.cli parity-report --ours DIR --reference DIR
  python -m prdisagg_torch.cli rainfarm-calibrate --data d.npy --indices i.pkl
  python -m prdisagg_torch.cli rainfarm-crps --slopes data/spectral_slopes_0.pkl \\
      --real data/real_samples.npy
  python -m prdisagg_torch.cli rainfarm-generate --slopes S.pkl --real R.npy
  python -m prdisagg_torch.cli generate --weights gen.h5 --conds conds.npy --n-scenarios 1000
  python -m prdisagg_torch.cli serve --weights gen.npz --socket /tmp/gen.sock
  python -m prdisagg_torch.cli example [--weights gen.npz]
  python -m prdisagg_torch.cli inspect --weights gen.h5 --layers

Each takes the JAX package's flags, plus ``--device`` where it computes
(default ``cuda``: the port runs on the card unless asked otherwise;
``inspect`` touches no device); ``train`` also ``--export-format`` and
``--plot-every-epochs``, and ``evaluate`` and ``lsd`` ``--no-plots``.  The
per-epoch ``.h5`` exports (the default format) need ``h5py``, and figures
``matplotlib`` (the evaluation's and RainFARM's also ``seaborn``, the
evaluation's ``pandas``); where one is missing the command refuses to
start, names the package and the flag that turns the artifact off, if
there is one (``example``, ``rainfarm-generate`` and ``generate --plot``
make only figures or need them).

Data parallelism runs one process per device under a launcher that sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``:

  torchrun --standalone --nproc-per-node 4 -m prdisagg_torch.cli train --synthetic
  torchrun --standalone --nproc-per-node 4 -m prdisagg_torch.cli crps --dp 4 ...
  torchrun --standalone --nproc-per-node 4 -m prdisagg_torch.cli serve --dp 4 ...

``train`` under a launched world trains data-parallel over all its ranks;
``evaluate``, ``crps``, ``generate`` and ``serve`` take ``--dp N``, which
needs a launched world of N processes and refuses otherwise.  Rank 0
writes the files; under ``serve --dp`` it owns the socket and the other
ranks follow it (api/server.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import pickle
import sys

import numpy as np


def _load_dataset(args, cfg):
    from prdisagg_torch.data.sampler import DeviceDataset

    if getattr(args, "synthetic", False):
        from prdisagg_torch.data.synthetic import make_synthetic_dataset

        data, indices, cfg = make_synthetic_dataset(
            n_days=args.synthetic_days, ny=args.synthetic_size,
            nx=args.synthetic_size, cfg=cfg)
    else:
        if not args.data or not args.indices:
            sys.exit("need --data and --indices (or --synthetic)")
        data = np.load(args.data, mmap_mode="r")
        # the valid-index list this tool or the reference wrote
        with open(args.indices, "rb") as f:
            indices = np.asarray(pickle.load(f), dtype=np.int32)
    doy = np.load(args.doy) if getattr(args, "doy", None) else None
    return DeviceDataset.from_numpy(np.asarray(data), indices, cfg, doy=doy,
                                    device=args.device), cfg


def _data_config(args):
    from prdisagg_torch.core.config import DataConfig

    kw = {}
    for field in ("ndomain", "stride", "tp_thresh_daily", "n_thresh",
                  "conditioning", "startdate", "enddate"):
        v = getattr(args, field, None)
        if v is not None:
            kw[field] = v
    return DataConfig(**kw)


def _add_data_args(p, with_dataset=True):
    p.add_argument("--ndomain", type=int, default=None)
    p.add_argument("--stride", type=int, default=None)
    p.add_argument("--tp-thresh-daily", dest="tp_thresh_daily",
                   type=float, default=None)
    p.add_argument("--n-thresh", dest="n_thresh", type=int, default=None)
    p.add_argument("--startdate", default=None)
    p.add_argument("--enddate", default=None)
    p.add_argument("--conditioning", choices=["base", "doy", "lon"],
                   default=None)
    if with_dataset:
        p.add_argument("--data", help="training tensor .npy")
        p.add_argument("--indices", help="valid-indices .pkl")
        p.add_argument("--doy", help="day-of-year sidecar .npy")
        p.add_argument("--synthetic", action="store_true",
                       help="use the synthetic fixture dataset")
        p.add_argument("--synthetic-days", type=int, default=8)
        p.add_argument("--synthetic-size", type=int, default=64)


def _refuse_missing(needs) -> None:
    """Exit, before any work, if a (module, what needs it, flag that turns
    it off or None) of `needs` is not installed, naming the flags."""
    missing = [
        f"{what} need the '{mod}' package, which is not installed"
        + (f"; pass {flag} to run without them" if flag else "")
        for mod, what, flag in needs
        if importlib.util.find_spec(mod) is None]
    if missing:
        sys.exit("; ".join(missing))


def _figure_needs(args, mods, what) -> list:
    """The modules figures need, unless --no-plots turned them off."""
    if args.no_plots:
        return []
    return [(mod, what, "--no-plots") for mod in mods]


def _load_generator(args, **kw):
    """The generator of --weights (.npz or the reference's .h5) on
    --device, its architecture inferred from the file; --n-cond-channels
    and --wire-dtype where the subcommand has them, and the keyword
    arguments (seed, max_batch, ...) go to the constructor."""
    from prdisagg_torch.api.pretrained import PretrainedGenerator

    kw.setdefault("n_cond_channels", getattr(args, "n_cond_channels", 1))
    kw.setdefault("wire_dtype", getattr(args, "wire_dtype", None))
    kw.setdefault("mesh", _dp_mesh(args))
    kw["device"] = args.device
    if args.weights.endswith(".h5"):
        return PretrainedGenerator.from_keras_h5(args.weights, None, **kw)
    return PretrainedGenerator.from_npz(args.weights, None, **kw)


def _dp_mesh(args):
    """The data-parallel mesh of --dp N (0 = none).  It needs a launched
    world of exactly N processes; otherwise the command exits, printing
    the launch line."""
    if not getattr(args, "dp", 0):
        return None
    import torch.distributed as dist

    from prdisagg_torch.parallel.distributed import initialize_multihost
    from prdisagg_torch.parallel.mesh import make_mesh

    if not dist.is_initialized():
        initialize_multihost(device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != args.dp:
        line = " ".join(args.argv)
        sys.exit(f"--dp {args.dp} needs a launched world of {args.dp} "
                 f"processes, one per device (this process "
                 + (f"is one of {world})" if world else "was not launched)")
                 + f"; run: torchrun --standalone --nproc-per-node "
                 f"{args.dp} -m prdisagg_torch.cli {line}")
    return make_mesh(args.dp, device=args.device)


def cmd_train(args):
    from prdisagg_torch.core.config import ExperimentConfig, TrainConfig
    from prdisagg_torch.parallel.distributed import initialize_multihost
    from prdisagg_torch.parallel.mesh import make_mesh
    from prdisagg_torch.train.loop import Trainer

    needs = []
    if args.export_format in ("h5", "both"):
        needs.append(("h5py", "the .h5 weight exports",
                      "--export-format npz"))
    if args.plot_every_epochs:
        needs.append(("matplotlib", "the per-epoch plots",
                      "--plot-every-epochs 0"))
    _refuse_missing(needs)
    if args.f32_parity and args.compute_dtype == "bfloat16":
        sys.exit("--f32-parity contradicts --compute-dtype bfloat16: "
                 "pass exactly one precision request")
    dcfg = _data_config(args)
    ds, dcfg = _load_dataset(args, dcfg)
    compute_dtype = "float32" if args.f32_parity else args.compute_dtype
    # explicit flags always win; --production supplies the rest of its
    # preset wholesale
    explicit = dict(n_disc=args.n_disc, seed=args.seed)
    if args.schedule:
        from prdisagg_torch.core.config import parse_schedule

        try:  # each stage captures the step's graph once
            explicit["schedule"] = parse_schedule(args.schedule)
        except ValueError as err:
            sys.exit(f"bad --schedule: {err}")
    if args.ema_decay is not None:
        explicit["ema_decay"] = args.ema_decay
    if args.hoisted_chunks is not None:
        explicit["hoisted_chunks"] = args.hoisted_chunks
    if args.hoisted_chunk_samples is not None:
        explicit["hoisted_chunk_samples"] = args.hoisted_chunk_samples
    if args.production:
        from prdisagg_torch.core.config import production_train_config

        tcfg = production_train_config(**explicit)
    else:
        explicit.setdefault("schedule", ((args.epochs, args.batch_size),))
        tcfg = TrainConfig(**explicit)
    exp = ExperimentConfig(data=dcfg, train=tcfg, name=args.name,
                           compute_dtype=compute_dtype)
    if args.model_preset == "tiny":
        from prdisagg_torch.core.config import smoke_model_config

        exp = dataclasses.replace(exp, model_override=smoke_model_config(
            ndomain=dcfg.ndomain, n_cond_channels=dcfg.n_cond_channels,
            compute_dtype=compute_dtype))
    warm = None
    if args.warm_start_gen:
        warm = (args.warm_start_gen, args.warm_start_critic)
        if args.infer_arch:
            # the architecture from the weight files themselves; an explicit
            # precision request still wins over the inferred default
            from prdisagg_torch.train.state import (
                infer_model_config_from_weights,
            )

            inferred = infer_model_config_from_weights(*warm)
            if compute_dtype is not None:
                inferred = dataclasses.replace(inferred,
                                               compute_dtype=compute_dtype)
            exp = dataclasses.replace(exp, model_override=inferred)
    elif args.warm_start_critic:
        sys.exit("--warm-start-critic requires --warm-start-gen")
    mesh = None
    if initialize_multihost(device=args.device):
        # a launched world trains data-parallel over all its ranks
        mesh = make_mesh(device=args.device)
    tr = Trainer(exp, ds, workdir=args.workdir,
                 steps_per_epoch=args.steps_per_epoch,
                 plot_every_epochs=args.plot_every_epochs,
                 export_format=args.export_format,
                 warm_start_weights=warm, start_epoch=args.start_epoch,
                 tensorboard_dir=args.tensorboard, mesh=mesh)
    if args.resume:
        if tr.maybe_resume() and tr.primary:
            print(f"resumed at epoch {tr.epoch} (step {tr.state.step})",
                  flush=True)
    elif args.plot_every_epochs:
        tr.plot_real_samples()
    tr.fit()
    if tr.primary:
        ranks = f", data-parallel over {mesh.size} rank(s)" if mesh else ""
        print(f"finished at epoch {tr.epoch}{ranks}; artifacts in "
              f"{tr.outdir}")


def cmd_evaluate(args):
    from prdisagg_torch.core.config import ExperimentConfig
    from prdisagg_torch.eval import Evaluator

    _refuse_missing([("scipy", "the KS check (phase 5)", None)]
                    + _figure_needs(args, ("matplotlib", "seaborn", "pandas"),
                                    "the evaluation's figures"))
    if args.weights is None:
        sys.exit("evaluate requires --weights")
    dcfg = _data_config(args)
    ds, dcfg = _load_dataset(args, dcfg)
    exp = ExperimentConfig(data=dcfg, name=args.name)
    # the architecture from the weight file (the reference loads the .h5
    # with no config, generate_and_evaluate.py:60-63)
    gen = _load_generator(args, n_cond_channels=dcfg.n_cond_channels)
    ev = Evaluator(exp, ds, gen, workdir=args.workdir, epoch=args.epoch)
    overrides = {}
    if args.smoke:
        overrides = dict(n_map_conditions=2, n_fake_per_real=2,
                         n_stat_samples=50, n_line_conditions=1,
                         n_line_free_noise=10, n_line_shared_noise=2,
                         n_ks_conditions=2, n_ks_members=100)
    ev.run_all(make_plots=not args.no_plots, **overrides)
    if ev.primary:
        print(f"evaluation artifacts in {ev.plotdir} and {ev.datadir}")


def cmd_crps(args):
    from prdisagg_torch.eval.crps import run_crps_evaluation
    from prdisagg_torch.parallel.distributed import is_primary_host

    _refuse_missing([("scipy", "the CRPS analysis", None)])
    gen = _load_generator(args)
    reals = np.load(args.real)[: args.n_samples]
    baseline = np.load(args.baseline)
    res = run_crps_evaluation(gen, reals, baseline,
                              n_members=args.n_members, outdir=args.out)
    if is_primary_host():
        print(res["analysis"])


def cmd_lsd(args):
    from prdisagg_torch.eval.lsd import run_lsd_evaluation

    _refuse_missing(_figure_needs(args, ("matplotlib", "seaborn"),
                                  "the KDE plot"))
    rf = np.load(args.rainfarm) if args.rainfarm else None
    dists = run_lsd_evaluation(
        np.load(args.real), np.load(args.generated), rf,
        n_samples=args.n_samples, outdir=args.out, plotdir=args.plotdir,
        make_plot=not args.no_plots, reduction=args.reduction,
        device=args.device,
    )
    print({k: round(v, 4) for k, v in dists.medians.items()})
    print(f"LSD artifacts in {args.out}")


def cmd_crps_analyze(args):
    """Standalone analysis of saved CRPS pickles (analyze_crps_results.py)."""
    from prdisagg_torch.eval.crps import analyze

    with open(args.results, "rb") as f:
        gan, random_baseline = pickle.load(f)
    rainfarm = None
    if args.rainfarm:
        with open(args.rainfarm, "rb") as f:
            rainfarm = pickle.load(f)
    print(analyze(gan, random_baseline, rainfarm, outdir=args.out))


def cmd_parity_report(args):
    """Statistical-parity verdict against the reference's published
    artifacts."""
    import json

    from prdisagg_torch.eval.parity import parity_report

    res = parity_report(args.ours, args.reference, out_path=args.out,
                        ks_p_threshold=args.ks_p_threshold,
                        cycle_rtol=args.cycle_rtol)
    print(json.dumps(res, indent=2))
    print(f"verdict: {'PASS' if res['passes'] else 'FAIL'} -> {args.out}")


def _load_slopes(path: str):
    """(alpha, beta) from a spectral_slopes_{i}.pkl that this tool or the
    JAX package wrote."""
    with open(path, "rb") as f:
        alpha, beta = pickle.load(f)
    return alpha, beta


def cmd_rainfarm_calibrate(args):
    from prdisagg_torch.baselines.rainfarm.pipeline import calibrate
    from prdisagg_torch.core.config import RainFarmConfig

    ds, _ = _load_dataset(args, _data_config(args))
    cfg = RainFarmConfig(n_calib=args.n_calib, n_repeat=args.n_repeat)
    for i, (a, b) in enumerate(calibrate(ds, cfg, outdir=args.out)):
        print(f"repeat {i}: alpha={a:.4f} beta={b:.4f}")


def cmd_rainfarm_crps(args):
    from prdisagg_torch.baselines.rainfarm.pipeline import crps_rainfarm
    from prdisagg_torch.core.config import RainFarmConfig

    alpha, beta = _load_slopes(args.slopes)
    reals = np.load(args.real)[: args.n_samples]
    out = crps_rainfarm(reals, alpha, beta, RainFarmConfig(),
                        n_members=args.n_members,
                        outfile=os.path.join(args.out,
                                             "crps_results_rainfarm.pkl"),
                        device=args.device)
    print(f"rainfarm CRPS mean: {out.mean():.4f}")


def cmd_rainfarm_generate(args):
    """RainFARM generation artifacts (rainfarm_generate.py: ECDFs and
    per-condition map grids)."""
    from prdisagg_torch.baselines.rainfarm.pipeline import generate_and_plot
    from prdisagg_torch.core.config import RainFarmConfig

    _refuse_missing([(mod, "the RainFARM figures", None)
                     for mod in ("matplotlib", "seaborn")])
    alpha, beta = _load_slopes(args.slopes)
    reals = np.load(args.real)[: args.n_samples]
    if reals.ndim == 5:
        reals = reals[..., 0]
    generated = generate_and_plot(
        reals, alpha, beta, RainFarmConfig(), plotdir=args.plotdir,
        datadir=args.out, n_map_conditions=args.n_map_conditions,
        n_fake_per_real=args.n_fake_per_real, seed=args.seed,
        device=args.device)
    print(f"generated {generated.shape} -> {args.out}; plots in "
          f"{args.plotdir}")


def cmd_example(args):
    """The reference's example.py: a uniform 10 mm/day condition -> 10
    scenarios and their figure."""
    from prdisagg_torch.api.pretrained import PretrainedGenerator

    _refuse_missing([("matplotlib", "the example's figures", None)])
    if args.weights is not None:
        gen = _load_generator(args)
    else:
        from prdisagg_torch.core.config import ModelConfig, TrainConfig
        from prdisagg_torch.train.state import create_train_state

        print("no --weights given: using a randomly initialized generator "
              "(structure demo only)")
        state = create_train_state(ModelConfig(), TrainConfig(),
                                   device="cpu")
        gen = PretrainedGenerator(state.gen.state_dict(), device=args.device)
    cond = 10 * np.ones((gen.cfg.ndomain, gen.cfg.ndomain, 1))
    scenarios = gen.generate_scenarios(cond, args.n_scenarios)
    gen.plot_scenarios(scenarios).savefig(args.out)
    print(f"saved {args.out}; conservation check: max|sum_h - cond| = "
          f"{np.abs(scenarios.sum(axis=1) - 10).max():.2e}")


def cmd_generate(args):
    """Production serving: conditions .npy -> scenarios .npy.

    One condition (nd, nd)[, 1] takes the reference's single-request
    semantics (raindisagg_gan_pretrained.py:52-65); a stack (K, nd, nd)[, 1]
    is served as ONE fused batch (generate_scenarios_batch)."""
    from prdisagg_torch.parallel.distributed import is_primary_host

    if args.plot:
        _refuse_missing([("matplotlib", "the figures of --plot", None)])
    gen = _load_generator(args, seed=args.seed, max_batch=args.max_batch)
    conds = np.load(args.conds)
    if gen.cfg.n_cond_channels == 1:
        single = conds.ndim == 2 or (conds.ndim == 3
                                     and conds.shape[-1] == 1
                                     and conds.shape[0] == conds.shape[1])
    else:
        # variant conds are channels-last: one (nd, nd, C) map or a
        # (K, nd, nd, C) stack, told apart by rank
        single = conds.ndim == 3
    if single:
        scen = gen.generate_scenarios(conds, args.n_scenarios)
        daily = conds if conds.ndim == 2 else conds[..., 0]
        err = np.abs(scen.sum(axis=1) - daily[None]).max()
    else:
        scen = gen.generate_scenarios_batch(conds, args.n_scenarios)
        daily = conds if conds.ndim == 3 else conds[..., 0]
        err = np.abs(scen.sum(axis=2) - daily[:, None]).max()
    if not is_primary_host():
        return
    np.save(args.out, scen)
    print(f"saved {args.out} shape={scen.shape}; conservation check: "
          f"max|sum_h - cond| = {err:.2e}")
    if args.plot:
        os.makedirs(args.plot, exist_ok=True)
        first = scen if single else scen[0]
        path = os.path.join(args.plot, "scenarios_grid.png")
        gen.plot_scenarios(first[: min(8, len(first))]).savefig(path)
        print(f"saved {path}")


def cmd_serve(args):
    """Persistent serving daemon: load once, keep the weights on the
    device, answer newline-JSON requests over a Unix socket until a
    shutdown request, SIGTERM or SIGINT."""
    import signal
    import threading

    from prdisagg_torch.api.server import (
        MeshLeader,
        ScenarioServer,
        follow,
        watch_signature,
    )
    from prdisagg_torch.parallel.distributed import is_primary_host

    # the watch baseline comes BEFORE loading and warming, so a weight
    # export that lands meanwhile still triggers the first reload
    baseline = watch_signature(args.watch) if args.watch else None
    gen = _load_generator(args, seed=args.seed, max_batch=args.max_batch)
    warm = args.warm
    if warm == "max" and args.batch_window_ms > 0:
        # micro-batching pads fused totals to bucket sizes: warm the small
        # ones a concurrent-client load hits first
        warm = "max,buckets:16"
    if warm and warm != "none":
        sizes = [s if s == "max" or s.startswith("buckets") else int(s)
                 for s in warm.split(",") if s]
        secs = gen.warm(sizes)
        if is_primary_host():
            print(f"warmed forward for batch sizes {warm} in {secs:.1f}s",
                  flush=True)
    if gen.mesh is not None and gen.mesh.rank != 0:
        # a follower: rank 0's stop ends it, on its shutdown or signal
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        calls = follow(gen)
        print(f"[serve] rank {gen.mesh.rank} joined {calls} calls; bye",
              flush=True)
        return
    leader = None if gen.mesh is None else MeshLeader(gen)
    server = ScenarioServer(leader or gen, args.socket_path,
                            batch_window_ms=args.batch_window_ms,
                            watch_path=args.watch,
                            watch_interval_s=args.watch_interval,
                            watch_baseline=baseline)
    watching = f", watching {args.watch}" if args.watch else ""
    print(f"serving {args.weights} (ndomain={gen.cfg.ndomain}) on "
          f"{args.socket_path}{watching}", flush=True)
    if threading.current_thread() is threading.main_thread():
        # a clean stop (supervisor SIGTERM, ctrl-C): finish in-flight
        # requests, drain, unlink the socket
        def _stop(signum, frame):
            print(f"[serve] signal {signum}: shutting down", flush=True)
            server.shutdown()

        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)
    try:
        served = server.serve_forever(max_requests=args.max_requests)
    finally:
        if leader is not None:
            leader.stop()
    print(f"served {served} requests; bye")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield np.asarray(v)


def cmd_inspect(args):
    """Describe a weight file: network kind, inferred architecture,
    parameter count and bytes, from the shapes alone.  Host only: it
    touches no device and builds no model."""
    import json

    from prdisagg_torch.models.io import (
        infer_critic_config,
        infer_generator_config,
        load_keras_critic_h5,
        load_keras_generator_h5,
        load_params_npz,
    )

    path = args.weights
    if path.endswith((".h5", ".hdf5")):
        fmt = "keras-h5"
        try:
            params = load_keras_generator_h5(
                path, n_cond_channels=args.n_cond_channels)
        except Exception as gen_err:  # noqa: BLE001 — try the critic next
            try:
                params = load_keras_critic_h5(path)
            except Exception as critic_err:  # noqa: BLE001 — report both
                sys.exit(
                    f"cannot read {path} as a generator "
                    f"({type(gen_err).__name__}: {gen_err}) or a critic "
                    f"({type(critic_err).__name__}: {critic_err})")
    else:
        fmt = "npz"
        params = load_params_npz(path)
    p = params["params"] if isinstance(params.get("params"), dict) else params
    if "latent_proj" in p:
        kind = "generator"
        cfg = infer_generator_config(params,
                                     n_cond_channels=args.n_cond_channels)
    else:
        kind, cfg = "critic", infer_critic_config(params)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else
                f"{list(np.shape(v))} {np.asarray(v).dtype}"
                for k, v in tree.items()}

    leaves = list(_leaves(params))
    out = {
        "path": path,
        "format": fmt,
        "network": kind,
        "n_params": int(sum(a.size for a in leaves)),
        "bytes": int(sum(a.nbytes for a in leaves)),
        "inferred_config": dataclasses.asdict(cfg),
    }
    if args.layers:
        out["layers"] = shapes(p)
    print(json.dumps(out, indent=1))


def _add_device_arg(p, what: str) -> None:
    p.add_argument("--device", default="cuda",
                   help=f"where {what} (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")


def build_parser():
    p = argparse.ArgumentParser(prog="prdisagg_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    _add_data_args(t)
    _add_device_arg(t, "the dataset and the training run live")
    t.add_argument("--epochs", type=int, default=50)
    t.add_argument("--batch-size", type=int, default=32)
    t.add_argument("--schedule", default=None,
                   help="increasing-batch-size schedule EPOCHS:BATCH[,...] "
                        "e.g. '20:32,30:128' (overrides --epochs/--batch-size)")
    t.add_argument("--n-disc", type=int, default=5)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--steps-per-epoch", type=int, default=None)
    t.add_argument("--workdir", default=".")
    t.add_argument("--name", default="wgancp_pixelnorm")
    t.add_argument("--resume", action="store_true",
                   help="exact resume from the latest checkpoint")
    t.add_argument("--warm-start-gen", dest="warm_start_gen",
                   help="generator weights (.npz/.h5) to continue from "
                        "with fresh optimizers (reference workflow)")
    t.add_argument("--warm-start-critic", dest="warm_start_critic",
                   default=None)
    t.add_argument("--infer-arch", dest="infer_arch", action="store_true",
                   help="reconstruct the model architecture from the "
                        "warm-start weight files (no config needed)")
    t.add_argument("--start-epoch", dest="start_epoch", type=int, default=0,
                   help="epoch-label offset for continued runs")
    t.add_argument("--compute-dtype", dest="compute_dtype",
                   choices=["bfloat16", "float32"], default=None,
                   help="conv/matmul precision (params + conservation "
                        "softmax are always float32); default bfloat16")
    t.add_argument("--ema-decay", dest="ema_decay", type=float,
                   default=None,
                   help="EMA generator decay per fused step (0 = off, the "
                        "reference protocol); exports gen_ema_* weights")
    t.add_argument("--tensorboard", dest="tensorboard", default=None,
                   metavar="DIR",
                   help="also stream per-interval metrics to a TensorBoard "
                        "event file in DIR (hist.csv stays the record)")
    t.add_argument("--production", action="store_true",
                   help="production preset (core.config."
                        "production_train_config): schedule 20:32,30:128 + "
                        "EMA 0.999.  Explicit --schedule / --ema-decay win")
    t.add_argument("--f32-parity", dest="f32_parity", action="store_true",
                   help="strict reference-protocol precision; same as "
                        "--compute-dtype float32")
    t.add_argument("--hoisted-chunks", dest="hoisted_chunks", type=int,
                   default=None,
                   help="chunk the hoisted (n_disc*B) generator forward "
                        "into N sequential pieces (memory lever)")
    t.add_argument("--hoisted-chunk-samples", dest="hoisted_chunk_samples",
                   type=int, default=None,
                   help="cap per-chunk samples instead (auto chunk count "
                        "per schedule stage)")
    t.add_argument("--model-preset", choices=["flagship", "tiny"],
                   default="flagship",
                   help="'tiny' = shrunken smoke architecture for pipeline "
                        "rehearsals (NOT a benchmark or parity config)")
    t.add_argument("--export-format", dest="export_format",
                   choices=["h5", "npz", "both"], default="h5",
                   help="per-epoch weight exports: the reference's .h5 "
                        "(needs h5py), the JAX package's .npz, or both")
    t.add_argument("--plot-every-epochs", dest="plot_every_epochs",
                   type=int, default=1,
                   help="sample and loss plots every N epochs (needs "
                        "matplotlib); 0 = none")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate")
    _add_data_args(e)
    _add_device_arg(e, "the dataset and the generator live")
    e.add_argument("--weights", required=False)
    e.add_argument("--epoch", type=int, default=20)
    e.add_argument("--workdir", default=".")
    e.add_argument("--name", default="wgancp_pixelnorm")
    e.add_argument("--smoke", action="store_true")
    e.add_argument("--no-plots", dest="no_plots", action="store_true",
                   help="write the arrays and KS p-values but no figures "
                        "(figures need matplotlib, seaborn and pandas); "
                        "leaves out phase 4, which makes only figures")
    e.add_argument("--dp", type=int, default=0,
                   help="shard eval forwards data-parallel over N devices")
    e.set_defaults(fn=cmd_evaluate)

    cr = sub.add_parser("crps")
    _add_device_arg(cr, "the generator and both arms run")
    cr.add_argument("--weights", required=True)
    cr.add_argument("--real", required=True, help="real_samples.npy")
    cr.add_argument("--baseline", required=True,
                    help="rainfarm_calibration_data.npy")
    cr.add_argument("--n-members", type=int, default=1000)
    cr.add_argument("--n-samples", type=int, default=10000)
    cr.add_argument("--out", default="data")
    cr.add_argument("--dp", type=int, default=0,
                    help="shard each chunk's samples data-parallel over the "
                         "first N devices (params replicated; results "
                         "exactly equal to single-device)")
    cr.set_defaults(fn=cmd_crps)

    lsd = sub.add_parser("lsd")
    _add_device_arg(lsd, "the spectra and distances are computed")
    lsd.add_argument("--real", required=True)
    lsd.add_argument("--generated", required=True)
    lsd.add_argument("--rainfarm")
    lsd.add_argument("--n-samples", type=int, default=1000)
    lsd.add_argument("--out", default=".")
    lsd.add_argument("--plotdir", default="plots")
    lsd.add_argument("--reduction", choices=("full", "device"),
                     default="full",
                     help="full = save complete distance populations "
                          "(reference artifact contract); device = on-device "
                          "reduction, exact medians + subsample artifacts")
    lsd.add_argument("--no-plots", dest="no_plots", action="store_true",
                     help="no KDE plot (it needs matplotlib and seaborn)")
    lsd.set_defaults(fn=cmd_lsd)

    ca = sub.add_parser("crps-analyze")
    ca.add_argument("--results", required=True,
                    help="crps_results_n_sample*.pkl (gan, random)")
    ca.add_argument("--rainfarm", help="crps_results_rainfarm.pkl")
    ca.add_argument("--out", default="data")
    ca.set_defaults(fn=cmd_crps_analyze)

    pr = sub.add_parser("parity-report")
    pr.add_argument("--ours", required=True,
                    help="our plots_generated_* artifact directory")
    pr.add_argument("--reference", required=True,
                    help="reference plots_generated_wgancp_pixelnorm* dir")
    pr.add_argument("--out", default="data/parity_report.json")
    pr.add_argument("--ks-p-threshold", type=float, default=0.01)
    pr.add_argument("--cycle-rtol", type=float, default=0.25)
    pr.set_defaults(fn=cmd_parity_report)

    rc = sub.add_parser("rainfarm-calibrate")
    _add_data_args(rc)
    _add_device_arg(rc, "the dataset lives and the slopes are estimated")
    rc.add_argument("--n-calib", type=int, default=5000)
    rc.add_argument("--n-repeat", type=int, default=10)
    rc.add_argument("--out", default="data")
    rc.set_defaults(fn=cmd_rainfarm_calibrate)

    rcr = sub.add_parser("rainfarm-crps")
    _add_device_arg(rcr, "the ensembles are made and scored")
    rcr.add_argument("--slopes", required=True, help="spectral_slopes_0.pkl")
    rcr.add_argument("--real", required=True)
    rcr.add_argument("--n-members", type=int, default=1000)
    rcr.add_argument("--n-samples", type=int, default=10000)
    rcr.add_argument("--out", default="data")
    rcr.set_defaults(fn=cmd_rainfarm_crps)

    rg = sub.add_parser("rainfarm-generate")
    _add_device_arg(rg, "the realizations are made")
    rg.add_argument("--slopes", required=True, help="spectral_slopes_0.pkl")
    rg.add_argument("--real", required=True, help="real_samples.npy")
    rg.add_argument("--n-samples", type=int, default=10000)
    rg.add_argument("--n-map-conditions", type=int, default=20)
    rg.add_argument("--n-fake-per-real", type=int, default=10)
    rg.add_argument("--seed", type=int, default=0)
    rg.add_argument("--out", default="data")
    rg.add_argument("--plotdir", default="plots_generated_rainfarm")
    rg.set_defaults(fn=cmd_rainfarm_generate)

    ex = sub.add_parser("example")
    _add_device_arg(ex, "the generator runs")
    ex.add_argument("--weights")
    ex.add_argument("--n-scenarios", type=int, default=10)
    ex.add_argument("--out", default="generated_scenarios1.png")
    ex.set_defaults(fn=cmd_example)

    wire_help = ("dtype of the device->host copy: float16 halves its bytes "
                 "at about 5e-4 relative conservation error (default "
                 "float32, exact reference parity; responses are float32 "
                 "either way)")
    cond_help = ("conditioning channels of the weights (base 1, lon 2, doy "
                 "3); conditions then carry the extra channels after the mm "
                 "daily sums: (nd,nd,C) / (K,nd,nd,C)")
    g = sub.add_parser("generate", help="serve scenarios for condition(s) "
                       "from a .npy of daily-sum maps")
    _add_device_arg(g, "the generator runs")
    g.add_argument("--weights", required=True)
    g.add_argument("--conds", required=True,
                   help=".npy of daily sums in mm: (nd,nd)[,1] for one "
                        "request or (K,nd,nd)[,1] for a batch")
    g.add_argument("--n-scenarios", type=int, default=1000)
    g.add_argument("--out", default="scenarios.npy")
    g.add_argument("--seed", type=int, default=354)
    g.add_argument("--max-batch", type=int, default=None,
                   help="per-forward device batch cap (default: the "
                        "measured domain-scaled ceiling, 8192 at 16x16)")
    g.add_argument("--plot", default=None,
                   help="also save a scenario-grid png of the first request "
                        "(needs matplotlib)")
    g.add_argument("--dp", type=int, default=0,
                   help="shard the scenario batch data-parallel over the "
                        "first N devices (params replicated; per-sample "
                        "output identical to single-device)")
    g.add_argument("--n-cond-channels", dest="n_cond_channels", type=int,
                   default=1, help=cond_help)
    g.add_argument("--wire-dtype", dest="wire_dtype", default=None,
                   choices=["float32", "float16"], help=wire_help)
    g.set_defaults(fn=cmd_generate)

    srv = sub.add_parser(
        "serve",
        help="persistent scenario-serving daemon: weights kept on the "
             "device, newline-JSON requests over a Unix socket "
             "(api/server.py's docstring has the protocol)")
    _add_device_arg(srv, "the generator runs")
    srv.add_argument("--weights", required=True)
    srv.add_argument("--socket", required=True, dest="socket_path",
                     help="Unix socket path to listen on")
    srv.add_argument("--seed", type=int, default=354)
    srv.add_argument("--max-batch", type=int, default=None,
                     help="per-forward device batch cap (default: the "
                          "measured domain-scaled ceiling)")
    srv.add_argument("--max-requests", type=int, default=None,
                     help="exit after N requests (smoke runs and tests)")
    srv.add_argument("--batch-window-ms", type=float, default=0.0,
                     help="dynamic micro-batching: fuse concurrent scenario "
                          "requests arriving within this window into ONE "
                          "device forward (0 = off, keeping the sequential "
                          "per-request random stream exactly)")
    srv.add_argument("--warm", default="max",
                     help="comma list of request sizes to run once before "
                          "binding the socket ('max' = the max-batch chunk, "
                          "'buckets:N' = the micro-batching sizes up to N, "
                          "'none' to skip), so kernel builds and cuDNN's "
                          "plan search happen outside any request")
    srv.add_argument("--dp", type=int, default=0,
                     help="shard every request's scenario batch over the "
                          "first N devices (data-parallel serving)")
    srv.add_argument("--watch", default=None, metavar="PATH",
                     help="hot-reload weights when PATH changes: a file "
                          "(reload on mtime change) or a directory (reload "
                          "when a newer gen_*.h5/.npz export lands)")
    srv.add_argument("--watch-interval", type=float, default=5.0,
                     help="seconds between watch polls")
    srv.add_argument("--n-cond-channels", dest="n_cond_channels", type=int,
                     default=1, help=cond_help)
    srv.add_argument("--wire-dtype", dest="wire_dtype", default=None,
                     choices=["float32", "float16"], help=wire_help)
    srv.set_defaults(fn=cmd_serve)

    ins = sub.add_parser(
        "inspect",
        help="describe a weight file (.h5/.npz): network kind, inferred "
             "architecture, parameter count; host only, no device")
    ins.add_argument("--weights", required=True)
    ins.add_argument("--n-cond-channels", dest="n_cond_channels", type=int,
                     default=1,
                     help="conditioning channels for generator inference "
                          "(base 1, lon 2, doy 3: not recoverable from "
                          "generator shapes alone)")
    ins.add_argument("--layers", action="store_true",
                     help="also list per-layer shapes and dtypes")
    ins.set_defaults(fn=cmd_inspect)
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    args.argv = argv
    import torch.distributed as dist

    started_here = not dist.is_initialized()
    try:
        args.fn(args)
    finally:
        # a group this command started ends with it
        if started_here and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
