"""Training loop: epochs over the batch-size schedule, metrics history,
checkpoints and per-epoch artifacts (reference ``train()``,
gan_train_cwgangp_pixelnorm.py:431-529; the JAX package's train/loop.py).

* one call of the fused step per log interval, running K steps, K the
  largest divisor of the epoch's steps not above ``log_every_steps``; on a
  card the K steps are replays of a CUDA graph of one step, captured once
  per schedule stage (a new batch size), the counterpart of the JAX
  package's K steps scanned in one dispatch;
* metrics stay on the device; the packed vector is fetched to the host once
  per call, with the non-finite flag OR-ed over its steps, and a non-finite
  one raises :class:`NaNLossError` (reference abort, :487-488);
* ``hist.csv`` has the JAX package's columns, one row per call, written with
  the ``csv`` module in ``pandas.DataFrame.to_csv``'s layout;
* per-epoch weight exports ``gen_/disc_{params}_{epoch:04d}`` as the
  reference's ``.h5`` (the default), the JAX package's ``.npz`` or both,
  plus ``gen_ema_`` when EMA is on; full-state checkpoints every
  ``checkpoint_every_epochs`` (train/checkpoint.py) and a forced final one
  of the last completed epoch on completion and on abort;
  :meth:`Trainer.maybe_resume` resumes from one exactly;
* all artifact I/O runs on a background writer that reads device snapshots,
  never the live state (train/artifacts.py);
* ``run_config.json`` records the run's configuration and warns when a
  relaunch into the same workdir changes it; optional TensorBoard scalars,
  per-epoch sample and loss plots, and a heartbeat file after every metrics
  fetch (PRDISAGG_HEARTBEAT);
* data parallel over a mesh (parallel/mesh.py) when the process group has
  more than one rank, or when one is passed: the state is replicated, every
  rank runs the step on its shard of the batch, rank 0 alone writes every
  file (the same file set as a single-process run), every rank restores on
  resume, and :meth:`Trainer.fit` waits for all ranks before it returns.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from prdisagg_torch.core.config import ExperimentConfig
from prdisagg_torch.data.sampler import DeviceDataset
from prdisagg_torch.models.io import (
    params_to_jax,
    save_keras_critic_h5,
    save_keras_generator_h5,
    save_params_npz,
)
from prdisagg_torch.parallel.mesh import barrier, make_mesh
from prdisagg_torch.train.artifacts import (
    ArtifactWriter,
    Snapshot,
    SyncWriter,
    snapshot,
)
from prdisagg_torch.train.checkpoint import CheckpointManager
from prdisagg_torch.train.state import (
    GANTrainState,
    create_train_state,
    warm_start,
)
from prdisagg_torch.train.wgan_gp import make_train_step, unpack_metrics
from prdisagg_torch.utils.watchdog import Heartbeat

HIST_COLUMNS = ("d_loss", "g_loss", "gp", "w_distance", "d_grad_norm",
                "g_grad_norm", "epoch")
EXPORT_FORMATS = ("npz", "h5", "both")


def _dict_diff(a: dict, b: dict, prefix: str = "") -> list:
    """Dotted paths of leaves that differ between two nested dicts."""
    out = []
    for k in sorted(set(a) | set(b)):
        va, vb = a.get(k), b.get(k)
        if isinstance(va, dict) and isinstance(vb, dict):
            out += _dict_diff(va, vb, f"{prefix}{k}.")
        elif va != vb:
            out.append(f"{prefix}{k}")
    return out


def _is_nan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _number(s: str):
    """A hist.csv cell: '' (pandas' NaN) -> nan, an integral epoch -> int."""
    if s == "":
        return float("nan")
    v = float(s)
    return int(v) if v.is_integer() and "." not in s else v


class NaNLossError(RuntimeError):
    """Raised when the train step reports non-finite losses
    (reference abort: gan_train_cwgangp_pixelnorm.py:487-488)."""


def _data_mesh(mesh, n_data_devices: Optional[int], device):
    """The run's mesh: the one given, else one over the process group when
    it has more than one rank, else None.  Refuses a world whose size
    differs from `n_data_devices` when that is set."""
    if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_mesh(device=device)
    world = 1 if mesh is None else mesh.size
    if n_data_devices is not None and n_data_devices != world:
        raise ValueError(f"TrainConfig.n_data_devices is {n_data_devices}, "
                         f"the run has {world} data-parallel ranks")
    return mesh


class Trainer:
    def __init__(self, exp: ExperimentConfig, ds: DeviceDataset,
                 workdir: str = ".", steps_per_epoch: Optional[int] = None,
                 plot_every_epochs: int = 1,
                 export_weights_every_epochs: int = 1,
                 on_epoch_end: Optional[Callable] = None,
                 async_artifacts: bool = True, export_format: str = "h5",
                 warm_start_weights: Optional[tuple] = None,
                 start_epoch: int = 0,
                 tensorboard_dir: Optional[str] = None, mesh=None):
        """The state is created on the dataset's device from
        ``exp.train.seed``, or warm-started from
        ``warm_start_weights=(gen_path, critic_path_or_None)`` (.npz or
        reference .h5) with fresh optimizers.  `start_epoch` offsets the
        epoch labels and the schedule (the reference's continue-training
        workflow); for exact resume, optimizer state included, call
        :meth:`maybe_resume`.  A cadence of 0 (plots, weight exports,
        ``TrainConfig.checkpoint_every_epochs``) turns that artifact off.
        `tensorboard_dir` streams the hist rows' scalars to TensorBoard.
        `mesh` (parallel/mesh.py) makes the run data-parallel; by default
        it is the process group's when that has more than one rank.  Every
        rank constructs the Trainer and calls the same methods."""
        if export_format not in EXPORT_FORMATS:
            raise ValueError(f"unknown export_format {export_format!r}")
        self.mesh = _data_mesh(mesh, exp.train.n_data_devices, ds.device)
        #: whether this process writes the run's files (rank 0)
        self.primary = self.mesh is None or self.mesh.rank == 0
        self.exp = exp
        self.model_cfg = exp.model()
        self.ds = ds
        self.workdir = workdir
        self.params_str = exp.data.params_string()
        self.plotdir = os.path.join(workdir, f"plots_{exp.name}")
        self.outdir = os.path.join(workdir, "trained_models", exp.name)
        os.makedirs(self.plotdir, exist_ok=True)
        os.makedirs(self.outdir, exist_ok=True)
        self.steps_per_epoch = steps_per_epoch
        self.plot_every_epochs = plot_every_epochs
        self.export_weights_every_epochs = export_weights_every_epochs
        self.on_epoch_end = on_epoch_end
        self.export_format = export_format
        self.writer = (ArtifactWriter() if async_artifacts and self.primary
                       else SyncWriter())
        if warm_start_weights is not None:
            gen_w, critic_w = warm_start_weights
            self.state: GANTrainState = warm_start(
                self.model_cfg, exp.train, gen_w, critic_w, device=ds.device,
                mesh=self.mesh)
        else:
            self.state = create_train_state(self.model_cfg, exp.train,
                                            device=ds.device, mesh=self.mesh)
        self.ckpt = CheckpointManager(os.path.join(self.outdir, "ckpt"))
        # "epoch" tags each row, so that resume can drop the rows of epochs
        # newer than the restored checkpoint
        self.hist: dict = {k: [] for k in HIST_COLUMNS}
        self.epoch = start_epoch
        self._epoch0 = start_epoch  # schedule progress is counted from here
        #: host seconds of each epoch's steps (ending in the metrics fetch)
        self.epoch_seconds: list = []
        self.heartbeat = Heartbeat.from_env() if self.primary else None
        self.tb = None
        if tensorboard_dir and self.primary:
            from prdisagg_torch.utils.tb import MetricsTB

            self.tb = MetricsTB(tensorboard_dir)
        # (epoch, snapshot) of the last completed epoch: the final and abort
        # checkpoints' source (the live state after a NaN abort is poisoned)
        self._last_snap: Optional[tuple] = None
        self._last_ckpt_epoch = -1
        if self.primary:
            self._write_run_manifest()

    # ------------------------------------------------------------------
    def _write_run_manifest(self):
        """workdir/run_config.json: the whole ExperimentConfig and the
        environment.  A relaunch into the same workdir with another config
        gets a warning naming the changed fields; the current config is
        written (atomically) either way."""
        path = os.path.join(self.workdir, "run_config.json")
        # a json round trip turns tuples into lists, so comparisons are fair
        exp_dict = json.loads(json.dumps(dataclasses.asdict(self.exp)))
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    prev = json.load(fh).get("experiment")
            except (OSError, ValueError, AttributeError):
                prev = None
            if prev is not None and prev != exp_dict:
                changed = _dict_diff(prev, exp_dict)
                print(f"[trainer] WARNING: this workdir was written by a run "
                      f"with a different config (changed: "
                      f"{', '.join(changed)}); run_config.json now records "
                      f"the current one", flush=True)
        dev = self.ds.device
        manifest = {
            "experiment": exp_dict,
            "prdisagg_torch_version":
                __import__("prdisagg_torch").__version__,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "written_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=1)
        os.replace(tmp, path)

    # ------------------------------------------------------------------
    def maybe_resume(self) -> bool:
        """Restore the latest checkpoint into the state, in place, and
        continue after its epoch.  hist.csv rows of later epochs (written
        every epoch, while checkpoints may be rarer) are dropped; columns
        that an older or reference-style hist.csv lacks are filled with NaN.
        Returns False when there is no checkpoint."""
        latest = self.ckpt.latest_epoch()
        if latest is None:
            return False
        self.ckpt.restore(self.state, latest, self.mesh)
        self.epoch = latest
        self._last_ckpt_epoch = latest
        hist_path = os.path.join(self.workdir, "hist.csv")
        if os.path.exists(hist_path):
            with open(hist_path, newline="") as fh:
                rows = list(csv.DictReader(fh))
            if rows and "epoch" in rows[0]:
                rows = [r for r in rows if not _is_nan(_number(r["epoch"]))
                        and _number(r["epoch"]) <= latest]
            for k in HIST_COLUMNS:
                self.hist[k] = [_number(r[k]) if k in r else float("nan")
                                for r in rows]
        return True

    # ------------------------------------------------------------------
    def fit(self, progress: bool = True) -> dict:
        """Run the schedule; returns the metrics history.  Stage boundaries
        are cumulative from `start_epoch`, so a resumed run finishes the
        rest of the right stage.  On completion and on abort, a checkpoint
        of the last completed epoch is forced (unless checkpoints are off)
        and every queued artifact is written before returning or raising.
        Only rank 0 prints progress."""
        progress = progress and self.primary
        try:
            cum = self._epoch0
            for n_epochs, batch_size in self.exp.train.schedule:
                cum += n_epochs
                if self.epoch < cum:
                    self._fit_stage(cum, batch_size, progress)
        except BaseException:
            # drain what was queued, but never mask the training error
            try:
                self._finish()
            except Exception:  # noqa: BLE001 — the train error wins
                import traceback

                traceback.print_exc()
            raise
        self._finish()
        if self.mesh is not None:
            barrier(self.mesh)  # rank 0's files are on disk for every rank
        return self.hist

    def _finish(self):
        self._final_checkpoint()
        self.writer.flush()
        if self.tb is not None:
            self.tb.flush()

    def _final_checkpoint(self):
        """Checkpoint the last completed epoch unless it already is (or
        checkpoints are off)."""
        if not self.exp.train.checkpoint_every_epochs or self._last_snap is None:
            return
        e, snap = self._last_snap
        if e <= self._last_ckpt_epoch:
            return
        self._last_ckpt_epoch = e
        self.writer.submit(lambda: self.ckpt.save(e, snap))

    def _fit_stage(self, until_epoch: int, batch_size: int, progress: bool):
        spe = self.steps_per_epoch or max(1, self.ds.n_samples // batch_size)
        # one call (one host fetch) per log interval; K divides the epoch so
        # each epoch runs exactly spe steps
        k_max = max(1, min(self.exp.train.log_every_steps, spe))
        k_steps = next(k for k in range(k_max, 0, -1) if spe % k == 0)
        if k_steps * 10 <= k_max:
            print(f"[trainer] WARNING: steps_per_epoch={spe} has no divisor "
                  f"near log_every_steps={self.exp.train.log_every_steps} "
                  f"(chunk={k_steps}); throughput will be launch-bound",
                  flush=True)
        step_fn = make_train_step(self.model_cfg, self.exp.train, batch_size,
                                  steps_per_call=k_steps, mesh=self.mesh)

        while self.epoch < until_epoch:
            t0 = time.perf_counter()
            for j in range(spe // k_steps):
                self.state, metrics = step_fn(self.state, self.ds)
                m = unpack_metrics(metrics["packed"])
                if m["nonfinite"]:
                    raise NaNLossError(f"non-finite loss at epoch "
                                       f"{self.epoch + 1} chunk {j}: {m}")
                if self.heartbeat is not None:
                    self.heartbeat.beat()
                for k in HIST_COLUMNS:
                    self.hist[k].append(self.epoch + 1 if k == "epoch"
                                        else m[k])
                if self.tb is not None:
                    self.tb.log({k: m[k] for k in HIST_COLUMNS
                                 if k != "epoch"},
                                step=len(self.hist["d_loss"]))
                if progress:
                    print(f"epoch {self.epoch + 1} {(j + 1) * k_steps}/{spe} "
                          f"d_loss {m['d_loss']:.4f} g:{m['g_loss']:.4f} "
                          f"gp:{m['gp']:.4f}", flush=True)
            self.epoch += 1
            dt = time.perf_counter() - t0
            self.epoch_seconds.append(dt)
            if progress:
                print(f"epoch {self.epoch} done in {dt:.1f}s "
                      f"({spe / dt:.2f} fused steps/s)", flush=True)
            if self.tb is not None:
                self.tb.log({"steps_per_sec": spe / dt}, step=self.epoch,
                            prefix="perf")
            self._end_of_epoch()

    # ------------------------------------------------------------------
    def _end_of_epoch(self):
        if not self.primary:
            if self.on_epoch_end is not None:
                self.on_epoch_end(self)
            return
        e = self.epoch
        ck = self.exp.train.checkpoint_every_epochs
        we = self.export_weights_every_epochs
        pe = self.plot_every_epochs
        # device copies: the step updates the live tensors in place, so the
        # writer reads only this snapshot.  Taken every epoch, so the
        # final or abort checkpoint has the last completed epoch.
        snap = snapshot(self.state)
        self._last_snap = (e, snap)
        if ck and e % ck == 0:
            self._last_ckpt_epoch = e
            self.writer.submit(lambda: self.ckpt.save(e, snap))
        if we and e % we == 0:
            self.writer.submit(lambda: self._export_weights(e, snap))
        hist_copy = {k: list(v) for k, v in self.hist.items()}
        self.writer.submit(lambda: self._write_hist(hist_copy))
        if pe and e % pe == 0:
            # the device work stays in the loop thread; the worker only
            # copies to the host and runs matplotlib
            batch = self._fake_plot_batch(e, 30)
            self.writer.submit(lambda: self._plot_epoch(e, batch, hist_copy))
        if self.on_epoch_end is not None:
            self.on_epoch_end(self)

    def _export_weights(self, e: int, snap: Snapshot):
        """Reference-named exports of epoch `e` (gan_train_cwgangp_pixelnorm
        .py:520-521): .h5 is the reference's format, .npz the JAX
        package's; the EMA generator too when EMA is on."""
        host = snap.host()
        nets = {"gen": (host["gen"], save_keras_generator_h5),
                "disc": (host["critic"], save_keras_critic_h5)}
        if host["ema_gen"] is not None:
            nets["gen_ema"] = (host["ema_gen"], save_keras_generator_h5)
        for prefix, (sd, save_h5) in nets.items():
            base = os.path.join(self.outdir,
                                f"{prefix}_{self.params_str}_{e:04d}")
            tree = params_to_jax(sd)
            if self.export_format in ("npz", "both"):
                save_params_npz(base + ".npz", tree)
            if self.export_format in ("h5", "both"):
                save_h5(base + ".h5", tree, self.model_cfg)

    def _write_hist(self, hist: dict):
        """hist.csv as ``pandas.DataFrame(hist).to_csv`` writes it: an
        unnamed index column, then the metric columns; NaN as an empty
        cell."""
        path = os.path.join(self.workdir, "hist.csv")
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["", *HIST_COLUMNS])
            for i, row in enumerate(zip(*(hist[k] for k in HIST_COLUMNS))):
                w.writerow([i, *("" if _is_nan(v) else v for v in row)])
        os.replace(tmp, path)

    def _fake_plot_batch(self, epoch: int, n_plot: int) -> Snapshot:
        """n_plot generated samples and their conditions, drawn from a
        stream seeded by the epoch (the same plots after a resume)."""
        g = torch.Generator(device=self.ds.device).manual_seed(1000 + epoch)
        with torch.no_grad():
            latent, cond = self.ds.sample_latent(
                n_plot, self.model_cfg.latent_dim, g)
            fake = self.state.gen(latent, cond)
        return Snapshot({"fake": fake, "cond": cond})

    def _plot_epoch(self, epoch: int, batch: Snapshot, hist: dict):
        from prdisagg_torch.utils import plotting

        host = batch.host()
        plotting.sample_grid_mosaic(
            host["fake"].float().numpy(), host["cond"].float().numpy(),
            os.path.join(self.plotdir,
                         f"fake_samples_{self.params_str}_{epoch:04d}.png"))
        fig = plotting.loss_curves(hist)
        fig.savefig(os.path.join(self.plotdir,
                                 f"training_loss_{self.params_str}.png"))
        plotting.close_all()

    def plot_real_samples(self, n_plot: int = 30):
        """Pre-training real-sample grid (reference :411-425); rank 0's."""
        from prdisagg_torch.utils import plotting

        if not self.primary:
            return
        g = torch.Generator(device=self.ds.device).manual_seed(7)
        frac, cond = self.ds.sample_real(n_plot, g)
        plotting.sample_grid_mosaic(
            frac.cpu().numpy(), cond.cpu().numpy(),
            os.path.join(self.plotdir, "real_samples.png"))
