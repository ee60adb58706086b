"""Training loop: epochs over the batch-size schedule, metrics history
and per-epoch weight exports (reference ``train()``,
gan_train_cwgangp_pixelnorm.py:431-529).

* metrics stay on the device; the packed vector is fetched to the host once
  per log interval, with the non-finite flag OR-ed over the interval, and a
  non-finite one raises :class:`NaNLossError` (reference abort, :487-488);
* ``hist.csv`` has the JAX package's columns, one row per log interval,
  written with the ``csv`` module in ``pandas.DataFrame.to_csv``'s layout;
* per-epoch ``gen_/disc_{params}_{epoch:04d}.npz`` exports in the JAX
  package's ``.npz`` layout (plus ``gen_ema_`` when EMA is on).

Not ported yet: full-state resume, ``.h5`` exports, plots, TensorBoard,
warm-start and the background artifact writer.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Optional

from prdisagg_torch.core.config import ExperimentConfig
from prdisagg_torch.data.sampler import DeviceDataset
from prdisagg_torch.models.io import params_to_jax, save_params_npz
from prdisagg_torch.train.state import GANTrainState, create_train_state
from prdisagg_torch.train.wgan_gp import make_train_step, unpack_metrics

HIST_COLUMNS = ("d_loss", "g_loss", "gp", "w_distance", "d_grad_norm",
                "g_grad_norm", "epoch")


class NaNLossError(RuntimeError):
    """Raised when the train step reports non-finite losses
    (reference abort: gan_train_cwgangp_pixelnorm.py:487-488)."""


class Trainer:
    def __init__(self, exp: ExperimentConfig, ds: DeviceDataset,
                 workdir: str = ".", steps_per_epoch: Optional[int] = None,
                 export_weights_every_epochs: int = 1, start_epoch: int = 0):
        """The state is created on the dataset's device from
        ``exp.train.seed``.  `start_epoch` offsets the epoch labels and the
        schedule (the reference's continue-training workflow)."""
        self.exp = exp
        self.model_cfg = exp.model()
        self.ds = ds
        self.workdir = workdir
        self.params_str = exp.data.params_string()
        self.outdir = os.path.join(workdir, "trained_models", exp.name)
        os.makedirs(self.outdir, exist_ok=True)
        self.steps_per_epoch = steps_per_epoch
        self.export_weights_every_epochs = export_weights_every_epochs
        self.state: GANTrainState = create_train_state(
            self.model_cfg, exp.train, device=ds.device)
        self.hist: dict = {k: [] for k in HIST_COLUMNS}
        self.epoch = start_epoch
        self._epoch0 = start_epoch
        #: host seconds of each epoch's steps (ending in the metrics fetch)
        self.epoch_seconds: list = []

    def fit(self, progress: bool = True) -> dict:
        """Run the schedule; returns the metrics history.  Stage boundaries
        are cumulative from `start_epoch`."""
        cum = self._epoch0
        for n_epochs, batch_size in self.exp.train.schedule:
            cum += n_epochs
            if self.epoch < cum:
                self._fit_stage(cum, batch_size, progress)
        return self.hist

    def _fit_stage(self, until_epoch: int, batch_size: int, progress: bool):
        spe = self.steps_per_epoch or max(1, self.ds.n_samples // batch_size)
        # one host fetch per log interval; the interval divides the epoch so
        # each epoch runs exactly spe steps
        k_max = max(1, min(self.exp.train.log_every_steps, spe))
        k_steps = next(k for k in range(k_max, 0, -1) if spe % k == 0)
        step_fn = make_train_step(self.model_cfg, self.exp.train, batch_size)

        while self.epoch < until_epoch:
            t0 = time.perf_counter()
            for j in range(spe // k_steps):
                flag = None
                for _ in range(k_steps):
                    self.state, metrics = step_fn(self.state, self.ds)
                    f = metrics["nonfinite"]
                    flag = f if flag is None else flag | f
                packed = metrics["packed"].clone()
                packed[-1] = flag.float()
                m = unpack_metrics(packed)
                if m["nonfinite"]:
                    raise NaNLossError(f"non-finite loss at epoch "
                                       f"{self.epoch + 1} chunk {j}: {m}")
                for k in HIST_COLUMNS:
                    self.hist[k].append(self.epoch + 1 if k == "epoch"
                                        else m[k])
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
            self._end_of_epoch()

    def _end_of_epoch(self):
        e = self.epoch
        we = self.export_weights_every_epochs
        if we and e % we == 0:
            self._export_weights(e)
        self._write_hist()

    def _export_weights(self, e: int):
        """Reference-named per-epoch exports in the JAX ``.npz`` layout."""
        nets = {"gen": self.state.gen, "disc": self.state.critic}
        if self.state.ema_gen is not None:
            nets["gen_ema"] = self.state.ema_gen
        for prefix, net in nets.items():
            save_params_npz(
                os.path.join(self.outdir,
                             f"{prefix}_{self.params_str}_{e:04d}.npz"),
                params_to_jax(net.state_dict()))

    def _write_hist(self):
        """hist.csv as ``pandas.DataFrame(hist).to_csv`` writes it: an
        unnamed index column, then the metric columns."""
        path = os.path.join(self.workdir, "hist.csv")
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["", *HIST_COLUMNS])
            for i, row in enumerate(zip(*(self.hist[k] for k in HIST_COLUMNS))):
                w.writerow([i, *row])
        os.replace(tmp, path)

