"""Optional TensorBoard sink for training metrics.

hist.csv stays the always-on record; this streams the same scalars for
``tensorboard --logdir``.  Opt-in: constructing :class:`MetricsTB` is the
only place the ``tensorboard`` package is touched.
"""

from __future__ import annotations


class MetricsTB:
    """Append scalar metrics to a TensorBoard event file; the Trainer logs
    once per log interval, the cadence of its hist rows."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as err:
            raise RuntimeError(
                "TensorBoard logging needs the `tensorboard` package "
                "(torch.utils.tensorboard); install it or drop the "
                "tensorboard_dir / --tensorboard option") from err
        self._writer = SummaryWriter(logdir)

    def log(self, metrics: dict, step: int, prefix: str = "train") -> None:
        for k, v in metrics.items():
            self._writer.add_scalar(f"{prefix}/{k}", float(v), step)

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()
