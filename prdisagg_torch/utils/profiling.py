"""Profiling and timing helpers.

* `trace(logdir)`: a context manager around `torch.profiler` (CPU, and the
  card when CUDA is available) that writes a Chrome trace of whatever runs
  inside it into `logdir`, loadable in TensorBoard or Perfetto.
* `StepTimer`: steps/s of a chain of device steps.  Launches return before
  the device finishes, so the timer syncs by fetching a caller-provided
  scalar that depends on the computation, or with
  `torch.cuda.synchronize()` when CUDA is in use.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile the body; its Chrome trace lands in `logdir` (default
    prdisagg_trace in the temporary directory) as ``*.pt.trace.json``.
    Yields the profiler, whose ``key_averages()`` the caller may read."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "prdisagg_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


class StepTimer:
    """Measure throughput of a chain of device steps.

    >>> timer = StepTimer()
    >>> timer.start()
    >>> for _ in range(n): state, metrics = step(state, ds)
    >>> sps = timer.stop(n, sync_scalar=metrics["packed"])
    """

    def __init__(self):
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int, sync_scalar=None) -> float:
        if sync_scalar is not None:
            # a host fetch of a dependent value waits for the device
            if isinstance(sync_scalar, torch.Tensor):
                sync_scalar.reshape(-1)[0].item()
            else:
                float(sync_scalar)
        elif torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return n_steps / (time.perf_counter() - self._t0)
