"""Asynchronous end-of-epoch artifact writing.

Per-epoch host work (the checkpoint, weight exports, hist.csv, plots) runs
on one background worker thread while the loop keeps training, as in the
JAX package (train/artifacts.py there), which found that doing it in the
loop ate most of a long run's wall clock.  One worker also serialises all
matplotlib use, which is not thread-safe across threads.  A failed job is
kept and re-raised on the next ``submit`` or ``flush``, so no failure
passes silently.

The port updates its state in place, eagerly and under the CUDA graph
alike, so the worker must never read the live tensors: the loop hands it a
:class:`Snapshot`, device copies made on the training stream (the
counterpart of the JAX package's copy, which it needs because the step
donates its buffers).  The worker's device-to-host copy runs on a side
stream of its own, after an event recorded behind the device copies, so it
neither reads a tensor before its copy is done nor waits for the training
steps queued after it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import torch

from prdisagg_torch.train.state import GANTrainState, state_tree


def _map(tree, fn):
    """`fn` applied to every tensor of a tree of dicts, lists and tuples;
    other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def _cuda_device(tree) -> Optional[torch.device]:
    found = []
    _map(tree, lambda t: found.append(t.device) if t.is_cuda else None)
    return found[0] if found else None


class Snapshot:
    """Copies of a tree of tensors, made on the current stream when it is
    created; :meth:`host` gives them on the host (copied once, by whoever
    asks first, which is meant to be the artifact worker)."""

    def __init__(self, tree):
        with torch.no_grad():
            self._dev = _map(tree, lambda t: t.detach().clone())
        self._device = _cuda_device(self._dev)
        self._ready = None
        if self._device is not None:
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(self._device))
        self._host = None
        self._lock = threading.Lock()

    def host(self):
        with self._lock:
            if self._host is None:
                if self._device is None:
                    self._host = self._dev
                else:
                    stream = torch.cuda.Stream(self._device)
                    with torch.cuda.stream(stream):
                        stream.wait_event(self._ready)
                        # a copy to pageable memory returns when it is done,
                        # so the device copies may be freed right after
                        self._host = _map(self._dev, lambda t: t.cpu())
                self._dev = None
            return self._host


def snapshot(state: GANTrainState) -> Snapshot:
    """A :class:`Snapshot` of the whole train state in the checkpoint's
    layout (:func:`prdisagg_torch.train.state.state_tree`)."""
    return Snapshot(state_tree(state))


class ArtifactWriter:
    """Single background worker draining a queue of artifact-writing jobs."""

    def __init__(self, name: str = "artifact-writer"):
        self._q: queue.Queue = queue.Queue()
        # every failed job is kept: two queued jobs can both fail before the
        # next submit or flush, and the first must not be masked
        self._errors: list = []
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                job()
            except BaseException as e:  # noqa: BLE001 — reported on flush
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _check_error(self):
        if self._errors:
            errs, self._errors = self._errors, []
            msg = "; ".join(f"{type(e).__name__}: {e}" for e in errs)
            raise RuntimeError(f"{len(errs)} artifact writer job(s) failed: "
                               f"{msg}") from errs[0]

    def submit(self, job: Callable[[], None]) -> None:
        """Enqueue a no-argument callable.  Raises if a previous job
        failed."""
        self._check_error()
        if not self._thread.is_alive():
            raise RuntimeError("artifact writer already closed")
        self._q.put(job)

    def flush(self) -> None:
        """Block until every queued job has run; re-raise any job error."""
        self._q.join()
        self._check_error()

    def close(self) -> None:
        self.flush()
        self._q.put(None)
        self._thread.join()


class SyncWriter:
    """Runs each job at once, in the caller's thread (async_artifacts=False)."""

    def submit(self, job: Callable[[], None]) -> None:
        job()

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
