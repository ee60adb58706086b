"""The traced slice: a torch.profiler trace of whole units of the timed
path (some 2 seconds of them, set by each cell's file), run after the
measured window, reduced to what the per-layer readers and the result
line need.

The device's busy time is the union of its kernel, copy and set intervals
inside the slice; the slice's window is the span of a host annotation
around it, which ends after a synchronise (the profiler's clock for both).
The arithmetic of the union and the idle gaps follows ``chip_smoke.py``
``profile_breakdown``.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch

SLICE = "portbench.slice"
GAPS_NAMED = 200   # longest idle gaps attributed to a host operation


@dataclasses.dataclass
class Trace:
    units: int                      # requests or steps in the slice
    window_us: float
    device: List[Tuple[str, float, float]]   # (name, start_us, end_us)
    host: List[Tuple[str, float, float]]
    start_us: float = 0.0

    @property
    def busy_us(self) -> float:
        return union_us([(s, e) for _, s, e in self.device])

    def kernels(self):
        return [ev for ev in self.device if kind(ev[0]) == "kernel"]

    def memcpy(self, prefix: str = "Memcpy"):
        return [ev for ev in self.device if ev[0].startswith(prefix)]


def kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def union_us(spans) -> float:
    busy, cur = 0.0, None
    for s, e in sorted(spans):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def run_traced(fn: Callable[[], None], units: int) -> Optional[Trace]:
    """Trace `units` calls of fn (each ends its own work), after one more
    left out of the slice, with a final synchronise inside the annotated
    slice; None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        # one unit before the slice takes the profiler's own start-up
        # (its first activity buffers) out of the slice's idle time
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with record_function(SLICE):
            for _ in range(units):
                fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = prof.events()
    marks = [e for e in events if e.name == SLICE
             and e.device_type == DeviceType.CPU]
    if not marks:
        return None
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    device, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append((e.name, max(s, lo), min(t, hi)))
        elif e.name != SLICE:
            host.append((e.name, s, t))
    device = [d for d in device if d[2] > d[1]]
    print(f"[trace] {len(device)} device and {len(host)} host events, "
          f"reduced in {time.perf_counter() - t0:.1f} s")
    if not device:
        return None
    return Trace(units=units, window_us=hi - lo, device=device, host=host,
                 start_us=lo)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the host operation that was running in their middle
    (the innermost one), in seconds."""
    by_name: dict = {}
    for name, s, e in tr.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((s, e) for _, s, e in tr.device)
    gaps, end = [], tr.start_us
    for s, e in spans:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if tr.start_us + tr.window_us > end:
        gaps.append((end, tr.start_us + tr.window_us))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]
    host = sorted(tr.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    named: dict = {}
    for a, b in gaps:
        mid, key = 0.5 * (a + b), "(no host operation)"
        # the latest-starting operation that still runs at mid
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][2] >= mid:
                key = host[i][0]
                break
        named[key] = named.get(key, 0.0) + (b - a)
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
            "idle_gaps": [[n[:120], us / 1e6] for n, us in idle]}
