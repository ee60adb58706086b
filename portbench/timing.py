"""Device time of a call, and K1's calls at the shapes a cell's timed path
makes them.

:func:`queued_ms` is copied from ``chip_smoke.py``: the calls are queued
behind a spin kernel, so that the CUDA events around them see device time
only and not the Python launches, which take longer than a small kernel.
"""

from __future__ import annotations

import time

import torch


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of fn over `reps` calls queued
    behind a spin kernel that doubles until it outlasts the host's
    enqueueing."""
    fn()
    torch.cuda.synchronize()
    spin_cycles = 10_000_000  # about 5 ms at the H100's 1.98 GHz boost
    for _ in range(8):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(spin_cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        marks[2].record()
        marks[2].synchronize()
        if host_ms < 0.8 * marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / reps
        spin_cycles *= 2
    raise RuntimeError("the host could not queue the calls ahead of the card")


def k1_case_ms(entry, case, reps: int, seed: int) -> float:
    """Device ms of one K1 call through its public entry `entry` (x, kernel,
    bias) at `case` = (kind, dtype, (b, d, h, w, cin, cout)): a forward
    without gradient, or the backward of a forward whose three inputs need
    gradients (as the generator update's stages do)."""
    kind, dtype, (b, d, h, w, cin, cout) = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, d, h, w, cin), generator=g, device=dev).to(
        getattr(torch, dtype))
    k = 0.02 * torch.randn((3, 3, 3, cin, cout), generator=g, device=dev)
    bias = 0.02 * torch.randn((cout,), generator=g, device=dev)
    if kind == "forward":
        with torch.inference_mode():
            return queued_ms(lambda: entry(x, k, bias), reps)
    leaves = [t.requires_grad_(True) for t in (x, k, bias)]
    out = entry(*leaves)
    cot = torch.randn(out.shape, generator=g, device=dev).to(out.dtype)
    return queued_ms(lambda: torch.autograd.grad(out, leaves, cot,
                                                 retain_graph=True), reps)
