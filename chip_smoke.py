#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (prdisagg_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root.  Phases:

1. device: a CUDA device must be present; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles every CUDA kernel from the sources in prdisagg_torch/csrc;
3. kernel check: the upsample-conv kernel against its plain PyTorch version
   at the flagship generator's three stage shapes (batch 1000) and at the
   64x64 domain's last stage (batch 8), in float32 and bfloat16, with its
   time beside the plain version's, one cuDNN convolution of the upsampled
   input (timed only) and the card's bound for the same work;
4. slice: a flagship float32 PretrainedGenerator built from seeded random
   weights, written to .npz and loaded back, generates 1000 scenarios; the
   kernel's launch count, shapes, finiteness and conservation of the daily
   sum are checked, the result is held against the CPU path on a few
   samples, and scenarios/s and peak memory per scenario are measured;
5. serve: a ScenarioServer answers ping, info, a b64 map request, a stack
   request, reload, stats and shutdown.

Prints a {"kernels": [...]} line and, last, a device line.  Exits non-zero,
printing no result, if any phase fails or no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

# published dense peaks of one H100 SXM at its 700 W limit
PEAK_F32_FLOPS = 67e12      # float32 FMA, outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # bf16 tensor cores
PEAK_BYTES = 3.35e12        # HBM3

STAGES = [  # (name, batch, D, H, W, Cin, Cout)
    ("stage0", 1000, 3, 2, 2, 256, 256),
    ("stage1", 1000, 6, 4, 4, 256, 128),
    ("stage2", 1000, 12, 8, 8, 128, 64),
    ("stage2_64x64", 8, 12, 32, 32, 128, 64),
]
MAIN_PATH_STAGES = ("stage0", "stage1", "stage2")
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}  # rtol, atol/max
SCENARIOS = 1000
CONSERVATION_RTOL = 1e-5  # |sum_h scenarios - cond| <= this * max(cond)


def check(ok: bool, what) -> None:
    """An assertion that also holds under python -O."""
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device milliseconds of fn() over `reps` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")


def phase_build():
    from prdisagg_torch import _build

    secs = _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernel source(s) built in "
          f"{secs:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernel_check(seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from prdisagg_torch.ops.core import full_f32, upsample3d_nearest
    from prdisagg_torch.ops.upsample_conv import (
        _folded,
        upsample2_conv3_cuda,
        upsample2_conv3_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    ok = True
    for name, b, d, h, w, cin, cout in STAGES:
        x32 = torch.randn((b, d, h, w, cin), generator=gen, device=dev)
        k = 0.02 * torch.randn((3, 3, 3, cin, cout), generator=gen, device=dev)
        bias = 0.02 * torch.randn((cout,), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = x32.to(dtype)
            k2 = _folded(k, dtype).reshape(8, 8, cin, cout).contiguous()
            with full_f32():
                ref = upsample2_conv3_reference(x, k, bias)
                got = upsample2_conv3_cuda(x, k2, bias)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs()
                scale = ref.float().abs().max().item()
                rtol, atol = TOL[dname]
                good = bool((err <= atol * scale
                             + rtol * ref.float().abs()).all().item())
                max_err = err.max().item()
                del got, err
                reps = 10
                ms = cuda_ms(lambda: upsample2_conv3_cuda(x, k2, bias), reps)
                plain_ms = cuda_ms(
                    lambda: upsample2_conv3_reference(x, k, bias), reps)
                # library yardstick: one cuDNN conv of the upsampled input
                xu = upsample3d_nearest(x, 2).permute(0, 4, 1, 2, 3)
                wt = k.permute(4, 3, 0, 1, 2).to(dtype)
                bt = bias.to(dtype)
                library_ms = cuda_ms(
                    lambda: F.conv3d(xu, wt, bt, padding=1), reps)
                del xu, ref
            es = x.element_size()
            flops = 2 * 64 * b * d * h * w * cin * cout
            nbytes = (b * d * h * w * cin * es + 64 * cin * cout * es
                      + 4 * cout + 8 * b * d * h * w * cout * es)
            peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
            ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES
            row = dict(stage=name, dtype=dname,
                       shape=[b, d, h, w, cin, cout], ok=good,
                       max_abs_err=max_err, max_ref=scale, rtol=rtol,
                       atol_over_max=atol, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                       tflops=flops / ms / 1e9)
            rows.append(row)
            ok &= good
            print("[kernel] " + json.dumps(row))
        del x32, x, k2
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("upsample2_conv3 kernel disagrees with its "
                             "plain version (see [kernel] lines)")
    return {"rows": rows}


def profile_breakdown(fn, what: str, top: int = 8) -> None:
    """Device time by kernel and the device's idle share over one call of
    fn, from a torch.profiler trace; prints "not measured" when the trace
    holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    events = list(prof.events())
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"[profile] {what}: no device activity in the trace; "
              "breakdown not measured")
        return
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    print(f"[profile] {what}: window {window / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / window:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[profile]   {us / 1e3:9.3f} ms  {us / busy:6.1%}  {name[:90]}")


def _random_generator_tree(cfg, seed: int) -> dict:
    """Flagship generator weights in the JAX/Keras layout, N(0, 0.02)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    gd, gh, gw = cfg.latent_grid
    in_dim = cfg.latent_dim + cfg.ndomain ** 2 * cfg.n_cond_channels
    shapes = {"latent_proj": (in_dim, cfg.base_channels * gd * gh * gw)}
    cin = cfg.base_channels
    for i, ch in enumerate(cfg.gen_channels):
        shapes[f"conv{i}"] = (3, 3, 3, cin, ch)
        cin = ch
    shapes["head"] = (3, 3, 3, cin, 1)
    return {name: {"kernel": (cfg.init_stddev * rng.randn(*s)).astype("f4"),
                   "bias": (cfg.init_stddev * rng.randn(s[-1])).astype("f4")}
            for name, s in shapes.items()}


def _conservation_err(scen, cond) -> float:
    import numpy as np

    return float(np.abs(scen.sum(axis=-3) - cond).max() / cond.max())


def phase_slice(seed: int, workdir: str) -> dict:
    import numpy as np
    import torch

    from prdisagg_torch.api.pretrained import PretrainedGenerator
    from prdisagg_torch.core.config import ModelConfig
    from prdisagg_torch.ops import upsample_conv

    cfg = ModelConfig(compute_dtype="float32")
    tree = _random_generator_tree(cfg, seed)
    npz = os.path.join(workdir, "gen_flagship.npz")
    np.savez(npz, **{f"params/{layer}/{kind}": arr
                     for layer, d in tree.items() for kind, arr in d.items()})
    gen = PretrainedGenerator.from_npz(npz, seed=seed)
    check(gen.cfg == cfg, gen.cfg)
    rng = np.random.RandomState(seed + 1)
    cond = rng.gamma(0.6, 12.0, (16, 16)).astype("f4")  # daily sums, mm

    torch.cuda.synchronize()
    upsample_conv.launches = 0
    scen = gen.generate_scenarios(cond, SCENARIOS)
    launches = upsample_conv.launches
    print(f"[slice] main path: generate_scenarios(cond, {SCENARIOS}) "
          f"launched the kernel {launches} times (max_batch {gen.max_batch})")
    check(launches == 3, f"expected 3 kernel launches, got {launches}")
    check(scen.shape == (SCENARIOS, 24, 16, 16), scen.shape)
    check(np.isfinite(scen).all(), "non-finite scenarios")
    cons = _conservation_err(scen, cond)
    print(f"[slice] shape {scen.shape} finite; max |sum_h - cond| / max(cond)"
          f" = {cons:.3e} (bound {CONSERVATION_RTOL})")
    check(cons <= CONSERVATION_RTOL, f"conservation error {cons}")

    # the same weights and latents through the CPU path (plain PyTorch)
    lat = rng.randn(8, cfg.latent_dim).astype("f4")
    cpu = PretrainedGenerator.from_npz(npz, device="cpu")
    want = cpu.generate_scenarios(cond, 8, latent=lat)
    got = gen.generate_scenarios(cond, 8, latent=lat)
    cpu_err = float(np.abs(got - want).max())
    print(f"[slice] card vs CPU on 8 scenarios: max |diff| = {cpu_err:.3e} mm"
          f" (bound 1e-5 * max(cond) = {1e-5 * cond.max():.3e})")
    check(cpu_err <= 1e-5 * cond.max(), f"card vs CPU differ by {cpu_err}")

    result = {"launches": launches, "conservation": cons, "cpu_err": cpu_err,
              "npz": npz, "gen": gen, "cond": cond}
    for n in (SCENARIOS, gen.max_batch):
        t0 = time.perf_counter()
        gen.generate_scenarios(cond, n)  # returns host numpy: synchronous
        first = time.perf_counter() - t0
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            gen.generate_scenarios(cond, n)
            walls.append(time.perf_counter() - t0)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen.generate_scenarios(cond, n)
        peak = torch.cuda.max_memory_allocated() - base
        wall = statistics.median(walls)
        row = {"n": n, "scenarios_per_s": n / wall, "median_s": wall,
               "first_s": first, "peak_bytes": peak,
               "peak_bytes_per_scenario": peak / n}
        print("[slice] f32 " + json.dumps(row))
        result[f"f32_{n}"] = row
    profile_breakdown(lambda: gen.generate_scenarios(cond, SCENARIOS),
                      f"f32 generate_scenarios(cond, {SCENARIOS})")
    gen16 = PretrainedGenerator.from_npz(
        npz, cfg=ModelConfig(compute_dtype="bfloat16"), seed=seed)
    scen16 = gen16.generate_scenarios(cond, SCENARIOS)
    cons16 = _conservation_err(scen16, cond)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        gen16.generate_scenarios(cond, SCENARIOS)
        walls.append(time.perf_counter() - t0)
    print(f"[slice] bf16 generate_scenarios(cond, {SCENARIOS}): "
          f"{SCENARIOS / statistics.median(walls):.1f} scenarios/s, "
          f"conservation {cons16:.3e}")
    check(np.isfinite(scen16).all() and cons16 <= CONSERVATION_RTOL,
          f"bf16 scenarios: conservation error {cons16}")
    return result


def phase_serve(sl: dict) -> None:
    import numpy as np

    from prdisagg_torch.api.server import ScenarioServer, request, scenarios_array
    from prdisagg_torch.ops import upsample_conv

    gen, cond, npz = sl["gen"], sl["cond"], sl["npz"]
    os.makedirs("build", exist_ok=True)  # short relative path: AF_UNIX limit
    sock = os.path.join("build", f"chip_smoke-{os.getpid()}.sock")
    server = ScenarioServer(gen, sock)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    stack = np.stack([cond * (1 + 0.1 * i) for i in range(8)])
    upsample_conv.launches = 0
    try:
        answers = {
            "ping": request(sock, {"cmd": "ping"}),
            "info": request(sock, {"cmd": "info"}),
            "map_b64": request(sock, {"cond": cond.tolist(), "n_scenarios": 16,
                                      "encoding": "b64"}),
            "stack": request(sock, {"cond": stack.tolist(), "n_scenarios": 4}),
            "reload": request(sock, {"cmd": "reload", "weights": npz}),
            "stats": request(sock, {"cmd": "stats"}),
            "shutdown": request(sock, {"cmd": "shutdown"}),
        }
    finally:
        server.shutdown()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread did not stop")
    for name, resp in answers.items():
        short = {k: v for k, v in resp.items() if k not in (
            "scenarios", "scenarios_b64")}
        print(f"[serve] {name}: {json.dumps(short)}")
        check(resp.get("ok") is True, (name, resp))
    one = scenarios_array(answers["map_b64"])
    many = scenarios_array(answers["stack"])
    check(one.shape == (16, 24, 16, 16) and many.shape == (8, 4, 24, 16, 16),
          (one.shape, many.shape))
    cons = max(_conservation_err(one, cond),
               max(_conservation_err(many[i], stack[i]) for i in range(8)))
    print(f"[serve] 7/7 responses ok; conservation {cons:.3e}; kernel "
          f"launches {upsample_conv.launches} for 2 scenario requests")
    check(cons <= CONSERVATION_RTOL, f"conservation error {cons}")
    check(upsample_conv.launches == 6,
          f"expected 6 kernel launches, got {upsample_conv.launches}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    try:
        phase_device()
        phase_build()
    except Exception:  # noqa: BLE001 — nothing can run after this
        traceback.print_exc()
        return 1

    failed = []
    kc, sl = None, None
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke-")
    for name, fn in (("kernel_check", lambda: phase_kernel_check(args.seed)),
                     ("slice", lambda: phase_slice(args.seed, workdir.name))):
        try:
            out = fn()
            if name == "kernel_check":
                kc = out
            else:
                sl = out
        except Exception:  # noqa: BLE001 — report, run the other phases
            traceback.print_exc()
            failed.append(name)
    if sl is not None:
        try:
            phase_serve(sl)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            failed.append("serve")
    else:
        failed.append("serve (skipped: slice failed)")
    workdir.cleanup()
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    main_rows = [r for r in kc["rows"] if r["stage"] in MAIN_PATH_STAGES
                 and r["dtype"] == "float32"]
    kernels = [{
        "name": "upsample2_conv3",
        "route": "cuda",
        "source": "prdisagg_torch/csrc/upsample_conv.cu",
        "replaces": "prdisagg_tpu/ops/pallas_upsample_conv.py:37",
        "launches": sl["launches"],
        # one flagship float32 forward's three launches at batch 1000 (every
        # stage and dtype checked is in the [kernel] lines)
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": "operations" if all(
            r["bound_by"] == "operations" for r in main_rows) else "bytes",
        "library_ms": sum(r["library_ms"] for r in main_rows),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
