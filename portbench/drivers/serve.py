"""Serving: a closed loop of one caller of
``PretrainedGenerator.generate_scenarios(cond, n, latent)``, a new daily
map every request.

The maps are daily sums of the benchmark's fields (portbench/synth.py) at
valid patches, taken in turn in an order drawn from the seed; the latents are the
benchmark's, request i's drawn from its own seed, so that the check can
draw them again.  Each request is timed on the host from the call to the
returned numpy array, which is dropped at once unless the check keeps it.
The check keeps `check_requests` requests drawn from the seed among the
first `sample_from`, which a run finishes (or serves on, untimed, after
the window until it has), so that every seed keeps
as many arrays at the same points of its run (holding an array moves
where the host allocates the next ones).  After the window they are
computed again by the plain reference (float32, TF32 off) and compared:
the widest gap as a share of the request's largest value, and the
conservation of the daily sum.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench import arith, harness, program, reference, synth, timing
from portbench.trace import run_traced


def pool_maps(r: harness.Run, model: dict, data_cfg: dict, traffic: dict):
    """The pool of daily maps (mm), host float32 (nd, nd) arrays."""
    days, (ny, nx) = traffic["pool_days"], r.config["dataset_grid"]
    data, rows = synth.make_dataset(days, ny, nx, model["nhours"],
                                    harness.mix(r.seed, 1), data_cfg,
                                    r.device)
    pick = random.Random(harness.mix(r.seed, 2)).sample(
        range(len(rows)), min(traffic["pool_maps"], len(rows)))
    nd = data_cfg["ndomain"]
    daily = data.sum(dim=1)
    out = [daily[t, y:y + nd, x:x + nd].cpu().numpy()
           for t, y, x in rows[pick]]
    del data, daily
    return out


def run(r: harness.Run) -> dict:
    from prdisagg_torch.api.pretrained import PretrainedGenerator
    from prdisagg_torch.ops.upsample_conv import upsample2_conv3

    model, data_cfg = r.config["model"], r.config["data"]
    traffic, cell = r.traffic, r.cell
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("the serve driver runs one closed-loop caller")
    n, dtype = traffic["n_scenarios"], traffic["compute_dtype"]
    max_batch = r.config["serve"]["max_batch"]
    dev = torch.device(r.device)
    w = reference.make_weights(model, harness.mix(r.seed, 3), dev)
    maps = pool_maps(r, model, data_cfg, traffic)
    order = list(range(len(maps)))
    random.Random(harness.mix(r.seed, 4)).shuffle(order)
    g = torch.Generator(device=dev)

    def latent(i):
        g.manual_seed(harness.mix(r.seed, 5, i))
        return torch.randn((n, model["latent_dim"]), generator=g, device=dev)

    pg = PretrainedGenerator(program.generator_state(w),
                             program.model_config(model, dtype),
                             norm_scale=data_cfg["norm_scale"],
                             max_batch=max_batch, device=dev)
    next_i = [0]

    def request():
        i = next_i[0]
        next_i[0] += 1
        cond = maps[order[i % len(order)]]
        lat = latent(i)
        t0 = time.perf_counter()
        out = pg.generate_scenarios(cond, n, latent=lat)
        return i, cond, out, time.perf_counter() - t0

    for _ in range(traffic["warm_requests"]):
        request()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - r.t_start

    first = next_i[0]
    keep = {first + j for j in random.Random(harness.mix(r.seed, 6)).sample(
        range(cell["sample_from"]), cell["check_requests"])}
    sample, lat_ms, seen = [], [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds:
        i, cond, out, secs = request()
        lat_ms.append(1e3 * secs)
        if i in keep:
            sample.append((i, cond, out))
        del out
        seen += 1
    window_s = time.perf_counter() - t0
    while len(sample) < len(keep):  # a short run: serve on, untimed
        i, cond, out, _ = request()
        if i in keep:
            sample.append((i, cond, out))
    facts = program.device_facts(r.device)

    tr, k1 = None, []
    if r.trace:
        tr = run_traced(request, cell["trace_requests"])
        if dev.type == "cuda":
            for case in arith.k1_serve_cases(model, n, max_batch, dtype):
                k1.append((arith.k1_case_bound_ms(case),
                           timing.k1_case_ms(upsample2_conv3, case,
                                             cell["k1_reps"],
                                             harness.mix(r.seed, 7))))
    del pg
    program.free(r.device)

    checks = check(r, w, sample, latent)
    facts.update(
        setup_s=setup_s, window_s=window_s, units=seen, scenarios=seen * n,
        latencies_ms=lat_ms, trace=tr, k1=k1,
        flops_per_unit=arith.request_flops(model, n),
        peak_flops=arith.peak_flops(dtype), attempted=seen, failed=0,
        checks=checks, kind_of_cell="serve")
    return facts


def check(r: harness.Run, w: dict, sample: list, latent,
          outputs=None) -> dict:
    """The compared numbers over the sampled requests: ``max_err``, the
    widest |served - reference| over the request's largest reference value,
    and ``conservation``, the widest |sum over hours - daily sum| over the
    largest daily sum.  With `outputs`, a function (i, cond) -> array, the
    served arrays are replaced by it (the control)."""
    model, norm = r.config["model"], r.config["data"]["norm_scale"]
    dev = torch.device(r.device)
    err = cons = 0.0
    for i, cond, out in sample:
        if outputs is not None:
            out = outputs(i, cond)
        c = torch.as_tensor(cond, device=dev)
        frac = reference.serve_fractions(
            w, model, latent(i), (c / norm)[..., None], r.cell["ref_block"])
        ref = frac * (c / norm) * norm
        got = torch.as_tensor(np.asarray(out), device=dev)
        err = max(err, ((got - ref).abs().max() / ref.abs().max()).item())
        cons = max(cons, ((got.sum(dim=1) - c).abs().max()
                          / c.abs().max()).item())
        del frac, ref, got
    limits = r.cell["limits"]
    return {"max_err": {"value": err, "limit": limits["max_err"]},
            "conservation": {"value": cons,
                             "limit": r.config["guarantees"]
                             ["conservation_rtol"]}}
