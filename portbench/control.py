"""The controls of the output check: the plain reference put in the
program's place, one precision below the configuration's (float32 cells:
TF32, bfloat16 cells: fp8), judged by the cell's own check at the cell's
own sizes.  Their readings are the upper ends the limits were set from
(``PERF.md``); the benchmark's own runs never run them.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed with the compared numbers.  A float32 cell's
control serves the requests a run would check (the first
``check_requests``); a bfloat16 cell's follows the checked steps.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import harness, reference  # noqa: E402

LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def readings(bench: harness.Bench, name: str, seed: int,
             device: str = "cuda") -> dict:
    cell, config, traffic = bench.cell_files(name)
    r = harness.Run(name=name, seed=seed, seconds=0.0, trace=False,
                    device=device, cell=cell, config=config, traffic=traffic,
                    t_start=time.perf_counter())
    prec = LOWER[traffic["compute_dtype"]]
    drv = bench.driver(traffic)
    if traffic["driver"] == "serve":
        return serve_readings(drv, r, prec)
    data, rows = drv.setup_data(r)
    w = reference.make_weights(config["model"], harness.mix(seed, 3),
                               torch.device(device))
    draw_seed = harness.mix(seed, 4)
    warm = drv.moments(r, w, data, rows)
    got = drv.follow(r, w, data, rows, draw_seed, warm, prec)
    return drv.gaps(got, drv.follow(r, w, data, rows, draw_seed, warm))


def serve_readings(drv, r: harness.Run, prec: str) -> dict:
    model, norm = r.config["model"], r.config["data"]["norm_scale"]
    n = r.traffic["n_scenarios"]
    dev = torch.device(r.device)
    w = reference.make_weights(model, harness.mix(r.seed, 3), dev)
    maps = drv.pool_maps(r, model, r.config["data"], r.traffic)
    g = torch.Generator(device=dev)

    def latent(i):
        g.manual_seed(harness.mix(r.seed, 5, i))
        return torch.randn((n, model["latent_dim"]), generator=g, device=dev)

    def outputs(i, cond):
        c = torch.as_tensor(cond, device=dev)
        frac = reference.serve_fractions(w, model, latent(i),
                                         (c / norm)[..., None],
                                         r.cell["ref_block"], prec)
        return (frac * (c / norm) * norm).cpu().numpy()

    sample = [(i, maps[i % len(maps)], None)
              for i in range(r.cell["check_requests"])]
    checks = drv.check(r, w, sample, latent, outputs)
    return {k: v["value"] for k, v in checks.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = harness.Bench.load()
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(bench, args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": LOWER[bench.cell_files(args.workload)[2]
                                           ["compute_dtype"]],
                          "readings": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
