"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The run makes its weights and data on the
card from the seed, warms up (counted as set-up), measures the cell's
timed path for `--seconds`, checks what that path produced against the
plain reference (``portbench/reference.py``), and prints one JSON line
last: its end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1`` (a traced slice after the window).  Each compared number
is printed with its limit as the last lines on standard error and under
``checks``, last in the line.

It exits non-zero and prints no result when there is no CUDA device, when
a name is not found, or when JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, device: str = "cuda", bench=None) -> dict:
    """The result object of one run; `device` and `bench` let a test drive
    a run on the CPU on a benchmark of its own."""
    bench = bench or harness.Bench.load()
    bench.workload(args.workload)
    cell, config, traffic = bench.cell_files(args.workload)
    r = harness.Run(name=args.workload, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=device, cell=cell,
                    config=config, traffic=traffic, t_start=T_START)
    facts = bench.driver(traffic).run(r)
    return harness.result(bench, r, facts)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    bench = harness.Bench.load()
    need = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run(args, "cuda", bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
