"""A copy of the benchmark at a size the CPU runs in seconds: the cells'
files as they are, the configurations cut to widths of 8 and small data,
the traffic to small batches.  Only the copy is changed."""

import json
import pathlib
import shutil

from portbench import harness

HERE = pathlib.Path(__file__).resolve().parents[1]


def copy_bench(dest: pathlib.Path) -> pathlib.Path:
    """portbench/ and BENCHMARK.json copied under `dest`; returns the copy
    of portbench/."""
    shutil.copytree(HERE, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest / "portbench"


def edit_json(path: pathlib.Path, fn) -> None:
    d = json.loads(path.read_text())
    fn(d)
    path.write_text(json.dumps(d))


def list_waiting_cells(bench_json: pathlib.Path, root: pathlib.Path) -> None:
    """Entries in the copy's BENCHMARK.json for the cell files that the
    benchmark does not list yet (the training cells, whose check waits for
    a number that a lower precision fails: PERF.md, section 7), named
    ``<config>.<traffic>``."""
    def add(spec):
        listed = {w["name"] for w in spec["workloads"]}
        for f in sorted((root / "workloads").glob("*.json")):
            if f.stem not in listed:
                config, traffic = f.stem.split(".", 1)
                spec["workloads"].append({
                    "name": f.stem, "config": config, "traffic": traffic,
                    "chips": 1, "why": "not yet in the benchmark"})

    edit_json(bench_json, add)


def small_bench(dest: pathlib.Path, widths: bool = True,
                f32: bool = False) -> harness.Bench:
    """With `f32`, the training traffic runs the program in float32, where
    it is the reference's computation up to rounding."""
    root = copy_bench(dest)
    list_waiting_cells(dest / "BENCHMARK.json", root)

    def config(c):
        if widths:
            c["model"].update(latent_dim=8, gen_channels=[8, 8, 8],
                              base_channels=8, critic_channels=[8, 8, 8, 8])
        c["dataset_days"], c["dataset_grid"] = 8, [96, 96]

    def traffic(t):
        if t["driver"] == "serve":
            t.update(n_scenarios=16, pool_days=2, pool_maps=8)
        else:
            t.update(batch_size=4)
            if f32:
                t.update(compute_dtype="float32")

    for f in (root / "configs").glob("*.json"):
        edit_json(f, config)
    for f in (root / "traffic").glob("*.json"):
        edit_json(f, traffic)
    return harness.Bench.load(dest / "BENCHMARK.json", root)
