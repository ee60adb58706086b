"""Cells, configurations, traffic mixes and metrics are found by name, and
a new one is added as new files and entries alone."""

import json
import pathlib
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.small import copy_bench, edit_json

HERE = pathlib.Path(__file__).resolve().parents[1]


def test_every_cell_and_metric_of_the_benchmark_is_found():
    bench = harness.Bench.load()
    for w in bench.spec["workloads"]:
        cell, config, traffic = bench.cell_files(w["name"])
        assert config["name"] == w["config"]
        assert "limits" in cell
        bench.driver(traffic)
        metrics = bench.end_to_end(w["name"]) + bench.per_layer(w["name"])
        names = {m["name"] for m in metrics}
        assert "setup_s" in names and len(names) >= 3
        for m in metrics:
            assert callable(bench.reader(m["name"]).read)


def test_unknown_names_are_refused():
    bench = harness.Bench.load()
    with pytest.raises(harness.NotFound):
        bench.workload("flagship16.no_such_mix")
    with pytest.raises(harness.NotFound):
        bench.reader("no_such_metric")
    with pytest.raises(harness.NotFound):
        bench.driver({"driver": "no_such_driver"})


def test_a_cell_and_a_metric_are_added_as_new_files(tmp_path):
    root = copy_bench(tmp_path)
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}
    (root / "traffic" / "serve_f32_small.json").write_text(json.dumps(
        dict(json.loads((root / "traffic" / "serve_f32.json").read_text()),
             n_scenarios=100)))
    (root / "workloads" / "flagship16.serve_f32_small.json").write_text(
        (root / "workloads" / "flagship16.serve_f32.json").read_text())
    (root / "metrics" / "requests_per_s.py").write_text(
        "def read(facts):\n"
        "    return facts['units'] / facts['window_s']\n")

    def add(spec):
        spec["workloads"].append({
            "name": "flagship16.serve_f32_small", "config": "flagship16",
            "traffic": "serve_f32_small", "chips": 1, "why": "small"})
        spec["end_to_end"].append({
            "name": "requests_per_s", "unit": "requests/s",
            "better": "higher", "bound": 0.05, "source": "host_clock",
            "workloads": ["flagship16.serve_f32_small"]})

    edit_json(tmp_path / "BENCHMARK.json", add)
    bench = harness.Bench.load(tmp_path / "BENCHMARK.json", root)
    cell, config, traffic = bench.cell_files("flagship16.serve_f32_small")
    assert traffic["n_scenarios"] == 100 and config["name"] == "flagship16"
    names = [m["name"] for m in bench.end_to_end("flagship16.serve_f32_small")]
    assert "requests_per_s" in names and "setup_s" in names
    assert bench.reader("requests_per_s").read(
        {"units": 10, "window_s": 2.0}) == 5.0
    # the per-layer metrics that list their cells do not take it in
    assert bench.per_layer("flagship16.serve_f32_small") == []
    after = {p.relative_to(root): p.read_bytes()
             for p in root.rglob("*") if p.is_file()
             and p.relative_to(root) in before}
    assert after == before


def test_the_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "flagship16.serve_f32", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=HERE.parent, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_nearest_rank_p95():
    read = harness.Bench.load().reader("request_p95_ms").read
    assert read({"latencies_ms": list(range(1, 101))}) == 95
    assert read({"latencies_ms": list(range(1, 21))}) == 19
    assert read({"latencies_ms": []}) is None
