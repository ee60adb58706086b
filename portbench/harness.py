"""The harness: finds a cell and everything it names by name, runs the
cell's driver and reduces what the driver measured to the result line.

Every part of a cell is a file of its own, found by name, so that a later
change adds a configuration, a traffic mix, a cell or a metric as new files
and new entries in ``BENCHMARK.json`` and edits none:

* ``BENCHMARK.json`` (the checkout's root): the cell's entry, its
  configuration's entry and the metrics;
* ``workloads/<cell>.json``: the cell's own parameters (the size of the
  traced slice, the outputs the check compares, and each compared number's
  limit);
* the configuration's ``file``: the model, data, training and serving
  sizes, as run;
* ``traffic/<traffic>.json``: the mix, which names its driver;
* ``drivers/<driver>.py``: ``run(Run) -> dict`` of what the run measured,
  its facts: the device's (``platform``, ``kind``, ``count``,
  ``memory_peak_bytes``, ``power_limit_w``), ``setup_s``, ``window_s``,
  ``units`` (requests or steps in the window), ``attempted``, ``failed``,
  ``checks`` ({name: {value, limit}}), ``kind_of_cell``,
  ``flops_per_unit`` and ``peak_flops``, the traced slice ``trace``
  (portbench/trace.py, or None), ``k1`` ([(bound ms, device ms)] of K1's
  calls), and a serving driver's ``scenarios`` and ``latencies_ms``;
* ``metrics/<metric>.py``: ``read(facts) -> float | None``, one reader a
  metric, end-to-end and per-layer alike.

A name that is not found raises; a reader that finds nothing to read
returns None and its metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "prdisagg_tpu")


class NotFound(LookupError):
    pass


def _json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise NotFound(f"{path} not found")
    return json.loads(path.read_text())


_MODULES: dict = {}


def _module(path: pathlib.Path, what: str):
    """The module of a driver or reader file, loaded once a process."""
    if path in _MODULES:
        return _MODULES[path]
    if not path.is_file():
        raise NotFound(f"no {what} at {path}")
    name = "portbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _MODULES[path] = mod
    return mod


def mix(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = seed % (1 << 64)
    for t in tags:
        h = (h * 0x100000001B3 ^ (t + 0x9E3779B97F4A7C15)) % (1 << 64)
    return h % (1 << 63)


@dataclasses.dataclass
class Run:
    """One run of one cell, as the driver sees it."""

    name: str
    seed: int
    seconds: float
    trace: bool
    device: str
    cell: dict          # workloads/<cell>.json
    config: dict        # the configuration's file
    traffic: dict       # traffic/<traffic>.json
    t_start: float      # the process's start, perf_counter seconds


@dataclasses.dataclass
class Bench:
    spec: dict
    root: pathlib.Path = HERE

    @classmethod
    def load(cls, path: Optional[pathlib.Path] = None,
             root: pathlib.Path = HERE) -> "Bench":
        return cls(_json(path or root.parent / "BENCHMARK.json"), root)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise NotFound(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return c
        raise NotFound(f"no configuration {name!r} in BENCHMARK.json")

    def cell_files(self, name: str):
        """(cell, configuration, traffic) dicts of the workload `name`."""
        w = self.workload(name)
        cell = _json(self.root / "workloads" / f"{name}.json")
        config = _json(self.root.parent / self.config_entry(w["config"])["file"])
        traffic = _json(self.root / "traffic" / f"{w['traffic']}.json")
        return cell, config, traffic

    def driver(self, traffic: dict):
        return _module(self.root / "drivers" / f"{traffic['driver']}.py",
                       "driver")

    def end_to_end(self, name: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if name in m.get("workloads", [name])]

    def per_layer(self, name: str) -> list:
        moves = {m["name"] for m in self.end_to_end(name)}
        return [m for m in self.spec["per_layer"]
                if (name in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]

    def reader(self, metric: str):
        return _module(self.root / "metrics" / f"{metric}.py", "reader")


def read_metrics(bench: Bench, metrics: list, facts: dict) -> dict:
    out = {}
    for m in metrics:
        value = bench.reader(m["name"]).read(facts)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def checks_ok(checks: dict) -> bool:
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())


def result(bench: Bench, run: Run, facts: dict) -> dict:
    """The result line's object; `checks` comes last."""
    metrics = (bench.per_layer(run.name) if run.trace
               else bench.end_to_end(run.name))
    dev = {"platform": facts["platform"], "kind": facts["kind"],
           "count": facts["count"],
           "memory_peak_bytes": facts["memory_peak_bytes"]}
    tr = facts.get("trace")
    if run.trace and tr is not None:
        dev["busy_s"] = tr.busy_us / 1e6
        dev["window_s"] = tr.window_us / 1e6
    if "power_limit_w" in facts:
        dev["power_limit_w"] = facts["power_limit_w"]
    out = {"correct": checks_ok(facts["checks"]),
           "attempted": facts["attempted"], "failed": facts["failed"],
           "metrics": read_metrics(bench, metrics, facts), "device": dev}
    if run.trace and tr is not None:
        from portbench.trace import breakdown

        out["breakdown"] = breakdown(tr)
    out["checks"] = facts["checks"]
    return out
