"""The port's protocol data and the paper protocol against the JAX drivers,
on the CPU.

* ``make_scale_dataset`` against ``scripts/full_protocol_scale_run.py``'s,
  bit for bit, in both regimes;
* ``epoch_curve.select_epoch`` against the selection rule of
  ``scripts/paper_protocol.py``, executed from that file's own lines;
* ``protocols.paper --smoke`` twice in one workdir (the second run with
  every battery stage cached and the same values), its summary's keys and
  file names against the JAX driver's summary; ``paper_finish`` and
  ``epoch_curve`` on what it wrote.
"""

import ast
import json
import os
import pathlib
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.core.config import DataConfig  # noqa: E402
from prdisagg_torch.data.synthetic import make_scale_dataset  # noqa: E402
from prdisagg_torch.protocols import epoch_curve  # noqa: E402
from prdisagg_torch.protocols import paper  # noqa: E402
from prdisagg_torch.protocols import paper_finish  # noqa: E402
from prdisagg_tpu.core.config import DataConfig as JaxDataConfig  # noqa: E402
from scripts.full_protocol_scale_run import (  # noqa: E402
    make_scale_dataset as jax_make_scale_dataset,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX driver's summary of a first run (every stage computed)
JAX_SUMMARY = ROOT / "artifacts/paper_protocol_regime_ema2/" \
    "paper_protocol_summary.json"
BATTERY = ("datasets", "eval_phases_1to5", "rainfarm", "crps", "lsd")


@pytest.mark.parametrize("regime", [False, True], ids=["plain", "regime"])
@pytest.mark.parametrize("nd,size,n_days", [(16, 32, 3), (64, 80, 4)],
                         ids=["nd16", "nd64"])
def test_make_scale_dataset_matches_jax(regime, nd, size, n_days):
    kw = dict(ndomain=nd, n_thresh=40 if nd == 64 else 20)
    got, got_idx = make_scale_dataset(n_days, size, size, 5,
                                      DataConfig(**kw), regime=regime)
    want, want_idx = jax_make_scale_dataset(n_days, size, size, 5,
                                            JaxDataConfig(**kw),
                                            regime=regime)
    assert got.dtype == want.dtype == np.float32
    assert got_idx.dtype == want_idx.dtype == np.int32
    assert got.shape == (n_days, 24, size, size)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_idx, want_idx)
    assert len(got_idx) > 0


def _jax_selection_rule():
    """scripts/paper_protocol.py's selection statements, from
    `max_corr = ...` to `peak_key = ...`, as a function of `selectable`."""
    src = (ROOT / "scripts/paper_protocol.py").read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    lines = src.splitlines()
    first = next(n for n in main.body if isinstance(n, ast.Assign)
                 and n.targets[0].id == "max_corr")
    last = next(n for n in main.body if isinstance(n, ast.Assign)
                and n.targets[0].id == "peak_key")
    body = textwrap.dedent("\n".join(
        lines[first.lineno - 1:last.end_lineno]))

    def rule(selectable):
        scope = {"selectable": dict(selectable), "print": lambda *a, **k: 0}
        exec(body, scope)  # noqa: S102 - the reference's own statements
        return scope["peak_key"], scope["max_corr"]
    return rule


def _curves():
    rng = np.random.RandomState(3)
    yield {str(e): {"corr": round(float(c), 4), "crps": round(float(p), 5)}
           for e, (c, p) in enumerate(zip(rng.uniform(0.5, 1.0, 12),
                                          rng.uniform(0.9, 3.0, 12)), 1)}
    # EMA candidates beside the raw exports
    yield {"1": {"corr": 0.99, "crps": 1.2}, "ema:1": {"corr": 0.98,
                                                       "crps": 1.1},
           "2": {"corr": 0.7, "crps": 0.5}, "ema:2": {"corr": 0.95,
                                                      "crps": 1.0}}
    # the gate is inactive: no positive correlation
    yield {"1": {"corr": -0.2, "crps": 2.0}, "2": {"corr": -0.5,
                                                   "crps": 1.5}}
    # ties on the CRPS: the first in order wins in both
    yield {"3": {"corr": 0.9, "crps": 1.0}, "1": {"corr": 0.95, "crps": 1.0},
           "2": {"corr": 0.1, "crps": 0.2}}
    # the artifact of a JAX run of 50 epochs
    yield json.loads(JAX_SUMMARY.read_text())["stages"]["epoch_curve"][
        "curve"]


@pytest.mark.parametrize("case", range(5))
def test_select_epoch_matches_the_jax_rule(case):
    curve = list(_curves())[case]
    key, max_corr, gated = epoch_curve.select_epoch(curve)
    assert (key, max_corr) == _jax_selection_rule()(curve)
    assert gated == (case != 2)


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    """protocols.paper --smoke on the CPU, twice in one workdir (the second
    run reusing the exports), at 4 training and 4 held-out days."""
    wd = str(tmp_path_factory.mktemp("paper") / "run")
    argv = ["--smoke", "--device", "cpu", "--no-plots", "--export-format",
            "npz", "--workdir", wd]
    mp = pytest.MonkeyPatch()
    mp.setattr(paper, "SMOKE_RUN", (4, 4, 2))
    try:
        first = paper.run(paper.parse_args(argv))
        second = paper.run(paper.parse_args(argv + ["--reuse-train"]))
    finally:
        mp.undo()
    return wd, first, second


def test_paper_summary_keys_and_files_match_jax(smoke_runs):
    wd, first, _ = smoke_runs
    want = json.loads(JAX_SUMMARY.read_text())
    on_disk = json.loads((pathlib.Path(wd) / "paper_protocol_summary.json")
                         .read_text())
    assert set(first) == set(want) == {"config", "stages", "verdict"}
    # the JAX flags, and the port's device and artifact flags beside them
    assert set(first["config"]) == set(want["config"]) | {
        "device", "export_format", "no_plots"}
    assert list(first["stages"]) == list(want["stages"])
    for stage, fields in want["stages"].items():
        assert set(first["stages"][stage]) == set(fields) - {"cached"}, stage
    assert set(first["verdict"]) == set(want["verdict"])
    assert set(first["verdict"]["crps"]) == {"gan", "random", "rainfarm"}
    assert set(first["verdict"]["lsd_medians"]) == set(
        want["verdict"]["lsd_medians"])
    data = set(os.listdir(os.path.join(wd, "data")))
    n_crps, n_lsd = paper.SIZES["smoke"][0], paper.SIZES["smoke"][2]
    assert {"generated_samples.npy", "real_samples.npy",
            "rainfarm_calibration_data.npy", "spectral_slopes_0.pkl",
            "spectral_slopes_1.pkl", "rainfarm_fields_for_lsd.npy",
            "crps_results.json", "crps_results_rainfarm.pkl",
            f"crps_results_n_sample{n_crps}.pkl",
            f"log_spectral_distances_summary_n{n_lsd}.json"} <= data
    for k in paper_finish.LABELS:
        assert f"log_spectral_distances_{k}_n{n_lsd}_subsample.npy" in data
    assert os.path.exists(os.path.join(wd, "protocol_state.json"))
    assert os.listdir(os.path.join(wd, "trained_models",
                                   "paper_protocol")) != []
    # the last run's summary is on disk
    assert on_disk["verdict"]["crps"] == first["verdict"]["crps"]


def test_paper_rerun_has_every_stage_cached_with_the_same_values(smoke_runs):
    _, first, second = smoke_runs
    for stage in BATTERY:
        assert second["stages"][stage].get("cached") is True, stage
    assert second["stages"]["train"] == {"seconds": 0.0, "reused": True}
    assert (second["stages"]["epoch_curve"]["curve"]
            == first["stages"]["epoch_curve"]["curve"])
    a, b = dict(first["verdict"]), dict(second["verdict"])
    a.pop("total_wall_clock_minutes")
    b.pop("total_wall_clock_minutes")
    assert a == b
    for stage in ("eval_phases_1to5", "rainfarm"):
        got = {k: v for k, v in second["stages"][stage].items()
               if k not in ("seconds", "cached")}
        want = {k: v for k, v in first["stages"][stage].items()
                if k != "seconds"}
        assert got == want, stage


def test_paper_refuses_a_second_live_run(smoke_runs):
    from prdisagg_torch.utils.watchdog import acquire_workdir_lock

    wd = smoke_runs[0]
    fd = acquire_workdir_lock(wd)
    try:
        with pytest.raises(RuntimeError, match="locked"):
            paper.run(paper.parse_args(["--smoke", "--device", "cpu",
                                        "--workdir", wd]))
    finally:
        os.close(fd)


def test_paper_finish_rebuilds_the_verdict(smoke_runs, tmp_path,
                                           monkeypatch):
    """The port's paper_finish and the JAX scripts/paper_protocol_finish.py
    on two copies of one run's data: the same summary."""
    import shutil
    import sys

    from scripts import paper_protocol_finish as jax_finish

    wd, first, _ = smoke_runs
    ours, theirs = tmp_path / "run", tmp_path / "jax"
    for copy in (ours, theirs):
        shutil.copytree(os.path.join(wd, "data"), copy / "data")
    v = first["verdict"]
    n_lsd = str(paper.SIZES["smoke"][2])
    args = [v["peak_epoch"], str(v["heldout_daily_cycle_corr"]),
            str(v["ks_frac_distinct_p05"]), n_lsd]
    out = paper_finish.run(paper_finish.parse_args([str(ours), *args]))
    monkeypatch.setattr(sys, "argv", ["paper_protocol_finish.py",
                                      str(theirs), *args])
    jax_finish.main()
    got = json.loads((ours / "paper_protocol_summary.json").read_text())
    want = json.loads((theirs / "paper_protocol_summary.json").read_text())
    assert got == want == json.loads(json.dumps(out))
    assert set(got) == {"verdict"}
    assert set(got["verdict"]) == set(v) - {"total_wall_clock_minutes"}
    for k in ("crps", "lsd_medians", "gan_beats_random",
              "lsd_gan_closer_to_obs_than_rainfarm"):
        assert got["verdict"][k] == v[k], k
    for copy in (ours, theirs):
        assert os.path.exists(copy / "plots" / "log_spectral_distances_n"
                              f"{n_lsd}.svg")


def test_epoch_curve_over_the_exports(smoke_runs, capsys, monkeypatch):
    monkeypatch.setattr(epoch_curve, "HELDOUT_DAYS", 3)
    wd, first, _ = smoke_runs
    model_dir = os.path.join(wd, "trained_models", "paper_protocol")
    curve = epoch_curve.run(epoch_curve.parse_args([
        model_dir, "1", "2", "3", "--device", "cpu", "--export-format",
        "npz"]))
    out = capsys.readouterr().out
    assert set(curve) == {"1", "2"}
    assert "epoch  3: no export found" in out
    assert all(-1.0 <= c <= 1.0 for c in curve.values())
    best = max(curve, key=curve.get)
    assert f"best: epoch {best} (corr {curve[best]:.4f})" in out
