"""The port's variant drivers and the L1 rehearsal on the CPU, against the
JAX drivers' outputs: ``protocols.large_domain`` (64x64) and
``protocols.variants`` (doy, lon) at the smoke architecture, their summary
lines against the JAX drivers' committed ones (artifacts/*_tpu.txt), and
``protocols.l1_rehearsal``'s CLI chain against the JAX rehearsal's on the
same days (its raw corpus, and the files of its convert-tiffs, reformat-nc
and compute-indices stages), its parity stage against the JAX
``parity_report`` on the same directories, and its summary's keys against
the JAX driver's.
"""

import importlib.util
import json
import os
import pathlib
import pickle
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.protocols import l1_rehearsal  # noqa: E402
from prdisagg_torch.protocols import large_domain  # noqa: E402
from prdisagg_torch.protocols import variants  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tag(line: str) -> str:
    return line.split("]", 1)[0] + "]"


def _words(line: str) -> list:
    """A summary line's words without numbers, parentheses or an export's
    extension."""
    line = re.sub(r"\(.*?\)", "", line)
    return [w for w in re.sub(r"\.(h5|npz)\b", "", line).split()
            if not re.search(r"\d", w)]


def test_large_domain_trains_and_evaluates_the_export(tmp_path, monkeypatch):
    monkeypatch.setattr(large_domain, "N_MAP_CONDITIONS", 1)
    monkeypatch.setattr(large_domain, "N_STAT_SAMPLES", 24)
    monkeypatch.setattr(large_domain, "HELDOUT_DAYS", 1)
    wd = tmp_path / "ld"
    r = large_domain.run(large_domain.parse_args([
        "1", "2", "8", "--device", "cpu", "--model-preset", "tiny",
        "--export-format", "npz", "--no-plots", "--workdir", str(wd)]))
    want = (ROOT / "artifacts/large_domain_tpu.txt").read_text().splitlines()
    assert [_tag(s) for s in r["lines"]] == [_tag(s) for s in want] == [
        "[data]", "[train]", "[eval]", "[artifacts]"]
    assert re.fullmatch(r"\[data\] \d+ train / \d+ held-out 64x64 patches "
                        r"\(n_thresh=40\)", r["lines"][0])
    assert "2x2@b8 steps" in r["lines"][1] and r["steps"] == 4
    for phrase in ("held-out daily-cycle corr", "max rel conservation err"):
        assert phrase in r["lines"][2]
    assert r["conservation"] <= 1e-5
    assert r["export"].endswith("_0002.npz")
    assert "magma_r, 15 fakes/real" in r["lines"][3]
    written = (wd / "large_domain_b8c1.txt").read_text().splitlines()
    assert written == r["lines"]


def test_large_domain_refuses_without_h5py(monkeypatch, tmp_path):
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py"
                        else find(name, *a))
    with pytest.raises(SystemExit, match="--export-format npz"):
        large_domain.main(["1", "2", "--device", "cpu", "--no-plots",
                           "--workdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_variants_train_evaluate_and_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(variants, "N_STAT_SAMPLES", 50)
    monkeypatch.setattr(variants, "HELDOUT_DAYS", 2)
    wd = tmp_path / "var"
    out = variants.run(variants.parse_args([
        "2", "2", "--device", "cpu", "--model-preset", "tiny",
        "--export-format", "npz", "--workdir", str(wd)]))
    lines = (wd / "variants.txt").read_text().splitlines()
    want = (ROOT / "artifacts/variants_tpu.txt").read_text().splitlines()
    assert [_tag(s) for s in lines] == [_tag(s) for s in want]
    for got, ref in zip(lines, want):
        # the same statement, numbers aside; the export's format and the
        # card are the port's words
        assert _words(got) == _words(ref.replace(" on chip", "")), (got, ref)
    for variant in ("doy", "lon"):
        r = out[variant]
        assert r["conservation"] <= 1e-5
        assert r["round_trip_max_abs"] == 0.0 and r["round_trip_max"] > 0
        assert r["export"].endswith("_0002.npz")
        assert (wd / f"variant_{variant}" / "data"
                / "generated_samples.npy").exists()


def _reference_like_dir(path, seed):
    """Figure files in the layout parity-report reads: per-epoch KS
    p-values and per-hour fraction tables."""
    import pandas as pd

    rng = np.random.RandomState(seed)
    os.makedirs(path)
    for i in range(3):
        np.savetxt(os.path.join(
            path, f"check_conditional_dist_samenoise_KSpvalx_{i:04d}.txt"),
            rng.rand(24))
        frames = [pd.DataFrame({"fraction": rng.rand(20) / 24 * (1 + h / 48),
                                "cond": c, "hour": h + 1})
                  for h in range(24) for c in (1, 2)]
        pd.concat(frames).to_csv(os.path.join(
            path, f"check_conditional_dist_samenoise_x_{i:04d}.csv"))
    return str(path)


def _jax_data_stages(jwd, dates):
    """The JAX rehearsal's corpus and its convert-tiffs, reformat-nc and
    compute-indices stages (the JAX CLI in process, in `jwd`, where the
    contract's file names resolve)."""
    from prdisagg_tpu import cli as jcli
    from scripts import l1_rehearsal as jax_l1

    n = jax_l1.write_raw_corpus(str(jwd / "raw_tiffs"), dates, 48)
    span = ["--startdate", dates[0], "--enddate", dates[-1]]
    tensor = f"{dates[0]}-{dates[-1]}_tres1.npy"
    for argv in (["convert-tiffs", "--tiff-dir", "raw_tiffs", "--out-dir",
                  "netcdf"],
                 ["reformat-nc", "--nc-dir", "netcdf", *span],
                 ["compute-indices", "--data", tensor, *span]):
        args = jcli.build_parser().parse_args(argv)
        args.fn(args)
    return n


def test_l1_rehearsal_runs_the_cli_chain(tmp_path, monkeypatch):
    from prdisagg_tpu.eval import parity as jparity

    wd, jwd = tmp_path / "l1", tmp_path / "jax"
    ref = _reference_like_dir(tmp_path / "ref", 2)
    s = l1_rehearsal.run(l1_rehearsal.parse_args([
        str(wd), "--days", "3", "--steps-per-epoch", "4", "--device", "cpu",
        "--reference", ref]))
    # the keys the JAX driver writes, in its order
    src = (ROOT / "scripts/l1_rehearsal.py").read_text()
    keys = list(dict.fromkeys(re.findall(r'summary\["(\w+)"\] =', src)))
    assert list(s) == ["workdir", "dates"] + keys
    assert json.loads((wd / "l1_rehearsal_summary.json").read_text()) == s
    assert s["ok"] is True
    assert s["dates"] == ["20090101", "20090103"]

    # the deterministic stages against the JAX rehearsal's on the same days
    jwd.mkdir()
    monkeypatch.chdir(jwd)
    dates = ["20090101", "20090102", "20090103"]
    assert _jax_data_stages(jwd, dates) == s["raw_files"] == 3 * 288
    for date in dates:
        names = sorted(os.listdir(wd / "raw_tiffs" / date))
        assert names == sorted(os.listdir(jwd / "raw_tiffs" / date))
        for name in names:
            assert ((wd / "raw_tiffs" / date / name).read_bytes()
                    == (jwd / "raw_tiffs" / date / name).read_bytes())
    assert s["nc_files"] == sorted(os.listdir(jwd / "netcdf")) == [
        f"smhi_radar_{d}.nc" for d in dates]
    tensor = np.load(wd / s["tensor"])
    np.testing.assert_array_equal(tensor, np.load(jwd / s["tensor"]))
    assert s["tensor_shape"] == list(tensor.shape) == [3, 24, 48, 48]
    np.testing.assert_array_equal(np.load(wd / s["doy_sidecar"]),
                                  np.load(jwd / s["doy_sidecar"]))
    assert os.listdir(jwd / "data") == [s["indices"]]
    with open(wd / "data" / s["indices"], "rb") as f:
        mine = [tuple(map(int, r)) for r in pickle.load(f)]
    with open(jwd / "data" / s["indices"], "rb") as f:
        theirs = [tuple(map(int, r)) for r in pickle.load(f)]
    assert mine == theirs and s["n_valid_samples"] == len(mine) > 0
    assert s["weights"] == ("gen_20090101-20090103-tp_thresh_daily5_n_thresh20"
                            "_ndomain16_stride16_0001.h5")
    assert s["eval_plots"] > 0

    # the parity stage against the JAX report on the same directories
    want = jparity.parity_report(
        str(wd / "eval" / "plots_generated_wgancp_pixelnorm"), ref,
        out_path=str(tmp_path / "parity_jax.json"))
    assert s["parity_report"] == {
        "passes": want["passes"],
        "ks_p_match": want["ks_population"]["p_match"],
        "cycle_correlation": want["daily_cycle"]["correlation"]}
    committed = json.loads((ROOT / "artifacts/l1_rehearsal/"
                            "l1_rehearsal_summary.json").read_text())
    assert set(s["parity_report"]) == set(committed["parity_report"])
