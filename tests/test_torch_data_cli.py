"""The port's data subcommands against the JAX package's on one raw corpus,
on the CPU: ``convert-tiffs``, ``reformat-nc`` and ``compute-indices`` in
both packages give equal .nc arrays, tensors, doy sidecars and index
pickles, and the port's ``train --conditioning doy`` runs on them.  Also
the two places where the port departs from the JAX package on purpose
(SMHI file names, no TIFF reader) and the six subcommands' flags.
"""

import argparse
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from PIL import Image  # noqa: E402

from prdisagg_torch import cli as tcli  # noqa: E402
from prdisagg_torch.data.ingest import (  # noqa: E402
    convert_day,
    reflectivity_to_mm_per_5min,
)
from prdisagg_torch.data.netcdf_io import read_day_nc  # noqa: E402
from prdisagg_tpu import cli as jcli  # noqa: E402
from prdisagg_tpu.data.netcdf_io import read_day_nc as j_read_day_nc  # noqa: E402

DATES = ["20090101", "20090102", "20090103"]
SIZE = 48
# thresholds low enough that the small corpus has valid boxes
THRESH = ["--tp-thresh-daily", "2.0", "--n-thresh", "10"]


def raw_corpus(n_days: int, size: int, seed: int) -> np.ndarray:
    """(days, 288, size, size) uint8 SMHI bytes: two drifting rain blobs
    with an afternoon peak, noise, and a missing (255) border row."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    hours = np.arange(288, dtype=np.float32) / 12.0
    envelope = 0.35 + 0.65 * np.exp(-((hours - 15.0) ** 2) / 18.0)
    out = np.empty((n_days, 288, size, size), np.uint8)
    for d in range(n_days):
        dbz = rng.randn(288, size, size).astype(np.float32) * 1.5
        for _ in range(2):
            path = (rng.rand(2) * size + np.cumsum(
                rng.randn(288, 2) * 0.8, axis=0)) % size
            d2 = (((yy - path[:, :1, None]) % size) ** 2
                  + ((xx - path[:, 1:, None]) % size) ** 2)
            dbz += 45.0 * envelope[:, None, None] * np.exp(
                -d2 / (2 * (size / 6) ** 2))
        raw = np.clip((dbz + 30.0) / 0.4, 0, 254).astype(np.uint8)
        raw[:, :1, :] = 255
        out[d] = raw
    return out


def write_tiffs(raw, root, dates, flat=False):
    for date, day in zip(dates, raw):
        ddir = root if flat else os.path.join(root, date)
        os.makedirs(ddir, exist_ok=True)
        for step, frame in enumerate(day):
            hh, mm = divmod(5 * step, 60)
            name = (f"radar_{date[2:]}{hh:02d}{mm:02d}.tif" if flat
                    else f"radar_{date}_{step:03d}.tif")
            Image.fromarray(frame, mode="L").save(os.path.join(ddir, name))


def _jax(argv):
    """A JAX CLI command in process, without main's compile-cache setup."""
    args = jcli.build_parser().parse_args(argv)
    args.fn(args)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The raw corpus as day-directory TIFFs, run through both packages'
    convert-tiffs, reformat-nc and compute-indices."""
    root = tmp_path_factory.mktemp("chain")
    raw = raw_corpus(len(DATES), SIZE, seed=0)
    tiffs = str(root / "tiffs")
    write_tiffs(raw, tiffs, DATES)
    out = {"raw": raw}
    for pkg, run in (("torch", tcli.main), ("jax", _jax)):
        d = root / pkg
        run(["convert-tiffs", "--tiff-dir", tiffs, "--out-dir",
             str(d / "nc")])
        run(["reformat-nc", "--nc-dir", str(d / "nc"), "--out",
             str(d / "tensor")])
        extra = ["--device", "cpu"] if pkg == "torch" else []
        run(["compute-indices", "--data", str(d / "tensor.npy"), "--out",
             str(d / "idx.pkl"), *THRESH, *extra])
        out[pkg] = d
    return out


def test_convert_tiffs_nc_files_equal_jax(chain):
    names = sorted(os.listdir(chain["torch"] / "nc"))
    assert names == [f"smhi_radar_{d}.nc" for d in DATES]
    assert names == sorted(os.listdir(chain["jax"] / "nc"))
    for name in names:
        mine = read_day_nc(str(chain["torch"] / "nc" / name))
        np.testing.assert_array_equal(
            mine, j_read_day_nc(str(chain["jax"] / "nc" / name)))
        assert mine.shape == (288, SIZE, SIZE)


def test_reformat_nc_tensor_and_doy_equal_jax(chain):
    t, j = chain["torch"], chain["jax"]
    tensor = np.load(t / "tensor.npy")
    np.testing.assert_array_equal(tensor, np.load(j / "tensor.npy"))
    np.testing.assert_array_equal(np.load(t / "tensor.npz")["data"], tensor)
    np.testing.assert_array_equal(
        tensor, np.stack([convert_day(d) for d in chain["raw"]]))
    doy = np.load(t / "tensor_doy.npy")
    np.testing.assert_array_equal(doy, np.load(j / "tensor_doy.npy"))
    np.testing.assert_array_equal(doy, np.array([1, 2, 3], np.float32))


def test_compute_indices_pickle_equals_jax(chain):
    with open(chain["torch"] / "idx.pkl", "rb") as f:
        mine = pickle.load(f)
    with open(chain["jax"] / "idx.pkl", "rb") as f:
        theirs = pickle.load(f)
    assert len(mine) > 0
    assert [tuple(map(int, r)) for r in mine] == \
        [tuple(map(int, r)) for r in theirs]
    # --include-last-box in both
    out = {}
    for pkg, run in (("torch", tcli.main), ("jax", _jax)):
        d = chain[pkg]
        extra = ["--device", "cpu"] if pkg == "torch" else []
        run(["compute-indices", "--data", str(d / "tensor.npy"), "--out",
             str(d / "idx_last.pkl"), "--include-last-box", *THRESH, *extra])
        with open(d / "idx_last.pkl", "rb") as f:
            out[pkg] = [tuple(map(int, r)) for r in pickle.load(f)]
    assert out["torch"] == out["jax"] and len(out["torch"]) > len(mine)


def test_train_doy_on_the_pipeline_files(chain, tmp_path, capsys):
    d = chain["torch"]
    tcli.main(["train", "--device", "cpu", "--model-preset", "tiny",
               "--conditioning", "doy", "--data", str(d / "tensor.npy"),
               "--indices", str(d / "idx.pkl"), "--doy",
               str(d / "tensor_doy.npy"), *THRESH, "--epochs", "1",
               "--steps-per-epoch", "2", "--batch-size", "4", "--n-disc", "1",
               "--export-format", "npz", "--plot-every-epochs", "0",
               "--workdir", str(tmp_path)])
    assert "finished at epoch 1" in capsys.readouterr().out
    gens = [f for f in os.listdir(tmp_path / "trained_models"
                                  / "wgancp_pixelnorm")
            if f.startswith("gen_")]
    assert len(gens) == 1 and gens[0].endswith("_0001.npz")


def test_flat_smhi_names_group_by_day(tmp_path, capsys):
    """radar_YYMMDDHHMM.tif: the port groups 2 days of 288 files into 2
    days.  The JAX package takes the first 8 digits, YYMMDDHH, as the date:
    48 groups of 12 files with false dates (ADVICE.md, JAX cli.py:205)."""
    raw = raw_corpus(2, 16, seed=1)
    flat = str(tmp_path / "flat")
    write_tiffs(raw, flat, DATES[:2], flat=True)
    days = tcli.tiff_days(flat)
    assert list(days) == DATES[:2]
    assert [len(p) for p in days.values()] == [288, 288]
    tcli.main(["convert-tiffs", "--tiff-dir", flat, "--out-dir",
               str(tmp_path / "t")])
    assert sorted(os.listdir(tmp_path / "t")) == \
        [f"smhi_radar_{d}.nc" for d in DATES[:2]]
    np.testing.assert_array_equal(
        read_day_nc(str(tmp_path / "t" / "smhi_radar_20090102.nc")),
        reflectivity_to_mm_per_5min(raw[1]))
    capsys.readouterr()
    _jax(["convert-tiffs", "--tiff-dir", flat, "--out-dir",
          str(tmp_path / "j")])
    jax_files = sorted(os.listdir(tmp_path / "j"))
    assert len(jax_files) == 48
    assert jax_files[0] == "smhi_radar_09010100.nc"
    assert read_day_nc(str(tmp_path / "j" / jax_files[0])).shape[0] == 12


def test_convert_tiffs_refuses_without_a_reader(chain, tmp_path, capsys,
                                                monkeypatch):
    """The port exits non-zero before any work, naming both packages; the
    JAX package fails every day and exits 0 ("converted 0/N days")."""
    real = importlib.util.find_spec
    monkeypatch.setattr(
        tcli.importlib.util, "find_spec",
        lambda name, *a: None if name in ("rasterio", "PIL") else real(name,
                                                                      *a))
    tiffs = str(chain["torch"].parent / "tiffs")
    with pytest.raises(SystemExit) as err:
        tcli.main(["convert-tiffs", "--tiff-dir", tiffs, "--out-dir",
                   str(tmp_path / "t")])
    assert err.value.code not in (0, None)
    assert "rasterio" in str(err.value) and "Pillow" in str(err.value)
    assert not os.path.exists(tmp_path / "t")
    monkeypatch.setitem(sys.modules, "rasterio", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    _jax(["convert-tiffs", "--tiff-dir", tiffs, "--out-dir",
          str(tmp_path / "j")])
    assert f"converted 0/{len(DATES)} days" in capsys.readouterr().out


def test_download_cli_collects_failures(tmp_path, monkeypatch, capsys):
    import urllib.request

    def refuse(url, dest):
        raise OSError("no network in this test")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    tcli.main(["download", "--start", "20090101", "--end", "20090102",
               "--out", str(tmp_path)])
    assert "failed dates: ['20090101', '20090102']" in capsys.readouterr().out
    assert os.listdir(tmp_path) == []


def _subparser(parser, name):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[name]


@pytest.mark.parametrize("name", ["convert-tiffs", "reformat-nc",
                                  "compute-indices", "download", "doctor",
                                  "supervise"])
def test_data_and_ops_subcommands_take_the_jax_flags(name):
    """The JAX package's flags and defaults, plus --device (default cuda)
    on compute-indices, the one that computes on a device."""
    mine = {a.dest: a for a in _subparser(tcli.build_parser(), name)._actions}
    theirs = {a.dest: a for a in _subparser(jcli.build_parser(),
                                            name)._actions}
    device = mine.pop("device", None)
    if name == "compute-indices":
        assert device.default == "cuda"
    else:
        assert device is None
    assert set(mine) == set(theirs)
    for dest, action in mine.items():
        assert action.option_strings == theirs[dest].option_strings, dest
        assert action.default == theirs[dest].default, dest
        assert action.choices == theirs[dest].choices, dest
        assert action.nargs == theirs[dest].nargs, dest
