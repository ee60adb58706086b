"""The port's offline data pipeline against the JAX package's, on the CPU:
prdisagg_torch/data/ingest.py, netcdf_io.py, download.py, the day-streamed
scan (data/indices.py) and data/native.py, and the files both packages
share (utils/stagecache.py), with utils/profiling.py.

The file stages keep the JAX package's numpy arithmetic, so every array and
file is compared bit for bit.
"""

import datetime
import os
import shutil
import sys
import zipfile

import h5py
import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.core.config import DataConfig as TDataConfig  # noqa: E402
from prdisagg_torch.data import download as tdl  # noqa: E402
from prdisagg_torch.data import indices as tidx  # noqa: E402
from prdisagg_torch.data import ingest as ting  # noqa: E402
from prdisagg_torch.data import native as tnat  # noqa: E402
from prdisagg_torch.data import netcdf_io as tnc  # noqa: E402
from prdisagg_torch.utils import profiling as tprof  # noqa: E402
from prdisagg_torch.utils.stagecache import StageCache as TCache  # noqa: E402
from prdisagg_tpu.core.config import DataConfig as JDataConfig  # noqa: E402
from prdisagg_tpu.data import download as jdl  # noqa: E402
from prdisagg_tpu.data import indices as jidx  # noqa: E402
from prdisagg_tpu.data import ingest as jing  # noqa: E402
from prdisagg_tpu.data import native as jnat  # noqa: E402
from prdisagg_tpu.data import netcdf_io as jnc  # noqa: E402
from prdisagg_tpu.utils.stagecache import StageCache as JCache  # noqa: E402


def _raw_day(seed, ny=12, nx=10):
    """One day of raw bytes: every value 0-255 occurs, 255 = missing."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(288, ny, nx)).astype(np.uint8)


def _mm5(seed, ny=12, nx=10):
    rng = np.random.RandomState(seed)
    return rng.gamma(0.3, 0.4, size=(288, ny, nx)).astype(np.float32)


# --------------------------------------------------------------------------
# conversion and dates
# --------------------------------------------------------------------------

def test_every_byte_converts_as_jax_does():
    raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = ting.reflectivity_to_mm_per_5min(raw)
    want = jing.reflectivity_to_mm_per_5min(raw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # NaN where JAX has NaN
    assert np.isnan(got.reshape(-1)[255]) and np.isfinite(got[:-1]).all()


def test_aggregate_propagates_nan_as_jax_does():
    mm5 = _mm5(0, 4, 5)
    mm5[13, 1, 2] = np.nan  # poisons hour 1 only
    got = ting.aggregate_to_tres(mm5, 1)
    np.testing.assert_array_equal(got, jing.aggregate_to_tres(mm5, 1))
    assert np.isnan(got[1, 1, 2]) and np.isnan(got).sum() == 1
    np.testing.assert_array_equal(ting.aggregate_to_tres(mm5, 3),
                                  jing.aggregate_to_tres(mm5, 3))
    with pytest.raises(ValueError):
        ting.aggregate_to_tres(mm5[:100])


def test_convert_day_and_reformat_stream_match_jax():
    days = [_raw_day(s) for s in range(3)]
    for tres in (1, 2):
        got = [ting.convert_day(d, tres) for d in days]
        want = [jing.convert_day(d, tres) for d in days]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        out = ting.reformat_stream(iter(got), 3, (12, 10), tres=tres)
        np.testing.assert_array_equal(
            out, jing.reformat_stream(iter(want), 3, (12, 10), tres=tres))
        hourly = np.concatenate(got)
        np.testing.assert_array_equal(ting.reshape_to_days(hourly, tres),
                                      jing.reshape_to_days(hourly, tres))
    with pytest.raises(ValueError, match="expected 3 days"):
        ting.reformat_stream(iter(got[:2]), 3, (12, 10), tres=2)


def test_day_of_year_and_urls_match_jax_across_leap_day_and_year_end():
    dates = [d.strftime("%Y%m%d")
             for d in pd.date_range("20120227", "20130102")]
    got = ting.day_of_year(dates)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jing.day_of_year(dates))
    iso = [datetime.date(2012, 2, 29), "2012-12-31"]
    np.testing.assert_array_equal(ting.day_of_year(iso), [60.0, 366.0])
    assert tdl.day_urls("20120227", "20130102") == \
        jdl.day_urls("20120227", "20130102")


def test_save_training_tensor_files(tmp_path):
    t = ting.convert_day(_raw_day(1))[None]
    ting.save_training_tensor(str(tmp_path / "a"), t)
    jing.save_training_tensor(str(tmp_path / "b"), t)
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"),
                                  np.load(tmp_path / "b.npy"))
    np.testing.assert_array_equal(np.load(tmp_path / "a.npz")["data"], t)


def test_read_geotiff_needs_a_reader(tmp_path, monkeypatch):
    from PIL import Image

    raw = _raw_day(2)[0]
    path = str(tmp_path / "r.tif")
    Image.fromarray(raw, mode="L").save(path)
    np.testing.assert_array_equal(ting.read_geotiff(path), raw)
    np.testing.assert_array_equal(ting.read_geotiff(path),
                                  jing.read_geotiff(path))
    monkeypatch.setitem(sys.modules, "rasterio", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="rasterio or Pillow"):
        ting.read_geotiff(path)


# --------------------------------------------------------------------------
# netCDF
# --------------------------------------------------------------------------

def test_netcdf_written_by_either_reads_in_the_other(tmp_path):
    mm5 = _mm5(3)
    mm5[7, 3, 4] = np.nan
    mine = str(tmp_path / "mine" / tnc.day_nc_filename("20090101"))
    theirs = str(tmp_path / "theirs" / jnc.day_nc_filename("20090101"))
    os.makedirs(os.path.dirname(mine))
    os.makedirs(os.path.dirname(theirs))
    tnc.write_day_nc(mine, mm5, "20090101")
    jnc.write_day_nc(theirs, mm5, "20090101")
    with open(mine, "rb") as f:
        assert f.read(3) == b"CDF"
    for path in (mine, theirs):
        np.testing.assert_array_equal(tnc.read_day_nc(path), mm5)
        np.testing.assert_array_equal(jnc.read_day_nc(path), mm5)
    from scipy.io import netcdf_file

    with netcdf_file(mine, "r", mmap=False) as a, \
            netcdf_file(theirs, "r", mmap=False) as b:
        assert list(a.variables) == list(b.variables)
        assert a.dimensions == b.dimensions
        assert a.variables["time"].units == b.variables["time"].units
        assert a.variables["time"].calendar == b.variables["time"].calendar
        np.testing.assert_array_equal(a.variables["time"][:],
                                      b.variables["time"][:])


def test_hdf5_reference_file_and_fill_value(tmp_path, monkeypatch):
    mm5 = _mm5(4)
    mm5[0, 0, 0] = 9.969209968386869e36  # netCDF's default float fill
    path = str(tmp_path / "smhi_radar_20100202.nc")
    with h5py.File(path, "w") as f:  # xarray's netCDF4 layout
        f.create_dataset("time", data=np.arange(288, dtype="f8"))
        f.create_dataset(tnc.VAR_NAME, data=mm5)
    got = tnc.read_day_nc(path)
    np.testing.assert_array_equal(got, jnc.read_day_nc(path))
    assert np.isnan(got[0, 0, 0]) and np.isfinite(got[1:]).all()
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py.*not installed") as err:
        tnc.read_day_nc(path)
    assert path in str(err.value)


def test_find_reformat_and_failed_days_match_jax(tmp_path):
    nc_dir = str(tmp_path / "nc")
    days = [("20090101", _raw_day(5)), ("20090102", None),
            ("20090104", _raw_day(6)), ("20090105", _raw_day(7)[:100]),
            ("20100101", _raw_day(8))]
    failed = tnc.convert_and_write_days(iter(days), nc_dir)
    jdir = str(tmp_path / "jnc")
    assert failed == jnc.convert_and_write_days(iter(days), jdir) \
        == ["20090102"]
    for start, end in (("20090101", "20091231"), ("20090103", "20100101")):
        got = tnc.find_day_files(nc_dir, start, end)
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in jnc.find_day_files(jdir, start,
                                                             end)]
    paths = tnc.find_day_files(nc_dir, "20090101", "20090104")
    for tres in (1, 4):
        got = tnc.reformat_from_netcdf(paths, tres=tres)
        np.testing.assert_array_equal(
            got, jnc.reformat_from_netcdf(paths, tres=tres))
        np.testing.assert_array_equal(
            got, np.stack([ting.convert_day(_raw_day(s), tres)
                           for s in (5, 6)]))
    with pytest.raises(ValueError, match="no input files"):
        tnc.reformat_from_netcdf([])


def test_download_range_collects_failures_without_fetching(tmp_path,
                                                           monkeypatch):
    src = tmp_path / "day.zip"
    with zipfile.ZipFile(src, "w") as z:
        z.writestr("radar_0901010000.tif", b"tiff bytes")
    fetched = []

    def fake_retrieve(url, dest):
        fetched.append(url)
        if url.split("comp/")[1].startswith("2009/2/2."):  # lacks Feb 2
            with open(dest, "wb") as f:
                f.write(b"not a zip")
            raise OSError("HTTP Error 404")
        shutil.copy(src, dest)

    import urllib.request

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)
    out = tmp_path / "raw"
    failed = tdl.download_range("20090201", "20090203", str(out))
    assert failed == ["20090202"]
    assert fetched == [u for _, u in jdl.day_urls("20090201", "20090203")]
    assert sorted(os.listdir(out)) == ["radar_0901010000.tif"]


# --------------------------------------------------------------------------
# the scan and the patch store
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def noisy_data():
    rng = np.random.RandomState(7)
    data = rng.gamma(0.5, 3.0, size=(5, 24, 48, 40)).astype(np.float32)
    data[1, :, 5:12, 8:15] = np.nan
    data[3, 10, 30:, :10] = np.nan
    return data


@pytest.mark.parametrize("include_last_box", [False, True])
@pytest.mark.parametrize("days_per_chunk", [1, 3, 5])
def test_streamed_scan_matches_jax(noisy_data, tmp_path, days_per_chunk,
                                   include_last_box):
    path = str(tmp_path / "d.npy")
    np.save(path, noisy_data)
    mm = np.load(path, mmap_mode="r")
    for stride in (16, 8):
        tcfg = TDataConfig(ndomain=16, stride=stride, n_thresh=20)
        jcfg = JDataConfig(ndomain=16, stride=stride, n_thresh=20)
        got = tidx.compute_valid_indices_streamed(
            mm, tcfg, include_last_box, device="cpu",
            days_per_chunk=days_per_chunk)
        assert got.dtype == np.int32 and len(got) > 0
        np.testing.assert_array_equal(
            got, jidx.compute_valid_indices(noisy_data, jcfg,
                                            include_last_box))
        np.testing.assert_array_equal(
            got, jidx.compute_valid_indices_bruteforce(noisy_data, jcfg,
                                                       include_last_box))
        np.testing.assert_array_equal(
            got, tnat.compute_valid_indices_native(mm, tcfg, include_last_box,
                                                   device="cpu"))


def test_streamed_scan_refusals_and_empty():
    cfg = TDataConfig(ndomain=16, stride=16)
    with pytest.raises(ValueError, match="4-D"):
        tidx.compute_valid_indices_streamed(np.zeros((2, 3, 4)), cfg,
                                            device="cpu")
    with pytest.raises(ValueError, match="days_per_chunk"):
        tidx.compute_valid_indices_streamed(np.zeros((1, 2, 16, 16)), cfg,
                                            device="cpu", days_per_chunk=0)
    got = tidx.compute_valid_indices_streamed(
        np.zeros((0, 24, 32, 32), np.float32), cfg, device="cpu")
    assert got.shape == (0, 3) and got.dtype == np.int32


def test_patch_store_matches_jax_native(noisy_data, tmp_path):
    rng = np.random.RandomState(3)
    # days with many rows, one row and none; rows at the last row/column
    idx = np.array([[t, y, x] for t, y, x in zip(
        rng.choice([0, 0, 2, 2, 4], 40), rng.randint(0, 33, 40),
        rng.randint(0, 25, 40))] + [[1, 32, 24], [4, 0, 0]], np.int32)
    path = str(tmp_path / "d.npy")
    np.save(path, noisy_data)
    mm = np.load(path, mmap_mode="r")
    want = jnat.extract_patch_store(noisy_data, idx, 16)
    got = tnat.extract_patch_store(mm, idx, 16, device="cpu")
    assert got.dtype == np.float32 and got.shape == (42, 24, 16, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tnat.gather_patches_native(noisy_data, idx, 16, device="cpu"),
        jnat.gather_patches_native(noisy_data, idx, 16))
    assert tnat.extract_patch_store(mm, idx[:0], 16,
                                    device="cpu").shape == (0, 24, 16, 16)
    for bad in ([[5, 0, 0]], [[0, 33, 0]], [[0, 0, -1]]):
        with pytest.raises(ValueError, match="out of range"):
            tnat.extract_patch_store(mm, np.array(bad), 16, device="cpu")
        with pytest.raises(ValueError, match="out of range"):
            tnat.gather_patches_native(noisy_data, np.array(bad), 16,
                                       device="cpu")


def test_patch_store_of_real_size_days_equals_numpy_slices(tmp_path):
    """The store of a memmap of 256 x 256 days (a real day's grid), rows out
    of day order with repeats, a day without rows and patches at the last
    start, against plain numpy slices of the memmap: a reference that
    shares no code with data/native.py."""
    rng = np.random.RandomState(11)
    data = rng.gamma(0.3, 0.4, size=(4, 24, 256, 256)).astype(np.float32)
    data[1, 3, 100:140, 7] = np.nan
    path = str(tmp_path / "d.npy")
    np.save(path, data)
    mm = np.load(path, mmap_mode="r")
    nd = 16
    idx = np.stack([rng.choice([3, 0, 1, 3], 60), rng.randint(0, 241, 60),
                    rng.randint(0, 241, 60)], axis=1).astype(np.int32)
    idx = np.concatenate([idx, [[0, 240, 240], [3, 0, 240], idx[5]]])
    got = tnat.extract_patch_store(mm, idx, nd, device="cpu")
    want = np.stack([mm[t, :, y:y + nd, x:x + nd] for t, y, x in idx])
    assert got.shape == (63, 24, nd, nd)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# --------------------------------------------------------------------------
# files both packages share; profiling
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(TCache, JCache),
                                           (JCache, TCache)])
def test_stage_cache_file_reads_in_the_other_package(tmp_path, writer,
                                                     reader):
    path = str(tmp_path / "run" / "stages.json")
    w = writer(path)
    w.mark("crps", mean=0.25, path="data/crps.pkl")
    w.mark("lsd", median=1.5)
    w.clear("lsd")
    r = reader(path)
    assert r.done("crps") and not r.done("lsd")
    assert r.get("crps") == {"mean": 0.25, "path": "data/crps.pkl"}
    assert r.get("lsd", "none") == "none"
    assert not [f for f in os.listdir(os.path.dirname(path))
                if ".tmp." in f]  # the atomic write left nothing behind
    with open(path, "w") as f:
        f.write("{not json")
    assert not reader(path).done("crps")  # corrupt file: no cache


def test_step_timer_and_trace(tmp_path):
    timer = tprof.StepTimer()
    timer.start()
    x = torch.ones(64)
    for _ in range(3):
        x = x * 1.0001
    rate = timer.stop(3, sync_scalar=x.sum())
    assert rate > 0
    timer.start()
    assert timer.stop(1) > 0
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(32, 32).matmul(torch.ones(32, 32))
    assert prof.key_averages()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
