"""netCDF interop for the reference's intermediate-file contract.

The reference pipeline's stage boundary between convert and reformat is one
netCDF file per day: ``smhi_radar_{YYYYMMDD}.nc`` holding an UNNAMED xarray
DataArray (on disk the variable ``__xarray_dataarray_variable__``) of shape
(time=288, y, x) in mm per 5 minutes (convert_smhi_radardata.py:45 writes,
reformat_data.py:69 reads with ``xr.open_mfdataset``).  Without xarray or
netCDF4:

* writing: ``scipy.io.netcdf_file`` emits NETCDF3_64BIT with the reference's
  variable, dimensions and time attributes, which ``xr.open_mfdataset``
  reads as it reads the reference's own files;
* reading: the reference's files are netCDF4, that is HDF5, read with
  ``h5py`` (where it is missing, reading one raises ImportError naming it
  and the file); classic netCDF3 files with scipy.

The reformat math downstream is ``reformat_data.py:75-86``: per-day 5-min
steps summed to tres-hour totals with skipna=False semantics (NaN
propagates, ``ingest.aggregate_to_tres``) and stacked to
(ndays, 24/tres, ny, nx) float32.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from prdisagg_torch.data.ingest import (
    aggregate_to_tres,
    reflectivity_to_mm_per_5min,
    reformat_stream,
)

VAR_NAME = "__xarray_dataarray_variable__"
_HDF5_MAGIC = b"\x89HDF"
_NC3_MAGIC = b"CDF"

DAY_FILE_RE = re.compile(r"smhi_radar_(\d{8})\.nc$")


def day_nc_filename(date: str) -> str:
    """Per-day filename codec (convert_smhi_radardata.py:45)."""
    return f"smhi_radar_{date}.nc"


def write_day_nc(path: str, mm5: np.ndarray, date: str) -> None:
    """Write one day of (n_steps, ny, nx) mm/5min as a reference-contract
    NETCDF3_64BIT file.  ``date`` is YYYYMMDD; the time coordinate counts
    5-minute steps from 00:00."""
    mm5 = np.asarray(mm5, dtype=np.float32)
    if mm5.ndim != 3:
        raise ValueError(f"expected (time, y, x), got shape {mm5.shape}")
    n_t, ny, nx = mm5.shape
    minutes = np.arange(n_t, dtype=np.float64) * 5.0
    units = f"minutes since {date[:4]}-{date[4:6]}-{date[6:8]} 00:00:00"
    from scipy.io import netcdf_file

    with netcdf_file(path, "w", version=2) as f:  # version=2 -> NETCDF3_64BIT
        f.createDimension("time", n_t)
        f.createDimension("y", ny)
        f.createDimension("x", nx)
        tvar = f.createVariable("time", "d", ("time",))
        tvar[:] = minutes
        tvar.units = units.encode()
        tvar.calendar = b"proleptic_gregorian"
        var = f.createVariable(VAR_NAME, "f", ("time", "y", "x"))
        var[:] = mm5


def _pick_var(names: Iterable[str], shapes) -> str:
    """The reference variable name, else the first >=2-D non-coordinate."""
    names = list(names)
    if VAR_NAME in names:
        return VAR_NAME
    for n in names:
        if n not in ("time", "y", "x", "band", "spatial_ref") and \
                len(shapes(n)) >= 2:
            return n
    raise ValueError(f"no data variable among {names}")


def read_day_nc(path: str) -> np.ndarray:
    """Read one per-day netCDF (the reference's or this module's) ->
    (n_steps, ny, nx) float32 mm/5min, fill values (|x| > 1e30) as NaN.

    Dispatches on the file's magic bytes: HDF5 (netCDF4, what the
    reference's ``to_netcdf`` writes) via h5py, classic netCDF3 via scipy.
    """
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic.startswith(_HDF5_MAGIC):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"{path} is netCDF4 (HDF5), which needs the "
                              "'h5py' package; it is not installed") from e

        with h5py.File(path, "r") as f:
            name = _pick_var(f.keys(), lambda n: f[n].shape)
            arr = np.asarray(f[name], dtype=np.float32)
    elif magic.startswith(_NC3_MAGIC):
        from scipy.io import netcdf_file

        with netcdf_file(path, "r", mmap=False) as f:
            name = _pick_var(f.variables.keys(),
                             lambda n: f.variables[n].shape)
            arr = np.asarray(f.variables[name][:], dtype=np.float32)
    else:
        raise ValueError(f"{path}: not a netCDF file (magic {magic!r})")
    if arr.ndim == 4:  # (time, band, y, x): band kept by some writers
        arr = arr[:, 0]
    if arr.ndim != 3:
        raise ValueError(f"{path}: expected (time, y, x), got {arr.shape}")
    # netCDF's default float fill is ~9.97e36: missing, like NaN
    return np.where(np.abs(arr) > 1e30, np.nan, arr)


def find_day_files(nc_dir: str, startdate: str, enddate: str) -> List[str]:
    """Existing per-day files in [startdate, enddate], sorted by date;
    missing days are skipped as the reference skips them
    (reformat_data.py:56-62 keeps only files that exist)."""
    out = []
    for name in sorted(os.listdir(nc_dir)):
        m = DAY_FILE_RE.search(name)
        if m and startdate <= m.group(1) <= enddate:
            out.append(os.path.join(nc_dir, name))
    return out


def reformat_from_netcdf(
    paths: Sequence[str],
    tres: int = 1,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-day netCDF files -> (ndays, 24/tres, ny, nx) float32 training
    tensor, one day resident at a time.

    Sum semantics match ``resample(...).sum(skipna=False)``
    (reformat_data.py:75): any NaN 5-min step poisons its tres-hour bin.
    """
    if not paths:
        raise ValueError("no input files found!")  # reference message, :64
    first = read_day_nc(paths[0])
    shape_yx = first.shape[1:]

    def days():
        yield aggregate_to_tres(first, tres)
        for p in paths[1:]:
            yield aggregate_to_tres(read_day_nc(p), tres)

    return reformat_stream(days(), len(paths), shape_yx, tres=tres, out=out)


def convert_and_write_days(
    raw_days: Iterable[Tuple[str, np.ndarray]],
    outdir: str,
) -> List[str]:
    """The convert stage: (date, raw (288, ny, nx) reflectivity) pairs ->
    per-day mm/5min netCDF files.  Returns the dates that failed (a day
    given as None fails), skipped and recorded as the reference does
    (convert_smhi_radardata.py:47-52)."""
    os.makedirs(outdir, exist_ok=True)
    failed: List[str] = []
    for date, raw in raw_days:
        try:
            mm5 = reflectivity_to_mm_per_5min(np.asarray(raw))
            write_day_nc(os.path.join(outdir, day_nc_filename(date)),
                         mm5, date)
        except Exception:  # noqa: BLE001 — one bad day fails that day only
            failed.append(date)
    return failed
