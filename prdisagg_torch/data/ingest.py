"""Offline data pipeline: raw SMHI radar -> training tensor.

The JAX package's stages, with the same numpy arithmetic operation for
operation, so that the intermediate files and the training tensor are bit
for bit the JAX package's:

  convert:  raw 5-minute reflectivity composites -> mm/5min
            (convert_smhi_radardata.py:39-43: mask 255 -> NaN,
             dBZ = x*0.4 - 30, mm/h = ((10^(dBZ/10))/200)^(1/1.5), /12)
  reformat: 5-minute steps -> tres-hour sums with skipna=False semantics
            (NaN propagates, reformat_data.py:75), reshaped to
            (days, 24/tres, ny, nx) float32 (:80-91)
  doy:      day-of-year sidecar for the doy-conditioning variant
            (reformat_data_make_timelist.py:58-62), from the standard
            library's dates (the JAX package uses pandas)

`reformat_stream` folds one day at a time into a preallocated output, so
memory is one day (the reference materializes the whole multi-year array,
reformat_data.py:5).  These stages are host file work: no device runs them.
"""

from __future__ import annotations

import datetime
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

MISSING_VALUE = 255
STEPS_PER_HOUR = 12  # 5-minute radar steps


def reflectivity_to_mm_per_5min(raw: np.ndarray) -> np.ndarray:
    """SMHI radar byte reflectivity -> precipitation in mm per 5 minutes.

    Exact reference math (convert_smhi_radardata.py:39-43) with the Z-R
    relation Z = 200 * R^1.6 from the SMHI open-data docs.
    """
    x = np.asarray(raw, dtype=np.float32)
    x = np.where(x == MISSING_VALUE, np.nan, x)
    dbz = x * 0.4 - 30.0
    mm_per_h = ((10.0 ** (dbz / 10.0)) / 200.0) ** (1.0 / 1.5)
    return (mm_per_h * 5.0 / 60.0).astype(np.float32)


def aggregate_to_tres(mm5: np.ndarray, tres: int = 1) -> np.ndarray:
    """(n_steps, ny, nx) mm/5min -> (n_steps/(12*tres), ny, nx) mm per tres
    hours, NaN-propagating sum (skipna=False, reformat_data.py:75)."""
    steps = STEPS_PER_HOUR * tres
    n = mm5.shape[0]
    if n % steps != 0:
        raise ValueError(f"{n} 5-min steps not divisible by {steps}")
    return mm5.reshape(n // steps, steps, *mm5.shape[1:]).sum(
        axis=1, dtype=np.float32)


def reshape_to_days(hourly: np.ndarray, tres: int = 1) -> np.ndarray:
    """(ntime, ny, nx) -> (ndays, 24/tres, ny, nx) (reformat_data.py:80-86)."""
    t_per_day = 24 // tres
    ntime = hourly.shape[0]
    if ntime % t_per_day != 0:
        raise ValueError(f"{ntime} steps not divisible by {t_per_day}/day")
    return hourly.reshape(ntime // t_per_day, t_per_day, *hourly.shape[1:])


def convert_day(raw_day: np.ndarray, tres: int = 1) -> np.ndarray:
    """One day of raw 5-min reflectivity (288, ny, nx) -> (24/tres, ny, nx)
    mm per tres hours."""
    if raw_day.shape[0] != 24 * STEPS_PER_HOUR:
        raise ValueError(f"expected {24 * STEPS_PER_HOUR} five-minute steps, "
                         f"got {raw_day.shape[0]}")
    return aggregate_to_tres(reflectivity_to_mm_per_5min(raw_day), tres)


def reformat_stream(
    day_arrays: Iterable[np.ndarray],
    n_days: int,
    shape_yx: Tuple[int, int],
    tres: int = 1,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Fold per-day (24/tres, ny, nx) mm arrays into the training tensor
    (n_days, 24/tres, ny, nx) float32, one day resident at a time."""
    t_per_day = 24 // tres
    if out is None:
        out = np.empty((n_days, t_per_day, *shape_yx), dtype=np.float32)
    i = -1
    for i, day in enumerate(day_arrays):
        if day.shape != (t_per_day, *shape_yx):
            raise ValueError(f"day {i}: shape {day.shape}")
        out[i] = day
    if i + 1 != n_days:
        raise ValueError(f"expected {n_days} days, got {i + 1}")
    return out


def as_date(d) -> datetime.date:
    """A date from a datetime.date/datetime, 'YYYYMMDD' or ISO
    'YYYY-MM-DD[...]'."""
    if isinstance(d, datetime.date):
        return d
    s = str(d)
    if len(s) == 8 and s.isdigit():
        return datetime.date(int(s[:4]), int(s[4:6]), int(s[6:]))
    return datetime.date.fromisoformat(s[:10])


def day_of_year(dates: Sequence) -> np.ndarray:
    """Day-of-year sidecar for doy conditioning, float32
    (reformat_data_make_timelist.py:58-62)."""
    return np.array([as_date(d).timetuple().tm_yday for d in dates],
                    dtype=np.float32)


def save_training_tensor(path_prefix: str, tensor: np.ndarray) -> None:
    """.npy + compressed .npz, reference file contract (reformat_data.py:90-91)."""
    np.save(path_prefix + ".npy", tensor)
    np.savez_compressed(path_prefix + ".npz", data=tensor)


# ---------------------------------------------------------------------------
# GeoTIFF reading (rasterio, else Pillow)
# ---------------------------------------------------------------------------

TIFF_READERS = ("rasterio", "PIL")


def read_geotiff(path: str) -> np.ndarray:
    """Read one radar GeoTIFF; picks band 0 if multi-band
    (convert_smhi_radardata.py:31-34).  Needs rasterio or Pillow and raises
    ImportError naming both where neither is installed."""
    try:
        import rasterio  # type: ignore

        with rasterio.open(path) as f:
            return f.read(1)
    except ImportError:
        pass
    try:
        from PIL import Image  # type: ignore
    except ImportError as e:
        raise ImportError(
            "reading GeoTIFFs needs rasterio or Pillow; neither is "
            "installed (convert raw arrays with convert_day instead)") from e
    with Image.open(path) as img:
        arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr


def convert_day_from_tiffs(paths: Sequence[str], tres: int = 1) -> np.ndarray:
    raw = np.stack([read_geotiff(p) for p in paths])
    return convert_day(raw, tres)
