"""The benchmark's data: radar-like hourly fields made from the seed, and
their valid patch rows.

Copied from ``prdisagg_torch/data/synthetic.py``
(``make_synthetic_dataset_torch``) and ``prdisagg_torch/data/indices.py``
(``compute_valid_indices``), so that a change to the program cannot change
the data the yardstick trains and serves on.  The recipe: gamma noise
(shape 0.6, scale 4) blurred by zero-padded moving averages of width 5
(hours), 7 (y) and 7 (x), times a daily cycle 1 + 0.5 sin(2 pi h / 24),
plus a 1e-3 floor.  A patch (t, y, x) is valid when its daily-sum box is
NaN-free and at least ``n_thresh`` gridpoints exceed ``tp_thresh_daily``,
over the reference's sweep ``range(0, n - ndomain, stride)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WIDTHS = (5, 7, 7)   # moving-average widths along hours, y, x
CHUNK_DAYS = 16      # days made at a time: ~0.4 GB at 256 x 256


def make_fields(n_days: int, ny: int, nx: int, nhours: int, seed: int,
                device) -> torch.Tensor:
    """(n_days, nhours, ny, nx) float32 on `device`, from `seed`, a chunk of
    days at a time so that the only full-size allocation is the result."""
    device = torch.device(device)
    data = torch.empty((n_days, nhours, ny, nx), dtype=torch.float32,
                       device=device)
    cycle = 1.0 + 0.5 * torch.sin(
        2 * torch.pi * torch.arange(nhours, device=device,
                                    dtype=torch.float64) / nhours)
    cycle = cycle.float()[:, None, None]
    gen = torch.Generator(device=device).manual_seed(seed)
    pad = tuple(w // 2 for w in WIDTHS)
    for d0 in range(0, n_days, CHUNK_DAYS):
        n = min(CHUNK_DAYS, n_days - d0)
        alpha = torch.full((n, 1, nhours, ny, nx), 0.6, device=device)
        x = 4.0 * torch._standard_gamma(alpha, generator=gen)
        x = F.avg_pool3d(x, WIDTHS, stride=1, padding=pad,
                         count_include_pad=True)
        data[d0:d0 + n] = x[:, 0] * cycle + 1e-3
    return data


def _box_sums(m: np.ndarray, nd: int) -> np.ndarray:
    """Sums of all nd x nd boxes of (D, ny, nx) float64 fields."""
    sat = np.zeros((m.shape[0], m.shape[1] + 1, m.shape[2] + 1))
    sat[:, 1:, 1:] = m.cumsum(axis=1).cumsum(axis=2)
    return (sat[:, nd:, nd:] - sat[:, :-nd, nd:] - sat[:, nd:, :-nd]
            + sat[:, :-nd, :-nd])


def valid_rows(daily: np.ndarray, data_cfg: dict) -> np.ndarray:
    """(S, 3) int32 rows (t, y, x) of the valid patches of (days, ny, nx)
    float64 daily sums, t-major, then y, then x."""
    nd, stride = data_cfg["ndomain"], data_cfg["stride"]
    _, ny, nx = daily.shape
    ys = np.arange(0, max(ny - nd, 0), stride)
    xs = np.arange(0, max(nx - nd, 0), stride)
    if len(ys) == 0 or len(xs) == 0:
        return np.zeros((0, 3), dtype=np.int32)
    nan_counts = _box_sums(np.isnan(daily).astype(np.float64), nd)
    exceed = _box_sums((np.nan_to_num(daily, nan=0.0)
                        > data_cfg["tp_thresh_daily"]).astype(np.float64), nd)
    ok = ((nan_counts[:, ys][:, :, xs] == 0)
          & (exceed[:, ys][:, :, xs] >= data_cfg["n_thresh"]))
    t, yi, xi = np.nonzero(ok)
    return np.stack([t, ys[yi], xs[xi]], axis=1).astype(np.int32)


def daily_sums(data: torch.Tensor) -> np.ndarray:
    """(days, nhours, ny, nx) -> (days, ny, nx) float64 on the host."""
    return data.sum(dim=1, dtype=torch.float64).cpu().numpy()


def make_dataset(n_days: int, ny: int, nx: int, nhours: int, seed: int,
                 data_cfg: dict, device):
    """(fields on `device`, valid rows (S, 3) int32 numpy); raises when no
    patch is valid."""
    data = make_fields(n_days, ny, nx, nhours, seed, device)
    rows = valid_rows(daily_sums(data), data_cfg)
    if len(rows) == 0:
        raise RuntimeError("the synthetic fields have no valid patch")
    return data, rows
