"""Valid-patch index computation.

A patch (tidx, ii, jj) of size ndomain x ndomain is valid iff its daily-sum
box is NaN-free and at least ``n_thresh`` gridpoints exceed
``tp_thresh_daily`` (reference: compute_valid_indices.py:74-93).  The sweep
is vectorized with 2-D summed-area tables over boolean masks, as in the JAX
package.

Boundary semantics: the reference iterates ``range(0, ny - ndomain, stride)``,
which EXCLUDES the last fitting box row and column.  That off-by-one is kept
by default, so the index lists match the reference's; pass
``include_last_box=True`` for the corrected sweep.
"""

from __future__ import annotations

import numpy as np

from prdisagg_torch.core.config import DataConfig


def _box_sums(m: np.ndarray, nd: int) -> np.ndarray:
    """Sums of all nd x nd boxes of per-day 2-D fields.

    m: (D, ny, nx) float64.  Returns (D, ny-nd+1, nx-nd+1).
    """
    sat = np.zeros((m.shape[0], m.shape[1] + 1, m.shape[2] + 1),
                   dtype=np.float64)
    sat[:, 1:, 1:] = m.cumsum(axis=1).cumsum(axis=2)
    return (sat[:, nd:, nd:] - sat[:, :-nd, nd:] - sat[:, nd:, :-nd]
            + sat[:, :-nd, :-nd])


def sweep_starts(n: int, ndomain: int, stride: int,
                 include_last_box: bool = False) -> np.ndarray:
    """Box starts along one axis: ``range(0, n - ndomain, stride)``, the
    reference's sweep, which leaves out the last box that fits, or with
    `include_last_box` ``range(0, n - ndomain + 1, stride)``."""
    stop = n - ndomain + (1 if include_last_box else 0)
    return np.arange(0, max(stop, 0), stride)


def _daily_sums(data) -> np.ndarray:
    """(days, nhours, ny, nx) -> (days, ny, nx) float64 sums over hours.

    A torch tensor is summed where it lies (a dataset on the card never
    travels to the host whole; only its 1/nhours-size daily sums do)."""
    if isinstance(data, np.ndarray):
        return data.sum(axis=1, dtype=np.float64)
    import torch

    return data.sum(dim=1, dtype=torch.float64).cpu().numpy()


def compute_valid_indices(data, cfg: DataConfig,
                          include_last_box: bool = False) -> np.ndarray:
    """data: (days, nhours, ny, nx) float32 (NaN = missing), a numpy array
    or a torch tensor on any device.

    Returns int32 array (S, 3) of (tidx, ii, jj) rows, ordered exactly like
    the reference triple loop (t-major, then row, then column).
    """
    if data.ndim != 4:
        raise ValueError(f"data must be 4-D (days,hours,ny,nx), got "
                         f"{tuple(data.shape)}")
    _, _, ny, nx = data.shape
    nd, stride = cfg.ndomain, cfg.stride

    daily = _daily_sums(data)  # NaN propagates, as in the reference
    nan_counts = _box_sums(np.isnan(daily).astype(np.float64), nd)
    exceed_counts = _box_sums(
        (np.nan_to_num(daily, nan=0.0) > cfg.tp_thresh_daily)
        .astype(np.float64), nd)

    ys = sweep_starts(ny, nd, stride, include_last_box)
    xs = sweep_starts(nx, nd, stride, include_last_box)
    if len(ys) == 0 or len(xs) == 0:
        return np.zeros((0, 3), dtype=np.int32)

    nanfree = nan_counts[:, ys][:, :, xs] == 0
    enough = exceed_counts[:, ys][:, :, xs] >= cfg.n_thresh
    t_idx, y_pos, x_pos = np.nonzero(nanfree & enough)
    return np.stack([t_idx, ys[y_pos], xs[x_pos]], axis=1).astype(np.int32)
