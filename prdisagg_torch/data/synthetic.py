"""Synthetic radar-like dataset.

Strictly positive, spatially and temporally correlated "rain blob" fields
shaped like the reference's reformatted tensor (days, 24, ny, nx), plus the
matching valid-index list: gamma noise blurred by moving averages of width
5 (hours), 7 (y) and 7 (x), modulated by a daily cycle, plus a 1e-3 floor.

:func:`make_synthetic_dataset` is the JAX package's numpy recipe, array for
array from the same seed.  :func:`make_synthetic_dataset_torch` follows the
same recipe on a device, a chunk of days at a time, for datasets of
gigabytes that should be made where they will live; its random numbers come
from torch, so it does not reproduce the numpy arrays.
"""

from __future__ import annotations

import numpy as np

from prdisagg_torch.core.config import DataConfig
from prdisagg_torch.data.indices import compute_valid_indices

_WIDTHS = (5, 7, 7)  # moving-average widths along hours, y, x
_CHUNK_DAYS = 16     # days made at a time on a device: ~0.4 GB at 256x256


def _daily_cycle(nh: int) -> np.ndarray:
    return 1.0 + 0.5 * np.sin(2 * np.pi * np.arange(nh) / nh)


def make_synthetic_dataset(n_days: int = 8, ny: int = 64, nx: int = 64,
                           seed: int = 0, cfg: DataConfig | None = None):
    """Returns (data (n_days,24,ny,nx) float32, indices (S,3) int32, cfg)."""
    cfg = cfg or DataConfig()
    rng = np.random.RandomState(seed)
    nh = cfg.nhours

    x = rng.gamma(shape=0.6, scale=4.0, size=(n_days, nh, ny, nx))
    for axis, width in zip((1, 2, 3), _WIDTHS):
        k = np.ones(width) / width
        x = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), axis, x)
    x = x * _daily_cycle(nh)[None, :, None, None]
    data = (x + 1e-3).astype(np.float32)

    indices = compute_valid_indices(data, cfg)
    if len(indices) == 0:
        raise RuntimeError("synthetic dataset produced no valid patches; "
                           "loosen thresholds or enlarge the domain")
    return data, indices, cfg


def make_scale_dataset(n_days: int, ny: int, nx: int, seed: int,
                       cfg: DataConfig, regime: bool = False):
    """Rain-blob fields at the reference's real dimensions, made fast
    enough for thousands of days: gamma noise blurred by
    ``scipy.ndimage.uniform_filter1d`` (widths 5, 7, 7, edges repeated),
    200 days at a time, times a day factor, plus a 1e-3 floor.

    ``regime=False`` gives every day one fixed daily cycle and nearly equal
    daily totals; on such data the reference's random-climatology CRPS
    baseline is a near-oracle ensemble.  ``regime=True`` draws a day
    regime z ~ N(0, 1) per day: an amplitude e^{0.8 z}, and a von-Mises
    envelope whose peak hour (15 + 3 tanh z + N(0, 1)) and concentration
    (1.5 + 1.2 tanh z) follow the amplitude, so the hourly profile is
    predictable from the daily sum, as in real precipitation.

    Returns (data (n_days, nhours, ny, nx) float32, indices (S, 3) int32),
    array for array the JAX recipe's from the same seed."""
    from scipy.ndimage import uniform_filter1d

    rng = np.random.RandomState(seed)
    nh = cfg.nhours
    if regime:
        z = rng.normal(size=n_days)
        amp = np.exp(0.8 * z).astype(np.float32)
        peak = 15.0 + 3.0 * np.tanh(z) + rng.normal(0.0, 1.0, n_days)
        kappa = 1.5 + 1.2 * np.tanh(z)
        t = np.arange(nh)
        env = np.exp(kappa[:, None]
                     * np.cos(2 * np.pi * (t[None] - peak[:, None]) / nh))
        env = (env / env.mean(axis=1, keepdims=True)).astype(np.float32)
        day_factor = amp[:, None] * env  # (n_days, nh)
    else:
        cycle = _daily_cycle(nh).astype(np.float32)
        day_factor = np.broadcast_to(cycle[None], (n_days, nh))
    chunks = []
    for d0 in range(0, n_days, 200):
        d = min(200, n_days - d0)
        x = rng.gamma(shape=0.6, scale=4.0,
                      size=(d, nh, ny, nx)).astype(np.float32)
        for axis, width in zip((1, 2, 3), _WIDTHS):
            x = uniform_filter1d(x, size=width, axis=axis, mode="nearest")
        chunks.append(x * day_factor[d0:d0 + d, :, None, None] + 1e-3)
    data = np.concatenate(chunks)
    return data, np.asarray(compute_valid_indices(data, cfg), dtype=np.int32)


def make_synthetic_dataset_torch(n_days: int, ny: int, nx: int, seed: int,
                                 device, cfg: DataConfig | None = None):
    """The same recipe made on `device`, a chunk of days at a time, so the
    only full-size allocation is the result.

    Returns (data (n_days, nhours, ny, nx) float32 tensor on `device`,
    indices (S, 3) int32 numpy array, cfg)."""
    import torch
    import torch.nn.functional as F

    cfg = cfg or DataConfig()
    nh = cfg.nhours
    device = torch.device(device)
    data = torch.empty((n_days, nh, ny, nx), dtype=torch.float32,
                       device=device)
    cycle = torch.tensor(_daily_cycle(nh), dtype=torch.float32,
                         device=device)[:, None, None]
    pad = tuple(w // 2 for w in _WIDTHS)
    with torch.random.fork_rng(devices=[device] if device.type == "cuda"
                               else []):
        torch.manual_seed(seed)
        for d0 in range(0, n_days, _CHUNK_DAYS):
            n = min(_CHUNK_DAYS, n_days - d0)
            alpha = torch.full((n, 1, nh, ny, nx), 0.6, device=device)
            x = 4.0 * torch._standard_gamma(alpha)
            # separable zero-padded moving averages == one box filter that
            # divides by the full window (np.convolve(..., "same"))
            x = F.avg_pool3d(x, _WIDTHS, stride=1, padding=pad,
                             count_include_pad=True)
            data[d0:d0 + n] = x[:, 0] * cycle + 1e-3
    indices = compute_valid_indices(data, cfg)
    if len(indices) == 0:
        raise RuntimeError("synthetic dataset produced no valid patches")
    return data, indices, cfg
