"""Statistical metrics: ECDF, ensemble CRPS, radial power spectra, LSD.

The JAX package's metric stack (its ops/stats.py), as plain tensor functions
that run on their inputs' device:

* :func:`crps_ensemble` replaces ``properscoring.crps_ensemble``
  (generate_and_evaluate_crps.py:189) with an O(M log M) sort-based
  estimator over whole fields;
* :func:`radial_spectra` / :func:`log_spectral_distance` replace the numba
  loops (log_spectral_distance.py:19-76): the azimuthal binning is
  precomputed per field shape, so a batch of spectra is one FFT and one
  segment sum, and all-pairs distances are one matrix product.

Every contraction (the CRPS spread, the LSD cross term) runs in float32
with TF32 off (:func:`prdisagg_torch.ops.core.full_f32`): the weights of the
spread term range over +-(M-1) and correlate with the sorted values, so a
contraction with a 10-bit mantissa biases the result instead of adding noise
that cancels.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from prdisagg_torch.ops.core import full_f32
from prdisagg_torch.utils.watchdog import beat_if_enabled


def ecdf(data: np.ndarray):
    """Empirical CDF, reference semantics (generate_and_evaluate.py:431-435)."""
    x = np.sort(np.asarray(data).ravel())
    y = np.arange(1, x.size + 1) / x.size
    return x, y


def ecdf_plot(data: np.ndarray, cap: int = 200_000):
    """:func:`ecdf` decimated to at most about `cap` quantile-spaced vertices,
    for plotting: the full ECDF of a 10,000-sample protocol is a 61M-vertex
    path.  A sorted stride is the same curve at any plottable resolution;
    the first and last points are kept, so the curve still spans
    [min, max] x (~0, 1.0].  Numeric consumers keep using :func:`ecdf`."""
    x, y = ecdf(data)
    if len(x) > cap:
        step = len(x) // cap + 1
        x = np.concatenate([x[::step], x[-1:]])
        y = np.concatenate([y[::step], y[-1:]])
    return x, y


# ---------------------------------------------------------------------------
# CRPS
# ---------------------------------------------------------------------------

def ensemble_spread(forecasts: torch.Tensor) -> torch.Tensor:
    """0.5 * E|X - X'| of an M-member ensemble (M, ...) -> (...), with 1/M^2
    weighting, by the sort identity
      sum_{i,j} |x_i - x_j| = 2 * sum_k (2k - M + 1) * x_(k)."""
    m = forecasts.shape[0]
    xs = torch.sort(forecasts.movedim(0, -1), dim=-1).values
    w = 2.0 * torch.arange(m, dtype=xs.dtype, device=xs.device) - m + 1.0
    with full_f32():
        return torch.matmul(xs, w) / (m * m)


def crps_ensemble(observation: torch.Tensor,
                  forecasts: torch.Tensor) -> torch.Tensor:
    """CRPS of an M-member ensemble against observations.

    forecasts: (M, ...) ensemble along axis 0; observation: (...).  The
    empirical (fair=False) estimator of properscoring,
    E|X - y| - 0.5 * E|X - X'|."""
    term1 = torch.mean(torch.abs(forecasts - observation[None]), dim=0)
    return term1 - ensemble_spread(forecasts)


def crps_ensemble_fixed(observations: torch.Tensor, forecasts: torch.Tensor,
                        spread: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """CRPS of one FIXED ensemble against a batch of observations: equal to
    :func:`crps_ensemble` per observation, but the spread term depends on
    the forecasts only, so it is computed once for the batch (the
    reference's "random" baseline, where one 5000-patch ensemble scores
    every test sample, generate_and_evaluate_crps.py:164-195).

    observations: (B, ...); forecasts: (M, ...); `spread`, the forecasts'
    :func:`ensemble_spread`, when a caller scores many batches against the
    same ensemble.  Returns (B, ...)."""
    if spread is None:
        spread = ensemble_spread(forecasts)
    term1 = torch.mean(torch.abs(forecasts[None] - observations[:, None]),
                       dim=1)
    return term1 - spread[None]


# ---------------------------------------------------------------------------
# Radial power spectrum + log-spectral distance
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _radial_bins(ny: int, nx: int):
    """The reference azimuthal binning (log_spectral_distance.py:19-56):
    integer-truncated radii around ((nx-1)/2, (nx-1)/2), group means via
    cumulative sums over the radius-sorted pixels, first group dropped.

    Returns (sort_order flat indices, group segment ids (ny*nx,) with -1 for
    dropped pixels, group sizes (n_groups,))."""
    y, x = np.indices((ny, nx))
    center = np.array([(x.max() - x.min()) / 2.0, (x.max() - x.min()) / 2.0])
    r = np.hypot(x - center[0], y - center[1])
    ind = np.argsort(r.flat)
    r_int = r.flat[ind].astype(int)

    deltar = r_int[1:] - r_int[:-1]
    rind = np.where(deltar)[0]              # last index of each radius group
    nr = rind[1:] - rind[:-1]               # sizes of groups 1..G-1

    # pixels of output bin b are the sorted positions rind[b]+1..rind[b+1]
    seg = np.full(ny * nx, -1, dtype=np.int64)
    for b in range(len(rind) - 1):
        seg[rind[b] + 1: rind[b + 1] + 1] = b
    return ind.astype(np.int64), seg, nr.astype(np.float64)


def radial_spectra(fields: torch.Tensor) -> torch.Tensor:
    """Radially averaged 2-D power spectra of (N, ny, nx) fields -> (N,
    n_bins), each as compute_radial_spectrum (log_spectral_distance.py:59-65)
    computes it: fft2, fftshift, |.|^2, then a segment sum over the
    radius-sorted pixels."""
    n, ny, nx = fields.shape
    ind, seg, nr = _radial_bins(ny, nx)
    dev = fields.device
    keep = seg >= 0
    pix = torch.as_tensor(ind[keep], device=dev)
    bins = torch.as_tensor(seg[keep], device=dev)
    f = torch.fft.fftshift(torch.fft.fft2(fields.float()), dim=(-2, -1))
    psd = torch.abs(f) ** 2
    sums = torch.zeros((n, len(nr)), dtype=psd.dtype, device=dev)
    sums.index_add_(1, bins, psd.reshape(n, -1)[:, pix])
    return sums / torch.as_tensor(nr, dtype=psd.dtype, device=dev)


def radial_spectrum(field: torch.Tensor) -> torch.Tensor:
    """:func:`radial_spectra` of one (ny, nx) field."""
    return radial_spectra(field[None])[0]


def log_spectral_distance(ps1: torch.Tensor, ps2: torch.Tensor
                          ) -> torch.Tensor:
    """LSD between power spectra (log_spectral_distance.py:68-76):
    sqrt(sum((10*log10(ps1/ps2))^2)) / n."""
    n = ps1.shape[-1]
    d = 10.0 * torch.log10(ps1 / ps2)
    return torch.sqrt(torch.sum(d * d, dim=-1)) / n


def _finite_center(logs: torch.Tensor) -> torch.Tensor:
    """The mean log-spectrum with nonfinite bins set to 0: one zero-bin
    spectrum (log10 -> -inf) must not poison the shared center, and with it
    every centred spectrum."""
    center = torch.mean(logs, dim=0)
    return torch.where(torch.isfinite(center), center,
                       torch.zeros_like(center))


def _centered_logs(la: torch.Tensor, lb: torch.Tensor,
                   center: torch.Tensor):
    la, lb = la - center, lb - center
    return la, lb, torch.sum(la * la, dim=-1), torch.sum(lb * lb, dim=-1)


def _gemm_dists(la: torch.Tensor, lb: torch.Tensor, sq_a: torch.Tensor,
                sq_b: torch.Tensor, nbins: int) -> torch.Tensor:
    """sqrt(max(|a|^2 + |b|^2 - 2ab, 0)) / nbins for every (row, row) pair,
    the cross term one float32 matrix product with TF32 off."""
    with full_f32():
        cross = la @ lb.T
    d2 = torch.clamp(sq_a[:, None] + sq_b[None, :] - 2.0 * cross, min=0.0)
    return torch.sqrt(d2) / nbins


def pairwise_lsd(spectra_a: torch.Tensor, spectra_b: torch.Tensor
                 ) -> torch.Tensor:
    """All-pairs LSD matrix (Na, Nb), replacing the numba O(n^2) loop
    (log_spectral_distance.py:104-115).

    d(i, j) = sqrt(sum_k (L_i[k] - L_j[k])^2) / n with L = 10 log10(ps): the
    log-spectra are computed once per spectrum and the pair matrix is one
    GEMM through |a|^2 + |b|^2 - 2ab.  Both inputs are centred by a shared
    finite vector first: differences do not change, but the norms shrink to
    the spread, which keeps the float32 expansion's cancellation far below
    the distances.  Self-pairs land near 0, not at 0.0; populations exclude
    them by index (:func:`pairwise_lsd_offdiag`)."""
    la = 10.0 * torch.log10(spectra_a)
    lb = 10.0 * torch.log10(spectra_b)
    la, lb, sq_a, sq_b = _centered_logs(la, lb, _finite_center(la))
    return _gemm_dists(la, lb, sq_a, sq_b, spectra_a.shape[-1])


def pairwise_lsd_offdiag(spectra_a: torch.Tensor, spectra_b: torch.Tensor,
                         block: int = 2048) -> np.ndarray:
    """Flattened all-pairs LSD values without the same-index pairs, blocked
    to bound memory, fetched to the host in row-major order.

    The same deliberate cleanup as the JAX package (its docs/DESIGN.md §8):
    the reference skips i == j in its loop (log_spectral_distance.py:104-110)
    but then deletes flat indices 0, n, 2n, ... (:123-126), the first
    COLUMN, not the diagonal.  Here the same-index pairs themselves go, and
    no legitimate value is lost.  Each block's distances come from
    :func:`pairwise_lsd` of that block against all of `spectra_b`."""
    a, b = torch.as_tensor(spectra_a), torch.as_tensor(spectra_b)
    na, nb = len(a), len(b)
    out = []
    for i0 in range(0, na, block):
        hi = min(i0 + block, na)
        blk = pairwise_lsd(a[i0:hi], b).cpu().numpy()
        rows = np.arange(i0, hi)
        keep = np.ones(blk.shape, dtype=bool)
        in_range = rows < nb
        keep[np.nonzero(in_range)[0], rows[in_range]] = False
        out.append(blk[keep])
        beat_if_enabled()  # each block is a confirmed device->host fetch
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# Device-reduced pairwise-LSD population summary
# ---------------------------------------------------------------------------
#
# The evaluation battery consumes only each population's median and a
# bounded subsample (for a KDE plot), so this path reduces on the device and
# fetches a few MB instead of the 576M-value population at n = 1000.  The
# median is the EXACT pair of central order statistics, found by bisection on
# the float32 bit patterns: for non-negative floats the bit order is the
# value order, so 31 counting passes over recomputed distance blocks land on
# the data values themselves, without a device sort or an O(Na*Nb) buffer.

#: bit pattern of float32 +inf: every distance's bits lie in [0, this]
_INF_BITS = 0x7F800000
#: halvings that close [0, _INF_BITS] to one value (2^31 > _INF_BITS + 1)
_BISECT_STEPS = 31


def _lsd_summary_device(a_pad: torch.Tensor, b: torch.Tensor,
                        sub_rows: torch.Tensor, sub_cols: torch.Tensor, *,
                        n_real: int, block: int, exclude_same: bool):
    """(central order statistics (2,), mean, n_valid, subsample), all on
    the device; no host sync."""
    nbins = a_pad.shape[-1]
    dev = a_pad.device
    n_blocks = a_pad.shape[0] // block
    la = 10.0 * torch.log10(a_pad)
    lb = 10.0 * torch.log10(b)
    # the centre of pairwise_lsd, over the real (unpadded) rows
    la, lb, sq_a, sq_b = _centered_logs(la, lb, _finite_center(la[:n_real]))
    col_ids = torch.arange(b.shape[0], device=dev)

    def block_dists(i):
        """(block, nb) distances and validity of row block i."""
        r0 = i * block
        d = _gemm_dists(la[r0:r0 + block], lb, sq_a[r0:r0 + block], sq_b,
                        nbins)
        rows = torch.arange(r0, r0 + block, device=dev)[:, None]
        valid = (rows < n_real) & torch.isfinite(d)
        if exclude_same:
            valid &= rows != col_ids[None, :]
        return d, valid

    # counts in int64: the guard of pairwise_lsd_summary keeps the JAX
    # package's 2^32 limit all the same
    n_valid = torch.zeros((), dtype=torch.int64, device=dev)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(n_blocks):
        d, valid = block_dists(i)
        n_valid += valid.sum()
        total += torch.where(valid, d, 0.0).sum(dtype=torch.float64)
    mean = (total / torch.clamp(n_valid, min=1)).float()

    # the two central order statistics (0-based ranks), np.median semantics
    ks = torch.stack([(n_valid - 1) // 2, n_valid // 2])

    def count_leq(t):
        """How many valid distances are <= each of the two thresholds."""
        acc = torch.zeros(2, dtype=torch.int64, device=dev)
        for i in range(n_blocks):
            d, valid = block_dists(i)
            acc += (valid[:, :, None] & (d[:, :, None] <= t)).sum(dim=(0, 1))
        return acc

    # the smallest bits v with count_leq(float(v)) >= k+1 are exactly the
    # k-th smallest value; a fixed number of steps, so the host never waits
    lo = torch.zeros(2, dtype=torch.int32, device=dev)
    hi = torch.full((2,), _INF_BITS, dtype=torch.int32, device=dev)
    for _ in range(_BISECT_STEPS):
        mid = lo + (hi - lo) // 2
        found = count_leq(mid.view(torch.float32)) >= ks + 1
        lo, hi = torch.where(found, lo, mid + 1), torch.where(found, mid, hi)
    med_pair = lo.view(torch.float32)
    med_pair = torch.where(n_valid > 0, med_pair,
                           torch.full_like(med_pair, float("nan")))

    # natural-order subsample of the kept population (per-pair expansion on
    # the same centred log-spectra; the KDE consumer filters nonfinite)
    cross_s = torch.sum(la[sub_rows] * lb[sub_cols], dim=-1)
    d2_s = torch.clamp(sq_a[sub_rows] + sq_b[sub_cols] - 2.0 * cross_s,
                       min=0.0)
    sub = torch.sqrt(d2_s) / nbins
    return med_pair, mean, n_valid, sub


def _check_pair_count_capacity(na: int, nb: int) -> None:
    """The JAX package's device reducer counts pairs in uint32, so
    na*nb == 2^32 - 1 is the largest population it takes.  The port counts
    in int64 but keeps the same limit, so that both packages accept the same
    inputs."""
    if na * nb >= 2**32:
        raise ValueError(
            f"population of {na}x{nb} pairs exceeds the device reducer's "
            "uint32 count capacity (2^32); split the populations or use the "
            "full-fetch path (reduction='full')")


def _subsample_positions(na: int, nb: int, m_sub: int, n_kept: int,
                         exclude_same_index: bool):
    """(rows, cols) of an even stride of m_sub over the kept values, in the
    row-major order of :func:`pairwise_lsd_offdiag`'s concatenation."""
    idx = np.floor(np.linspace(0, n_kept - 1, m_sub)).astype(np.int64)
    if not exclude_same_index:
        return idx // nb, idx % nb
    n_excl = min(na, nb)
    boundary = n_excl * (nb - 1)
    in_excl = idx < boundary
    r = np.where(in_excl, idx // max(nb - 1, 1), 0)
    j = np.where(in_excl, idx % max(nb - 1, 1), 0)
    c = j + (j >= r)
    rem = idx - boundary
    return (np.where(in_excl, r, n_excl + rem // nb),
            np.where(in_excl, c, rem % nb))


def pairwise_lsd_summary(spectra_a: torch.Tensor, spectra_b: torch.Tensor,
                         subsample: int = 2_000_000, block: int = 2048,
                         exclude_same_index: bool = True
                         ) -> Dict[str, object]:
    """Device-reduced summary of :func:`pairwise_lsd_offdiag`'s population,
    on the spectra's device: median, mean and count over the FINITE kept
    values plus a natural-order subsample, without fetching or holding the
    O(Na*Nb) matrix.

    The median equals ``np.median(v[np.isfinite(v)])`` of the full path's
    population: both central order statistics are found exactly (the
    distances themselves agree with the full path's to GEMM-reassociation
    rounding).  One host sync, at the end.

    Returns dict(median, mean, n_valid, subsample (numpy))."""
    a = torch.as_tensor(spectra_a).float()
    b = torch.as_tensor(spectra_b).float().to(a.device)
    na, nb = len(a), len(b)
    n_kept = na * nb - (min(na, nb) if exclude_same_index else 0)
    _check_pair_count_capacity(na, nb)
    m_sub = int(min(subsample, n_kept))
    rows, cols = _subsample_positions(na, nb, m_sub, n_kept,
                                      exclude_same_index)

    na_pad = -(-na // block) * block
    a_pad = torch.cat([a, torch.ones((na_pad - na, a.shape[1]),
                                     dtype=a.dtype, device=a.device)])
    med_pair, mean, n_valid, sub = _lsd_summary_device(
        a_pad, b, torch.as_tensor(rows, device=a.device),
        torch.as_tensor(cols, device=a.device), n_real=na, block=block,
        exclude_same=exclude_same_index)
    med_pair = med_pair.cpu().numpy()
    beat_if_enabled()
    return {
        "median": float(np.mean(med_pair)),  # np.median's central average
        "mean": float(mean),
        "n_valid": int(n_valid),
        "subsample": sub.cpu().numpy(),
    }
