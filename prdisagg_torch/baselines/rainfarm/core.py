"""RainFARM spatiotemporal stochastic downscaling, the non-ML baseline.

The reference's adapted RainFARM (rainfarm/rainfarm_temporal_downscaling.py)
as the JAX package computes it (its baselines/rainfarm/core.py): calibrate
spatial (alpha) and temporal (beta) spectral slopes from training patches,
then synthesize hourly fields from a daily sum through random-phase Fourier
noise shaped by the power law sqrt(om^-beta * k^2^(-alpha/2)),
exponentiated and rescaled so that the per-gridpoint time sum equals the
daily field exactly: the GAN's conservation property.

Every function runs on its inputs' device, with ``torch.fft`` (cuFFT on the
card).  Draws come from a ``torch.Generator`` the caller passes; the
``*_from_phase`` functions take the uniform phases themselves, so a test can
hand the port and the JAX package the same ones.  They are batched: phases
(..., n_t, ny, nx) with the daily sums broadcasting against (..., ny, nx),
so one call makes a whole ensemble.

The slope estimators compute their power spectra in float64 (complex128),
as numpy before 2.0 did for the reference's float32 batches (numpy 2 keeps
a float32 FFT in complex64): a float32 FFT leaves tiny non-zero powers
where float64 gives exactly 0, and the finite mask then keeps points that
the reference drops.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from prdisagg_torch.ops.core import full_f32


def _f64(p) -> torch.Tensor:
    """A float64 tensor of `p` (numpy or a tensor), on `p`'s device."""
    return torch.as_tensor(p).to(torch.float64)


def _log_slope(log_k: np.ndarray, log_ps: torch.Tensor,
               valid: torch.Tensor) -> float:
    """Minus the slope of the least-squares line through (log_k, log_ps) over
    the valid points whose log_k lies in the middle 2/3 of the valid range
    (rainfarm_temporal_downscaling.py:6-19): the line ``np.polyfit(x, y, 1)``
    fits, in closed form, in float64.  `log_k` is the wavenumber grid's log
    (computed in numpy, so the range bounds equal the reference's bit for
    bit) and broadcasts against `log_ps`; `valid` marks the points the
    reference keeps."""
    lk = torch.as_tensor(log_k, device=log_ps.device).expand_as(log_ps)
    lk_min = torch.where(valid, lk, math.inf).min()
    lk_max = torch.where(valid, lk, -math.inf).max()
    lk_range = lk_max - lk_min
    sel = (valid & (lk >= lk_min + lk_range / 6.0)
           & (lk <= lk_max - lk_range / 6.0))
    n = sel.sum()
    x = torch.where(sel, lk, 0.0)
    y = torch.where(sel, log_ps, 0.0)
    dx = torch.where(sel, x - x.sum() / n, 0.0)
    slope = (dx * (y - y.sum() / n)).sum() / (dx * dx).sum()
    return float(-slope)


def _log_power(fp: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.abs(fp) ** 2)


def _spatial_log_slope(log_ps: torch.Tensor, ny: int, nx: int) -> float:
    k = np.sqrt(np.fft.fftfreq(ny)[:, None] ** 2
                + np.fft.fftfreq(nx)[None, :] ** 2)
    with np.errstate(divide="ignore"):
        log_k = np.log(k)
    valid = (torch.as_tensor(k != 0, device=log_ps.device)
             & torch.isfinite(log_ps))
    return _log_slope(log_k, log_ps, valid)


def estimate_beta(p_samples) -> float:
    """Temporal spectral slope from samples (n, n_t, ny, nx)
    (rainfarm_temporal_downscaling.py:22-51)."""
    p = _f64(p_samples)
    n_t = p.shape[1]
    log_ps = _log_power(torch.fft.fft(p, dim=1))
    om = np.abs(2 * np.pi * np.fft.fftfreq(n_t))[:, None, None]
    with np.errstate(divide="ignore"):
        log_om = np.log(om)
    valid = (torch.as_tensor(om != 0, device=p.device)
             & torch.isfinite(log_ps))
    return _log_slope(log_om, log_ps, valid)


def estimate_alpha(p_samples) -> float:
    """Spatial spectral slope from samples (n, n_t, ny, nx)
    (rainfarm_temporal_downscaling.py:54-81)."""
    p = _f64(p_samples)
    return _spatial_log_slope(_log_power(torch.fft.fftn(p, dim=(2, 3))),
                              p.shape[2], p.shape[3])


def estimate_alpha_single(precip) -> float:
    """Spatial slope from one 2-D field (rainfarm_pysteps.py:86-91)."""
    p = _f64(precip)
    return _spatial_log_slope(_log_power(torch.fft.fft2(p)), *p.shape)


def _k_sqr(ny: int, nx: int, d: float = 1.0) -> np.ndarray:
    """Squared wavenumbers of an (ny, nx) grid in float32."""
    ki = np.fft.fftfreq(ny, d=d).astype(np.float32)
    kj = np.fft.fftfreq(nx, d=d).astype(np.float32)
    return ki[:, None] ** 2 + kj[None, :] ** 2


@lru_cache(maxsize=16)
def _spatiotemporal_amplitude(n_t: int, ny: int, nx: int, alpha: float,
                              beta: float, device: torch.device
                              ) -> torch.Tensor:
    """sqrt(om^-beta * k^2^(-alpha/2)) as complex64 (n_t, ny, nx), zero
    where om or k is 0 (the reference computes inf there and overwrites it
    after, :104-115).  The power of a negative frequency is complex: om is
    complex with a +0.0 imaginary part, so its power lies on the principal
    branch, as in the JAX package (its core.py:80,89); a -0.0 imaginary part
    would put it on the conjugate branch.  Built on the CPU, so the card and
    the CPU shape their noise with the same numbers."""
    om = (2 * np.pi * np.fft.fftfreq(n_t)).astype(np.float32)
    om[0] = 1.0
    om_c = torch.complex(torch.from_numpy(om), torch.zeros(n_t))
    k_sqr = _k_sqr(ny, nx)
    k_safe = torch.from_numpy(np.where(k_sqr == 0.0, 1.0, k_sqr)
                              .astype(np.float32))
    amp = torch.sqrt(om_c[:, None, None] ** (-beta)
                     * k_safe[None] ** (-alpha / 2.0))
    mask = ((torch.arange(n_t) != 0)[:, None, None]
            & torch.from_numpy(k_sqr != 0.0)[None])
    return (amp * mask).to(device)


def _unit_phasor(phase: torch.Tensor) -> torch.Tensor:
    return torch.exp(1j * 2 * math.pi * phase)


def _normalized_exp(g: torch.Tensor, dims) -> torch.Tensor:
    """exp(g / std(g)), the population std of each realization over
    `dims`."""
    return torch.exp(g / torch.std(g, dim=dims, correction=0, keepdim=True))


def downscale_from_phase(precip, alpha: float, beta: float,
                         phase: torch.Tensor) -> torch.Tensor:
    """RainFARM realizations from given uniform phases in [0, 1)
    (rainfarm_temporal_downscaling.py:84-127).

    phase: (..., n_t, ny, nx) float32, one (n_t, ny, nx) block per
    realization; precip: daily sums broadcasting against (..., ny, nx).
    Returns (..., n_t, ny, nx) on phase's device, each realization's time
    sum equal to its daily sum."""
    n_t, ny, nx = phase.shape[-3:]
    precip = torch.as_tensor(precip, dtype=torch.float32, device=phase.device)
    amp = _spatiotemporal_amplitude(n_t, ny, nx, float(alpha), float(beta),
                                    phase.device)
    dims = (-3, -2, -1)
    g = torch.fft.ifftn(_unit_phasor(phase) * amp, dim=dims).real
    r = _normalized_exp(g, dims)
    return r * precip.unsqueeze(-3) / r.sum(dim=-3, keepdim=True)


def downscale_spatiotemporal(precip: torch.Tensor, alpha: float, beta: float,
                             ds_t_factor: int,
                             generator: torch.Generator) -> torch.Tensor:
    """One stochastic hourly realization of a daily-sum field (ny, nx):
    (ds_t_factor, ny, nx) whose per-gridpoint time sum is precip."""
    phase = torch.rand((ds_t_factor, *precip.shape), generator=generator,
                       device=precip.device)
    return downscale_from_phase(precip, alpha, beta, phase)


def downscale_ensemble(precip: torch.Tensor, alpha: float, beta: float,
                       ds_t_factor: int, generator: torch.Generator,
                       n_members: int) -> torch.Tensor:
    """(n_members, ds_t_factor, ny, nx) realizations of one daily-sum field,
    their phases drawn in one call."""
    phase = torch.rand((n_members, ds_t_factor, *precip.shape),
                       generator=generator, device=precip.device)
    return downscale_from_phase(precip, alpha, beta, phase)


# ---------------------------------------------------------------------------
# Pure spatial RainFARM (Rebora 2006; the pysteps port, rainfarm_pysteps.py)
# ---------------------------------------------------------------------------

def _pad_symmetric(x: torch.Tensor, rad: int) -> torch.Tensor:
    """Pad the last two axes by `rad`, repeating the edge (numpy's
    "symmetric", scipy.ndimage's "reflect"; torch's "reflect" does not
    repeat it)."""
    if rad == 0:
        return x
    if rad > min(x.shape[-2:]):
        raise ValueError(f"pad {rad} exceeds the field {tuple(x.shape[-2:])}")
    x = torch.cat([x[..., :rad].flip(-1), x, x[..., -rad:].flip(-1)], dim=-1)
    return torch.cat([x[..., :rad, :].flip(-2), x, x[..., -rad:, :].flip(-2)],
                     dim=-2)


def _balanced_spatial_average(x: torch.Tensor,
                              kernel: torch.Tensor) -> torch.Tensor:
    """convolve(x, k) / convolve(ones, k) over the last two axes with
    scipy.ndimage's 'reflect' boundaries (rainfarm_pysteps.py:34-36), in
    full float32 (no TF32)."""
    rad = kernel.shape[0] // 2
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    xp = _pad_symmetric(x.reshape(-1, 1, h, w), rad)
    k4 = kernel.to(xp).flip(0, 1)[None, None]  # ndimage flips the kernel
    with full_f32():
        num = F.conv2d(xp, k4)
        den = F.conv2d(torch.ones_like(xp[:1]), k4)
    return (num / den).reshape(*lead, h, w)


def _tophat(ds_factor: int) -> np.ndarray:
    """The normalized disc of radius round(ds_factor / sqrt(pi))."""
    rad = int(round(ds_factor / np.sqrt(np.pi)))
    mx, my = np.mgrid[-rad: rad + 0.01, -rad: rad + 0.01]
    tophat = ((mx ** 2 + my ** 2) <= rad ** 2).astype(np.float32)
    return tophat / tophat.sum()


def downscale_spatial_from_phase(precip, alpha: float, ds_factor: int,
                                 phase: torch.Tensor) -> torch.Tensor:
    """Pure spatial RainFARM downscaling from given uniform phases
    (rainfarm_pysteps.py:39-125): an (m, n) rain-rate field becomes
    (m*ds_factor, n*ds_factor), conserving tophat-window local averages.

    phase: (..., m*ds_factor, n*ds_factor), one block per realization;
    precip: (m, n) or broadcasting against (..., m, n).  Estimate alpha
    beforehand with :func:`estimate_alpha_single` when it is unknown."""
    md, nd_ = phase.shape[-2:]
    dev = phase.device
    precip = torch.as_tensor(precip, dtype=torch.float32, device=dev)
    k_sqr = _k_sqr(md, nd_, d=1.0 / ds_factor)
    k_safe = np.where(k_sqr == 0.0, 1.0, k_sqr).astype(np.float32)
    amp = torch.sqrt(torch.from_numpy(k_safe) ** (-float(alpha) / 2.0))
    amp = (amp * torch.from_numpy(k_sqr != 0.0)).to(dev)
    g = torch.fft.ifft2(_unit_phasor(phase) * amp).real
    r = _normalized_exp(g, (-2, -1))
    p_u = precip.repeat_interleave(ds_factor, dim=-2).repeat_interleave(
        ds_factor, dim=-1)
    tophat = torch.from_numpy(_tophat(ds_factor))
    p_agg = _balanced_spatial_average(p_u, tophat)
    r_agg = _balanced_spatial_average(r, tophat)
    return r * p_agg / r_agg


def downscale_spatial(precip: torch.Tensor, alpha: float, ds_factor: int,
                      generator: torch.Generator) -> torch.Tensor:
    """One realization of :func:`downscale_spatial_from_phase`, its phases
    drawn from `generator` on precip's device."""
    m, n = precip.shape
    phase = torch.rand((m * ds_factor, n * ds_factor), generator=generator,
                       device=precip.device)
    return downscale_spatial_from_phase(precip, alpha, ds_factor, phase)
