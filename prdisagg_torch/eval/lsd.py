"""Log-spectral-distance evaluation: parity with log_spectral_distance.py,
as the JAX package's eval/lsd.py computes it.

Radially averaged power spectra of every hourly field, then all-pairs LSD
within and between the {real, generated, rainfarm} sample sets, saved as
.npy arrays plus a KDE comparison plot.  Everything runs on `device` (the
card by default).  Two reductions:

* ``reduction="full"``: fetch and save the complete distance populations
  (the reference's artifact contract: 576M float32 values per population at
  n = 1000);
* ``reduction="device"``: reduce on the device
  (ops/stats.pairwise_lsd_summary: exact central order statistics by
  bit-pattern bisection) and save ``*_subsample.npy`` and a summary json
  instead of the full arrays.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from prdisagg_torch.core.device import resolve_device
from prdisagg_torch.ops.stats import (
    pairwise_lsd_offdiag,
    pairwise_lsd_summary,
    radial_spectra,
)
from prdisagg_torch.utils.watchdog import beat_if_enabled


class LsdResult(dict):
    """Population arrays (full distances, or KDE subsamples in device mode)
    plus `.medians`: the exact per-population median over finite values,
    the same in both modes up to GEMM-reassociation rounding."""

    def __init__(self, *args, medians: Optional[Dict[str, float]] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.medians: Dict[str, float] = medians or {}


def spectra_of_fields(fields, chunk: int = 2048,
                      device="cuda") -> torch.Tensor:
    """fields: (n, 24, ny, nx), numpy or a tensor -> (n*24, n_bins) radial
    spectra on `device`; the hour axis is flattened into the sample axis
    (log_spectral_distance.py:91-99).  Moved to the device a chunk at a
    time."""
    dev = resolve_device(device)
    flat = fields.reshape(-1, *fields.shape[-2:])
    out = []
    for i0 in range(0, len(flat), chunk):
        part = torch.as_tensor(flat[i0:i0 + chunk], dtype=torch.float32)
        out.append(radial_spectra(part.to(dev)))
        beat_if_enabled()
    return torch.cat(out)


def _finite_median(v: np.ndarray) -> float:
    finite = v[np.isfinite(v)]
    return float(np.median(finite)) if len(finite) else float("nan")


def run_lsd_evaluation(
    real,
    generated,
    generated_rainfarm=None,
    n_samples: int = 1000,
    outdir: str = ".",
    plotdir: str = "plots",
    make_plot: bool = True,
    reduction: str = "full",
    device="cuda",
) -> LsdResult:
    """Inputs are (n, 24, ny, nx) mm/h sample tensors (the .npy artifacts of
    the evaluation's phase 2).  Returns the distance populations (full or
    subsampled per `reduction`) with exact medians attached."""
    if reduction not in ("full", "device"):
        raise ValueError(f"reduction must be 'full' or 'device', got "
                         f"{reduction!r}")
    real = real[:n_samples]
    generated = generated[:n_samples]

    sp_real = spectra_of_fields(real, device=device)
    sp_gen = spectra_of_fields(generated, device=device)

    pairs = [
        ("real", sp_real, sp_real),
        ("gen", sp_gen, sp_gen),
        ("between_gen_real", sp_gen, sp_real),
    ]
    if generated_rainfarm is not None:
        sp_rf = spectra_of_fields(generated_rainfarm[:n_samples],
                                  device=device)
        pairs += [
            ("gen_rainfarm", sp_rf, sp_gen),
            ("between_gen_rainfarm_real", sp_rf, sp_real),
        ]

    medians: Dict[str, float] = {}
    summaries: Dict[str, Dict[str, float]] = {}
    dists = LsdResult()
    for k, a, b in pairs:
        if reduction == "device":
            s = pairwise_lsd_summary(a, b)
            dists[k] = s["subsample"]
            medians[k] = s["median"]
            summaries[k] = {
                "median": s["median"], "mean": s["mean"],
                "n_valid": s["n_valid"],
                "subsample_size": len(s["subsample"]),
            }
        else:
            dists[k] = pairwise_lsd_offdiag(a, b)
            medians[k] = _finite_median(dists[k])
    dists.medians = medians

    os.makedirs(outdir, exist_ok=True)
    names = {
        "real": f"log_spectral_distances_real_n{n_samples}.npy",
        "gen": f"log_spectral_distances_gen_n{n_samples}.npy",
        "gen_rainfarm": f"log_spectral_distances_gen_rainfarm_n{n_samples}.npy",
        "between_gen_real":
            f"log_spectral_distances_between_gen_real_n{n_samples}.npy",
        "between_gen_rainfarm_real":
            f"log_spectral_distances_between_gen_rainfarm_real_n{n_samples}"
            ".npy",
    }
    if reduction == "device":
        for k, v in dists.items():
            np.save(os.path.join(
                outdir, names[k].replace(".npy", "_subsample.npy")), v)
        with open(os.path.join(
                outdir,
                f"log_spectral_distances_summary_n{n_samples}.json"), "w") as fh:
            json.dump(summaries, fh, indent=1)
    else:
        for k, v in dists.items():
            np.save(os.path.join(outdir, names[k]), v)

    if make_plot:
        _kde_plot(dists, plotdir, n_samples)
    return dists


def _kde_plot(dists: Dict[str, np.ndarray], plotdir: str,
              n_samples: int) -> None:
    """KDE of each population (log_spectral_distance.py:142-146), on a
    deterministic stride of at most 2M finite values per curve: scipy's
    gaussian_kde is O(n * gridsize), hours per curve at 576M values (the
    saved .npy files keep the full populations in full mode)."""
    from prdisagg_torch.utils.plotting import _pyplot

    _, plt = _pyplot()
    import seaborn as sns

    os.makedirs(plotdir, exist_ok=True)
    sns.set_palette("colorblind")
    plt.figure()
    labels = {
        "real": "obs", "gen": "generated",
        "gen_rainfarm": "generated rainfarm",
        "between_gen_real": "between obs and generated",
        "between_gen_rainfarm_real": "between obs and generated rainfarm",
    }
    kde_cap = 2_000_000
    for k, v in dists.items():
        finite = v[np.isfinite(v)]
        if len(finite) > kde_cap:
            finite = finite[:: len(finite) // kde_cap + 1]
        if len(finite):
            sns.kdeplot(finite, label=labels[k])
    plt.xlabel("log spectral distance")
    plt.legend()
    sns.despine()
    plt.savefig(os.path.join(plotdir,
                             f"log_spectral_distances_n{n_samples}.svg"))
    plt.close("all")
