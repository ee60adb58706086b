"""The RainFARM pipeline: calibration, generation and CRPS scoring.

The reference chain rainfarm_calibrate.py -> rainfarm_generate.py ->
rainfarm_generate_crps.py, as the JAX package runs it (its
baselines/rainfarm/pipeline.py), with the same artifact names.  Everything
runs on the card unless the caller passes a CPU dataset or ``device="cpu"``.
Draws come from one ``torch.Generator`` on the device, seeded as the JAX
package seeds its keys; the streams differ from JAX's, so results agree with
the JAX package in distribution, and exactly where the phases are given.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from prdisagg_torch.baselines.rainfarm.core import (
    downscale_from_phase,
    estimate_alpha,
    estimate_beta,
)
from prdisagg_torch.core.config import RainFarmConfig
from prdisagg_torch.core.device import resolve_device
from prdisagg_torch.data.sampler import DeviceDataset
from prdisagg_torch.ops.stats import crps_ensemble
from prdisagg_torch.utils.watchdog import beat_if_enabled


def calibrate(
    ds: DeviceDataset,
    cfg: RainFarmConfig,
    outdir: str = "data",
    save_calibration_batch: bool = True,
):
    """Estimate (alpha, beta) over cfg.n_repeat independent cfg.n_calib-patch
    draws (rainfarm_calibrate.py:66-98), drawn in order from one generator
    on the dataset's device seeded with cfg.seed (the patch gather kernel on
    the card).  Saves spectral_slopes_{i}.pkl per repeat, a tuple of two
    floats, and the repeat-0 batch as rainfarm_calibration_data.npy (the
    "random" CRPS baseline of generate_and_evaluate_crps.py:164).

    Returns the list of (alpha, beta)."""
    os.makedirs(outdir, exist_ok=True)
    gen = torch.Generator(device=ds.device).manual_seed(cfg.seed)
    slopes = []
    for i in range(cfg.n_repeat):
        batch = ds.sample_patches_raw(cfg.n_calib, gen)
        if bool(torch.isnan(batch).any()):
            raise ValueError(f"calibration draw {i} holds NaN values")
        alpha, beta = estimate_alpha(batch), estimate_beta(batch)
        slopes.append((alpha, beta))
        with open(os.path.join(outdir, f"spectral_slopes_{i}.pkl"), "wb") as f:
            pickle.dump((alpha, beta), f)
        if i == 0 and save_calibration_batch:
            np.save(os.path.join(outdir, "rainfarm_calibration_data.npy"),
                    batch.cpu().numpy())
    return slopes


def generate_for_daily_sums(daily_sums, alpha: float, beta: float,
                            cfg: RainFarmConfig, seed: int = 0,
                            device="cuda") -> np.ndarray:
    """One realization per daily-sum field (n, ny, nx) (rainfarm_generate.py
    :23), the phases of all n drawn in one call from a generator on
    `device` seeded with `seed`.  Returns (n, ds_t_factor, ny, nx)."""
    dev = resolve_device(device)
    dsums = torch.as_tensor(daily_sums, dtype=torch.float32, device=dev)
    rng = torch.Generator(device=dev).manual_seed(seed)
    phase = torch.rand((len(dsums), cfg.ds_t_factor, *dsums.shape[1:]),
                       generator=rng, device=dev)
    return downscale_from_phase(dsums, alpha, beta, phase).cpu().numpy()


def generate_and_plot(
    reals: np.ndarray,
    alpha: float,
    beta: float,
    cfg: RainFarmConfig,
    plotdir: str = "plots_generated_rainfarm",
    datadir: str = "data",
    n_map_conditions: int = 20,
    n_fake_per_real: int = 10,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """RainFARM generation evaluation artifacts (rainfarm_generate.py:30-156).

    Under `plotdir`, the reference's plots_generated_rainfarm/ names:
      * ecdf_allx_rainfarm.png / ecdf_rainfarm.png: two-panel ECDFs of the
        hourly area means and the flattened fields, full-range and zoomed;
      * generated_precip_rainfarm_{i:04d}_allhours.png and
        generated_precip_rainfarm_{i:04d}.png (every 3rd hour): map grids of
        one real day against `n_fake_per_real` RainFARM realizations;
    and one realization per real day as
    `datadir`/generated_samples_rainfarm.npy (rainfarm_generate.py:25).
    Needs matplotlib and seaborn.

    reals: (n, nhours, ny, nx) mm/h hourly fields.  Returns the generated
    (n, nhours, ny, nx) array."""
    import seaborn as sns

    from prdisagg_torch.ops.stats import ecdf_plot
    from prdisagg_torch.utils.plotting import (
        _pyplot,
        close_all,
        map_comparison_grid,
    )

    _, plt = _pyplot()
    os.makedirs(plotdir, exist_ok=True)
    os.makedirs(datadir, exist_ok=True)
    reals = np.asarray(reals)
    dsums = reals.sum(axis=1)
    dev = resolve_device(device)

    generated = generate_for_daily_sums(dsums, alpha, beta, cfg, seed=seed,
                                        device=dev)
    np.save(os.path.join(datadir, "generated_samples_rainfarm.npy"), generated)

    # two-panel ECDFs, full-range then zoomed (rainfarm_generate.py:38-65)
    sns.set_palette("colorblind")
    plt.figure()
    ax1 = plt.subplot(211)
    plt.plot(*ecdf_plot(generated.mean(axis=(2, 3))), label="gen")
    plt.plot(*ecdf_plot(reals.mean(axis=(2, 3))), label="real")
    plt.legend(loc="upper left")
    sns.despine()
    plt.xlabel("mm/h")
    plt.ylabel("ecdf areamean")
    plt.semilogx()
    ax2 = plt.subplot(212)
    plt.plot(*ecdf_plot(generated), label="gen")
    plt.plot(*ecdf_plot(reals), label="real")
    plt.legend(loc="upper left")
    sns.despine()
    plt.ylabel("ecdf")
    plt.xlabel("mm/h")
    plt.semilogx()
    plt.tight_layout()
    plt.savefig(os.path.join(plotdir, "ecdf_allx_rainfarm.png"), dpi=200)
    ax1.set_xlim(xmin=0.5)
    ax1.set_ylim(ymin=0.8, ymax=1.01)
    ax2.set_xlim(xmin=0.1)
    ax2.set_ylim(ymin=0.6, ymax=1.01)
    plt.savefig(os.path.join(plotdir, "ecdf_rainfarm.png"), dpi=200)
    close_all()

    # per-condition map grids: real hours against n_fake_per_real
    # realizations (rainfarm_generate.py:71-156)
    rng = torch.Generator(device=dev).manual_seed(seed + 1)
    for i in range(min(n_map_conditions, len(reals))):
        beat_if_enabled()
        phase = torch.rand((n_fake_per_real, cfg.ds_t_factor,
                            *dsums.shape[1:]), generator=rng, device=dev)
        ens = downscale_from_phase(dsums[i], alpha, beta, phase).cpu().numpy()
        for every, suffix in ((1, "_allhours"), (3, "")):
            fig = map_comparison_grid(reals[i], ens, dsums[i],
                                      fractions=False, every=every)
            fig.savefig(os.path.join(
                plotdir, f"generated_precip_rainfarm_{i + 1:04d}{suffix}.png"))
            close_all()
    return generated


def _score_one_sample(real: torch.Tensor, dsum: torch.Tensor, alpha: float,
                      beta: float, phases: torch.Tensor) -> torch.Tensor:
    """Area-mean CRPS row (n_t,) of ONE sample: the RainFARM ensemble of
    `dsum` (ny, nx) from the phases (n_members, n_t, ny, nx), scored against
    the real hourly field `real` (n_t, ny, nx)
    (rainfarm_generate_crps.py:23-36).  The single owner of the per-sample
    scoring math."""
    ens = downscale_from_phase(dsum, alpha, beta, phases)
    return torch.mean(crps_ensemble(real, ens), dim=(1, 2))


def crps_rainfarm(
    reals,
    alpha: float,
    beta: float,
    cfg: RainFarmConfig,
    n_members: int = 1000,
    seed: int = 0,
    outfile: str | None = None,
    sample_chunk: int = 50,
    device="cuda",
) -> np.ndarray:
    """Area-mean per-hour CRPS of n_members RainFARM ensembles against each
    real hourly field (rainfarm_generate_crps.py:23-36).

    reals: (n, nhours, ny, nx) mm/h (numpy or a tensor).  Returns (n, nhours)
    and, with `outfile`, pickles it there.

    Each sample's phases are drawn in sample order from one generator on
    `device` seeded with `seed`, and one sample's ensemble is in flight at a
    time (49 MB of complex64 at 1000 members of 24 x 16 x 16), so
    `sample_chunk` changes nothing in the result: it only sets how many
    samples' rows stack up on the device between two heartbeats."""
    dev = resolve_device(device)
    reals_t = torch.as_tensor(reals, dtype=torch.float32, device=dev)
    dsums = torch.sum(reals_t, dim=1)
    rng = torch.Generator(device=dev).manual_seed(seed)
    shape = (n_members, cfg.ds_t_factor, *reals_t.shape[2:])
    out = []
    with torch.inference_mode():
        for i0 in range(0, len(reals_t), sample_chunk):
            rows = [_score_one_sample(real, dsum, alpha, beta,
                                      torch.rand(shape, generator=rng,
                                                 device=dev))
                    for real, dsum in zip(reals_t[i0:i0 + sample_chunk],
                                          dsums[i0:i0 + sample_chunk])]
            out.append(torch.stack(rows))  # device rows: no host sync
            beat_if_enabled()
    res = torch.cat(out).cpu().numpy()
    if outfile:
        os.makedirs(os.path.dirname(outfile) or ".", exist_ok=True)
        with open(outfile, "wb") as f:
            pickle.dump(res, f)
    return res
