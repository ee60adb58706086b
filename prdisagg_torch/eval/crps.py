"""CRPS evaluation and analysis: parity with generate_and_evaluate_crps.py and
analyze_crps_results.py, as the JAX package's eval/crps.py computes them.

For each real test sample: an n_members GAN ensemble conditioned on its daily
sum, CRPS against the real hourly field, area mean per hour.  The "random"
baseline scores a fixed ensemble of real training patches
(rainfarm_calibration_data.npy) against every sample
(generate_and_evaluate_crps.py:164-195).  The RainFARM arm scores the
baseline's ensembles the same way (baselines/rainfarm/pipeline.py).  All
run on the card by default; in the protocol, on the generator's device.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from prdisagg_torch.api.pretrained import PretrainedGenerator
from prdisagg_torch.baselines.rainfarm.pipeline import crps_rainfarm
from prdisagg_torch.core.device import resolve_device
from prdisagg_torch.ops.stats import (
    crps_ensemble,
    crps_ensemble_fixed,
    ensemble_spread,
)
from prdisagg_torch.parallel.mesh import all_gather_batch, shard_bounds
from prdisagg_torch.utils.watchdog import beat_if_enabled


def _score_one_sample(gen, real: torch.Tensor, dsum: torch.Tensor,
                      latents: torch.Tensor, n_members: int, mb: int,
                      norm_scale: float) -> torch.Tensor:
    """Area-mean CRPS row (24,) of ONE sample: `gen` (a ``Generator``) draws
    its n_members ensemble in mb-sized batches from `latents`
    (n_members, latent_dim), conditioned on the daily sum `dsum` (nd, nd)
    in mm; `real` is the (24, nd, nd) hourly field.  The single owner of the
    per-sample scoring math."""
    cond = (dsum / norm_scale)[None, ..., None]
    ens = torch.cat([
        gen(latents[i0:i0 + mb], cond.expand(mb, *cond.shape[1:]))[..., 0]
        * dsum[None, None]
        for i0 in range(0, n_members, mb)])
    return torch.mean(crps_ensemble(real, ens), dim=(1, 2))


def crps_gan(
    generator: PretrainedGenerator,
    reals_precip,
    n_members: int = 1000,
    seed: int = 354,
    norm_scale: float = 127.4,
    member_batch: int = 500,
    sample_chunk: int = 50,
) -> np.ndarray:
    """reals_precip: (n, 24, nd, nd) mm/h test fields (numpy or a tensor).
    Returns the area-mean CRPS (n, 24).

    The latents come from one ``torch.Generator`` on the generator's device,
    seeded with `seed` and drawn in sample order, so the result does not
    depend on `sample_chunk`: that only sets how many samples' rows are
    stacked on the device between two heartbeats.  Nothing is fetched to
    the host before the end.

    When the generator carries a data-parallel mesh
    (``PretrainedGenerator(mesh=...)`` / ``cli crps --dp N``), the chunk is
    rounded up to a multiple of the mesh size and each rank scores its own
    contiguous shard of each chunk's samples; every rank still draws every
    sample's latents in sample order, so each sample meets the latents it
    meets on one device, and the gathered rows equal the single-device
    rows exactly.  A collective: every rank calls it with the same
    arguments, and every rank returns all rows."""
    mb = min(member_batch, n_members)
    if n_members % mb != 0:
        raise ValueError(f"n_members {n_members} not divisible by {mb}")
    mesh = generator.mesh
    if mesh is not None:
        sample_chunk += (-sample_chunk) % mesh.size
    dev = generator.device
    reals = torch.as_tensor(reals_precip, dtype=torch.float32, device=dev)
    dsums = torch.sum(reals, dim=1)  # (n, nd, nd) mm
    rng = torch.Generator(device=dev).manual_seed(seed)
    gen, latent_dim = generator._gen, generator.cfg.latent_dim
    out = []
    with torch.inference_mode():
        for i0 in range(0, len(reals), sample_chunk):
            n = min(sample_chunk, len(reals) - i0)
            # the chunk's samples this rank scores; a last chunk pads to
            # the mesh, and pads score nothing and draw nothing
            lo, hi = (0, n) if mesh is None else shard_bounds(
                n + (-n) % mesh.size, mesh)
            rows = []
            for i in range(n):
                latents = torch.randn((n_members, latent_dim), generator=rng,
                                      device=dev)
                if lo <= i < hi:
                    rows.append(_score_one_sample(
                        gen, reals[i0 + i], dsums[i0 + i], latents,
                        n_members, mb, norm_scale))
            if mesh is None:
                out.append(torch.stack(rows))  # device rows: no host sync
            else:
                mine = torch.zeros((hi - lo, reals.shape[1]), device=dev)
                if rows:
                    mine[:len(rows)] = torch.stack(rows)
                out.append(all_gather_batch(mine, mesh)[:n])
            beat_if_enabled()  # host-loop liveness for a supervisor
    return torch.cat(out).cpu().numpy()


def crps_random_baseline(reals_precip, baseline_patches, chunk: int = 64,
                         device="cuda") -> np.ndarray:
    """Score a fixed real-patch ensemble (M, 24, nd, nd) against every
    sample (generate_and_evaluate_crps.py:193-195) on `device`.  Returns
    (n, 24).

    The ensemble is fixed, so its spread term (the O(M log M) sort) is
    computed once for all samples.  The ragged last chunk is padded with
    ones to the chunk's shape and its rows dropped.  Each chunk holds
    |ensemble - sample| for `chunk` samples at once: 7.9 GB at chunk 64,
    M 5000 and 24 x 16 x 16."""
    dev = resolve_device(device)
    ens = torch.as_tensor(baseline_patches, dtype=torch.float32, device=dev)
    reals = torch.as_tensor(reals_precip, dtype=torch.float32, device=dev)
    outs = []
    with torch.inference_mode():
        spread = ensemble_spread(ens)
        for i0 in range(0, len(reals), chunk):
            r = reals[i0:i0 + chunk]
            c = len(r)
            if c < chunk:
                r = torch.cat([r, torch.ones((chunk - c, *r.shape[1:]),
                                             device=dev)])
            crps = crps_ensemble_fixed(r, ens, spread)
            outs.append(torch.mean(crps, dim=(2, 3))[:c])
            beat_if_enabled()
    return torch.cat(outs).cpu().numpy()


def analyze(
    gan: np.ndarray,
    random_baseline: np.ndarray,
    rainfarm: Optional[np.ndarray] = None,
    outdir: str = "data",
    n_bootstrap: int = 10_000,
    seed: int = 0,
) -> dict:
    """Means, 1-sample t-test on (gan - random), bootstrap CI
    (analyze_crps_results.py:9-47).  Writes crps_results.json."""
    from scipy import stats

    res = {
        "gan": float(gan.mean()),
        "random": float(random_baseline.mean()),
    }
    if rainfarm is not None:
        res["rainfarm"] = float(np.asarray(rainfarm).mean())

    diff = (gan - random_baseline).ravel()
    _, p = stats.ttest_1samp(diff, popmean=0)
    res["ttest_p_gan_vs_random"] = float(p)

    rng = np.random.RandomState(seed)
    means = np.array([
        diff[rng.choice(len(diff), size=len(diff), replace=True)].mean()
        for _ in range(n_bootstrap)
    ])
    res["bootstrap_diff"] = {
        "mean": float(diff.mean()),
        "lower": float(np.percentile(means, 1)),
        "upper": float(np.percentile(means, 99)),
    }
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "crps_results.json"), "w") as f:
        json.dump(res, f, indent=2)
    return res


def run_crps_evaluation(
    generator: PretrainedGenerator,
    reals_precip,
    baseline_patches,
    n_members: int = 1000,
    outdir: str = "data",
    seed: int = 354,
    rainfarm: Optional[tuple] = None,
    n_bootstrap: int = 10_000,
) -> dict:
    """The reference CRPS protocol as one call: GAN against the random
    climatology (generate_and_evaluate_crps.py:161-195), plus, when
    ``rainfarm=(alpha, beta, RainFarmConfig)`` is given, the RainFARM arm
    (crps_results_rainfarm.pkl), which the analysis then includes.  Every
    arm runs on the generator's device.  The single owner of the artifact
    names.  ``gan_seconds`` / ``random_seconds`` / ``rainfarm_seconds``
    are each arm's wall time (the last None without the arm).

    With a data-parallel generator the GAN arm is collective; the other
    ranks then return ``{"gan", "gan_seconds"}`` alone, and rank 0 runs
    the rest and writes every file."""
    t0 = time.perf_counter()
    gan = crps_gan(generator, reals_precip, n_members=n_members, seed=seed)
    t_gan = time.perf_counter() - t0
    if generator.mesh is not None and generator.mesh.rank != 0:
        return {"gan": gan, "gan_seconds": t_gan}
    rnd = crps_random_baseline(reals_precip, baseline_patches,
                               device=generator.device)
    t_rnd = time.perf_counter() - t0 - t_gan
    os.makedirs(outdir, exist_ok=True)
    rf, t_rf = None, None
    if rainfarm is not None:
        alpha, beta, rf_cfg = rainfarm
        t1 = time.perf_counter()
        rf = crps_rainfarm(
            reals_precip, alpha, beta, rf_cfg, n_members=n_members,
            outfile=os.path.join(outdir, "crps_results_rainfarm.pkl"),
            device=generator.device)
        t_rf = time.perf_counter() - t1
    with open(os.path.join(
        outdir, f"crps_results_n_sample{len(reals_precip)}.pkl"
    ), "wb") as f:
        pickle.dump((gan, rnd), f)
    return {"gan": gan, "random": rnd, "rainfarm": rf,
            "gan_seconds": t_gan, "random_seconds": t_rnd,
            "rainfarm_seconds": t_rf,
            "analysis": analyze(gan, rnd, rf, outdir=outdir,
                                n_bootstrap=n_bootstrap)}
