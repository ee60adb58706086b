from prdisagg_torch.baselines.rainfarm.core import (
    downscale_ensemble,
    downscale_spatiotemporal,
    estimate_alpha,
    estimate_beta,
)

__all__ = [
    "estimate_alpha",
    "estimate_beta",
    "downscale_spatiotemporal",
    "downscale_ensemble",
]
