"""Model configuration of the generator and critic.

Field for field the same architecture knobs as the JAX package's
``ModelConfig``, so a weight file, a test or a CLI flag names the same
network in both packages.  The JAX-only ``spatial_axis`` (SPMD sharding of
activations) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Generator / critic architecture.

    Defaults replicate the reference networks
    (generator: gan_train_cwgangp_pixelnorm.py:312-357,
    critic: gan_train_cwgangp_pixelnorm.py:272-309).  The generator's initial
    latent grid scales with ndomain//8, which subsumes the large-domain
    variant (alternative_domains/gan_train_cwgangp_pixelnorm_largedomain.py).
    """

    ndomain: int = 16
    nhours: int = 24
    latent_dim: int = 100
    n_cond_channels: int = 1
    gen_channels: Tuple[int, ...] = (256, 128, 64)
    base_channels: int = 256        # channels of the initial latent grid
    critic_channels: Tuple[int, ...] = (64, 128, 256, 256)
    leak: float = 0.2
    dropout_rate: float = 0.25
    init_stddev: float = 0.02
    # Numerical policy: parameters and the conservation softmax always stay
    # float32; conv/matmul inputs run in the compute dtype.  bfloat16 is the
    # training default; serving defaults to float32 (api/pretrained.py), the
    # reference's implicit predict precision.
    compute_dtype: str = "bfloat16"
    # True: pixel_norm on a full-f32 tensor.  False: f32 statistic only,
    # activations stay in compute_dtype.
    pixelnorm_f32: bool = True
    # Fold nearest-upsample+Conv3D into 8 low-res phase convs (exact, 3.375x
    # fewer MACs; ops/upsample_conv.py).  Same parameter layout either way.
    fused_upsample: bool = True

    def __post_init__(self):
        if self.ndomain % 8 != 0:
            raise ValueError("ndomain must be a multiple of 8 "
                             "(generator upsamples 3x by factor 2)")
        if self.nhours % 8 != 0:
            raise ValueError("nhours must be a multiple of 8")

    @property
    def latent_grid(self) -> Tuple[int, int, int]:
        """Shape of the generator's initial (hours, y, x) latent grid."""
        return (self.nhours // 8, self.ndomain // 8, self.ndomain // 8)


def smoke_model_config(ndomain: int = 16, n_cond_channels: int = 1,
                       compute_dtype: Optional[str] = None) -> ModelConfig:
    """Shrunken architecture for smoke tests and pipeline rehearsals.  NOT a
    benchmark or parity config: it keeps CPU drills cheap."""
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    return ModelConfig(
        ndomain=ndomain, n_cond_channels=n_cond_channels,
        latent_dim=8, gen_channels=(8, 8, 8), base_channels=8,
        critic_channels=(8, 8, 8, 8), **kw)
