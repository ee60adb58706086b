"""Typed configuration of the data, the model and the training run.

Field for field the same knobs as the JAX package's configuration, so a
weight file, a test or a CLI flag names the same network and run in both
packages.  Left out: ``TrainConfig.pallas_gather``, which chooses between
two gathers in the JAX package; on CUDA the sampler always gathers with the
hand-written kernel of ops/gather.py, so there is no choice to make.

:meth:`DataConfig.params_string` reproduces the reference's filename codec,
so exported weights keep the reference's names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


class Conditioning:
    """Conditioning-channel variants of the model.

    BASE: condition = normalized daily sum only (1 channel).
    DOY:  + sin/cos of day-of-year (3 channels).
    LON:  + normalized x-index of the patch (2 channels).
    """

    BASE = "base"
    DOY = "doy"
    LON = "lon"

    N_CHANNELS = {BASE: 1, DOY: 3, LON: 2}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset / patch-extraction configuration; the defaults are the
    reference training setup (gan_train_cwgangp_pixelnorm.py:51-64)."""

    startdate: str = "20090101"
    enddate: str = "20161231"
    ndomain: int = 16          # patch size in gridpoints
    stride: int = 16           # stride of the valid-box sweep
    tres: int = 1              # temporal resolution in hours
    tp_thresh_daily: float = 5.0   # mm threshold on the daily sum
    n_thresh: int = 20         # min number of gridpoints above threshold
    norm_scale: float = 127.4  # 99.9th percentile of 2010 daily sums
    conditioning: str = Conditioning.BASE
    # guards the hourly / daily-sum division, so an all-dry gridpoint gives
    # zero fractions instead of NaN (the reference divides unguarded)
    frac_eps: float = 1e-12

    @property
    def nhours(self) -> int:
        return 24 // self.tres

    @property
    def n_cond_channels(self) -> int:
        return Conditioning.N_CHANNELS[self.conditioning]

    def params_string(self) -> str:
        """Reference filename codec (gan_train_cwgangp_pixelnorm.py:113)."""
        tp = self.tp_thresh_daily
        tp_str = str(int(tp)) if float(tp).is_integer() else str(tp)
        return (
            f"{self.startdate}-{self.enddate}-tp_thresh_daily{tp_str}"
            f"_n_thresh{self.n_thresh}_ndomain{self.ndomain}_stride{self.stride}"
        )

    def data_filename(self) -> str:
        """Reformatted-tensor filename (reformat_data.py:91)."""
        return f"{self.startdate}-{self.enddate}_tres{self.tres}.npy"

    def indices_filename(self) -> str:
        """Valid-index pickle filename (compute_valid_indices.py:99)."""
        return f"valid_indices_smhi_radar_{self.params_string()}.pkl"

    def doy_filename(self) -> str:
        """Day-of-year sidecar filename (reformat_data_make_timelist.py:62)."""
        return f"{self.startdate}-{self.enddate}_tres{self.tres}_doy.npy"


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
    # Spatial sharding: the name of a mesh axis that the y dimension of the
    # conv activations is split over (parallel/spatial.py, with halo rows
    # exchanged between neighbouring ranks); apply the nets under
    # ``parallel.spatial.use_mesh(mesh)``.  None = replicated (default).
    spatial_axis: Optional[str] = None

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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """cWGAN-GP optimization settings; the defaults are the reference's
    (Adam(1e-4, 0, 0.9), n_disc=5, GP weight 10, schedule ((50, 32),);
    gan_train_cwgangp_pixelnorm.py:67-74,384-392)."""

    n_disc: int = 5
    gp_weight: float = 10.0
    learning_rate: float = 1e-4
    beta1: float = 0.0
    beta2: float = 0.9
    # ((n_epochs, batch_size), ...) increasing-batch-size schedule
    schedule: Tuple[Tuple[int, int], ...] = ((50, 32),)
    seed: int = 0
    # the JAX package's choice of PRNG implementation; kept so both packages
    # read the same config, unused by torch.Generator
    rng_impl: str = "rbg"
    # memory lever: split the held-over (n_disc*B) generator forward into
    # this many sequential chunks.  1 = off.
    hoisted_chunks: int = 1
    # cap the per-chunk sample count instead: each schedule stage takes the
    # smallest chunk count that divides n_disc*batch and keeps chunks at or
    # under this many samples.  None = off; ignored when hoisted_chunks > 1.
    hoisted_chunk_samples: Optional[int] = None
    checkpoint_every_epochs: int = 10
    log_every_steps: int = 50
    # data-parallel world size the run expects; None = the launched world,
    # whatever its size.  A Trainer refuses a world of another size.
    n_data_devices: Optional[int] = None
    # EMA of the generator parameters, updated once per fused step; 0 = off
    # (the reference protocol)
    ema_decay: float = 0.0

    @property
    def total_epochs(self) -> int:
        return sum(n for n, _ in self.schedule)


def parse_schedule(spec: str) -> Tuple[Tuple[int, int], ...]:
    """Parse an increasing-batch-size schedule "EPOCHS:BATCH[,...]" (e.g.
    "20:32,30:128") into the ``TrainConfig.schedule`` tuple (reference
    schedule semantics: gan_train_cwgangp_pixelnorm.py:73-74,526-529)."""
    try:
        out = tuple((int(e), int(b))
                    for e, b in (stage.split(":") for stage in spec.split(",")))
    except ValueError as err:
        raise ValueError(f"bad schedule {spec!r}; expected "
                         f"EPOCHS:BATCH[,EPOCHS:BATCH...]") from err
    if not out or any(e <= 0 or b <= 0 for e, b in out):
        raise ValueError(f"bad schedule {spec!r}: epochs/batch must be >= 1")
    return out


def production_train_config(**overrides) -> TrainConfig:
    """The JAX package's production preset: the reference's commented-out
    increasing-batch-size schedule ((20, 32), (30, 128)) and a generator EMA
    of decay 0.999.  ``TrainConfig()`` stays the reference protocol; keyword
    overrides win."""
    kw: dict = dict(schedule=((20, 32), (30, 128)), ema_decay=0.999)
    kw.update(overrides)
    return TrainConfig(**kw)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation-suite settings (generate_and_evaluate.py:30-57,
    generate_and_evaluate_crps.py:161-162)."""

    seed: int = 354
    epoch: int = 20
    eval_startdate: str = "20170101"
    eval_enddate: str = "20181231"
    n_map_conditions: int = 20
    n_fake_per_real: int = 10
    n_stat_samples: int = 10_000
    n_line_free_noise: int = 100
    n_line_shared_noise: int = 10
    n_ks_members: int = 1000
    n_ks_conditions: int = 20
    n_crps_samples: int = 10_000
    n_crps_members: int = 1000
    n_lsd_samples: int = 1000
    plot_format: str = "png"
    fraction_cmap: str = "Greys"


@dataclasses.dataclass(frozen=True)
class RainFarmConfig:
    """RainFARM baseline settings (rainfarm/rainfarm_calibrate.py:18,67-69)."""

    seed: int = 334
    n_calib: int = 5000
    n_repeat: int = 10
    ds_t_factor: int = 24


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Bundle of all stage configs for one experiment."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    rainfarm: RainFarmConfig = dataclasses.field(default_factory=RainFarmConfig)
    name: str = "wgancp_pixelnorm"
    # set to override the derived architecture (e.g. shrunken test models)
    model_override: Optional[ModelConfig] = None
    # None = ModelConfig default (bfloat16); "float32" = strict reference
    # precision
    compute_dtype: Optional[str] = None

    def model(self) -> ModelConfig:
        if self.model_override is not None:
            return self.model_override
        kw = {} if self.compute_dtype is None else {
            "compute_dtype": self.compute_dtype}
        return ModelConfig(
            ndomain=self.data.ndomain,
            nhours=self.data.nhours,
            n_cond_channels=self.data.n_cond_channels,
            **kw,
        )


def large_domain_experiment() -> ExperimentConfig:
    """The 64x64 large-domain variant
    (alternative_domains/gan_train_cwgangp_pixelnorm_largedomain.py:59,65),
    evaluated at epoch 8 with 15 fakes per real and the magma_r fraction
    colormap (generate_and_evaluate_largedomain.py:51,205,237)."""
    return ExperimentConfig(
        data=DataConfig(ndomain=64, n_thresh=40),
        eval=EvalConfig(epoch=8, n_fake_per_real=15, fraction_cmap="magma_r"),
        name="wgancp_pixelnorm_largedomain",
    )


def doy_experiment() -> ExperimentConfig:
    """Day-of-year conditioning variant (revision1/additional_inputs)."""
    return ExperimentConfig(
        data=DataConfig(conditioning=Conditioning.DOY),
        name="wgancp_pixelnorm_doy",
    )


def lon_experiment() -> ExperimentConfig:
    """Longitude conditioning variant (revision1/additional_inputs)."""
    return ExperimentConfig(
        data=DataConfig(conditioning=Conditioning.LON),
        name="wgancp_pixelnorm_lon",
    )
