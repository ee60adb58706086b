"""On-device patch sampler: the radar tensor lives in device memory once and
every training draw gathers (nhours, nd, nd) windows from it at random valid
index rows (reference: the host-side ``view_as_windows`` gather and its
queue, gan_train_cwgangp_pixelnorm.py:143-212,440-449).

On CUDA every gather is the hand-written kernel of ops/gather.py, which
reads the tensor in place; on the CPU it is the plain indexing of an unfold
view, which does not copy it either.  Unlike the JAX package there is no
x padding to a 128-lane multiple and no size rule choosing between gathers.

Every random draw comes from a ``torch.Generator`` the caller passes in.
With a data-parallel ``mesh`` (parallel/mesh.py), every rank draws the
global batch's rows and gathers only its own contiguous shard of them
(ops/gather.py ``gather_patches_sharded``): the tensor is replicated, the
batch is not.
The ``*_from_rows`` methods take index rows drawn elsewhere, so a test can
hand the port and the JAX package the same rows; they check the rows first
(one host sync), since the kernel reads out of bounds where a row is out of
range.  Draws from the dataset's own index rows, checked once when it is
made, take the unchecked ``_*_from_rows`` forms.

Conditioning variants:
  base: cond = normalized daily sum (1 channel)
  doy:  + sin/cos(2*pi*doy/365) channels from a per-day sidecar array
  lon:  + normalized patch x-index channel
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from prdisagg_torch.core.config import Conditioning, DataConfig
from prdisagg_torch.core.device import resolve_device
from prdisagg_torch.ops.core import fractions_and_condition
from prdisagg_torch.ops.gather import gather_patches, gather_patches_sharded
from prdisagg_torch.parallel.mesh import batch_shard


def _check_rows(rows: torch.Tensor, shape, nd: int) -> None:
    """Raise unless every (t, y, x) row puts an nd x nd patch inside a
    (days, nhours, ny, nx) tensor."""
    n_days, _, ny, nx = shape
    upper = torch.tensor([n_days - 1, ny - nd, nx - nd], device=rows.device)
    if rows.dim() != 2 or rows.shape[1] != 3 or not bool(
            ((rows >= 0) & (rows <= upper)).all()):
        raise ValueError(f"index rows out of range for data {tuple(shape)} "
                         f"and ndomain {nd}")


@dataclasses.dataclass
class DeviceDataset:
    """Device-resident dataset: radar tensor, valid index rows, daily sums."""

    data: torch.Tensor            # (days, nhours, ny, nx) float32
    indices: torch.Tensor         # (S, 3) int32 rows (tidx, yidx, xidx)
    doy: Optional[torch.Tensor]   # (days,) float32 day-of-year, or None
    # (days, ny, nx) daily sums: the generator update's conditions gather
    # from this 1/nhours-size tensor instead of full hourly patches
    dsum: torch.Tensor
    cfg: DataConfig
    # x-index range of the valid rows, for the lon channel
    lon_min: float = 0.0
    lon_div: float = 1.0

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_tensor(cls, data: torch.Tensor, indices, cfg: DataConfig,
                    doy=None) -> "DeviceDataset":
        """Wrap a float32 (days, nhours, ny, nx) tensor where it lies, without
        copying it.  Every index row is checked once here to lie inside the
        tensor, so the gather kernel needs no check on each call."""
        if cfg.conditioning == Conditioning.DOY and doy is None:
            raise ValueError("doy conditioning requires the day-of-year "
                             "sidecar")
        if data.dtype != torch.float32 or data.dim() != 4:
            raise ValueError(f"data must be float32 (days, nhours, ny, nx), "
                             f"got {data.dtype} {tuple(data.shape)}")
        data = data.contiguous()
        dev = data.device
        indices = torch.as_tensor(indices, dtype=torch.int32, device=dev)
        indices = indices.reshape(-1, 3).contiguous()
        if len(indices) == 0:
            raise ValueError("no valid index rows")
        _check_rows(indices, data.shape, cfg.ndomain)
        xs = indices[:, 2]
        return cls(
            data=data, indices=indices,
            doy=None if doy is None else torch.as_tensor(
                doy, dtype=torch.float32, device=dev),
            dsum=data.sum(dim=1), cfg=cfg,
            lon_min=float(xs.min()), lon_div=max(float(xs.max()), 1.0))

    @classmethod
    def from_numpy(cls, data: np.ndarray, indices: np.ndarray,
                   cfg: DataConfig, doy: Optional[np.ndarray] = None,
                   device="cuda") -> "DeviceDataset":
        dev = resolve_device(device)
        return cls.from_tensor(
            torch.as_tensor(np.asarray(data, dtype=np.float32)).to(dev),
            indices, cfg, doy)

    @property
    def n_samples(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    # -- draws ---------------------------------------------------------------
    def draw_rows(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """n valid index rows (n, 3) int32, uniform with replacement."""
        ix = torch.randint(0, self.n_samples, (n,), generator=generator,
                           device=self.device)
        return self.indices[ix]

    # -- from given rows -----------------------------------------------------
    def check_rows(self, rows: torch.Tensor) -> None:
        """Raise ValueError unless every (B, 3) row is a patch inside the
        tensor (one host sync)."""
        _check_rows(rows, self.data.shape, self.cfg.ndomain)

    def patches_from_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(B, 3) rows -> (B, nhours, nd, nd, 1) hourly mm patches."""
        self.check_rows(rows)
        return self._patches_from_rows(rows)

    def real_from_rows(self, rows: torch.Tensor):
        """(fractions (B, nh, nd, nd, 1), condition (B, nd, nd, C)) of the
        patches at `rows` (reference ``generate_real_samples``,
        gan_train_cwgangp_pixelnorm.py:143-174)."""
        self.check_rows(rows)
        return self._real_from_rows(rows)

    def cond_from_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Conditions (B, nd, nd, C) of the patches at `rows`, gathered from
        the daily sums (the same kernel at nh = 1): the values of
        :meth:`real_from_rows`'s condition up to summation order, for
        1/nhours of the bytes."""
        self.check_rows(rows)
        return self._cond_from_rows(rows)

    # -- from rows known to be in range ----------------------------------------
    # With a mesh, `rows` is the global batch and the result this rank's
    # shard of it.
    def _patches_from_rows(self, rows: torch.Tensor,
                           mesh=None) -> torch.Tensor:
        if mesh is not None:
            return gather_patches_sharded(self.data, rows, self.cfg.ndomain,
                                          mesh)[..., None]
        return gather_patches(self.data, rows, self.cfg.ndomain)[..., None]

    def _extra_cond_channels(self, rows: torch.Tensor) -> List[torch.Tensor]:
        """Per-patch scalars broadcast into (B, nd, nd, 1) condition maps."""
        cfg = self.cfg
        nd, b = cfg.ndomain, rows.shape[0]
        if cfg.conditioning == Conditioning.DOY:
            angle = 2.0 * math.pi * self.doy[rows[:, 0].long()] / 365.0
            chans = [torch.sin(angle), torch.cos(angle)]
        elif cfg.conditioning == Conditioning.LON:
            # (x - min x) / max x, the reference's normalization
            # (gan_train_cwgangp_pixelnorm_lon.py:126-129,175-178)
            chans = [(rows[:, 2].float() - self.lon_min) / self.lon_div]
        else:
            chans = []
        return [c[:, None, None, None].expand(b, nd, nd, 1) for c in chans]

    def _with_extras(self, cond: torch.Tensor, rows: torch.Tensor):
        if self.cfg.conditioning == Conditioning.BASE:
            return cond
        return torch.cat([cond, *self._extra_cond_channels(rows)], dim=-1)

    def _real_from_rows(self, rows: torch.Tensor, mesh=None):
        frac, cond = fractions_and_condition(
            self._patches_from_rows(rows, mesh), self.cfg.norm_scale,
            self.cfg.frac_eps)
        local = rows if mesh is None else batch_shard(rows, mesh)
        return frac, self._with_extras(cond, local)

    def _cond_from_rows(self, rows: torch.Tensor, mesh=None) -> torch.Tensor:
        sums = self.dsum[:, None]
        if mesh is None:
            dsum = gather_patches(sums, rows, self.cfg.ndomain)
        else:
            dsum = gather_patches_sharded(sums, rows, self.cfg.ndomain, mesh)
            rows = batch_shard(rows, mesh)
        cond = dsum[:, 0, :, :, None] / self.cfg.norm_scale
        return self._with_extras(cond, rows)

    # -- random draws ----------------------------------------------------------
    def sample_patches_raw(self, n_batch: int,
                           generator: torch.Generator) -> torch.Tensor:
        """Random raw hourly-mm patches (B, nh, nd, nd), no fraction
        transform (RainFARM calibration)."""
        return self._patches_from_rows(
            self.draw_rows(n_batch, generator))[..., 0]

    # With a mesh, every rank draws the same n_batch rows (and latents) and
    # returns its shard: n_batch / mesh.size samples.
    def sample_real(self, n_batch: int, generator: torch.Generator,
                    mesh=None):
        return self._real_from_rows(self.draw_rows(n_batch, generator), mesh)

    def sample_cond(self, n_batch: int, generator: torch.Generator,
                    mesh=None) -> torch.Tensor:
        return self._cond_from_rows(self.draw_rows(n_batch, generator), mesh)

    def sample_latent(self, n_batch: int, latent_dim: int,
                      generator: torch.Generator, mesh=None):
        """(latent ~ N(0, 1), cond) for a generator update."""
        latent = torch.randn((n_batch, latent_dim), generator=generator,
                             device=self.device)
        if mesh is not None:
            latent = batch_shard(latent, mesh)
        return latent, self.sample_cond(n_batch, generator, mesh)
