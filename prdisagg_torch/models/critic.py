"""Conditional critic (Wasserstein discriminator).

Architecture parity with the reference critic
(gan_train_cwgangp_pixelnorm.py:272-309) and the JAX package's ``Critic``:
the daily-sum condition is broadcast along the hour axis and concatenated as
extra channel(s), then four stride-2 Conv3D(3^3) blocks (VALID, then three
SAME) with LeakyReLU(0.2) and Dropout(0.25), a flatten and a linear score.

Three details decide parity with the JAX weights and outputs:

* SAME padding at stride 2 is asymmetric wherever the extent is even: the
  pads are ``jax.lax.padtype_to_pads``'s (total = max((out-1)*2 + 3 - n, 0),
  low = total // 2), applied with ``F.pad`` before an unpadded convolution.
  For the flagship they are (1,1)^3 on (11,7,7), (0,1)^3 on (6,4,4) and
  (1,1),(0,1),(0,1) on (3,2,2); ``padding=1`` would shift every window.
* the flatten before ``score`` runs in (B, D, H, W, C) order;
* conv kernels keep the JAX/Keras layout (3, 3, 3, Cin, Cout), glorot-uniform
  initialised as Keras and Flax do.

Dropout takes explicit keep masks (:meth:`Critic.draw_masks` draws them from
a ``torch.Generator``), so the training step controls every random draw.

With ``cfg.spatial_axis`` set, under a mesh with that axis
(parallel/spatial.py ``use_mesh``), each stage's output rows are split
over the axis' ranks: the sample comes in as this rank's rows (as the
generator gives them) and the condition and the masks whole, sliced here;
each stride-2 conv fetches the input rows its output rows need, from the
pads above (stage 0 VALID), and the score is a partial dot over the rank's
rows summed over the axis, its bias added once after the sum.  A stage
whose output has fewer rows than the axis has ranks runs replicated.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prdisagg_torch.core.config import ModelConfig
from prdisagg_torch.models.generator import torch_dtype
from prdisagg_torch.ops.core import full_f32, leaky_relu
from prdisagg_torch.parallel import spatial


def _same_pads(n: int) -> Tuple[int, int]:
    out = -(-n // 2)
    total = max((out - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def critic_stage_dims(cfg: ModelConfig) -> List[Tuple[int, int, int]]:
    """(hour, y, x) extents after each conv stage: stage 0 is VALID
    (floor((n-3)/2)+1), the rest SAME (ceil(n/2))."""
    dims = (cfg.nhours, cfg.ndomain, cfg.ndomain)
    out = []
    for i in range(len(cfg.critic_channels)):
        dims = tuple((n - 3) // 2 + 1 if i == 0 else -(-n // 2) for n in dims)
        out.append(dims)
    return out


def pad_only_taps(cfg: ModelConfig) -> Dict[int, torch.Tensor]:
    """{stage: (3, 3, 3) bool mask} of the SAME conv stages' taps that read
    only padding at every output position, for stages that have any.  A
    tap reads data iff, on each axis, some output o reads input
    2 o + k - lo inside [0, n), lo the stage's low pad.  Such a tap's
    weights never touch data, so their gradient is exactly 0: at the
    flagship 16x16 that is 15 of conv3's 27 taps (ky = 2 or kx = 2), its
    input being (3, 2, 2) with pads (1, 1), (0, 1), (0, 1)."""
    dims = critic_stage_dims(cfg)
    out = {}
    for i in range(1, len(cfg.critic_channels)):
        dead = []  # per axis: the taps that read only padding
        for n in dims[i - 1]:
            lo = _same_pads(n)[0]
            dead.append(torch.tensor([
                all(not 0 <= 2 * o + k - lo < n for o in range(-(-n // 2)))
                for k in range(3)]))
        mask = (dead[0][:, None, None] | dead[1][None, :, None]
                | dead[2][None, None, :])
        if mask.any():
            out[i] = mask
    return out


def _glorot_(w: torch.Tensor, fan_in: int, fan_out: int) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-limit, limit)


class Conv3dNDHWC(nn.Module):
    """Parameters of one Conv3D(3^3) in the JAX/Keras layout."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(3, 3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        _glorot_(self.weight, 27 * cin, 27 * cout)


class Critic(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        cin = 1 + cfg.n_cond_channels
        for i, ch in enumerate(cfg.critic_channels):
            self.add_module(f"conv{i}", Conv3dNDHWC(cin, ch))
            cin = ch
        self.stage_dims = critic_stage_dims(cfg)
        # F.pad order: (x_lo, x_hi, y_lo, y_hi, hour_lo, hour_hi)
        self._pads = [None] + [
            tuple(p for n in reversed(self.stage_dims[i - 1])
                  for p in _same_pads(n))
            for i in range(1, len(cfg.critic_channels))]
        flat = math.prod(self.stage_dims[-1]) * cfg.critic_channels[-1]
        self.score = nn.Linear(flat, 1)
        _glorot_(self.score.weight, flat, 1)
        with torch.no_grad():
            self.score.bias.zero_()

    def convs(self):
        return [getattr(self, f"conv{i}")
                for i in range(len(self.cfg.critic_channels))]

    def draw_masks(self, batch: int, generator: torch.Generator
                   ) -> Optional[List[torch.Tensor]]:
        """Dropout keep masks for one call on `batch` samples, in the
        (B, C, D, H, W) layout of each stage's output; None when the
        dropout rate is 0 (Flax's Dropout is then the identity)."""
        rate = self.cfg.dropout_rate
        if rate == 0.0:
            return None
        dev = self.score.weight.device
        return [torch.rand((batch, ch, *dims), generator=generator,
                           device=dev) >= rate
                for ch, dims in zip(self.cfg.critic_channels,
                                    self.stage_dims)]

    def forward(self, sample: torch.Tensor, cond: torch.Tensor,
                masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """sample: (B, nhours, nd, nd, 1); cond: (B, nd, nd, n_cond_channels);
        masks: None (deterministic) or one keep mask per stage.  Under a
        spatial mesh, sample is this rank's rows (B, nhours, rows, nd, 1)
        and cond and masks are whole.

        Returns critic scores (B, 1) in float32."""
        cfg, cd = self.cfg, self.compute_dtype
        sp = spatial.axis_mesh(cfg.spatial_axis)
        keep = 1.0 - cfg.dropout_rate
        strict = (full_f32() if cd == torch.float32
                  else contextlib.nullcontext())
        with strict:
            b = sample.shape[0]
            n = cfg.ndomain  # y rows, dim 3 of the NCDHW view
            cond = spatial.shard_rows(cond, 1, sp)
            cond_b = cond[:, None].expand(b, cfg.nhours, *cond.shape[1:])
            x = torch.cat([sample, cond_b], dim=-1).to(cd)
            x = x.permute(0, 4, 1, 2, 3)  # NCDHW view of the NDHWC tensor
            for i, conv in enumerate(self.convs()):
                x = self._conv(i, conv, x, n, sp)
                n = self.stage_dims[i][1]
                x = leaky_relu(x, cfg.leak)
                if masks is not None:
                    x = torch.where(spatial.shard_rows(masks[i], 3, sp),
                                    x / keep, 0.0)
            x = x.permute(0, 2, 3, 4, 1).reshape(b, -1).float()
            if not spatial.is_sharded(n, sp):
                return self.score(x)
            lo, hi = spatial.own_rows(n, sp)
            w = self.score.weight.view(*self.stage_dims[-1], -1)[:, lo:hi]
            part = F.linear(x, w.reshape(1, -1))
            return spatial.all_reduce_sum(part, sp) + self.score.bias

    def _conv(self, i: int, conv: Conv3dNDHWC, x: torch.Tensor, n: int, sp
              ) -> torch.Tensor:
        """Stage i's stride-2 conv on x's n rows (NCDHW; this rank's, or
        all): output row o reads input rows 2 o - lo to 2 o + 2 - lo, lo
        the stage's low y pad."""
        cd = self.compute_dtype
        w = conv.weight.permute(4, 3, 0, 1, 2).to(cd)
        n_out = self.stage_dims[i][1]
        if not spatial.is_sharded(n_out, sp):
            x = spatial.gather_rows(x, n, sp, 3)
            if i > 0:
                x = F.pad(x, self._pads[i])
            return F.conv3d(x, w, conv.bias.to(cd), stride=2)
        lo = 0 if i == 0 else self._pads[i][2]

        def need(r):
            c, d = spatial.row_bounds(n_out, r, sp.size)
            return 2 * c - lo, 2 * d + 1 - lo

        spatial.own_rows(n_out, sp)  # raises where a rank would own none
        x = spatial.fetch_rows(x, n, sp, need, 3)
        if i > 0:  # the hour and x pads; y's zero rows came with the fetch
            p = self._pads[i]
            x = F.pad(x, (p[0], p[1], 0, 0, p[4], p[5]))
        return F.conv3d(x, w, conv.bias.to(cd), stride=2)

    def spatial_partial_params(self) -> set:
        """The parameters whose gradient each rank holds only its share of
        under the ambient spatial mesh (the stages whose output rows are
        split, and the score's weight when the last one is), to be summed
        over the axis; the others' (the score's bias among them) are whole
        on every rank."""
        sp = spatial.axis_mesh(self.cfg.spatial_axis)
        out = set()
        for i, (_, n, _) in enumerate(self.stage_dims):
            if spatial.is_sharded(n, sp):
                out |= {f"conv{i}.weight", f"conv{i}.bias"}
        if spatial.is_sharded(self.stage_dims[-1][1], sp):
            out.add("score.weight")
        return out
