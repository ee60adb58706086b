"""Conditional generator: (latent, daily-sum condition) -> hourly fractions.

Architecture parity with the reference generator
(gan_train_cwgangp_pixelnorm.py:312-357) and with the JAX package's
``Generator``: a dense projection to a (nhours/8, nd/8, nd/8, base) latent
grid, three [nearest-upsample x2 -> Conv3D(3^3) -> PixelNorm -> LeakyReLU]
stages, a linear Conv3D head and a softmax over the hour axis, so that the
per-gridpoint fractions sum to exactly 1 (conservation of the daily sum).

Activations stay channels-last (B, D, H, W, C) as in the JAX package, so the
condition flatten and the dense reshape keep the channel-last order that
reference and JAX weights expect.  Parameters are float32; conv and matmul
inputs run in ``cfg.compute_dtype``; pixel-norm (when ``pixelnorm_f32``) and
the softmax run in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from prdisagg_torch.core.config import ModelConfig
from prdisagg_torch.ops.core import (
    full_f32,
    hour_softmax,
    leaky_relu,
    pixel_norm,
    pixel_norm_mixed,
    upsample3d_nearest,
)
from prdisagg_torch.ops.upsample_conv import upsample2_conv3

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {name!r}")
    return _DTYPES[name]


class UpsampleConv(nn.Module):
    """nearest-upsample x2 + Conv3D(3^3, SAME).  The kernel keeps the JAX
    and Keras layout (3, 3, 3, Cin, Cout), so weight files map one to one."""

    def __init__(self, cin: int, cout: int, fused: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(3, 3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return upsample2_conv3(x, self.weight, self.bias)
        y = F.conv3d(upsample3d_nearest(x, 2).permute(0, 4, 1, 2, 3),
                     self.weight.permute(4, 3, 0, 1, 2).to(x.dtype),
                     self.bias.to(x.dtype), padding=1)
        return y.permute(0, 2, 3, 4, 1)


class Generator(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        gd, gh, gw = cfg.latent_grid
        in_dim = cfg.latent_dim + cfg.ndomain ** 2 * cfg.n_cond_channels
        self.latent_proj = nn.Linear(in_dim, cfg.base_channels * gd * gh * gw)
        cin = cfg.base_channels
        for i, ch in enumerate(cfg.gen_channels):
            self.add_module(f"conv{i}", UpsampleConv(cin, ch,
                                                     cfg.fused_upsample))
            cin = ch
        self.head = nn.Conv3d(cin, 1, 3, padding=1)
        with torch.no_grad():
            for p in self.parameters():
                if p.dim() > 1:
                    p.normal_(0.0, cfg.init_stddev)
                else:
                    p.zero_()

    def stages(self):
        return [getattr(self, f"conv{i}") for i in range(len(self.cfg.gen_channels))]

    def forward(self, latent: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """latent: (B, latent_dim); cond: (B, nd, nd, n_cond_channels).

        Returns fractions (B, nhours, nd, nd, 1), softmax over hours."""
        cfg, cd = self.cfg, self.compute_dtype
        strict = (full_f32() if cd == torch.float32
                  else contextlib.nullcontext())
        with strict:
            b = latent.shape[0]
            x = torch.cat([latent, cond.reshape(b, -1)], dim=-1).to(cd)
            x = F.linear(x, self.latent_proj.weight.to(cd),
                         self.latent_proj.bias.to(cd))
            x = leaky_relu(x, cfg.leak)
            x = x.reshape(b, *cfg.latent_grid, cfg.base_channels)
            for stage in self.stages():
                x = stage(x.to(cd))
                if cfg.pixelnorm_f32:
                    x = leaky_relu(pixel_norm(x.float()), cfg.leak).to(cd)
                else:
                    x = leaky_relu(pixel_norm_mixed(x), cfg.leak)
            x = F.conv3d(x.permute(0, 4, 1, 2, 3), self.head.weight.to(cd),
                         self.head.bias.to(cd), padding=1)
        return hour_softmax(x.permute(0, 2, 3, 4, 1))
