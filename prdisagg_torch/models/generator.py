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
the softmax run in float32; there, pixel-norm and leaky ReLU are one pass
on the card (:func:`pixel_norm_leaky`).  In float32 the latent projection
and the head conv fix their order of summation (:func:`latent_projection`,
:func:`head_conv_f32`), so that the port is no farther from the exact
result than the JAX package on any host.

With ``cfg.spatial_axis`` set, under a mesh with that axis
(parallel/spatial.py ``use_mesh``), the y rows of every stage's output are
split over the axis' ranks: the latent projection runs replicated (it needs
the whole condition), each stage takes the input rows its output rows
need (its own and one halo row on each side, from its neighbours) through
the upsample-conv and crops what came from the halo, the head conv takes a
one-row halo too, and pixel-norm, leaky-ReLU and the hour softmax, which
work per position, stay local.  The forward then returns the rank's rows
of the fractions; :meth:`Generator.assemble` puts them together.
"""

from __future__ import annotations

import contextlib
import itertools

import torch
import torch.nn.functional as F
from torch import nn

from prdisagg_torch.core.config import ModelConfig
from prdisagg_torch.ops.core import (
    full_f32,
    hour_softmax,
    leaky_relu,
    pixel_norm_leaky,
    pixel_norm_mixed,
    upsample3d_nearest,
)
from prdisagg_torch.ops.upsample_conv import upsample2_conv3
from prdisagg_torch.parallel import spatial

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {name!r}")
    return _DTYPES[name]


# The longest input (K) whose float32 latent projection is one F.linear in
# float32; longer ones are taken in float64 (latent_projection).
PROJ_F32_MAX_K = 1024


def latent_projection(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """x @ weight.T + bias, the latent projection (JAX's ``nn.Dense``).

    In float32 with more than PROJ_F32_MAX_K inputs (the 64x64 domain's K
    is latent_dim + 64^2 * n_cond_channels), the product and the bias are
    taken in float64 and rounded to float32 once.  A float32 product sums
    its K terms in the BLAS's order: on an H100, cuBLAS's run over the
    4,196 of the 64x64 flagship lands 3.1e-6 of the largest output from
    the exact product, and float32 partial products over chunks of 1,024
    still 1.0e-6, where one rounding is within 6e-8.  Otherwise, and
    always in bfloat16, it is one ``F.linear``."""
    if x.dtype != torch.float32 or x.shape[-1] <= PROJ_F32_MAX_K:
        return F.linear(x, weight, bias)
    return F.linear(x.double(), weight.double(), bias.double()).float()


def _shift(n_in: int, pad: int, t: int):
    """Tap t of a width-3 window padded by `pad` on an axis of n_in: the
    output slice it adds to and the input slice it reads."""
    lo, hi = max(0, pad - t), min(n_in + 2 * pad - 2, n_in + pad - t)
    return slice(lo, hi), slice(lo + t - pad, hi + t - pad)


class _TapSum(torch.autograd.Function):
    """The 27 tap planes (3, 3, 3, B, D, H, W) of a 3^3 conv, each shifted
    to where it lands (padded 1 in hours and x, `pad_h` in y) and summed:
    three along x, then those three along y, then those three along hours,
    so that each output is a tree of 3-term sums.  The backward copies each
    output region's gradient back to the planes that fed it."""

    @staticmethod
    def forward(ctx, planes, pad_h: int):
        *_, b, d, h, w = planes.shape
        ctx.pad_h, ctx.shape = pad_h, planes.shape
        out_shape = (b, d, h + 2 * pad_h - 2, w)
        out, by_y, by_x = (planes.new_zeros(out_shape),
                           planes.new_zeros(out_shape),
                           planes.new_zeros(b, d, h, w))
        for i in range(3):
            by_y.zero_()
            for j in range(3):
                by_x.zero_()
                for k in range(3):
                    o, n = _shift(w, 1, k)
                    by_x[..., o] += planes[i, j, k][..., n]
                o, n = _shift(h, pad_h, j)
                by_y[:, :, o] += by_x[:, :, n]
            o, n = _shift(d, 1, i)
            out[:, o] += by_y[:, n]
        return out

    @staticmethod
    def backward(ctx, g):
        *_, d, h, w = ctx.shape
        grad = g.new_zeros(ctx.shape)
        for i, j, k in itertools.product(range(3), repeat=3):
            (od, id_), (oh, ih), (ow, iw) = (
                _shift(d, 1, i), _shift(h, ctx.pad_h, j), _shift(w, 1, k))
            grad[i, j, k][:, id_, ih, iw] = g[:, od, oh, ow]
        return grad, None


def head_conv_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  pad_h: int = 1) -> torch.Tensor:
    """The float32 head conv: Conv3D(3^3, C -> 1) of channels-last x (B, D,
    H, W, C), padded 1 in hours and x and `pad_h` in y, NCDHW out.

    One (C -> 27) product gives a plane a tap, the 27 planes are summed
    shifted in a fixed tree (:class:`_TapSum`) and the bias is added last.
    A convolution library sums the 27 * C products in an order of its own,
    which on the CPU rounds 3x (C 8) to 10x (C 64) as far from the exact
    result as JAX's head does."""
    b, d, h, w, c = x.shape
    taps = weight[0].permute(1, 2, 3, 0).reshape(27, c)
    planes = torch.mm(taps, x.reshape(-1, c).T).view(3, 3, 3, b, d, h, w)
    return (_TapSum.apply(planes, pad_h) + bias).unsqueeze(1)


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

        Returns fractions (B, nhours, nd, nd, 1), softmax over hours; under
        a spatial mesh, this rank's rows of them (B, nhours, rows, nd, 1)."""
        cfg, cd = self.cfg, self.compute_dtype
        sp = spatial.axis_mesh(cfg.spatial_axis)
        strict = (full_f32() if cd == torch.float32
                  else contextlib.nullcontext())
        with strict:
            b = latent.shape[0]
            x = torch.cat([latent, cond.reshape(b, -1)], dim=-1).to(cd)
            x = latent_projection(x, self.latent_proj.weight.to(cd),
                                  self.latent_proj.bias.to(cd))
            x = leaky_relu(x, cfg.leak)
            x = x.reshape(b, *cfg.latent_grid, cfg.base_channels)
            n = cfg.latent_grid[1]  # y rows, dim 2
            for i, stage in enumerate(self.stages()):
                # the latent grid is replicated, every later input as split
                x, rows = self._stage(stage, x.to(cd), n, sp,
                                      i > 0 and spatial.is_sharded(n, sp))
                # pixel-norm is a pass over each position, so it may run
                # before a rank's rows are cut out of the contiguous output
                x = self._activate(x)
                if rows is not None:
                    x = x.narrow(2, *rows)
                n *= 2
            x = self._head(x, n, sp)
        return hour_softmax(x.permute(0, 2, 3, 4, 1))

    def _activate(self, y: torch.Tensor) -> torch.Tensor:
        """Pixel-norm and leaky ReLU of a stage's output."""
        cfg = self.cfg
        if cfg.pixelnorm_f32:
            return pixel_norm_leaky(y.float(), cfg.leak).to(
                self.compute_dtype)
        return leaky_relu(pixel_norm_mixed(y), cfg.leak)

    @staticmethod
    def _stage(stage: UpsampleConv, x: torch.Tensor, n: int, sp,
               sharded: bool) -> tuple:
        """One upsample-conv stage on x's n rows (this rank's if `sharded`,
        else all): output row o reads input rows (o - 1) // 2 to
        (o + 1) // 2.  Returns the output and, under a split, the (start,
        length) of this rank's rows in it along dim 2 (else None)."""
        if not spatial.is_sharded(2 * n, sp):
            return stage(spatial.gather_rows(x, n, sp, 2, sharded)), None

        def need(r):
            c, d = spatial.row_bounds(2 * n, r, sp.size)
            return (c - 1) // 2, d // 2 + 1

        c, d = spatial.own_rows(2 * n, sp)
        y = stage(spatial.fetch_rows(x, n, sp, need, 2, sharded))
        return y, (c - 2 * need(sp.rank)[0], d - c)

    def _head(self, x: torch.Tensor, n: int, sp) -> torch.Tensor:
        """The 64 -> 1 head conv (SAME), NCDHW out, on a one-row halo of
        this rank's rows where n is sharded; in float32 as
        :func:`head_conv_f32`."""
        cd = self.compute_dtype
        w, bias = self.head.weight.to(cd), self.head.bias.to(cd)
        if not spatial.is_sharded(n, sp):
            x, pad_h = spatial.gather_rows(x, n, sp, 2), 1
        else:
            def need(r):
                c, d = spatial.row_bounds(n, r, sp.size)
                return c - 1, d + 1

            x, pad_h = spatial.fetch_rows(x, n, sp, need, 2), 0
        if cd == torch.float32:
            return head_conv_f32(x, w, bias, pad_h)
        return F.conv3d(x.permute(0, 4, 1, 2, 3), w, bias,
                        padding=(1, pad_h, 1))

    def assemble(self, fractions: torch.Tensor) -> torch.Tensor:
        """The whole (B, nhours, nd, nd, 1) fractions, replicated, from each
        rank's rows under a spatial mesh (unchanged without one)."""
        sp = spatial.axis_mesh(self.cfg.spatial_axis)
        return spatial.gather_rows(fractions, self.cfg.ndomain, sp, 2)

    def spatial_partial_params(self) -> set:
        """The parameters whose gradient each rank holds only its share of
        under the ambient spatial mesh (those of the stages whose output
        rows are split), to be summed over the axis; the others' gradients
        are whole on every rank."""
        sp = spatial.axis_mesh(self.cfg.spatial_axis)
        out, n = set(), self.cfg.latent_grid[1]
        for i in range(len(self.cfg.gen_channels)):
            n *= 2
            if spatial.is_sharded(n, sp):
                out |= {f"conv{i}.weight", f"conv{i}.bias"}
        if spatial.is_sharded(n, sp):
            out |= {"head.weight", "head.bias"}
        return out
