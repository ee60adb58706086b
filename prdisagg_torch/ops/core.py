"""Elementwise and reduction ops of the generator, as plain tensor functions.

Layout is channels-last throughout, (batch, hour, y, x, channel), as in the
JAX package, so the hour axis is 1 and the channel axis is -1.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

HOUR_AXIS = 1


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def pixel_norm(x: torch.Tensor, eps: float = 1.0e-8) -> torch.Tensor:
    """x / sqrt(mean(x^2, channel axis) + eps), ProGAN's pixelwise feature
    normalization (reference PixelNormalization layer,
    gan_train_cwgangp_pixelnorm.py:249-270)."""
    mean_sq = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(mean_sq + eps)


def pixel_norm_mixed(x: torch.Tensor, eps: float = 1.0e-8) -> torch.Tensor:
    """pixel_norm with the statistic in float32 but the product in the input
    dtype: for bf16 activation stacks it avoids two full-tensor casts per
    stage.  Identical to :func:`pixel_norm` for float32 inputs."""
    mean_sq = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return x * torch.rsqrt(mean_sq + eps).to(x.dtype)


def hour_softmax(x: torch.Tensor, axis: int = HOUR_AXIS) -> torch.Tensor:
    """Softmax over the hour axis, always in float32: per-gridpoint
    fractions that sum to 1 over the day, so generated hourly fields re-sum
    to the conditioning daily total whatever the conv stack's dtype."""
    return torch.softmax(x.float(), dim=axis)


def upsample3d_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour x`factor` upsampling of the (hour, y, x) volume of a
    (B, D, H, W, C) tensor (Keras UpSampling3D)."""
    b, d, h, w, c = x.shape
    x = x[:, :, None, :, None, :, None, :].expand(
        b, d, factor, h, factor, w, factor, c)
    return x.reshape(b, d * factor, h * factor, w * factor, c)


def fractions_and_condition(patches: torch.Tensor, norm_scale: float,
                            eps: float = 1e-12):
    """Hourly mm patches (..., nhours, ny, nx, 1) -> (fractions summing to
    ~1 over hours, daily sum / norm_scale (..., ny, nx, 1)), the reference's
    last preprocessing step (gan_train_cwgangp_pixelnorm.py:159-166) with an
    epsilon guard for all-dry gridpoints."""
    cond = torch.sum(patches, dim=-4)
    frac = patches / torch.clamp(cond[..., None, :, :, :], min=eps)
    return frac, cond / norm_scale


@contextlib.contextmanager
def full_f32():
    """Run cuDNN convolutions and cuBLAS products in full float32.

    On Hopper, PyTorch sends float32 convolutions through TF32 by default
    (``torch.backends.cudnn.allow_tf32``), which keeps about three decimal
    digits.  The float32 serving path is held to the reference's precision,
    so it turns TF32 off for its convolutions and restores the caller's
    setting afterwards."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
