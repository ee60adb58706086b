"""Elementwise and reduction ops of the generator, as plain tensor functions,
and the one pass of pixel-norm and leaky ReLU on the card
(:func:`pixel_norm_leaky`, ``csrc/pixel_norm.cu``).

Layout is channels-last throughout, (batch, hour, y, x, channel), as in the
JAX package, so the hour axis is 1 and the channel axis is -1.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from prdisagg_torch import _build
from prdisagg_torch.utils.profiling import span

HOUR_AXIS = 1

#: number of CUDA kernel launches made by :func:`pixel_norm_leaky`
pixel_norm_launches = 0
#: the kernel's widths: C a multiple of 4 up to this, one or two float4s a
#: lane of a warp (csrc/pixel_norm.cu refuses others)
PIXEL_NORM_MAX_CHANNELS = 256


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def pixel_norm(x: torch.Tensor, eps: float = 1.0e-8) -> torch.Tensor:
    """x / sqrt(mean(x^2, channel axis) + eps), ProGAN's pixelwise feature
    normalization (reference PixelNormalization layer,
    gan_train_cwgangp_pixelnorm.py:249-270)."""
    mean_sq = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(mean_sq + eps)


@functools.lru_cache(maxsize=None)
def _pixel_norm_kernel():
    """The library's entry point and its error strings, resolved once per
    process."""
    lib = _build.load("pixel_norm")
    fn = lib.prdisagg_pixel_norm_leaky
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err_str = lib.prdisagg_pixel_norm_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, err_str


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pixel_norm_leaky_cuda(x: torch.Tensor, leak: float,
                          eps: float = 1.0e-8) -> torch.Tensor:
    """Launch the kernel: ``leaky_relu(pixel_norm(x, eps), leak)`` of a
    float32 CUDA tensor into a fresh contiguous one, on the current stream.
    Where x is not contiguous or not 16-byte aligned, the kernel reads a
    contiguous copy of it.  Raises where the launch fails or the C entry
    refuses x's width."""
    global pixel_norm_launches
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    out = torch.empty_like(x)
    c = x.shape[-1] if x.dim() else 0
    index = x.device.index
    fn, err_str = _pixel_norm_kernel()
    with torch.cuda.device(index):
        # the raw stream handle: torch.cuda.current_stream() builds a
        # Stream object on every call
        err = fn(x.data_ptr(), out.data_ptr(), x.numel() // c if c else 0,
                 c, eps, leak, _sm_count(index),
                 torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"pixel_norm_leaky kernel launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    pixel_norm_launches += 1
    return out


class _PixelNormLeaky(torch.autograd.Function):
    """The kernel's forward under a recorded gradient.  The backward is the
    plain chain's gradient in closed form, in plain tensor ops (themselves
    differentiable where a graph of the gradient is asked for): with
    r = rsqrt(mean(x^2) + eps) and dz = dy * leaky_relu'(x),
    dx = r * dz - x * r^3 * mean(dz * x).  The TPU had no backward kernel
    here to port: XLA differentiated the chain."""

    @staticmethod
    def forward(ctx, x, leak, eps):
        ctx.save_for_backward(x)
        ctx.leak, ctx.eps = leak, eps
        return pixel_norm_leaky_cuda(x, leak, eps)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        r = torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True)
                        + ctx.eps)
        dz = torch.where(x > 0, dy, dy * ctx.leak)
        dr = torch.mean(dz * x, dim=-1, keepdim=True) * r.pow(3)
        return r * dz - x * dr, None, None


def pixel_norm_plain_because(x: torch.Tensor) -> Optional[str]:
    """Why :func:`pixel_norm_leaky` takes the plain composition for x, or
    None where it launches the kernel: each a property of x that the caller
    can see."""
    c = x.shape[-1] if x.dim() else 0
    if x.device.type != "cuda":
        return "not on CUDA"
    if x.dtype != torch.float32:
        return "not float32"
    if c % 4 or not 0 < c <= PIXEL_NORM_MAX_CHANNELS:
        return "channels off the kernel's widths"
    return None


def pixel_norm_leaky(x: torch.Tensor, leak: float,
                     eps: float = 1.0e-8) -> torch.Tensor:
    """``leaky_relu(pixel_norm(x, eps), leak)``: one read and one write of
    x on the card, whatever its layout and whether or not a gradient is
    recorded; the plain composition where :func:`pixel_norm_plain_because`
    gives a reason (the CPU, another dtype or width).  Out of place either
    way."""
    with span("prdisagg.pixel_norm"):
        if pixel_norm_plain_because(x) is not None:
            return leaky_relu(pixel_norm(x, eps), leak)
        if torch.is_grad_enabled() and x.requires_grad:
            return _PixelNormLeaky.apply(x, leak, eps)
        return pixel_norm_leaky_cuda(x, leak, eps)


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
