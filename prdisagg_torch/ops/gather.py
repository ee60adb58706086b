"""Random patch gather: B windows (nh, nd, nd) at (t, y, x) offsets from a
(D, nh, ny, nx) tensor, the training sampler's data movement.

Two implementations of one function, both bit-exact copies:

* :func:`gather_patches_reference`, plain PyTorch: one advanced indexing of
  an ``unfold`` view, so ``data`` itself is never copied (the view shares
  its storage; only the B gathered windows are written).  The CPU path and
  the yardstick of the kernel on the card.
* the CUDA kernel in ``csrc/gather.cu``, the counterpart of the TPU kernel
  in prdisagg_tpu/ops/pallas_gather.py.

:func:`gather_patches` dispatches: a CPU tensor takes the plain version, a
CUDA tensor the kernel, anything else raises.  With nh = 1 (a (D, 1, ny, nx)
view of the daily sums) the same function gathers conditions.
"""

from __future__ import annotations

import ctypes

import torch

from prdisagg_torch import _build

#: number of CUDA kernel launches made by :func:`gather_patches`
launches = 0


def gather_patches_reference(data: torch.Tensor, idx: torch.Tensor,
                             nd: int) -> torch.Tensor:
    """data: (D, nh, ny, nx); idx: (B, 3) integer rows (t, y, x).
    Returns (B, nh, nd, nd)."""
    idx = idx.long()
    windows = data.unfold(2, nd, 1).unfold(3, nd, 1)  # a view of data
    return windows[idx[:, 0], :, idx[:, 1], idx[:, 2]]


def _kernel_fn():
    lib = _build.load("gather")
    fn = lib.prdisagg_gather_patches_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.prdisagg_gather_error_string.argtypes = [ctypes.c_int]
    lib.prdisagg_gather_error_string.restype = ctypes.c_char_p
    return fn, lib.prdisagg_gather_error_string


def gather_patches_cuda(data: torch.Tensor, idx: torch.Tensor,
                        nd: int) -> torch.Tensor:
    """Launch the CUDA kernel.  data: (D, nh, ny, nx) float32, contiguous;
    idx: (B, 3) int32, contiguous, on data's device, every row in range
    (the kernel does not check).  Returns (B, nh, nd, nd) float32 on the
    current stream."""
    global launches
    if data.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"gather_patches kernel takes float32 data and int32 "
                        f"indices, got {data.dtype} and {idx.dtype}")
    if data.dim() != 4 or idx.dim() != 2 or idx.shape[1] != 3:
        raise ValueError(f"data must be (D, nh, ny, nx) and idx (B, 3), got "
                         f"{tuple(data.shape)} and {tuple(idx.shape)}")
    _, nh, ny, nx = data.shape
    if not 0 < nd <= min(ny, nx):
        raise ValueError(f"patch size {nd} does not fit a {ny}x{nx} field")
    for name, t in (("data", data), ("idx", idx)):
        if t.device.type != "cuda" or t.device != data.device:
            raise ValueError(f"{name} is on {t.device}; both operands must "
                             f"be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b = idx.shape[0]
    out = torch.empty((b, nh, nd, nd), dtype=data.dtype, device=data.device)
    if out.numel() == 0:
        return out
    vec_ok = int(nx % 4 == 0 and nd % 4 == 0 and data.data_ptr() % 16 == 0)
    fn, err_str = _kernel_fn()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), idx.data_ptr(), out.data_ptr(), b, nh, ny,
                 nx, nd, vec_ok, stream)
    if err != 0:
        raise RuntimeError(f"gather_patches kernel launch failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    launches += 1
    return out


def gather_patches(data: torch.Tensor, idx: torch.Tensor,
                   nd: int) -> torch.Tensor:
    """out[b] = data[t_b, :, y_b:y_b+nd, x_b:x_b+nd] for idx rows (t, y, x).

    A CPU tensor runs the plain version; a CUDA tensor runs the kernel or
    raises.  Every row must lie in range: the kernel does not check, and
    reads out of bounds where one does not (DeviceDataset checks its rows
    and every row handed to its public methods)."""
    if data.device.type == "cpu":
        return gather_patches_reference(data, idx, nd)
    if data.device.type != "cuda":
        raise ValueError(f"gather_patches runs on cpu or cuda, got "
                         f"{data.device}")
    return gather_patches_cuda(data, idx, nd)
