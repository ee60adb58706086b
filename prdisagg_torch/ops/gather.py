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
import functools

import torch

from prdisagg_torch import _build
from prdisagg_torch.parallel.mesh import batch_shard

#: number of CUDA kernel launches made by :func:`gather_patches`
launches = 0


def gather_patches_reference(data: torch.Tensor, idx: torch.Tensor,
                             nd: int) -> torch.Tensor:
    """data: (D, nh, ny, nx); idx: (B, 3) integer rows (t, y, x).
    Returns (B, nh, nd, nd)."""
    idx = idx.long()
    windows = data.unfold(2, nd, 1).unfold(3, nd, 1)  # a view of data
    return windows[idx[:, 0], :, idx[:, 1], idx[:, 2]]


@functools.lru_cache(maxsize=None)
def _kernels():
    """The library's entry points and its launch record's size, resolved
    once per process."""
    lib = _build.load("gather")
    prepare = lib.prdisagg_gather_prepare
    prepare.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    prepare.restype = ctypes.c_int
    launch = lib.prdisagg_gather_launch
    launch.argtypes = [ctypes.c_void_p] * 4
    launch.restype = ctypes.c_int
    lib.prdisagg_gather_record_bytes.restype = ctypes.c_int
    err_str = lib.prdisagg_gather_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return prepare, launch, err_str, lib.prdisagg_gather_record_bytes()


#: prepared launch records by what fixes them: the source's address and
#: shape, nd and B.  The key holds all that a record holds, so an entry
#: never goes stale: a new tensor at a cached address and shape is
#: described by the same record.
_records: dict = {}
_MAX_RECORDS = 64


def _record(key, kernels):
    rec = _records.get(key)
    if rec is not None:
        return rec
    ptr, _, nh, ny, nx, nd, b = key
    prepare, _, err_str, record_bytes = kernels
    rec = ctypes.create_string_buffer(record_bytes)
    err = prepare(rec, ptr, b, nh, ny, nx, nd)
    if err != 0:
        raise RuntimeError(f"gather_patches: preparing the kernel failed: "
                           f"{err_str(err).decode()} (cuda error {err})")
    if len(_records) >= _MAX_RECORDS:
        _records.clear()
    _records[key] = rec
    return rec


def _launch(kernels, key, idx, out, index: int) -> None:
    # the raw stream handle: torch.cuda.current_stream() builds a Stream
    # object on every call, which costs more than the launch
    err = kernels[1](_record(key, kernels), idx.data_ptr(), out.data_ptr(),
                     torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"gather_patches kernel launch failed: "
                           f"{kernels[2](err).decode()} (cuda error {err})")


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
    d, nh, ny, nx = data.shape
    if not 0 < nd <= min(ny, nx):
        raise ValueError(f"patch size {nd} does not fit a {ny}x{nx} field")
    dev = data.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(f"data is on {dev} and idx on {idx.device}; both "
                         f"operands must be on one CUDA device")
    if not (data.is_contiguous() and idx.is_contiguous()):
        raise ValueError("data and idx must be contiguous")
    b = idx.shape[0]
    out = torch.empty((b, nh, nd, nd), dtype=torch.float32, device=dev)
    if b == 0 or nh == 0:
        return out
    kernels = _kernels()
    key = (data.data_ptr(), d, nh, ny, nx, nd, b)
    index = dev.index
    if index == torch.cuda.current_device():
        _launch(kernels, key, idx, out, index)
    else:
        with torch.cuda.device(index):
            _launch(kernels, key, idx, out, index)
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


def gather_patches_sharded(data: torch.Tensor, idx: torch.Tensor, nd: int,
                           mesh) -> torch.Tensor:
    """The data-parallel form of :func:`gather_patches` (the JAX package's
    ``gather_patches_pallas_sharded``): `data` is replicated on every rank
    and `idx` is the global (B, 3) index batch; this rank gathers only its
    contiguous shard of it, B / mesh.size patches, with the same kernel.
    Raises unless B divides evenly over the mesh."""
    return gather_patches(data, batch_shard(idx, mesh), nd)
