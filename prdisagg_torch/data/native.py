"""The offline pipeline's two hot spots on the card: the valid-patch scan and
the packed patch extraction (the JAX package's data/native.py, whose engine
is host C++ in native/validscan.cpp; here the engine is the card, and that
file is not compiled).

Both stream a (memmapped) multi-year tensor day by day, so it never lies in
memory whole (the reference needed 363 GB of RAM, reformat_data.py:5).
``compute_valid_indices_native`` and ``gather_patches_native`` keep the JAX
module's names: the first is the streamed scan under its JAX name, the second
the gather of a tensor that fits on the device whole.
There is no silent fallback: on a CUDA device the gathers launch K2
(ops/gather.py) or raise; ``device="cpu"`` runs the plain gather.
"""

from __future__ import annotations

import numpy as np
import torch

from prdisagg_torch.core.config import DataConfig
from prdisagg_torch.data.indices import compute_valid_indices_streamed
from prdisagg_torch.data.sampler import _check_rows
from prdisagg_torch.ops.gather import gather_patches


def compute_valid_indices_native(data: np.ndarray, cfg: DataConfig,
                                 include_last_box: bool = False,
                                 device="cuda") -> np.ndarray:
    """The JAX name of the day-streamed valid-patch scan of a (memmapped)
    tensor on `device`: data/indices.compute_valid_indices_streamed at its
    default chunk."""
    return compute_valid_indices_streamed(data, cfg, include_last_box,
                                          device=device)


def _checked_rows(indices, shape, ndomain: int) -> np.ndarray:
    """(S, 3) int32 rows, each checked to put a patch inside `shape`: the
    kernel does not check and would read out of bounds."""
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    if idx.size == 0:
        idx = idx.reshape(0, 3)
    _check_rows(torch.from_numpy(idx), shape, ndomain)
    return idx


def gather_patches_native(data: np.ndarray, indices: np.ndarray,
                          ndomain: int, device="cuda") -> np.ndarray:
    """Packed (S, nh, nd, nd) float32 patch store of an in-memory tensor,
    copied to `device` whole and gathered there: the JAX name, for a tensor
    that fits on the device.  A memmapped multi-year tensor goes through
    :func:`extract_patch_store`, which streams it."""
    idx = _checked_rows(indices, data.shape, ndomain)
    dev = torch.device(device)
    src = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
    out = gather_patches(src.to(dev), torch.from_numpy(idx).to(dev), ndomain)
    return out.cpu().numpy()


def extract_patch_store(data: np.ndarray, indices: np.ndarray, ndomain: int,
                        device="cuda") -> np.ndarray:
    """Day-streaming patch extraction for memmapped tensors: the offline pass
    that builds the compact (S, nh, nd, nd) float32 store, row s the patch
    of indices[s].  Each day that has rows is copied into one reused device
    slab (so the kernel's launch record, keyed by the source's address, is
    reused), its rows are gathered there and written to their places."""
    n_days, nh, ny, nx = data.shape
    idx = _checked_rows(indices, data.shape, ndomain)
    out = np.empty((len(idx), nh, ndomain, ndomain), dtype=np.float32)
    if len(idx) == 0:
        return out
    dev = torch.device(device)
    host = torch.empty((1, nh, ny, nx), dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    slab = host.to(dev) if dev.type != "cpu" else host
    order = np.argsort(idx[:, 0], kind="stable")
    days, starts = np.unique(idx[order, 0], return_index=True)
    for t, lo, hi in zip(days, starts, list(starts[1:]) + [len(order)]):
        sel = order[lo:hi]
        host.numpy()[0] = data[t]
        if slab is not host:
            slab.copy_(host, non_blocking=True)
        rows = idx[sel].copy()
        rows[:, 0] = 0  # the slab holds day t alone
        chunk = gather_patches(slab, torch.from_numpy(rows).to(dev), ndomain)
        # the copy back synchronises, so the staging buffer is free again
        out[sel] = chunk.cpu().numpy()
    return out
