"""The data-parallel mesh: which rank this process is, of how many, on
which device, and the collectives the port needs over it.

The JAX package shards the batch axis over a 1-D ``jax.sharding.Mesh``
named ``data`` and lets XLA insert the gradient all-reduce.  The port runs
one process per device under ``torch.distributed``
(parallel/distributed.py) and says where the work runs explicitly:

* every rank draws the global batch's random inputs from the same seeded
  generator and computes its own contiguous shard (:func:`batch_shard`);
* parameters, optimizer state, the random stream and the dataset are
  replicated: made identically on every rank and made identical
  (:func:`replicate`, a broadcast from rank 0 into the existing tensors);
* gradients and loss-like metrics are averaged (:func:`all_reduce_mean`),
  and per-sample outputs collected (:func:`all_gather_batch`).

The sharding helpers are pure functions of ``(rank, size)``, so a
:class:`DataMesh` with no process group behind it describes any rank of
any world for them.  Collectives run on the mesh's process group: NCCL on
the card, gloo on the CPU (gloo also takes CUDA tensors, so several ranks
can share one card).

A :class:`DataMesh` may name another axis: ``make_mesh(4, axis="spatial")``
is the JAX package's 1-D spatial mesh, over which parallel/spatial.py
splits the y rows of the conv activations.  :func:`make_mesh_2d` lays the
world out as a (data, spatial) grid, the counterpart of
``Mesh(devices.reshape(D, S), ("data", "spatial"))``: one process group per
row (the spatial ranks of one data shard) and per column.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from prdisagg_torch.core.device import resolve_device

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """Rank `rank` of `size` processes, computing on `device`, with
    collectives over `group` (None: the default group)."""

    rank: int
    size: int
    group: Optional[object] = None
    device: torch.device = torch.device("cpu")
    axis: str = DATA_AXIS

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def axis_mesh(self, name: str) -> Optional["DataMesh"]:
        """This mesh if it is the axis `name`, else None."""
        return self if name == self.axis else None


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """Rank `rank` of a world of `size` processes laid out as a (data,
    spatial) grid: world rank = data index * spatial size + spatial index.
    `data` and `spatial` are this rank's 1-D meshes along each axis, each
    over its own process group; `group` is the whole world's, over which
    :func:`replicate` broadcasts."""

    data: DataMesh
    spatial: DataMesh
    group: Optional[object] = None
    device: torch.device = torch.device("cpu")

    @property
    def rank(self) -> int:
        return self.data.rank * self.spatial.size + self.spatial.rank

    @property
    def size(self) -> int:
        return self.data.size * self.spatial.size

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def axis_mesh(self, name: str) -> Optional[DataMesh]:
        """The 1-D mesh of axis `name`, or None if the grid has no such
        axis."""
        return {self.data.axis: self.data,
                self.spatial.axis: self.spatial}.get(name)


def _world_device(n_devices: Optional[int], device) -> torch.device:
    """The device of this rank of the started process group, checked."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: data parallelism needs one process per "
            "device under a launcher, e.g. torchrun --standalone "
            "--nproc-per-node N, and initialize_multihost() in each")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested a mesh of {n_devices} devices, the "
                         f"process group has {world} ranks")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL process group computes on the card, not "
                         f"on {device}")
    return device


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              axis: str = DATA_AXIS) -> DataMesh:
    """The 1-D mesh named `axis` over the started process group
    (parallel/distributed.py ``initialize_multihost``), computing on
    `device`: "cuda" is this process's current card.  Raises when no group
    was started, or when `n_devices` is given and differs from its world
    size: a data-parallel run never shrinks to a single process on its
    own."""
    device = _world_device(n_devices, device)
    return DataMesh(rank=dist.get_rank(), size=dist.get_world_size(),
                    group=dist.group.WORLD, device=device, axis=axis)


def make_mesh_2d(n_data: int, n_spatial: int, device="cuda") -> Mesh2D:
    """The started process group as an (n_data, n_spatial) grid of axes
    ``data`` and ``spatial``, computing on `device` (as :func:`make_mesh`).
    World rank r sits at data index r // n_spatial and spatial index
    r % n_spatial.
    Makes one process group per row and per column; a collective, called
    by every rank in the same order."""
    device = _world_device(n_data * n_spatial, device)
    rank = dist.get_rank()
    di, si = divmod(rank, n_spatial)
    rows = [dist.new_group([d * n_spatial + s for s in range(n_spatial)])
            for d in range(n_data)]
    cols = [dist.new_group([d * n_spatial + s for d in range(n_data)])
            for s in range(n_spatial)]
    return Mesh2D(
        data=DataMesh(rank=di, size=n_data, group=cols[si], device=device,
                      axis=DATA_AXIS),
        spatial=DataMesh(rank=si, size=n_spatial, group=rows[di],
                         device=device, axis=SPATIAL_AXIS),
        group=dist.group.WORLD, device=device)


# -- sharding: pure functions of (rank, size) ---------------------------------

def shard_bounds(n: int, mesh: DataMesh) -> tuple:
    """[lo, hi) of this rank's contiguous shard of a batch of n."""
    if n % mesh.size:
        raise ValueError(f"batch {n} not divisible by mesh axis "
                         f"'{mesh.axis}' size {mesh.size}")
    q = n // mesh.size
    return mesh.rank * q, (mesh.rank + 1) * q


def batch_shard(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """This rank's contiguous dim-0 slice of `x` (a view)."""
    lo, hi = shard_bounds(x.shape[0], mesh)
    return x[lo:hi]


# -- collectives --------------------------------------------------------------

def _on_backend(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """`t`, or a copy on the mesh's card where NCCL cannot reach `t` (a
    host tensor: a random stream's state, a CPU optimizer's step)."""
    if mesh.backend == "nccl" and t.device.type != "cuda":
        return t.to(mesh.device)
    return t


def _broadcast_(t: torch.Tensor, mesh: DataMesh) -> None:
    src = _on_backend(t, mesh)
    dist.broadcast(src, 0, group=mesh.group)
    if src is not t:
        t.copy_(src)


def replicate(obj, mesh: DataMesh):
    """Make `obj` on every rank equal to rank 0's, in place, and return it:
    a tensor, a module (parameters and buffers), an optimizer (its
    per-parameter state), a ``torch.Generator`` (its state), an int, or a
    dataclass or dict of those (a training state).  Tensors
    are overwritten where they lie, so a CUDA graph captured on them reads
    the broadcast values.  A collective: every rank calls it with the same
    structure."""
    with torch.no_grad():
        return _replicate(obj, mesh)


def _replicate(obj, mesh: DataMesh):
    if obj is None:
        return obj
    if isinstance(obj, torch.Tensor):
        _broadcast_(obj, mesh)
    elif isinstance(obj, int):
        t = torch.tensor([obj], dtype=torch.int64)
        _broadcast_(t, mesh)
        return int(t.item())
    elif isinstance(obj, nn.Module):
        for t in obj.state_dict(keep_vars=True).values():
            _broadcast_(t.data, mesh)
    elif isinstance(obj, torch.optim.Optimizer):
        for group in obj.param_groups:
            for p in group["params"]:
                _replicate(obj.state[p], mesh)
    elif isinstance(obj, torch.Generator):
        state = obj.get_state()
        _broadcast_(state, mesh)
        obj.set_state(state)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            setattr(obj, f.name, _replicate(getattr(obj, f.name), mesh))
    elif isinstance(obj, dict):
        for k in obj:
            obj[k] = _replicate(obj[k], mesh)
    else:
        raise TypeError(f"replicate cannot broadcast a {type(obj).__name__}")
    return obj


def all_reduce_mean(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Average `t` over the ranks, in place, and return it.  On NCCL one
    AVG all-reduce (one kernel, also at world size 1, and one that a CUDA
    graph captures); gloo has no AVG: a sum, then a division."""
    if mesh.backend == "nccl":
        dist.all_reduce(t, op=dist.ReduceOp.AVG, group=mesh.group)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
        t.div_(mesh.size)
    return t


def all_gather_batch(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's `x`, of one shape, concatenated along dim 0 in rank
    order: the global batch from its shards."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def barrier(mesh: DataMesh) -> None:
    """Wait until every rank arrives."""
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)
