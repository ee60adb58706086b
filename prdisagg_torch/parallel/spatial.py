"""Spatial sharding of the conv activations: their y rows split over the
ranks of a mesh axis, with halo rows exchanged between neighbours.

The port's counterpart of the JAX package's ``spatial_constraint``
(ops/core.py there), which asks XLA to shard y over a mesh axis and lets
its partitioner insert the halo exchanges.  Here the nets
(models/generator.py, models/critic.py) say it themselves, under an
ambient mesh (:func:`use_mesh`, the counterpart of
``jax.sharding.set_mesh``), when ``ModelConfig.spatial_axis`` names one of
its axes:

* the partition rule is XLA's uneven split: rank r of P owns rows
  ``[r*ceil(n/P), min(n, (r+1)*ceil(n/P)))`` (:func:`row_bounds`); an
  extent smaller than P stays replicated, JAX's "too small to shard" rule
  (:func:`is_sharded`);
* a conv's output rows on a rank need input rows beyond the rank's own:
  :func:`fetch_rows` returns rows ``[a, b)`` of a sharded or replicated
  tensor, zero outside ``[0, n)`` (the conv's padding); a sharded tensor's
  halo rows come from its neighbours;
* every exchange is an ``all_gather`` or an ``all_reduce``, which gloo
  also runs on CUDA tensors, so one card running several gloo ranks runs
  the code that NCCL would.

Gradients follow one convention: a replicated tensor's gradient is whole
on every rank, a sharded tensor's is that of the rank's rows.  So each
exchange is a pair of ``torch.autograd.Function``s, each the other's
adjoint and each calling the other in its backward, which keeps the
gradient penalty's second derivative right:

* :class:`_AllReduceSum` (partial sums -> replicated) and
  :class:`_CopyRep` (replicated -> each rank's use of it);
* :class:`_HaloFetch` (own rows -> rows ``[a, b)``) and
  :class:`_HaloAdjoint` (their gradient added back into the rows that own
  it).

A parameter used on a rank's rows gets only that rank's share of its
gradient, to be summed over the axis (:func:`sum_partial_grads`); one used
in replicated work (the latent projection, the score's bias, a stage whose
y is too small to shard) already holds its whole gradient on every rank
and must not be summed.  The nets name the first kind
(``spatial_partial_params``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

_meshes: List[object] = []

#: the exchanges made, by kind ("halo", "halo_adjoint", "sum", "grads"),
#: and, while
#: :data:`timed` is True, their seconds: each then waits for the device
#: before and after its collective, so that the seconds are the exchange's
exchanges = collections.Counter()
exchange_seconds = collections.Counter()
timed = False


def _exchange(kind: str, t: torch.Tensor, collective) -> None:
    """Run `collective()` on `t`'s device, counted and, if asked, timed."""
    exchanges[kind] += 1
    if not timed:
        collective()
        return
    cuda = t.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    collective()
    if cuda:
        torch.cuda.synchronize(t.device)
    exchange_seconds[kind] += time.perf_counter() - t0


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the nets under `mesh` (a 1-D ``DataMesh`` or a ``Mesh2D``,
    parallel/mesh.py): a config whose ``spatial_axis`` names one of its
    axes shards y over it."""
    _meshes.append(mesh)
    try:
        yield mesh
    finally:
        _meshes.pop()


def axis_mesh(axis: Optional[str]):
    """The ambient mesh's 1-D mesh of `axis`; None when `axis` is None.
    Raises when no ambient mesh has that axis, as the JAX package does
    outside ``set_mesh``."""
    if axis is None:
        return None
    for mesh in reversed(_meshes):
        sub = mesh.axis_mesh(axis)
        if sub is not None:
            return sub
    raise RuntimeError(f"spatial_axis={axis!r} needs a mesh with that axis: "
                       f"run the nets under parallel.spatial.use_mesh(mesh)")


def is_sharded(n: int, mesh) -> bool:
    """Whether an extent of n rows is split over `mesh`: not when there is
    no mesh or one rank, nor when n < the mesh's size."""
    return mesh is not None and mesh.size > 1 and n >= mesh.size


def row_bounds(n: int, rank: int, size: int) -> tuple:
    """[lo, hi) of rank `rank`'s rows of n over `size` ranks: XLA's uneven
    split, every slab padded to ceil(n / size) rows."""
    s = -(-n // size)
    return min(n, rank * s), min(n, (rank + 1) * s)


def own_rows(n: int, mesh) -> tuple:
    """[lo, hi) of this rank's rows of an extent of n (all of them when n
    is not sharded).  Raises where the split leaves a rank no rows."""
    if not is_sharded(n, mesh):
        return 0, n
    for r in range(mesh.size):
        lo, hi = row_bounds(n, r, mesh.size)
        if hi <= lo:
            raise ValueError(f"{n} rows over {mesh.size} '{mesh.axis}' ranks "
                             f"leave rank {r} none; use fewer ranks")
    return row_bounds(n, mesh.rank, mesh.size)


def shard_rows(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's rows of a replicated tensor that needs no gradient (data:
    real patches, conditions, dropout masks): a view."""
    lo, hi = own_rows(x.shape[dim], mesh)
    return x.narrow(dim, lo, hi - lo)


# -- the exchanges and their adjoints -----------------------------------------

def _f32(x: torch.Tensor) -> torch.Tensor:
    """Collectives move float32: exact for halo rows, one rounding fewer
    for sums of bf16 partials, and a type every backend takes."""
    return x.float().contiguous() if x.dtype != torch.float32 \
        else x.contiguous()


class _AllReduceSum(torch.autograd.Function):
    """Partial sums on every rank -> their sum, replicated.  The loss that
    uses it is computed alike on every rank, so the backward hands each rank
    the whole gradient as it is (no second sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = _f32(x).clone()
        _exchange("sum", y, lambda: dist.all_reduce(
            y, op=dist.ReduceOp.SUM, group=group))
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _CopyRep.apply(g, ctx.group), None


class _CopyRep(torch.autograd.Function):
    """A replicated tensor used on every rank: the identity, whose backward
    sums the ranks' gradients (each rank's use contributes its own)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the mesh's ranks of their partial `x`, replicated, with
    the gradient that a replicated loss needs."""
    return _AllReduceSum.apply(x, mesh.group)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Rows [a, b) of an extent of n split over `size` ranks, as rank `rank`
    needs them: every rank sends its first `dn` rows (for the rank above)
    and its last `up` rows (for the rank below) in one all_gather."""

    n: int
    rank: int
    size: int
    a: int
    b: int
    dn: int
    up: int
    dim: int
    group: object = None

    @property
    def own(self) -> tuple:
        return row_bounds(self.n, self.rank, self.size)


def halo_plan(n: int, mesh, need, dim: int) -> HaloPlan:
    """The exchange that gives every rank r of `mesh` the rows
    ``need(r) = (a_r, b_r)`` of a y extent of n sharded over it, computed
    alike on every rank.  Raises where a rank's halo would reach past its
    neighbours."""
    size = mesh.size
    dn = up = 0
    for r in range(size):
        lo, hi = row_bounds(n, r, size)
        a, b = need(r)
        below = min(b, n) - hi  # rows from rank r + 1's top
        above = lo - max(a, 0)  # rows from rank r - 1's bottom
        if below > 0 and (r + 1 >= size
                          or min(b, n) > row_bounds(n, r + 1, size)[1]):
            raise ValueError(f"rank {r}'s halo, rows [{a}, {b}) of {n}, "
                             f"reaches past the rank below it")
        if above > 0 and (r == 0 or max(a, 0) < row_bounds(n, r - 1, size)[0]):
            raise ValueError(f"rank {r}'s halo, rows [{a}, {b}) of {n}, "
                             f"reaches past the rank above it")
        dn, up = max(dn, below), max(up, above)
    return HaloPlan(n, mesh.rank, size, *need(mesh.rank), dn, up, dim,
                    mesh.group)


def _rows(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """x's rows [lo, hi) along `dim`, zero where outside [0, len)."""
    n = x.shape[dim]
    body = x.narrow(dim, max(lo, 0), max(0, min(hi, n) - max(lo, 0)))
    before, after = max(0, -lo), max(0, hi - max(lo, n))
    if before or after:
        pad = [0, 0] * (x.dim() - 1 - dim) + [before, after]
        body = F.pad(body, pad)
    return body


def _segments(p: HaloPlan):
    """The pieces of rows [a, b) in order: (source, start, count), source
    "zero", "own", "above" (rank - 1's sent bottom rows) or "below" (rank
    + 1's sent top rows), start an index into that source."""
    lo, hi = p.own
    out = []
    a, b = p.a, p.b
    if a < 0:
        out.append(("zero", 0, min(b, 0) - a))
    if max(a, 0) < min(b, lo):  # from rank - 1: its bottom `up` rows
        first = max(a, 0)
        prev_hi = row_bounds(p.n, p.rank - 1, p.size)[1]
        out.append(("above", first - (prev_hi - p.up), min(b, lo) - first))
    if max(a, lo) < min(b, hi):
        out.append(("own", max(a, lo) - lo, min(b, hi) - max(a, lo)))
    if max(a, hi) < min(b, p.n):  # from rank + 1: its top `dn` rows
        first = max(a, hi)
        next_lo = row_bounds(p.n, p.rank + 1, p.size)[0]
        out.append(("below", first - next_lo, min(b, p.n) - first))
    if b > p.n:
        out.append(("zero", 0, b - max(a, p.n)))
    return out


def _sent(x: torch.Tensor, p: HaloPlan) -> torch.Tensor:
    """What a rank sends: its first dn rows, then its last up rows (zero
    where the rank has fewer), along the plan's dim, in float32."""
    length = x.shape[p.dim]
    return _f32(torch.cat([_rows(x, p.dim, 0, p.dn),
                           _rows(x, p.dim, length - p.up, length)], p.dim))


class _HaloFetch(torch.autograd.Function):
    """A rank's own rows -> its rows [a, b): own rows, its neighbours' edge
    rows (one all_gather) and zeros outside [0, n)."""

    @staticmethod
    def forward(ctx, x, plan: HaloPlan):
        ctx.plan = plan
        segs = _segments(plan)
        parts = None
        if plan.dn + plan.up:  # every rank joins, needing halo rows or not
            sent = _sent(x, plan)
            parts = [torch.empty_like(sent) for _ in range(plan.size)]
            _exchange("halo", sent, lambda: dist.all_gather(
                parts, sent, group=plan.group))
        pieces = []
        for src, start, count in segs:
            if src == "zero":
                shape = list(x.shape)
                shape[plan.dim] = count
                pieces.append(x.new_zeros(shape))
            elif src == "own":
                pieces.append(x.narrow(plan.dim, start, count))
            elif src == "above":  # rank - 1's bottom rows follow its top dn
                pieces.append(parts[plan.rank - 1].narrow(
                    plan.dim, plan.dn + start, count).to(x.dtype))
            else:
                pieces.append(parts[plan.rank + 1].narrow(
                    plan.dim, start, count).to(x.dtype))
        return torch.cat(pieces, plan.dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _HaloAdjoint.apply(g, ctx.plan), None


class _HaloAdjoint(torch.autograd.Function):
    """The gradient of rows [a, b) -> that of the rank's own rows: its own
    part, plus what every rank's halo rows send back to their owner (one
    all_reduce of the edge rows)."""

    @staticmethod
    def forward(ctx, g, plan: HaloPlan):
        ctx.plan = plan
        lo, hi = plan.own
        shape = list(g.shape)
        shape[plan.dim] = hi - lo
        out = g.new_zeros(shape)
        segs = _segments(plan)
        back = None
        if plan.dn + plan.up:
            eshape = list(g.shape)
            eshape[plan.dim] = plan.dn + plan.up
            back = g.new_zeros([plan.size] + eshape, dtype=torch.float32)
        at = 0
        for src, start, count in segs:
            piece = g.narrow(plan.dim, at, count)
            at += count
            if src == "own":
                out.narrow(plan.dim, start, count).add_(piece)
            elif src == "above":
                back[plan.rank - 1].narrow(
                    plan.dim, plan.dn + start, count).add_(piece)
            elif src == "below":
                back[plan.rank + 1].narrow(plan.dim, start, count).add_(piece)
        if back is not None:
            _exchange("halo_adjoint", back, lambda: dist.all_reduce(
                back, op=dist.ReduceOp.SUM, group=plan.group))
            mine = back[plan.rank]
            length = hi - lo
            top = min(plan.dn, length)
            out.narrow(plan.dim, 0, top).add_(
                mine.narrow(plan.dim, 0, top).to(g.dtype))
            bot = min(plan.up, length)
            out.narrow(plan.dim, length - bot, bot).add_(mine.narrow(
                plan.dim, plan.dn + plan.up - bot, bot).to(g.dtype))
        return out

    @staticmethod
    def backward(ctx, gg):
        return _HaloFetch.apply(gg, ctx.plan), None


# -- what the nets call -------------------------------------------------------

def fetch_rows(x: torch.Tensor, n: int, mesh, need, dim: int,
               sharded: Optional[bool] = None) -> torch.Tensor:
    """Rows ``need(r) = (a, b)`` of an activation with n rows along `dim`,
    for rank r's output rows, zero outside [0, n), as a new contiguous
    tensor.  `x` is the rank's own rows when it is `sharded` (by default,
    when n is split over `mesh`), else the whole (replicated) tensor, whose
    gradient then comes back whole on every rank."""
    if is_sharded(n, mesh) if sharded is None else sharded:
        own_rows(n, mesh)
        return _HaloFetch.apply(x, halo_plan(n, mesh, need, dim))
    a, b = need(0 if mesh is None else mesh.rank)
    if mesh is not None and mesh.size > 1:
        x = _CopyRep.apply(x, mesh.group)
    return _rows(x, dim, a, b).contiguous()


def gather_rows(x: torch.Tensor, n: int, mesh, dim: int,
                sharded: Optional[bool] = None) -> torch.Tensor:
    """The whole activation, replicated, from each rank's own rows of an
    extent of n along `dim`; `x` itself when it is not `sharded` (by
    default, when n is not split over `mesh`)."""
    if not (is_sharded(n, mesh) if sharded is None else sharded):
        return x
    lo, hi = own_rows(n, mesh)
    return all_reduce_sum(_rows(x, dim, -lo, n - lo), mesh)


def sum_partial_grads(grads: Sequence[torch.Tensor], names: Sequence[str],
                      partial: set, mesh) -> list:
    """The gradients with those named in `partial` (each rank's share)
    summed over the mesh in one all-reduce of a flat float32 bucket; the
    others (whole on every rank) as they are."""
    grads = list(grads)
    if mesh is None or mesh.size == 1:
        return grads
    which = [i for i, n in enumerate(names) if n in partial]
    if not which:
        return grads
    flat = torch.cat([grads[i].reshape(-1).float() for i in which])
    _exchange("grads", flat, lambda: dist.all_reduce(
        flat, op=dist.ReduceOp.SUM, group=mesh.group))
    for i, part in zip(which, flat.split([grads[i].numel() for i in which])):
        grads[i] = part.view_as(grads[i]).to(grads[i].dtype)
    return grads
