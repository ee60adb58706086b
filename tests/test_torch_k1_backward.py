"""K1's backward kernels (``csrc/upsample_conv.cu``) emulated on the CPU,
against the plain backward and JAX.

The card's kernels cannot run here, so this file repeats their index math
in PyTorch.  The bf16 halo kernels: dx on blocks of low-res positions, each
phase's cotangent sub-box (zero-filled outside the full-res grid) read at
the 8 taps' windows against the forward's packing ``kp`` as it is, the
reduction units of each split summed, the splits in cluster rank order;
dk per phase on position blocks, the input sub-box read at the taps'
windows against the block's cotangent rows, the blocks of each split
summed, the splits in rank order, the first Cin tile's column sums of the
cotangent rows giving the bias gradient, then the fold kernel's (phase,
tap) pairs onto the 3^3 kernel and its sum of the phases' bias sums.  The
f32 halo kernels: the same walk with their own limits (units of 8
channels, dk blocks of 64 positions), dx against the TF32 parts of the
permuted weights (``pack_backward_kernels_tf32``), every product as three
TF32 products of ``split_tf32``'s parts summed in float32, a fresh sum for
each unit (dx) or block (dk) added to the split's.  The FMA kernels (other
widths): dx as one implicit GEMM whose rows gather the cotangent at the 64
full-res offsets against the weights ``pack_backward_kernels`` permutes,
dk as one GEMM per phase, each reduction cut into ``k1_backward_plan``'s
splits by ``split_range``, the partials summed in split order and folded.
The emulation must equal ``upsample2_conv3_backward`` and JAX's
``jax.vjp`` of the Pallas op (interpret mode) within float32 rtol 1e-4,
atol 1e-5 of the maximum.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.ops import upsample_conv as tuc  # noqa: E402
from prdisagg_tpu.ops.fused_upsample_conv import _phase_kernels  # noqa: E402
from prdisagg_tpu.ops.pallas_upsample_conv import (  # noqa: E402
    upsample2_conv3_pallas_interpret,
)

SOURCE = Path(tuc.__file__).resolve().parents[1] / "csrc" / "upsample_conv.cu"
# flagship generator stages (D, H, W, Cin, Cout)
FLAGSHIP_STAGES = [(3, 2, 2, 256, 256), (6, 4, 4, 256, 128),
                   (12, 8, 8, 128, 64)]
DTYPES = [torch.float32, torch.bfloat16]
RTOL, ATOL = 1e-4, 1e-5  # rtol, atol of the largest reference value


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype("f4")


def _positions(b, d, h, w):
    """(n, d, h, w) of every low-res position m, as the kernels decompose
    m = ((n*D + d)*H + h)*W + w."""
    m = torch.arange(b * d * h * w)
    return m // (d * h * w), m // (h * w) % d, m // w % h, m % w


def _fold_tap(i, pair):
    """k1_dk_fold's table: the tap of phase bit `pair` folding onto 3^3
    index i."""
    return 0 if i == 0 else (1 if i == 2 else 1 - pair)


def _fold(part):
    """k1_dk_fold: part (splits, 8 phases, 8 taps, Cin, Cout) summed over
    the splits in order, then over the 8 (phase, tap) pairs that fold onto
    each 3^3 index."""
    cin, cout = part.shape[-2:]
    dk = torch.zeros(3, 3, 3, cin, cout)
    for i, j, k in np.ndindex(3, 3, 3):
        for s in range(part.shape[0]):
            for pair in range(8):
                a, bb, c = pair >> 2, (pair >> 1) & 1, pair & 1
                tap = (_fold_tap(i, a) * 4 + _fold_tap(j, bb) * 2
                       + _fold_tap(k, c))
                dk[i, j, k] += part[s, pair, tap]
    return dk


def _blocks(plan):
    """The origins (n0, d0, h0, w0) of a halo plan's blocks, in the
    kernels' order (w fastest)."""
    tn, td, th, tw = plan.block
    return [(bn * tn, bd * td, bh * th, bw * tw)
            for bn, bd, bh, bw in np.ndindex(*plan.grid)]


def _local(extents, count):
    """(in, id, ih, iw) of local index 0..count-1 in a box of `extents`,
    w fastest, as the kernels decompose it."""
    q = torch.arange(count)
    tn, td, th, tw = extents
    return q // (td * th * tw), q // (th * tw) % td, q // tw % th, q % tw


def _subbox_rows(extents, origin, a, b, c, shape, full_res):
    """The flat source row of every sub-box row (in, ld, lh, lw) of phase
    (a, b, c) of the block at `origin`, or -1 where it lies outside the
    tensor (the kernels' zero fill).  Cotangent (full_res): the phase's
    sub-grid rows (d0 - a + ld, ...) at full-res 2(d0 + ld) - a; input: x
    at (d0 + a - 1 + ld, ...)."""
    tn, td, th, tw = extents
    nb, d, h, w = shape
    i_n, ld, lh, lw = _local((tn, td + 1, th + 1, tw + 1),
                             tn * (td + 1) * (th + 1) * (tw + 1))
    n0, d0, h0, w0 = origin
    n = n0 + i_n
    if full_res:
        dd, hh, ww = 2 * (d0 + ld) - a, 2 * (h0 + lh) - b, 2 * (w0 + lw) - c
        d, h, w = 2 * d, 2 * h, 2 * w
    else:
        dd, hh, ww = d0 + a - 1 + ld, h0 + b - 1 + lh, w0 + c - 1 + lw
    inside = ((n < nb) & (dd >= 0) & (dd < d) & (hh >= 0) & (hh < h)
              & (ww >= 0) & (ww < w))
    return torch.where(inside, ((n * d + dd) * h + hh) * w + ww, -1)


def _rows_of(flat, rows):
    """flat[rows] with -1 reading a zero row."""
    z = torch.cat([flat, torch.zeros(1, flat.shape[1])])
    return z[torch.where(rows >= 0, rows, len(flat))]


def _emulate_dx(g, kp, cin, plan):
    """k1_dx_bf16_halo: per block of positions and per split, the split's
    reduction units (phase, 16 output channels), each the phase's
    cotangent sub-box read at the 8 taps' windows (position (in, id, ih,
    iw), tap (p, q, r) -> sub-box row (in, id+1-p, ih+1-q, iw+1-r); rows
    past the block read position 0's and are not stored) times kp[phase,
    channels, tap*Cin + ci] read in place; the splits' tiles summed in
    rank order; stored where the position lies in the tensor."""
    b, d2, h2, w2, cout = g.shape
    d, h, w = d2 // 2, h2 // 2, w2 // 2
    p = plan.dx
    tn, td, th, tw = p.block
    sd, sh, sw = td + 1, th + 1, tw + 1
    npos = tn * td * th * tw
    assert npos <= tuc.HALO_BM and p.rows == tn * sd * sh * sw
    assert p.rows <= tuc.HALO_DX_RMAX and p.units == 8 * cout // tuc.HALO_CO
    gflat = g.reshape(-1, cout)
    m = torch.arange(tuc.HALO_BM)
    i_n, i_d, i_h, i_w = _local(p.block, npos)
    i_n, i_d, i_h, i_w = (t[torch.where(m < npos, m, 0)]
                          for t in (i_n, i_d, i_h, i_w))
    rho0 = ((i_n * sd + i_d + 1) * sh + i_h + 1) * sw + i_w + 1
    dx = torch.zeros(b, d, h, w, cin)
    for origin in _blocks(p):
        boxes = [_subbox_rows(p.block, origin, ph >> 2, (ph >> 1) & 1, ph & 1,
                              (b, d, h, w), True) for ph in range(8)]
        tile = None
        for s in range(p.splits):
            acc = torch.zeros(tuc.HALO_BM, cin)
            for u in range(*tuc.split_range(p.units, p.splits, s)):
                ph, c0 = u & 7, (u >> 3) * tuc.HALO_CO
                box = _rows_of(gflat[:, c0:c0 + tuc.HALO_CO], boxes[ph])
                for tap in range(8):
                    rho = rho0 - ((tap >> 2) * sh * sw
                                  + ((tap >> 1) & 1) * sw + (tap & 1))
                    acc += box[rho] @ kp[ph, c0:c0 + tuc.HALO_CO,
                                         tap * cin:(tap + 1) * cin]
            tile = acc if tile is None else tile + acc
        n0, d0, h0, w0 = origin
        n, dd, hh, ww = (o + t[:npos] for o, t in zip(
            origin, _local(p.block, npos)))
        keep = (n < b) & (dd < d) & (hh < h) & (ww < w)
        dx[n[keep], dd[keep], hh[keep], ww[keep]] = tile[:npos][keep]
    return dx


def _emulate_dk(x, g, plan):
    """k1_dk_bf16_halo, then k1_dk_fold: per phase and per split, the
    split's position blocks, each the phase's input sub-box read at the 8
    taps' windows (position (in, id, ih, iw), tap (p, q, r) -> sub-box row
    (in, id+p, ih+q, iw+r)) against the block's cotangent rows of the
    phase (zero past the block or the tensor), and the rows' column sums
    (the bias gradient's share); the splits summed in rank order; then the
    fold, and the bias sums summed over the phases in order.  Returns
    (dkernel, db)."""
    b, d, h, w, cin = x.shape
    cout = g.shape[-1]
    p = plan.dk
    tn, td, th, tw = p.block
    sd, sh, sw = td + 1, th + 1, tw + 1
    npos = tn * td * th * tw
    assert npos <= tuc.HALO_BP and p.rows == tn * sd * sh * sw
    assert p.rows <= tuc.HALO_DK_RMAX and p.tiles == 8 * (cin // 64) * (
        cout // 64)
    blocks = _blocks(p)
    assert p.units == len(blocks)
    xflat, gflat = x.reshape(-1, cin), g.reshape(-1, cout)
    i_n, i_d, i_h, i_w = _local(p.block, npos)
    rho0 = ((i_n * sd + i_d) * sh + i_h) * sw + i_w
    part = torch.zeros(1, 8, 8, cin, cout)
    dbp = torch.zeros(8, cout)
    for ph in range(8):
        a, bb, c = ph >> 2, (ph >> 1) & 1, ph & 1
        for s in range(p.splits):
            acc = torch.zeros(8, cin, cout)
            dbs = torch.zeros(cout)
            for bi in range(*tuc.split_range(p.units, p.splits, s)):
                n0, d0, h0, w0 = blocks[bi]
                box = _rows_of(xflat, _subbox_rows(
                    p.block, blocks[bi], a, bb, c, (b, d, h, w), False))
                n, dd, hh, ww = n0 + i_n, d0 + i_d, h0 + i_h, w0 + i_w
                inside = (n < b) & (dd < d) & (hh < h) & (ww < w)
                grow = (((n * 2 * d + 2 * dd + a) * 2 * h + 2 * hh + bb)
                        * 2 * w + 2 * ww + c)
                rows = _rows_of(gflat, torch.where(inside, grow, -1))
                dbs += rows.sum(0)
                for tap in range(8):
                    rho = rho0 + ((tap >> 2) * sh * sw
                                  + ((tap >> 1) & 1) * sw + (tap & 1))
                    acc[tap] += box[rho].T @ rows
            part[0, ph] += acc
            dbp[ph] += dbs
    return _fold(part), dbp.sum(0)


def _mm3(a, b_hi, b_lo):
    """a @ b in 3xTF32, as the f32 halo kernels take it: a split by
    split_tf32, the three TF32 products small terms first, summed in
    float32."""
    a_hi, a_lo = tuc.split_tf32(a)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _emulate_dx_f32(g, kp, cin, plan):
    """k1_dx_f32_halo: k1_dx_bf16_halo's walk with units of (phase,
    HALO_F32_CO output channels) against the TF32 parts of the permuted
    weights, wt[part, ci, off*Cout + c0..] with off = 16*(2p + a) +
    4*(2q + b) + 2r + c; each unit's 3xTF32 products summed afresh, then
    added to the split's tile; the splits' tiles summed in rank order."""
    b, d2, h2, w2, cout = g.shape
    d, h, w = d2 // 2, h2 // 2, w2 // 2
    co_n = tuc.HALO_F32_CO
    p = plan.dx
    tn, td, th, tw = p.block
    sd, sh, sw = td + 1, th + 1, tw + 1
    npos = tn * td * th * tw
    assert npos <= tuc.HALO_F32_BM and p.rows == tn * sd * sh * sw
    assert p.rows <= tuc.HALO_F32_DX_RMAX and p.units == 8 * cout // co_n
    wt = tuc.pack_backward_kernels_tf32(kp)
    gflat = g.reshape(-1, cout)
    m = torch.arange(tuc.HALO_F32_BM)
    i_n, i_d, i_h, i_w = _local(p.block, npos)
    i_n, i_d, i_h, i_w = (t[torch.where(m < npos, m, 0)]
                          for t in (i_n, i_d, i_h, i_w))
    rho0 = ((i_n * sd + i_d + 1) * sh + i_h + 1) * sw + i_w + 1
    dx = torch.zeros(b, d, h, w, cin)
    for origin in _blocks(p):
        boxes = [_subbox_rows(p.block, origin, ph >> 2, (ph >> 1) & 1, ph & 1,
                              (b, d, h, w), True) for ph in range(8)]
        tile = None
        for s in range(p.splits):
            acc = torch.zeros(tuc.HALO_F32_BM, cin)
            for u in range(*tuc.split_range(p.units, p.splits, s)):
                ph, c0 = u & 7, (u >> 3) * co_n
                a, bb, c = ph >> 2, (ph >> 1) & 1, ph & 1
                box = _rows_of(gflat[:, c0:c0 + co_n], boxes[ph])
                unit = torch.zeros(tuc.HALO_F32_BM, cin)
                for tap in range(8):
                    pp, q, r = tap >> 2, (tap >> 1) & 1, tap & 1
                    off = 16 * (2 * pp + a) + 4 * (2 * q + bb) + 2 * r + c
                    cols = slice(off * cout + c0, off * cout + c0 + co_n)
                    rho = rho0 - (pp * sh * sw + q * sw + r)
                    unit += _mm3(box[rho], wt[0][:, cols].T, wt[1][:, cols].T)
                acc += unit
            tile = acc if tile is None else tile + acc
        n, dd, hh, ww = (o + t[:npos] for o, t in zip(
            origin, _local(p.block, npos)))
        keep = (n < b) & (dd < d) & (hh < h) & (ww < w)
        dx[n[keep], dd[keep], hh[keep], ww[keep]] = tile[:npos][keep]
    return dx


def _emulate_dk_f32(x, g, plan):
    """k1_dk_f32_halo, then k1_dk_fold: k1_dk_bf16_halo's walk over blocks
    of at most HALO_F32_BP positions, each tap's product in 3xTF32 (the
    cotangent rows split once a block, as the kernel's transpose does),
    each block's products summed afresh, then added to the split's; the
    splits in rank order; the fold and the phases' bias sums.  Returns
    (dkernel, db)."""
    b, d, h, w, cin = x.shape
    cout = g.shape[-1]
    p = plan.dk
    tn, td, th, tw = p.block
    sd, sh, sw = td + 1, th + 1, tw + 1
    npos = tn * td * th * tw
    assert npos <= tuc.HALO_F32_BP and p.rows == tn * sd * sh * sw
    assert p.rows <= tuc.HALO_F32_DK_RMAX and p.tiles == 16 * (cin // 64) * (
        cout // 64)
    blocks = _blocks(p)
    assert p.units == len(blocks)
    xflat, gflat = x.reshape(-1, cin), g.reshape(-1, cout)
    i_n, i_d, i_h, i_w = _local(p.block, npos)
    rho0 = ((i_n * sd + i_d) * sh + i_h) * sw + i_w
    part = torch.zeros(1, 8, 8, cin, cout)
    dbp = torch.zeros(8, cout)
    for ph in range(8):
        a, bb, c = ph >> 2, (ph >> 1) & 1, ph & 1
        for s in range(p.splits):
            acc = torch.zeros(8, cin, cout)
            dbs = torch.zeros(cout)
            for bi in range(*tuc.split_range(p.units, p.splits, s)):
                n0, d0, h0, w0 = blocks[bi]
                box = _rows_of(xflat, _subbox_rows(
                    p.block, blocks[bi], a, bb, c, (b, d, h, w), False))
                n, dd, hh, ww = n0 + i_n, d0 + i_d, h0 + i_h, w0 + i_w
                inside = (n < b) & (dd < d) & (hh < h) & (ww < w)
                grow = (((n * 2 * d + 2 * dd + a) * 2 * h + 2 * hh + bb)
                        * 2 * w + 2 * ww + c)
                rows = _rows_of(gflat, torch.where(inside, grow, -1))
                dbs += rows.sum(0)
                r_hi, r_lo = tuc.split_tf32(rows)
                for tap in range(8):
                    rho = rho0 + ((tap >> 2) * sh * sw
                                  + ((tap >> 1) & 1) * sw + (tap & 1))
                    acc[tap] += _mm3(box[rho].T.contiguous(), r_hi, r_lo)
            part[0, ph] += acc
            dbp[ph] += dbs
    return _fold(part), dbp.sum(0)


def _emulate_dx_fma(g, wb, cin, plan):
    """The FMA dx kernels: row m gathers the cotangent row of (2d+u, 2h+v,
    2w+t), one shift from the row of (2d, 2h, 2w), masked by one test per
    slice; slice kt of split s covers offset kt // slices, channels
    (kt % slices)*bk..; the splits' partials are summed in split order."""
    b, d2, h2, w2, cout = g.shape
    d, h, w = d2 // 2, h2 // 2, w2 // 2
    n, dd, hh, ww = _positions(b, d, h, w)
    base = ((n * d2 + 2 * dd) * h2 + 2 * hh) * w2 + 2 * ww
    gflat = g.reshape(-1, cout)
    p = plan.dx
    slices = -(-cout // p.bk)
    assert p.kt == 64 * slices
    out = None
    for s in range(p.splits):
        part = torch.zeros(b * d * h * w, cin)
        for kt in range(*tuc.split_range(p.kt, p.splits, s)):
            off, c0 = kt // slices, kt % slices * p.bk
            u, v, t = 2 - (off >> 4), 2 - ((off >> 2) & 3), 2 - (off & 3)
            shift = (u * h2 + v) * w2 + t
            inside = ((2 * dd + u >= 0) & (2 * dd + u < d2)
                      & (2 * hh + v >= 0) & (2 * hh + v < h2)
                      & (2 * ww + t >= 0) & (2 * ww + t < w2))
            c1 = min(c0 + p.bk, cout)
            rows = gflat[torch.where(inside, base + shift, 0), c0:c1]
            rows = rows * inside[:, None]
            part += rows @ wb[:, off * cout + c0:off * cout + c1].T
        out = part if out is None else out + part
    return out.reshape(b, d, h, w, cin)


def _emulate_dk_fma(x, g, plan):
    """The FMA dk kernels: per phase, A[(tap, ci), m] = x[m + shift(phase,
    tap), ci] (zero outside the input), B[m, co] = g[(2d+a, 2h+b, 2w+c) of
    m, co]; slices of bk positions, split by split_range; then the fold
    kernel: splits in order, then the 8 (phase, tap) pairs."""
    b, d, h, w, cin = x.shape
    cout = g.shape[-1]
    n, dd, hh, ww = _positions(b, d, h, w)
    m = torch.arange(b * d * h * w)
    xflat, gflat = x.reshape(-1, cin), g.reshape(-1, cout)
    p = plan.dk
    assert p.kt == -(-(b * d * h * w) // p.bk)
    part = torch.zeros(p.splits, 8, 8 * cin, cout)
    for phase in range(8):
        pa, pb, pc = phase >> 2, (phase >> 1) & 1, phase & 1
        cols = []
        for tap in range(8):
            od = pa + (tap >> 2) - 1
            oh = pb + ((tap >> 1) & 1) - 1
            ow = pc + (tap & 1) - 1
            inside = ((dd + od >= 0) & (dd + od < d) & (hh + oh >= 0)
                      & (hh + oh < h) & (ww + ow >= 0) & (ww + ow < w))
            src = torch.where(inside, m + (od * h + oh) * w + ow, 0)
            cols.append(xflat[src] * inside[:, None])
        a_rows = torch.cat(cols, 1)  # (positions, 8*Cin), k = tap*Cin + ci
        grow = (((n * 2 * d + 2 * dd + pa) * 2 * h + 2 * hh + pb) * 2 * w
                + 2 * ww + pc)
        b_rows = gflat[grow]
        for s in range(p.splits):
            for kt in range(*tuc.split_range(p.kt, p.splits, s)):
                sl = slice(kt * p.bk, (kt + 1) * p.bk)
                part[s, phase] += a_rows[sl].T @ b_rows[sl]
    return _fold(part.reshape(p.splits, 8, 8, cin, cout))


def _jax_grads(x, k, bias, g):
    return jax.jit(lambda *a: jax.vjp(upsample2_conv3_pallas_interpret,
                                      *a[:3])[1](a[3]))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), jnp.asarray(g))


def _close(got, want):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


CASES = [
    # flagship widths at a small batch
    (2, 3, 2, 2, 256, 256),
    (1, 6, 4, 4, 256, 128),
    (1, 12, 8, 8, 128, 64),
    # odd widths and extents
    (2, 3, 2, 2, 8, 6),
    (3, 2, 3, 2, 4, 5),
    (1, 3, 5, 3, 7, 9),
    # halo blocks that do not divide W or B; an odd y-slab of the
    # spatial path's 64x64 stage 0 (its P 4 slab is y 4); a 64x64 stage
    (3, 5, 7, 11, 64, 64),
    (11, 3, 2, 2, 64, 64),
    (2, 3, 5, 8, 64, 128),
    (1, 3, 8, 8, 256, 256),
]


def _emulate(x, k, g, plan):
    """(dx, dkernel, db) by the kernels a plan names: the halo kernels
    (bf16 or f32) with their bias sums, or the FMA kernels (db by one
    reduction)."""
    cin = x.shape[-1]
    kp = tuc.pack_phase_kernels(k, torch.float32)
    if plan.variant == "halo":
        dk, db = _emulate_dk(x, g, plan)
        return _emulate_dx(g, kp, cin, plan), dk, db
    if plan.variant == "halo_f32":
        dk, db = _emulate_dk_f32(x, g, plan)
        return _emulate_dx_f32(g, kp, cin, plan), dk, db
    wb = tuc.pack_backward_kernels(kp)
    return (_emulate_dx_fma(g, wb, cin, plan), _emulate_dk_fma(x, g, plan),
            g.sum(dim=(0, 1, 2, 3)))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32_plan", "bf16_plan"])
@pytest.mark.parametrize("shape", CASES)
def test_emulated_kernels_match_plain_backward_and_jax(shape, dtype):
    """dx, dk and db by the kernels' index math and split reduction, at
    the plan the card would take for this dtype (computed here in
    float32)."""
    b, d, h, w, cin, cout = shape
    x = _x((b, d, h, w, cin), seed=sum(shape))
    k = _x((3, 3, 3, cin, cout), seed=sum(shape) + 1, scale=0.1)
    bias = _x((cout,), seed=sum(shape) + 2)
    g = _x((b, 2 * d, 2 * h, 2 * w, cout), seed=sum(shape) + 3)
    plan = tuc.k1_backward_plan(dtype, *shape)
    tx, tk, tg = (torch.tensor(a) for a in (x, k, g))
    dx, dk, db = _emulate(tx, tk, tg, plan)
    want_dx, want_dk = tuc.upsample2_conv3_backward(tx, tk, tg)
    _close(dx.numpy(), want_dx.numpy())
    _close(dk.numpy(), want_dk.numpy())
    jdx, jdk, jdb = _jax_grads(x, k, bias, g)
    _close(dx.numpy(), jdx)
    _close(dk.numpy(), jdk)
    _close(db.numpy(), jdb)


def test_cases_hold_ragged_halo_blocks_and_splits():
    """The bf16 cases above reach blocks that overhang the tensor in W and
    in B, blocks of several samples, and both kernels' cluster sums."""
    plans = [tuc.k1_backward_plan(torch.bfloat16, *s) for s in CASES]
    halo = [(s, p) for s, p in zip(CASES, plans) if p.variant == "halo"]
    ragged = {i for s, p in halo for q in (p.dx, p.dk)
              for i, (n, t, e) in enumerate(zip(q.grid, q.block, s[:4]))
              if n * t > e}
    assert {0, 3} <= ragged
    assert any(p.dx.block[0] > 1 for _, p in halo)
    assert any(p.dx.splits > 1 for _, p in halo)
    assert any(p.dk.splits > 1 for _, p in halo)


def test_halo_kernels_read_the_forward_packing_in_place(monkeypatch):
    """The bf16 path never permutes the weights: the emulated dx reads kp,
    and the wrapper's halo branch does not call pack_backward_kernels."""
    import inspect

    called = []
    monkeypatch.setattr(tuc, "pack_backward_kernels",
                        lambda kp: called.append(kp))
    shape = (1, 3, 2, 2, 64, 64)
    b, d, h, w, cin, cout = shape
    tx = torch.tensor(_x((b, d, h, w, cin)))
    tk = torch.tensor(_x((3, 3, 3, cin, cout), seed=1, scale=0.1))
    tg = torch.tensor(_x((b, 2 * d, 2 * h, 2 * w, cout), seed=2))
    plan = tuc.k1_backward_plan(torch.bfloat16, *shape)
    dx = _emulate_dx(tg, tuc.pack_phase_kernels(tk, torch.float32), cin, plan)
    _close(dx.numpy(), tuc.upsample2_conv3_backward(tx, tk, tg)[0].numpy())
    assert not called
    src = inspect.getsource(tuc.upsample2_conv3_backward_cuda)
    assert "pack_backward_kernels" not in src and "float()" not in src


@pytest.mark.parametrize("cin,cout,seed", [(4, 5, 0), (8, 8, 1), (16, 3, 2)])
def test_packed_backward_weights_unpack_to_jax_phase_kernels(cin, cout, seed):
    """Offset j = 2p + a per axis (full-res 2d + 2 - j) holds K2[phase a,
    tap p]: the 64 offsets are the 64 (phase, tap) pairs, each once."""
    k = _x((3, 3, 3, cin, cout), seed=seed)
    wb = tuc.pack_backward_kernels(
        tuc.pack_phase_kernels(torch.tensor(k), torch.float32))
    assert wb.shape == (cin, 64 * cout) and wb.is_contiguous()
    want = np.asarray(_phase_kernels(jnp.asarray(k))).reshape(
        2, 2, 2, 2, 2, 2, cin, cout)
    got = np.zeros_like(want)
    seen = set()
    for a, b, c, p, q, r in np.ndindex(2, 2, 2, 2, 2, 2):
        iu, iv, it = 2 * p + a, 2 * q + b, 2 * r + c
        off = 16 * iu + 4 * iv + it
        seen.add(off)
        got[a, b, c, p, q, r] = wb[:, off * cout:(off + 1) * cout].numpy()
    assert seen == set(range(64))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("seed", range(3))
def test_split_tf32_parts_are_tf32_and_sum_to_v(seed):
    """hi and lo carry no bits below TF32's 10-bit mantissa (their low 13
    bits are 0), and v - hi - lo is within 2^-22 |v|, over 60 binades."""
    rng = np.random.RandomState(seed)
    v = torch.tensor((rng.randn(4096)
                      * 10.0 ** rng.uniform(-18, 18, 4096)).astype("f4"))
    hi, lo = tuc.split_tf32(v)
    assert ((_bits(hi) & 0x1FFF) == 0).all()
    assert ((_bits(lo) & 0x1FFF) == 0).all()
    err = (v.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * v.double().abs()).all()
    assert (lo.abs() <= 2.0 ** -11 * v.abs()).all()


def test_split_tf32_rounds_to_nearest_ties_away_from_zero():
    """As cvt.rna.tf32.f32: below half a TF32 ulp rounds down, above it up,
    and exactly half away from zero, for either sign (round-to-even would
    give 1.0 for 1 + 2^-11)."""
    cases = {0x3F801000: 0x3F802000,  # 1 + 2^-11: a tie, mantissa even
             0x3F803000: 0x3F804000,  # a tie, mantissa odd
             0x3F800FFF: 0x3F800000, 0x3F801001: 0x3F802000,
             0x3F7FF000: 0x3F800000}  # the carry reaches the exponent
    src = torch.tensor(list(cases), dtype=torch.int32)
    want = torch.tensor(list(cases.values()), dtype=torch.int32)
    for sign in (0, -2 ** 31):
        hi, _ = tuc.split_tf32((src | sign).view(torch.float32))
        assert torch.equal(_bits(hi), want | sign)


def test_split_tf32_passes_signs_zeros_inf_and_nan():
    v = torch.tensor([0.0, -0.0, 1.5, -1.5, float("inf"), -float("inf"),
                      float("nan")])
    hi, lo = tuc.split_tf32(v)
    assert torch.equal(_bits(hi)[:6], _bits(v)[:6])  # -0.0 keeps its sign
    assert torch.isnan(hi[6])
    assert torch.equal(lo, torch.zeros(7))


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64), (8, 4)])
def test_tf32_packed_weights_split_the_permuted_weights(cin, cout):
    """pack_backward_kernels_tf32 is split_tf32 of pack_backward_kernels,
    hi then lo, contiguous."""
    k = torch.tensor(_x((3, 3, 3, cin, cout), seed=cin + cout))
    kp = tuc.pack_phase_kernels(k, torch.float32)
    wt = tuc.pack_backward_kernels_tf32(kp)
    assert wt.shape == (2, cin, 64 * cout) and wt.is_contiguous()
    hi, lo = tuc.split_tf32(tuc.pack_backward_kernels(kp))
    assert torch.equal(wt[0], hi) and torch.equal(wt[1], lo)


def test_packed_backward_weights_round_once():
    """Folded in float32, then cast: bf16 weights are the f32 ones rounded."""
    k = torch.tensor(_x((3, 3, 3, 8, 8), seed=7))
    packed = {dt: tuc.pack_backward_kernels(tuc.pack_phase_kernels(k, dt))
              for dt in DTYPES}
    np.testing.assert_array_equal(
        packed[torch.bfloat16].float().numpy(),
        packed[torch.float32].to(torch.bfloat16).float().numpy())


def _check_halo(p, shape, positions, rmax, waves=False):
    """A halo launch's block fits its kernel and tiles the tensor once; its
    cluster is portable and its split order covers the reduction once; its
    splits fill the card (bf16), or (`waves`) run in the least time of
    the counts allowed."""
    b, d, h, w = shape[:4]
    tn, td, th, tw = p.block
    assert tn * td * th * tw <= positions and tn <= 255
    assert p.rows == tn * (td + 1) * (th + 1) * (tw + 1) <= rmax
    for n, t, e in zip(p.grid, p.block, (b, d, h, w)):
        assert (n - 1) * t < e <= n * t  # every position in one block
    assert 1 <= p.splits <= tuc.MAX_CLUSTER
    assert p.splits <= p.units // tuc.MIN_SPLIT_SLICES or p.splits == 1
    assert p.ctas == p.tiles * p.splits
    if waves:
        def time(s):
            return -(-p.tiles * s // tuc.CLUSTER_CTAS[s]) / s

        allowed = [s for s in range(1, min(tuc.MAX_CLUSTER, max(
            1, p.units // tuc.MIN_SPLIT_SLICES)) + 1)
            if s == 1 or p.tiles * s <= 3 * tuc.CLUSTER_CTAS[s]]
        assert p.splits in allowed
        assert time(p.splits) <= min(time(s) for s in allowed) / 0.95
    else:
        # the grid fills the card, or the cluster is as large as it may be
        assert p.ctas >= tuc.SMS or p.splits == max(1, min(
            tuc.MAX_CLUSTER, p.units // tuc.MIN_SPLIT_SLICES))
    ranges = [tuc.split_range(p.units, p.splits, s) for s in range(p.splits)]
    covered = np.zeros(p.units, dtype=int)
    for a0, a1 in ranges:
        assert a1 > a0
        covered[a0:a1] += 1
    assert (covered == 1).all()


def _check_halo_plan(plan, shape, dtype):
    """A halo plan's two launches against their dtype's limits; f32's
    splits are the count that runs its CTAs (one an SM, CLUSTER_CTAS at a
    time) in the least time, at most 3 waves."""
    cin, cout = shape[4:]
    if dtype == torch.bfloat16:
        assert plan.variant == "halo"
        _check_halo(plan.dx, shape, tuc.HALO_BM, tuc.HALO_DX_RMAX)
        _check_halo(plan.dk, shape, tuc.HALO_BP, tuc.HALO_DK_RMAX)
        return
    assert plan.variant == "halo_f32"
    _check_halo(plan.dx, shape, tuc.HALO_F32_BM, tuc.HALO_F32_DX_RMAX,
                waves=True)
    _check_halo(plan.dk, shape, tuc.HALO_F32_BP, tuc.HALO_F32_DK_RMAX,
                waves=True)
    assert plan.dx.units == 8 * cout // tuc.HALO_F32_CO
    assert plan.dk.tiles == 16 * (cin // 64) * (cout // 64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [32, 16, 192])
@pytest.mark.parametrize("stage", range(3))
def test_backward_plan_puts_main_path_on_fast_kernels(dtype, batch, stage):
    d, h, w, cin, cout = FLAGSHIP_STAGES[stage]
    shape = (batch, d, h, w, cin, cout)
    _check_halo_plan(tuc.k1_backward_plan(dtype, *shape), shape, dtype)


# the 64x64 generator's stages (D, H, W, Cin, Cout), and each stage's y-slab
# on a rank of the spatial path (y H/P + 2 at P 4 and 2)
LARGE_STAGES = [(3, 8, 8, 256, 256), (6, 16, 16, 256, 128),
                (12, 32, 32, 128, 64)]
SLABS = [(d, h // p + 2, w, cin, cout) for p in (4, 2)
         for d, h, w, cin, cout in LARGE_STAGES]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [32, 4, 1])
@pytest.mark.parametrize("stage", LARGE_STAGES + SLABS + [(3, 5, 8, 256, 256),
                                                          (6, 9, 16, 256, 128)])
def test_backward_plan_puts_64x64_stages_and_slabs_on_halo_kernels(batch,
                                                                     stage,
                                                                     dtype):
    shape = (batch, *stage)
    plan = tuc.k1_backward_plan(dtype, *shape)
    _check_halo_plan(plan, shape, dtype)
    assert np.prod(plan.dx.grid) < 65536 and np.prod(plan.dk.grid) < 65536


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (2, 3, 2, 2, 16, 4),    # the card tests' odd widths
    (3, 5, 3, 7, 40, 70),
    (1, 1, 1, 1, 1, 1),
    (4, 3, 2, 2, 8, 8),     # smoke_model_config() stages
    (4, 6, 4, 4, 8, 8),
    (4, 12, 8, 8, 8, 8),
    (32, 6, 4, 4, 256, 96),  # Cout off the fast tiles
])
def test_backward_plan_puts_odd_widths_on_general_kernels(dtype, shape):
    plan = tuc.k1_backward_plan(dtype, *shape)
    assert plan.variant == "general"
    b, d, h, w, cin, cout = shape
    m = b * d * h * w
    assert plan.dx.ctas == -(-m // 64) * -(-cin // 64) * plan.dx.splits
    assert plan.dk.ctas == 8 * -(-8 * cin // 64) * -(-cout // 64) \
        * plan.dk.splits
    assert plan.dx.kt == 64 * -(-cout // 16) and plan.dk.kt == -(-m // 16)


def test_backward_plan_general_override():
    """Misaligned operands fall back to the general kernels' plan."""
    plan = tuc.k1_backward_plan(torch.bfloat16, 32, 3, 2, 2, 256, 256,
                                general=True)
    assert plan.variant == "general" and plan.dx.bm == plan.dk.bm == 64


@pytest.mark.parametrize("kt", [1, 2, 3, 6, 7, 48, 64, 256, 384, 1024])
def test_split_ranges_cover_the_reduction_once(kt):
    for splits in range(1, min(kt, 140) + 1):
        ranges = [tuc.split_range(kt, splits, s) for s in range(splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == kt
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0  # contiguous and disjoint
        assert all(a1 > a0 for a0, a1 in ranges)  # no split is empty
        covered = np.zeros(kt, dtype=int)
        for a0, a1 in ranges:
            covered[a0:a1] += 1
        assert (covered == 1).all()


def test_constants_match_the_kernel_source():
    """The slice, block and tile sizes emulated here are the ones
    compiled."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("HB_BM") == tuc.HALO_BM and const("HB_BP") == tuc.HALO_BP
    assert const("HB_CO") == tuc.HALO_CO
    assert const("DX_RMAX") == tuc.HALO_DX_RMAX
    assert const("DK_RMAX") == tuc.HALO_DK_RMAX
    assert const("MAX_CLUSTER") == tuc.MAX_CLUSTER
    # the f32 halo kernels' limits
    assert const("HF_BM") == tuc.HALO_F32_BM
    assert const("HF_CO") == tuc.HALO_F32_CO
    assert const("HF_DX_RMAX") == tuc.HALO_F32_DX_RMAX
    assert const("HF_BP") == tuc.HALO_F32_BP
    assert const("HF_DK_RMAX") == tuc.HALO_F32_DK_RMAX
    fma = re.search(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+), "
                    r"THREADS = 256;", src)
    assert fma.groups() == (str(tuc.BWD_FMA_TILE), str(tuc.BWD_FMA_TILE),
                            str(tuc.BWD_FMA_BK))
    # the split rule, kt * s / splits, in 64-bit
    assert "kt0 = (int)((long long)KT * s / splits);" in src
    assert "kt1 = (int)((long long)KT * (s + 1) / splits);" in src


def test_cpu_backward_takes_the_plain_version():
    """A CPU tensor's backward runs the plain version: no kernel counted."""
    x = torch.tensor(_x((1, 3, 2, 2, 4)), requires_grad=True)
    k = torch.tensor(_x((3, 3, 3, 4, 4), seed=1), requires_grad=True)
    bias = torch.zeros(4, requires_grad=True)
    before = dict(tuc.backward_launches_by_variant)
    calls = tuc.backward_calls
    tuc.upsample2_conv3(x, k, bias).sum().backward()
    assert tuc.backward_calls == calls + 1
    assert tuc.backward_launches_by_variant == before


def test_cuda_backward_refuses_cpu_tensors():
    x = torch.zeros(1, 3, 2, 2, 4)
    k = torch.zeros(3, 3, 3, 4, 4)
    g = torch.zeros(1, 6, 4, 4, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        tuc.upsample2_conv3_backward_cuda(x, k, g)
