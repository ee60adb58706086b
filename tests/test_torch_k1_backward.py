"""K1's backward kernels (``csrc/upsample_conv.cu``: dx and dkernel with a
split reduction) emulated on the CPU, against the plain backward and JAX.

The card's kernels cannot run here, so this file repeats their index math
in PyTorch: dx as one implicit GEMM whose rows gather the cotangent at the
64 full-res offsets (2d+u, 2h+v, 2w+t), u, v, t in -1..2, against the
weights ``pack_backward_kernels`` permutes from the forward's packing; dkernel as one GEMM per phase
over the positions, each reduction cut into ``k1_backward_plan``'s splits
by ``split_range``, the partials summed in split order and folded onto the
3^3 kernel by the fold kernel's (phase, tap) pairs.  The emulation must
equal ``upsample2_conv3_backward`` and JAX's ``jax.vjp`` of the Pallas op
(interpret mode) within float32 rtol 1e-4, atol 1e-5 of the maximum.
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


def _emulate_dx(g, wb, cin, plan):
    """The dx kernels: row m gathers the cotangent row of (2d+u, 2h+v,
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


def _fold_tap(i, pair):
    """k1_dk_fold's table: the tap of phase bit `pair` folding onto 3^3
    index i."""
    return 0 if i == 0 else (1 if i == 2 else 1 - pair)


def _emulate_dk(x, g, plan):
    """The dk kernels: per phase, A[(tap, ci), m] = x[m + shift(phase,
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
    dk = torch.zeros(3, 3, 3, cin, cout)
    for i, j, k in np.ndindex(3, 3, 3):
        for s in range(p.splits):
            for pair in range(8):
                a, bb, c = pair >> 2, (pair >> 1) & 1, pair & 1
                tap = (_fold_tap(i, a) * 4 + _fold_tap(j, bb) * 2
                       + _fold_tap(k, c))
                dk[i, j, k] += part[s, pair, tap * cin:(tap + 1) * cin]
    return dk


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
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32_plan", "bf16_plan"])
@pytest.mark.parametrize("shape", CASES)
def test_emulated_kernels_match_plain_backward_and_jax(shape, dtype):
    """dx and dk by the kernels' index math and split reduction, at the
    plan the card would take for this dtype (computed here in float32)."""
    b, d, h, w, cin, cout = shape
    x = _x((b, d, h, w, cin), seed=sum(shape))
    k = _x((3, 3, 3, cin, cout), seed=sum(shape) + 1, scale=0.1)
    bias = _x((cout,), seed=sum(shape) + 2)
    g = _x((b, 2 * d, 2 * h, 2 * w, cout), seed=sum(shape) + 3)
    plan = tuc.k1_backward_plan(dtype, *shape)
    tx, tk, tg = (torch.tensor(a) for a in (x, k, g))
    wb = tuc.pack_backward_kernels(tuc.pack_phase_kernels(tk, torch.float32))
    dx = _emulate_dx(tg, wb, cin, plan)
    dk = _emulate_dk(tx, tg, plan)
    want_dx, want_dk = tuc.upsample2_conv3_backward(tx, tk, tg)
    _close(dx.numpy(), want_dx.numpy())
    _close(dk.numpy(), want_dk.numpy())
    jdx, jdk, _ = _jax_grads(x, k, bias, g)
    _close(dx.numpy(), jdx)
    _close(dk.numpy(), jdk)


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


def test_packed_backward_weights_round_once():
    """Folded in float32, then cast: bf16 weights are the f32 ones rounded."""
    k = torch.tensor(_x((3, 3, 3, 8, 8), seed=7))
    packed = {dt: tuc.pack_backward_kernels(tuc.pack_phase_kernels(k, dt))
              for dt in DTYPES}
    np.testing.assert_array_equal(
        packed[torch.bfloat16].float().numpy(),
        packed[torch.float32].to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [32, 16])
@pytest.mark.parametrize("stage", range(3))
def test_backward_plan_puts_main_path_on_fast_kernels(dtype, batch, stage):
    d, h, w, cin, cout = FLAGSHIP_STAGES[stage]
    plan = tuc.k1_backward_plan(dtype, batch, d, h, w, cin, cout)
    assert plan.variant == "fast"
    m = batch * d * h * w
    for p, tiles in ((plan.dx, -(-m // plan.dx.bm) * (cin // plan.dx.bn)),
                     (plan.dk, 8 * (8 * cin // plan.dk.bm)
                      * (cout // plan.dk.bn))):
        assert p.ctas == tiles * p.splits >= tuc.SMS  # the grid fills the card
        assert 1 <= p.splits <= p.kt // tuc.MIN_SPLIT_SLICES or p.splits == 1
    if dtype == torch.bfloat16:  # the wgmma tiles divide the widths
        assert cin % plan.dx.bn == 0 and cout % plan.dx.bk == 0
        assert cin % plan.dk.bm == 0 and cout % plan.dk.bn == 0


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
    """The slice and tile sizes emulated here are the ones compiled."""
    src = SOURCE.read_text()
    assert re.search(r"constexpr int DK_BK = (\d+);", src).group(1) == \
        str(tuc.BWD_FAST_BK)
    assert re.search(r"constexpr int BK = (\d+);\s+// bf16 per row",
                     src).group(1) == str(tuc.BWD_FAST_BK)
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
