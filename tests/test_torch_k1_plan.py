"""The Python side of the upsample-conv kernels (K1) against the JAX
package, on the CPU.

The CUDA kernels read the folded weights packed K-major, (8 phases, Cout,
8*Cin) with k = tap*Cin + ci, and gather the input rows of each tap at the
offsets (a+p-1, b+q-1, c+r-1).  Unpacked, the packing must be the JAX
package's ``_phase_kernels``; a plain implicit GEMM over it must be the TPU
kernel's function.  The shape chooser must send every main-path shape to the
dtype's tensor-core kernel with a grid that fills the card (f32 to the halo
forward on 3xTF32 tensor cores, bf16 to wgmma), and odd widths to the
general one.  The halo forward's weight split and its walk over
position blocks, units of 8 input channels and fresh sums are emulated here
from its constants in the source.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from prdisagg_torch.core.config import smoke_model_config  # noqa: E402
from prdisagg_torch.ops import upsample_conv as tuc  # noqa: E402
from prdisagg_tpu.ops.fused_upsample_conv import _phase_kernels  # noqa: E402
from prdisagg_tpu.ops.pallas_upsample_conv import (  # noqa: E402
    upsample2_conv3_pallas_interpret,
)

# flagship generator stages (D, H, W, Cin, Cout) and the 64x64 last stage
FLAGSHIP_STAGES = [(3, 2, 2, 256, 256), (6, 4, 4, 256, 128),
                   (12, 8, 8, 128, 64)]
LAST_STAGE_64 = (12, 32, 32, 128, 64)
DTYPES = [torch.float32, torch.bfloat16]


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype("f4")


def _implicit_gemm(x, kp, bias):
    """What the kernels compute, in plain PyTorch: per phase, the im2col
    rows of the 8 taps (zero outside the input) times the packed weights,
    stored at the phase's interleaved positions."""
    b, d, h, w, cin = x.shape
    cout = kp.shape[1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))  # padded index = input index + 1
    out = torch.empty((b, 2 * d, 2 * h, 2 * w, cout), dtype=x.dtype)
    for phase in range(8):
        pa, pb, pc = phase >> 2, (phase >> 1) & 1, phase & 1
        cols = []
        for tap in range(8):
            od = pa + (tap >> 2) - 1
            oh = pb + ((tap >> 1) & 1) - 1
            ow = pc + (tap & 1) - 1
            cols.append(xp[:, 1 + od:1 + od + d, 1 + oh:1 + oh + h,
                           1 + ow:1 + ow + w].reshape(-1, cin))
        y = torch.cat(cols, 1) @ kp[phase].T + bias  # k = tap*Cin + ci
        out[:, pa::2, pb::2, pc::2] = y.reshape(b, d, h, w, cout)
    return out


@pytest.mark.parametrize("cin,cout,seed", [(4, 5, 0), (8, 8, 1), (16, 3, 2)])
def test_packed_weights_unpack_to_jax_phase_kernels(cin, cout, seed):
    k = _x((3, 3, 3, cin, cout), seed=seed)
    kp = tuc.pack_phase_kernels(torch.tensor(k), torch.float32)
    assert kp.shape == (8, cout, 8 * cin) and kp.is_contiguous()
    unpacked = kp.reshape(8, cout, 8, cin).permute(0, 2, 3, 1).numpy()
    want = np.asarray(_phase_kernels(jnp.asarray(k))).reshape(8, 8, cin, cout)
    np.testing.assert_allclose(unpacked, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("xshape,cout", [((2, 3, 2, 2, 8), 8),
                                         ((1, 3, 2, 3, 16), 4),
                                         ((3, 2, 3, 2, 4), 6)])
def test_packed_implicit_gemm_matches_pallas_interpret(xshape, cout):
    x = _x(xshape, seed=2)
    k = _x((3, 3, 3, xshape[-1], cout), seed=4, scale=0.1)
    b = _x((cout,), seed=5)
    kp = tuc.pack_phase_kernels(torch.tensor(k), torch.float32)
    got = _implicit_gemm(torch.tensor(x), kp, torch.tensor(b)).numpy()
    want = np.asarray(upsample2_conv3_pallas_interpret(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def _check_halo_forward(plan, b, d, h, w, cin, cout):
    """A halo_f32 plan's tile, block and work items are what the kernel
    takes: a block of at most bm positions and HALO_F32_FW_RMAX sub-box
    rows, inside the tensor, tn > 1 only for whole samples."""
    assert plan.variant == "halo_f32"
    assert plan.bm in tuc.HALO_F32_FW_TILES and plan.bn == 64
    tn, td, th, tw = plan.block
    assert 1 <= td <= d and 1 <= th <= h and 1 <= tw <= w and 1 <= tn <= b
    assert tn == 1 or (td, th, tw) == (d, h, w)
    assert tn * td * th * tw <= plan.bm
    assert tn * (td + 1) * (th + 1) * (tw + 1) <= tuc.HALO_F32_FW_RMAX
    blocks = -(-b // tn) * -(-d // td) * -(-h // th) * -(-w // tw)
    assert plan.ctas == 8 * blocks * (cout // 64)
    return b * d * h * w / (blocks * plan.bm)  # the tiles' rows in use


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [32, 160, 1000])
@pytest.mark.parametrize("stage", range(3))
def test_plan_puts_main_path_on_fast_kernel(dtype, batch, stage):
    d, h, w, cin, cout = FLAGSHIP_STAGES[stage]
    plan = tuc.k1_plan(dtype, batch, d, h, w, cin, cout)
    if dtype == torch.float32:  # the halo forward on the tensor cores
        _check_halo_forward(plan, batch, d, h, w, cin, cout)
        # its work items fill the card, or the smallest tile makes the most
        assert plan.ctas >= tuc.SMS or plan.bm == min(tuc.HALO_F32_FW_TILES)
        return
    assert plan.variant == "fast"
    assert (plan.bm, plan.bn) in tuc.FAST_TILES and cout % plan.bn == 0
    m = batch * d * h * w
    assert plan.ctas == 8 * -(-m // plan.bm) * (cout // plan.bn)
    assert plan.ctas >= tuc.SMS  # the grid fills the card


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 8])
def test_plan_puts_64x64_last_stage_on_fast_kernel(dtype, batch):
    plan = tuc.k1_plan(dtype, batch, *LAST_STAGE_64)
    assert plan.variant == ("halo_f32" if dtype == torch.float32 else "fast")
    assert plan.ctas >= tuc.SMS


# the serving path's K1 calls: 16x16 at B 1000, 64x64 at B 512 and 488
SERVING = ([(1000, *s) for s in FLAGSHIP_STAGES]
           + [(512, 3, 8, 8, 256, 256), (512, 6, 16, 16, 256, 128),
              (512, *LAST_STAGE_64), (488, 3, 8, 8, 256, 256),
              (488, 6, 16, 16, 256, 128), (488, *LAST_STAGE_64)])


@pytest.mark.parametrize("shape", SERVING)
def test_plan_puts_serving_on_halo_forward_with_full_tiles(shape):
    """Every K1 call of the f32 serving path takes the halo forward, its
    tiles' rows almost all on positions, and many waves of work items."""
    plan = tuc.k1_plan(torch.float32, *shape)
    assert _check_halo_forward(plan, *shape) >= 0.97
    assert plan.ctas >= 8 * tuc.SMS
    assert tuc.k1_plan(torch.bfloat16, *shape).variant == "fast"


@pytest.mark.parametrize("shape", [(32, 3, 2, 2, 256, 256), (3, 3, 2, 2, 256,
                                                              256),
                                   (5, 6, 4, 4, 256, 128),
                                   (33, 6, 4, 4, 256, 128),
                                   (4, 12, 10, 32, 128, 64),
                                   (7, 5, 3, 9, 64, 192)])
def test_halo_forward_plan_takes_the_cheapest_tile(shape):
    """The plan's tile is the least time of the three, an item taking its
    tile's rows or the weights' copy, whichever is more, in waves of SMS;
    each forced tile gives a valid plan of its own."""
    b, d, h, w, cin, cout = shape
    plan = tuc.k1_plan(torch.float32, *shape)
    _check_halo_forward(plan, *shape)

    def cost(p):
        return -(-p.ctas // tuc.SMS) * max(p.bm, tuc.HALO_F32_FW_COPY_ROWS)

    forced = [tuc._halo_forward_plan(b, d, h, w, cout, (bm,))
              for bm in tuc.HALO_F32_FW_TILES]
    for p in forced:
        _check_halo_forward(p, *shape)
    assert cost(plan) <= min(cost(p) for p in forced) / 0.99


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (2, 3, 2, 2, 16, 4),    # the card tests' odd widths
    (3, 5, 3, 7, 40, 70),
    (1, 1, 1, 1, 1, 1),
    (4, 3, 2, 2, 8, 8),     # smoke_model_config() stages
    (4, 6, 4, 4, 8, 8),
    (4, 12, 8, 8, 8, 8),
])
def test_plan_puts_odd_widths_on_general_kernel(dtype, shape):
    cfg = smoke_model_config()
    assert cfg.base_channels == 8 and set(cfg.gen_channels) == {8}
    plan = tuc.k1_plan(dtype, *shape)
    assert plan.variant == "general"
    b, d, h, w, _, cout = shape
    assert plan.ctas == 8 * -(-(b * d * h * w) // 128) * -(-cout // 64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,tile", [
    ((3, 3, 2, 2, 256, 256), (64, 64)),     # M = 36, below one 64-row tile
    ((4, 12, 8, 8, 128, 64), (128, 64)),    # Cout 64, as at stage 2
    ((16, 6, 4, 4, 64, 192), (128, 64)),    # Cin 64, Cout 192
    ((1, 12, 32, 32, 128, 64), (128, 64)),  # the 64x64 last stage at B 1
    ((33, 6, 4, 4, 256, 128), (128, 128)),  # rows end mid-tile
])
def test_plan_card_edge_cases_take_fast_kernel(dtype, shape, tile):
    """bf16 takes the fast kernel at the tile given; f32, whose widths are
    multiples of 64 here, the halo forward."""
    plan = tuc.k1_plan(dtype, *shape)
    b, d, h, w, cin, cout = shape
    fast = tuc.fast_plan(b, d, h, w, cout)
    assert fast.variant == "fast" and (fast.bm, fast.bn) == tile
    if dtype == torch.float32:
        _check_halo_forward(plan, *shape)
    else:
        assert plan == fast


def test_fast_kernel_width_rules():
    # f32 takes the halo forward at any Cin in units of 8, bf16 the wgmma
    # kernel at Cin in slices of 64: Cin 32 is on tensor cores in f32 only
    for cin in (8, 32, 64, 96, 192):
        assert tuc.k1_plan(torch.float32, 64, 6, 4, 4, cin, 64).variant == \
            "halo_f32"
    assert tuc.k1_plan(torch.float32, 64, 6, 4, 4, 4, 64).variant == \
        "general"
    assert tuc.k1_plan(torch.bfloat16, 64, 6, 4, 4, 32, 64).variant == \
        "general"
    assert tuc.k1_plan(torch.bfloat16, 64, 6, 4, 4, 64, 64).variant == "fast"
    # Cout must be a multiple of 64 in both
    for dtype in DTYPES:
        assert tuc.k1_plan(dtype, 64, 6, 4, 4, 128, 96).variant == "general"


# The f32 halo forward, emulated

SOURCE = Path(tuc.__file__).resolve().parents[1] / "csrc" / "upsample_conv.cu"


def test_halo_forward_constants_match_the_kernel_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("HF_FW_RMAX") == tuc.HALO_F32_FW_RMAX
    assert const("HF_FW_BN") == tuc.HALO_F32_FW_BN
    assert "bm != 256 && bm != 192 && bm != 128" in src
    assert sorted(tuc.HALO_F32_FW_TILES) == [128, 192, 256]


def _three_products(x, kp, bias):
    """The halo forward's arithmetic in plain PyTorch: x and kp split by
    split_tf32, the three TF32 products (lo hi, hi lo, hi hi) of each
    phase through the implicit GEMM, summed in float32."""
    x_hi, x_lo = tuc.split_tf32(x)
    k_hi, k_lo = tuc.split_tf32(kp)
    zero = torch.zeros_like(bias)
    return (_implicit_gemm(x_lo, k_hi, zero) + _implicit_gemm(x_hi, k_lo, zero)
            + _implicit_gemm(x_hi, k_hi, bias))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("stage", range(3))
def test_three_tf32_products_equal_the_plain_version(stage):
    """3xTF32 keeps float32 accuracy at the flagship stages; one TF32
    product (hi hi) alone does not."""
    d, h, w, cin, cout = FLAGSHIP_STAGES[stage]
    x = torch.tensor(_x((2, d, h, w, cin), seed=stage))
    k = torch.tensor(_x((3, 3, 3, cin, cout), seed=stage + 1, scale=0.02))
    bias = torch.tensor(_x((cout,), seed=stage + 2, scale=0.02))
    kp = tuc.pack_phase_kernels(k, torch.float32)
    want = tuc.upsample2_conv3_reference(x, k, bias)
    _close(_three_products(x, kp, bias), want)
    one = _implicit_gemm(tuc.split_tf32(x)[0], tuc.split_tf32(kp)[0], bias)
    err = (one - want).abs().max() / want.abs().max()
    assert err > 1e-4  # TF32 alone misses the tolerance


def _unswizzle(wf):
    """wf as (tile, phase, unit, tap, part, 64 rows, 8 k): chunk kc of row r
    read back from kc ^ (r // 4 % 2)."""
    swap = ((torch.arange(64) >> 2) & 1).bool().view(64, 1, 1)
    t = torch.where(swap, wf.flip(-2), wf)
    return t.reshape(*wf.shape[:6], 8)


@pytest.mark.parametrize("cin,cout", [(64, 64), (256, 128), (8, 192)])
def test_forward_weight_split_lays_out_kp_parts(cin, cout):
    """pack_phase_kernels_tf32: element (r, k) of the (tile, phase, unit,
    tap, part) tile is part `part` of kp[phase, 64 tile + r, tap Cin + 8
    unit + k], hi + lo within 2^-22 of it; each tile's 16-byte chunks in the
    32-byte swizzle."""
    k = torch.tensor(_x((3, 3, 3, cin, cout), seed=cin + cout))
    kp = tuc.pack_phase_kernels(k, torch.float32)
    wf = tuc.pack_phase_kernels_tf32(kp)
    assert wf.shape == (cout // 64, 8, cin // 8, 8, 2, 64, 2, 4)
    assert wf.is_contiguous() and wf.numel() == 2 * kp.numel()
    hi, lo = tuc.split_tf32(kp)
    got = _unswizzle(wf)  # (tile, phase, unit, tap, part, r, k)
    for part, want in enumerate((hi, lo)):
        want = want.view(8, cout // 64, 64, 8, cin // 8, 8).permute(
            1, 0, 4, 3, 2, 5)
        assert torch.equal(got[:, :, :, :, part], want)
    assert ((hi + lo - kp).abs() <= 2.0 ** -22 * kp.abs()).all()
    # row 4's first chunk sits second, row 0's first
    assert torch.equal(wf[0, 0, 0, 0, 0, 4, 1], got[0, 0, 0, 0, 0, 4, :4])
    assert torch.equal(wf[0, 0, 0, 0, 0, 0, 0], got[0, 0, 0, 0, 0, 0, :4])


def _emulate_f32_halo(x, kp, bias, plan):
    """k1_f32_halo: per work item (phase fastest, then block, then channel
    tile) and per unit of 8 input channels, the phase's input sub-box at
    (d0 + a - 1, h0 + b - 1, w0 + c - 1) (zero outside x) read at the 8
    taps' windows (position (in, id, ih, iw), tap (p, q, r) -> sub-box row
    (in, id+p, ih+q, iw+r); rows past the block read position 0's and are
    not stored) times the unit's weights read back from the split's
    layout, each product in 3xTF32; each unit's sum started afresh and
    added to the item's; bias added, stored at the phase's positions."""
    b, d, h, w, cin = x.shape
    cout = kp.shape[1]
    tn, td, th, tw = plan.block
    sd, sh, sw = td + 1, th + 1, tw + 1
    npos = tn * td * th * tw
    wf = _unswizzle(tuc.pack_phase_kernels_tf32(kp))
    grid = (-(-b // tn), -(-d // td), -(-h // th), -(-w // tw))
    m = torch.arange(plan.bm)
    q = torch.where(m < npos, m, 0)
    i_n, i_d, i_h, i_w = (q // (td * th * tw), q // (th * tw) % td,
                          q // tw % th, q % tw)
    rho0 = ((i_n * sd + i_d) * sh + i_h) * sw + i_w
    ln, ld, lh, lw = np.unravel_index(np.arange(tn * sd * sh * sw),
                                      (tn, sd, sh, sw))
    xflat = torch.cat([x.reshape(-1, cin), torch.zeros(1, cin)])
    out = torch.full((b, 2 * d, 2 * h, 2 * w, cout), float("nan"))
    items = 8 * int(np.prod(grid)) * (cout // 64)
    assert items == plan.ctas
    for wi in range(items):
        phase, rest = wi & 7, wi >> 3
        blk, tile = rest % int(np.prod(grid)), rest // int(np.prod(grid))
        bn, bd, bh, bw = np.unravel_index(blk, grid)
        n0, d0, h0, w0 = bn * tn, bd * td, bh * th, bw * tw
        a, bb, c = phase >> 2, (phase >> 1) & 1, phase & 1
        n, dd, hh, ww = (n0 + ln, d0 + a - 1 + ld, h0 + bb - 1 + lh,
                         w0 + c - 1 + lw)
        inside = ((n < b) & (dd >= 0) & (dd < d) & (hh >= 0) & (hh < h)
                  & (ww >= 0) & (ww < w))
        rows = np.where(inside, ((n * d + dd) * h + hh) * w + ww,
                        len(xflat) - 1)
        box = xflat[torch.as_tensor(rows)]
        total = torch.zeros(plan.bm, 64)
        for u in range(cin // 8):
            unit = torch.zeros(plan.bm, 64)
            for tap in range(8):
                shift = ((tap >> 2) * sh * sw + ((tap >> 1) & 1) * sw
                         + (tap & 1))
                a_hi, a_lo = tuc.split_tf32(box[rho0 + shift, 8 * u:8 * u + 8])
                b_hi, b_lo = (wf[tile, phase, u, tap, part].T
                              for part in (0, 1))
                unit += a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
            total += unit
        pos = (n0 + i_n[:npos], d0 + i_d[:npos], h0 + i_h[:npos],
               w0 + i_w[:npos])
        keep = (pos[0] < b) & (pos[1] < d) & (pos[2] < h) & (pos[3] < w)
        pn, pd, ph, pw = (t[keep] for t in pos)
        out[pn, 2 * pd + a, 2 * ph + bb, 2 * pw + c,
            64 * tile:64 * tile + 64] = (total[:npos][keep]
                                         + bias[64 * tile:64 * tile + 64])
    return out


@pytest.mark.parametrize("shape,bm", [
    ((2, 12, 8, 8, 8, 64), None),      # a flagship stage-2 sample's extents
    ((3, 3, 2, 2, 16, 128), None),     # whole samples, a ragged last block
    ((1, 5, 3, 7, 8, 64), 128),        # blocks overhanging D, H and W
    ((2, 6, 4, 4, 24, 64), 192),       # three warpgroups' tile
    ((2, 6, 4, 4, 32, 64), None),      # Cin 32 and 96: widths off 64
    ((2, 5, 3, 7, 96, 128), None),
])
def test_emulated_halo_forward_matches_plain(shape, bm):
    """The kernel's walk, emulated from its packed weights, writes every
    output once and equals the plain version at float32's tolerance."""
    b, d, h, w, cin, cout = shape
    plan = (tuc._halo_forward_plan(b, d, h, w, cout) if bm is None else
            tuc._halo_forward_plan(b, d, h, w, cout, (bm,)))
    _check_halo_forward(plan, *shape)
    x = torch.tensor(_x((b, d, h, w, cin), seed=7))
    k = torch.tensor(_x((3, 3, 3, cin, cout), seed=8, scale=0.1))
    bias = torch.tensor(_x((cout,), seed=9))
    got = _emulate_f32_halo(x, tuc.pack_phase_kernels(k, torch.float32),
                            bias, plan)
    assert not got.isnan().any()  # every output written
    _close(got, tuc.upsample2_conv3_reference(x, k, bias))


def test_long_reduction_of_positive_terms_holds_float32():
    """Cin 256 with all-positive inputs and weights: the sums only grow,
    where truncated tensor-core sums would drift; the three products with
    a fresh sum a unit stay at float32's tolerance."""
    d, h, w, cin, cout = FLAGSHIP_STAGES[0]
    x = torch.tensor(np.abs(_x((2, d, h, w, cin), seed=3)))
    k = torch.tensor(np.abs(_x((3, 3, 3, cin, cout), seed=4, scale=0.02)))
    bias = torch.tensor(np.abs(_x((cout,), seed=5)))
    kp = tuc.pack_phase_kernels(k, torch.float32)
    _close(_three_products(x, kp, bias),
           tuc.upsample2_conv3_reference(x, k, bias))
