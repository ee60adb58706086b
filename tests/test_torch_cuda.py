"""The port's CUDA kernels (and K1's gradient) against their plain PyTorch
versions, on the card.

These tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode), so
they skip elsewhere.  On a machine with a card, from the repository root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest imports JAX, which the port
does not need.)  The shapes here are the awkward ones — channel counts that
are not multiples of the kernel's tiles, rows that end mid-tile, single
voxels, patches at the tensor's last row and column, x offsets that rule out
16-byte loads; the flagship shapes are checked by chip_smoke.py.  Each K1
test asserts, through ``launches_by_variant``, which kernel variant ran.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


SHAPES = [
    (2, 3, 2, 2, 16, 4),     # Cin < 32, Cout < 64
    (3, 5, 3, 7, 40, 70),    # odd extents, Cin and Cout off the tiles
    (1, 1, 1, 1, 1, 1),      # one voxel, one channel
    (5, 6, 4, 4, 256, 128),  # flagship stage-1 widths, small batch
]
# the fast kernels' edge cases, each with the tile k1_plan gives it
FAST_EDGES = [
    ((3, 3, 2, 2, 256, 256), (64, 64)),     # stage 0 at B 3: M = 36 < 64
    ((4, 12, 8, 8, 128, 64), (128, 64)),    # Cout 64, as at stage 2
    ((16, 6, 4, 4, 64, 192), (128, 64)),    # Cin 64, Cout 192
    ((1, 12, 32, 32, 128, 64), (128, 64)),  # the 64x64 last stage at B 1
    ((33, 6, 4, 4, 256, 128), (128, 128)),  # rows end mid-tile
]
DTYPE_TOLS = [("float32", 1e-4, 1e-5), ("bfloat16", 2e-2, 2e-2)]


def _check_forward(cuda, shape, dtype, rtol, atol):
    """One launch of the kernel against the plain version; returns the
    variant that ran."""
    from prdisagg_torch.ops import upsample_conv
    from prdisagg_torch.ops.core import full_f32

    b, d, h, w, cin, cout = shape
    rng = np.random.RandomState(sum(shape))
    dt = getattr(torch, dtype)
    x = torch.tensor(rng.randn(b, d, h, w, cin).astype("f4"), device=cuda)
    k = torch.tensor(0.1 * rng.randn(3, 3, 3, cin, cout).astype("f4"),
                     device=cuda)
    bias = torch.tensor(rng.randn(cout).astype("f4"), device=cuda)
    before = upsample_conv.launches
    by_variant = dict(upsample_conv.launches_by_variant)
    with torch.inference_mode(), full_f32():
        got = upsample_conv.upsample2_conv3(x.to(dt), k, bias)
        want = upsample_conv.upsample2_conv3_reference(x.to(dt), k, bias)
    torch.cuda.synchronize()
    assert upsample_conv.launches == before + 1
    ran = [v for v, n in upsample_conv.launches_by_variant.items()
           if n != by_variant[v]]
    assert len(ran) == 1
    assert got.shape == (b, 2 * d, 2 * h, 2 * w, cout) and got.dtype == dt
    scale = want.float().abs().max().item()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=rtol, atol=atol * scale)
    return ran[0]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,rtol,atol", DTYPE_TOLS)
def test_upsample2_conv3_kernel_matches_plain(cuda, shape, dtype, rtol, atol):
    from prdisagg_torch.ops import upsample_conv

    # the odd widths take the general kernel, flagship widths the fast one
    want = "fast" if shape[-2:] == (256, 128) else "general"
    assert upsample_conv.k1_plan(getattr(torch, dtype), *shape).variant == want
    assert _check_forward(cuda, shape, dtype, rtol, atol) == want


@pytest.mark.parametrize("shape,tile", FAST_EDGES)
@pytest.mark.parametrize("dtype,rtol,atol", DTYPE_TOLS)
def test_upsample2_conv3_fast_kernel_edge_cases(cuda, shape, tile, dtype,
                                                rtol, atol):
    from prdisagg_torch.ops import upsample_conv

    plan = upsample_conv.k1_plan(getattr(torch, dtype), *shape)
    assert (plan.variant, plan.bm, plan.bn) == ("fast", *tile)
    assert _check_forward(cuda, shape, dtype, rtol, atol) == "fast"


@pytest.mark.parametrize("shape", [(2, 3, 2, 2, 16, 4), (3, 5, 3, 7, 40, 70),
                                   (4, 6, 4, 4, 256, 128)])
@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-4),
                                             ("bfloat16", 2e-2, 2e-2)])
def test_upsample2_conv3_gradients_match_plain(cuda, shape, dtype, rtol, atol):
    """The kernel's autograd.Function against autograd through the plain
    version, on the card: dx, dkernel and dbias."""
    from prdisagg_torch.ops import upsample_conv
    from prdisagg_torch.ops.core import full_f32

    b, d, h, w, cin, cout = shape
    rng = np.random.RandomState(sum(shape))
    dt = getattr(torch, dtype)
    x = torch.tensor(rng.randn(b, d, h, w, cin).astype("f4"),
                     device=cuda).to(dt)
    k = torch.tensor(0.1 * rng.randn(3, 3, 3, cin, cout).astype("f4"),
                     device=cuda)
    bias = torch.tensor(rng.randn(cout).astype("f4"), device=cuda)
    g = torch.tensor(rng.randn(b, 2 * d, 2 * h, 2 * w, cout).astype("f4"),
                     device=cuda).to(dt)
    grads = []
    before = (upsample_conv.launches, upsample_conv.backward_calls)
    with full_f32():
        for fn in (upsample_conv.upsample2_conv3,
                   upsample_conv.upsample2_conv3_reference):
            leaves = [t.detach().requires_grad_(True) for t in (x, k, bias)]
            grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
    torch.cuda.synchronize()
    assert (upsample_conv.launches, upsample_conv.backward_calls) == (
        before[0] + 1, before[1] + 1)
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = want.float().abs().max().item()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=rtol, atol=atol * scale)


def test_upsample2_conv3_kernel_refuses_what_it_cannot_take(cuda):
    from prdisagg_torch.ops import upsample_conv

    x = torch.randn(2, 3, 2, 2, 8, device=cuda)
    k = torch.randn(3, 3, 3, 8, 4, device=cuda)
    bias = torch.zeros(4, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        upsample_conv.upsample2_conv3(x.half(), k, bias)
    kp = torch.zeros(8, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        upsample_conv.upsample2_conv3_cuda(
            x.transpose(1, 2), kp, bias)
    with pytest.raises(ValueError, match="CUDA device"):
        upsample_conv.upsample2_conv3_cuda(x, kp, bias.cpu())
    with pytest.raises(ValueError, match="kp must be"):
        upsample_conv.upsample2_conv3_cuda(
            x, torch.zeros(8, 8, 8, 4, device=cuda), bias)


GATHER_CASES = [  # (D, nh, ny, nx, nd, B)
    (3, 24, 48, 40, 16, 7),      # the flagship patch, 16-byte path
    (2, 1, 21, 19, 16, 5),       # nh = 1, nx not a multiple of 4
    (4, 24, 33, 37, 16, 1),      # B = 1, nx not a multiple of 4
    (3, 5, 17, 23, 5, 9),        # nd not a multiple of 4
    (2, 9, 64, 64, 8, 300),      # a partial hour block, many patches
    (2, 24, 128, 136, 64, 160),  # nd 64: many unrolled passes a block
    (40, 24, 64, 64, 16, 5000),  # a bulk draw
    (6, 1, 48, 48, 16, 32),      # conditions: nh 1 at B 32
]


def _gather_rows(rng, n_days, ny, nx, nd, b):
    """b random rows in range, the first at the last day, row and column,
    the second at an odd x."""
    rows = np.stack([rng.randint(0, n_days, b),
                     rng.randint(0, ny - nd + 1, b),
                     rng.randint(0, nx - nd + 1, b)], 1)
    rows[0] = (n_days - 1, ny - nd, nx - nd)  # the last row and column
    if b > 1:
        rows[1, 2] = 1 + 4 * ((nx - nd) // 8)  # an odd x in any tensor
    return rows


def _check_gather(data, idx, nd):
    """One launch against the plain version, bit for bit."""
    from prdisagg_torch.ops import gather

    before = gather.launches
    got = gather.gather_patches(data, idx, nd)
    want = gather.gather_patches_reference(data, idx, nd)
    torch.cuda.synchronize()
    assert gather.launches == before + 1
    assert got.shape == (idx.shape[0], data.shape[1], nd, nd)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_kernel_equals_plain_exactly(cuda, case):
    from prdisagg_torch.ops import gather

    n_days, nh, ny, nx, nd, b = case
    rng = np.random.RandomState(sum(case))
    data = torch.tensor(rng.rand(n_days, nh, ny, nx).astype("f4"),
                        device=cuda)
    rows = _gather_rows(rng, n_days, ny, nx, nd, b)
    idx = torch.tensor(rows.astype("i4"), device=cuda)
    _check_gather(data, idx, nd)
    got = gather.gather_patches(data, idx, nd).cpu()
    cpu = data.cpu()
    for i, (t, y, x) in enumerate(rows[:64]):
        assert torch.equal(got[i], cpu[t, :, y:y + nd, x:x + nd])


def test_gather_record_cache_follows_its_sources(cuda):
    """Launch records are cached by the source's address and shape: two sources in turn, new contents at one address,
    another shape at that address, and a freed and re-allocated source all
    stay exact."""
    rng = np.random.RandomState(5)
    shape, nd = (3, 24, 48, 48), 16
    sources = [torch.tensor(rng.rand(*shape).astype("f4"), device=cuda)
               for _ in range(2)]
    idx = torch.tensor(_gather_rows(rng, 3, 48, 48, nd, 40).astype("i4"),
                       device=cuda)
    for data in sources + sources:
        _check_gather(data, idx, nd)
    buf = sources[0]
    buf.copy_(torch.from_numpy(rng.rand(*shape).astype("f4")))
    _check_gather(buf, idx, nd)
    other = buf.view(6, 12, 48, 48)  # the same address, another shape
    assert other.data_ptr() == buf.data_ptr()
    rows6 = _gather_rows(rng, 6, 48, 48, nd, 40)
    idx6 = torch.tensor(rows6.astype("i4"), device=cuda)
    _check_gather(other, idx6, nd)
    del sources, buf, other, data
    # the caching allocator hands a freed block out again, most likely at a
    # cached address; the gather must be exact wherever it lands
    again = torch.empty(shape, device=cuda)
    again.copy_(torch.from_numpy(rng.rand(*shape).astype("f4")))
    _check_gather(again, idx, nd)


@pytest.mark.parametrize("why", ["storage offset", "nx % 4", "nd % 4"])
def test_gather_scalar_path_on_odd_shapes(cuda, why):
    """What 16-byte loads cannot take goes to the scalar path, still
    exact."""
    rng = np.random.RandomState(len(why))
    nd, shape = 16, (3, 24, 40, 40)
    if why == "nx % 4":
        shape = (3, 24, 40, 42)
    elif why == "nd % 4":
        nd = 14
    flat = torch.tensor(rng.rand(int(np.prod(shape)) + 1).astype("f4"),
                        device=cuda)
    data = (flat[1:] if why == "storage offset" else flat[:-1]).view(shape)
    assert data.is_contiguous()
    idx = torch.tensor(_gather_rows(rng, 3, shape[2], shape[3], nd,
                                    33).astype("i4"), device=cuda)
    _check_gather(data, idx, nd)


def test_gather_kernel_refuses_what_it_cannot_take(cuda):
    from prdisagg_torch.ops import gather

    data = torch.rand(2, 24, 32, 32, device=cuda)
    idx = torch.zeros(3, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        gather.gather_patches(data, idx.cpu(), 16)
    with pytest.raises(TypeError, match="int32"):
        gather.gather_patches(data, idx.long(), 16)
    with pytest.raises(TypeError, match="float32"):
        gather.gather_patches(data.double(), idx, 16)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_patches(data.transpose(2, 3), idx, 16)
    with pytest.raises(ValueError, match="does not fit"):
        gather.gather_patches(data, idx, 33)
