"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode), so
they skip elsewhere.  On a machine with a card, from the repository root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest imports JAX, which the port
does not need.)  The shapes here are the awkward ones — channel counts that
are not multiples of the kernel's tiles, rows that end mid-tile, single
voxels; the flagship shapes are checked by chip_smoke.py.
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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-5),
                                             ("bfloat16", 2e-2, 2e-2)])
def test_upsample2_conv3_kernel_matches_plain(cuda, shape, dtype, rtol, atol):
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
    with torch.inference_mode(), full_f32():
        got = upsample_conv.upsample2_conv3(x.to(dt), k, bias)
        want = upsample_conv.upsample2_conv3_reference(x.to(dt), k, bias)
    torch.cuda.synchronize()
    assert upsample_conv.launches == before + 1
    assert got.shape == (b, 2 * d, 2 * h, 2 * w, cout) and got.dtype == dt
    scale = want.float().abs().max().item()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=rtol, atol=atol * scale)


def test_upsample2_conv3_kernel_refuses_what_it_cannot_take(cuda):
    from prdisagg_torch.ops import upsample_conv

    x = torch.randn(2, 3, 2, 2, 8, device=cuda)
    k = torch.randn(3, 3, 3, 8, 4, device=cuda, requires_grad=True)
    bias = torch.zeros(4, device=cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        upsample_conv.upsample2_conv3(x, k, bias)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        with torch.no_grad():
            upsample_conv.upsample2_conv3(x.half(), k, bias)
    k2 = torch.zeros(8, 8, 8, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        upsample_conv.upsample2_conv3_cuda(
            x.transpose(1, 2), k2, bias)
    with pytest.raises(ValueError, match="CUDA device"):
        upsample_conv.upsample2_conv3_cuda(x, k2, bias.cpu())
