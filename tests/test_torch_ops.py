"""prdisagg_torch ops against their JAX twins, on the CPU.

The upsample-conv's plain PyTorch version is held against the JAX phase
formulation, against the TPU kernel run in Pallas interpret mode, and
against a direct upsample + conv3d (the fold is exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.ops import core as tops  # noqa: E402
from prdisagg_torch.ops import upsample_conv as tuc  # noqa: E402
from prdisagg_tpu.ops import core as jops  # noqa: E402
from prdisagg_tpu.ops.fused_upsample_conv import (  # noqa: E402
    _phase_kernels,
    upsample2_conv3,
)
from prdisagg_tpu.ops.pallas_upsample_conv import (  # noqa: E402
    upsample2_conv3_pallas_interpret,
)


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype("f4")


@pytest.mark.parametrize("name,args", [
    ("leaky_relu", (0.2,)),
    ("pixel_norm", ()),
    ("pixel_norm_mixed", ()),
    ("hour_softmax", ()),
    ("upsample3d_nearest", (2,)),
])
def test_op_matches_jax(name, args):
    x = _x((3, 4, 2, 3, 5), seed=1, scale=3.0)
    got = getattr(tops, name)(torch.tensor(x), *args).numpy()
    want = np.asarray(getattr(jops, name)(jnp.asarray(x), *args))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_hour_softmax_is_float32_and_conserves():
    x = torch.tensor(_x((2, 24, 4, 4, 1), scale=4.0)).to(torch.bfloat16)
    out = tops.hour_softmax(x)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, atol=1e-6)


def test_pixel_norm_mixed_keeps_bf16_activations():
    x = torch.tensor(_x((2, 3, 2, 2, 16), scale=5.0))
    out = tops.pixel_norm_mixed(x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               tops.pixel_norm(x).numpy(), rtol=2e-2, atol=2e-2)


def test_phase_kernels_match_jax():
    k = _x((3, 3, 3, 4, 5), seed=3)
    np.testing.assert_allclose(tuc.phase_kernels(torch.tensor(k)).numpy(),
                               np.asarray(_phase_kernels(jnp.asarray(k))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("xshape,cout", [((4, 6, 4, 4, 8), 8),
                                         ((2, 3, 2, 2, 16), 4)])
def test_upsample2_conv3_reference_matches_jax_and_pallas(xshape, cout):
    x = _x(xshape, seed=2)
    k = _x((3, 3, 3, xshape[-1], cout), seed=4, scale=0.1)
    b = _x((cout,), seed=5)
    got = tuc.upsample2_conv3_reference(
        torch.tensor(x), torch.tensor(k), torch.tensor(b)).numpy()
    xla = np.asarray(upsample2_conv3(jnp.asarray(x), jnp.asarray(k),
                                     jnp.asarray(b)))
    pallas = np.asarray(upsample2_conv3_pallas_interpret(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    assert got.shape == (xshape[0], 2 * xshape[1], 2 * xshape[2],
                         2 * xshape[3], cout)
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-5)

    # the fold is exact: equal to the direct 27-tap conv of the upsampled x
    direct = torch.nn.functional.conv3d(
        tops.upsample3d_nearest(torch.tensor(x)).permute(0, 4, 1, 2, 3),
        torch.tensor(k).permute(4, 3, 0, 1, 2), torch.tensor(b), padding=1)
    np.testing.assert_allclose(got, direct.permute(0, 2, 3, 4, 1).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_upsample2_conv3_dispatch_on_cpu_uses_plain_version():
    x = torch.tensor(_x((2, 3, 2, 2, 8)))
    k = torch.tensor(_x((3, 3, 3, 8, 4), seed=1, scale=0.1),
                     requires_grad=True)
    b = torch.zeros(4)
    before = tuc.launches
    out = tuc.upsample2_conv3(x, k, b)
    assert tuc.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, tuc.upsample2_conv3_reference(x, k, b),
                               rtol=0, atol=0)
    out.sum().backward()  # the plain version differentiates on the CPU
    assert k.grad is not None and k.grad.shape == k.shape
    with pytest.raises(ValueError, match="cpu or cuda"):
        tuc.upsample2_conv3(x.to("meta"), k, b)


def test_upsample2_conv3_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 1, 1, 1, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        tuc.upsample2_conv3_cuda(x, torch.zeros(8, 8, 4, 2), torch.zeros(2))


def test_full_f32_restores_flags():
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    with tops.full_f32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32 == conv
    assert torch.backends.cuda.matmul.allow_tf32 == mm


def test_jax_stays_on_cpu():
    # the parity tests above compare against JAX on the CPU backend
    assert jax.default_backend() == "cpu"
