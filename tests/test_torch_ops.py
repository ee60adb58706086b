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


@pytest.mark.parametrize("shape", [(3, 6, 4, 4, 256), (2, 12, 8, 8, 128),
                                   (2, 24, 16, 16, 64), (4, 5, 6)])
def test_pixel_norm_leaky_on_cpu_is_the_plain_composition(shape):
    x = torch.tensor(_x(shape, seed=6, scale=3.0))
    before = tops.pixel_norm_launches
    got = tops.pixel_norm_leaky(x, 0.2)
    assert tops.pixel_norm_launches == before  # no kernel on the CPU
    torch.testing.assert_close(got, tops.leaky_relu(tops.pixel_norm(x), 0.2),
                               rtol=0, atol=0)
    want = np.asarray(jops.leaky_relu(jops.pixel_norm(jnp.asarray(x.numpy())),
                                      0.2))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_pixel_norm_leaky_dispatch_rule():
    """The plain composition on the CPU and off the kernel's dtype and
    widths; a recorded gradient and a view that is not contiguous are no
    reason for it."""
    x = torch.tensor(_x((2, 6, 8, 8, 64), seed=7))
    why = tops.pixel_norm_plain_because
    assert why(x) == "not on CUDA"
    assert why(x.clone().requires_grad_()) == "not on CUDA"
    assert why(x.narrow(2, 1, 4)) == "not on CUDA"
    with torch.inference_mode():
        assert why(x) == "not on CUDA"
    # the card's reasons, read off a tensor that claims the device
    cuda = torch.device("cuda")

    class OnCard:
        def __init__(self, t):
            self.t = t
            self.device, self.dtype, self.shape = cuda, t.dtype, t.shape

        def dim(self):
            return self.t.dim()

    assert why(OnCard(x)) is None
    assert why(OnCard(x.narrow(2, 1, 4))) is None
    assert why(OnCard(x.clone().requires_grad_())) is None
    assert why(OnCard(x.bfloat16())) == "not float32"
    for c in (6, tops.PIXEL_NORM_MAX_CHANNELS + 4):
        assert (why(OnCard(torch.zeros(3, c)))
                == "channels off the kernel's widths")
    assert why(OnCard(torch.zeros(3, tops.PIXEL_NORM_MAX_CHANNELS))) is None
    # the plain composition carries the gradient
    leaf = x.clone().requires_grad_()
    tops.pixel_norm_leaky(leaf, 0.2).sum().backward()
    ref = x.clone().requires_grad_()
    tops.leaky_relu(tops.pixel_norm(ref), 0.2).sum().backward()
    torch.testing.assert_close(leaf.grad, ref.grad, rtol=0, atol=0)


def _plain_launch(x, leak, eps=1.0e-8):
    """A stand-in for the kernel's launch on the CPU: the plain chain,
    counted, on a contiguous copy where the kernel would make one."""
    if not x.is_contiguous():
        x = x.clone(memory_format=torch.contiguous_format)
    tops.pixel_norm_launches += 1
    return tops.leaky_relu(tops.pixel_norm(x, eps), leak)


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """pixel_norm_leaky's card route (launch, autograd function), with the
    kernel's launch played by the plain chain on the CPU."""
    monkeypatch.setattr(tops, "pixel_norm_plain_because", lambda x: None)
    monkeypatch.setattr(tops, "pixel_norm_leaky_cuda", _plain_launch)


@pytest.mark.parametrize("layout", ["contiguous", "narrowed"])
def test_pixel_norm_leaky_kernel_route_carries_the_plain_gradient(
        kernel_on_cpu, layout):
    """Under a recorded gradient the card route launches the kernel once
    and its closed-form backward gives the plain composition's gradient,
    for a contiguous input and for a narrowed view (a spatial mesh's rows),
    exact zeros included.  Tolerance: the closed form sums in another order
    than autograd's chain of the four ops, some ulps of the largest terms."""
    x = torch.tensor(_x((2, 6, 8, 8, 64), seed=10, scale=2.0))
    x[..., ::9] = 0.0
    dy = torch.tensor(_x((2, 6, 8, 8, 64), seed=11))
    if layout == "narrowed":
        x, dy = x.narrow(2, 1, 4), dy.narrow(2, 1, 4).contiguous()
    leaf = x.clone().requires_grad_()
    before = tops.pixel_norm_launches
    got = tops.pixel_norm_leaky(leaf * 1.0, 0.2)
    assert tops.pixel_norm_launches == before + 1
    assert got.grad_fn is not None
    got.backward(dy)
    ref = x.clone().requires_grad_()
    want = tops.leaky_relu(tops.pixel_norm(ref * 1.0), 0.2)
    want.backward(dy)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(leaf.grad, ref.grad, rtol=1e-5, atol=1e-6)
    assert tops.pixel_norm_launches == before + 1  # the backward is plain
    with torch.no_grad():
        assert tops.pixel_norm_leaky(leaf, 0.2).grad_fn is None
    assert tops.pixel_norm_launches == before + 2


def test_pixel_norm_leaky_kernel_route_is_twice_differentiable(
        kernel_on_cpu):
    """The card route's gradient is itself differentiable (a penalty on it
    would need that): gradcheck and gradgradcheck in float64."""
    x = torch.tensor(_x((3, 2, 8), seed=12)).double().requires_grad_()

    def fn(t):
        return tops.pixel_norm_leaky(t, 0.2)

    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


def test_generator_gradients_unchanged_by_the_fused_call(monkeypatch):
    """The generator's parameter gradients through pixel_norm_leaky equal,
    bit for bit, those through the plain composition it replaced."""
    from prdisagg_torch.core.config import smoke_model_config
    from prdisagg_torch.models import generator as gmod

    cfg = smoke_model_config(compute_dtype="float32")
    torch.manual_seed(0)
    gen = gmod.Generator(cfg)
    lat = torch.tensor(_x((4, cfg.latent_dim), seed=8))
    cond = torch.tensor(_x((4, cfg.ndomain, cfg.ndomain, 1), seed=9) ** 2)

    def grads():
        gen.zero_grad()
        out = gen(lat, cond)
        (out * torch.arange(out.numel()).reshape(out.shape)).sum().backward()
        return out.detach(), [p.grad.clone() for p in gen.parameters()]

    out, got = grads()
    monkeypatch.setattr(gmod, "pixel_norm_leaky", lambda x, leak: (
        tops.leaky_relu(tops.pixel_norm(x), leak)))
    out_ref, want = grads()
    torch.testing.assert_close(out, out_ref, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_generator_gradients_through_the_kernel_route(kernel_on_cpu):
    """A generator forward that records gradients takes the card route at
    each of its three stages, and its parameter gradients match those of
    the plain composition (the closed-form backward sums in another
    order)."""
    from prdisagg_torch.core.config import smoke_model_config
    from prdisagg_torch.models import generator as gmod

    cfg = smoke_model_config(compute_dtype="float32")
    torch.manual_seed(0)
    gen = gmod.Generator(cfg)
    lat = torch.tensor(_x((4, cfg.latent_dim), seed=8))
    cond = torch.tensor(_x((4, cfg.ndomain, cfg.ndomain, 1), seed=9) ** 2)

    def grads():
        gen.zero_grad()
        out = gen(lat, cond)
        (out * torch.arange(out.numel()).reshape(out.shape)).sum().backward()
        return out.detach(), [p.grad.clone() for p in gen.parameters()]

    before = tops.pixel_norm_launches
    out, got = grads()
    assert tops.pixel_norm_launches == before + 3
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gmod, "pixel_norm_leaky", lambda x, leak: (
            tops.leaky_relu(tops.pixel_norm(x), leak)))
        out_ref, want = grads()
    torch.testing.assert_close(out, out_ref, rtol=0, atol=0)
    # against the largest gradient of all: the head's bias shifts every
    # hour alike, which the softmax undoes, so its gradient is rounding
    scale = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * scale)


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
