"""The Python side of the upsample-conv kernels (K1) against the JAX
package, on the CPU.

The CUDA kernels read the folded weights packed K-major, (8 phases, Cout,
8*Cin) with k = tap*Cin + ci, and gather the input rows of each tap at the
offsets (a+p-1, b+q-1, c+r-1).  Unpacked, the packing must be the JAX
package's ``_phase_kernels``; a plain implicit GEMM over it must be the TPU
kernel's function.  The shape chooser must send every main-path shape to the
fast kernels with a grid that fills the card, and odd widths to the general
one.
"""

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [32, 160, 1000])
@pytest.mark.parametrize("stage", range(3))
def test_plan_puts_main_path_on_fast_kernel(dtype, batch, stage):
    d, h, w, cin, cout = FLAGSHIP_STAGES[stage]
    plan = tuc.k1_plan(dtype, batch, d, h, w, cin, cout)
    assert plan.variant == "fast"
    assert (plan.bm, plan.bn) in tuc.FAST_TILES and cout % plan.bn == 0
    m = batch * d * h * w
    assert plan.ctas == 8 * -(-m // plan.bm) * (cout // plan.bn)
    assert plan.ctas >= tuc.SMS  # the grid fills the card


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 8])
def test_plan_puts_64x64_last_stage_on_fast_kernel(dtype, batch):
    plan = tuc.k1_plan(dtype, batch, *LAST_STAGE_64)
    assert plan.variant == "fast" and plan.ctas >= tuc.SMS


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
    plan = tuc.k1_plan(dtype, *shape)
    assert plan.variant == "fast" and (plan.bm, plan.bn) == tile


def test_fast_kernel_width_rules():
    # bf16 slices are 64 deep, f32 slices 32: Cin 32 is fast in f32 only
    assert tuc.k1_plan(torch.float32, 64, 6, 4, 4, 32, 64).variant == "fast"
    assert tuc.k1_plan(torch.bfloat16, 64, 6, 4, 4, 32, 64).variant == \
        "general"
    # Cout must be a multiple of 64 in both
    for dtype in DTYPES:
        assert tuc.k1_plan(dtype, 64, 6, 4, 4, 128, 96).variant == "general"
