"""prdisagg_torch Generator against the JAX package's Generator, on the CPU.

The same weights (drawn by the JAX initializer, converted with
``params_from_jax``) and the same numpy latents and conditions go through
both; fractions must agree to 1e-5 and conserve (sum over hours = 1) to 1e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.core import config as tcfg  # noqa: E402
from prdisagg_torch.models.generator import Generator  # noqa: E402
from prdisagg_torch.models.io import params_from_jax  # noqa: E402
from prdisagg_tpu.core import config as jcfg  # noqa: E402
from prdisagg_tpu.models import Generator as JaxGenerator  # noqa: E402


def _pair(cfg_kw, smoke=True, seed=0):
    """(JAX config, port config) with identical fields."""
    if smoke:
        jc = jcfg.smoke_model_config(**{k: cfg_kw[k] for k in (
            "ndomain", "n_cond_channels") if k in cfg_kw})
        extra = {k: v for k, v in cfg_kw.items()
                 if k not in ("ndomain", "n_cond_channels")}
        jc = dataclasses.replace(jc, **extra)
    else:
        jc = jcfg.ModelConfig(**cfg_kw)
    tc = tcfg.ModelConfig(**{f.name: getattr(jc, f.name)
                             for f in dataclasses.fields(tcfg.ModelConfig)})
    return jc, tc


def _run_both(jc, tc, batch, seed=0):
    rng = np.random.RandomState(seed)
    lat = rng.randn(batch, jc.latent_dim).astype("f4")
    cond = rng.rand(batch, jc.ndomain, jc.ndomain,
                    jc.n_cond_channels).astype("f4")
    jgen = JaxGenerator(jc)
    params = jgen.init(jax.random.PRNGKey(seed), lat, cond)
    want = np.asarray(jgen.apply(params, lat, cond))
    gen = Generator(tc)
    gen.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.inference_mode():
        got = gen(torch.tensor(lat), torch.tensor(cond)).numpy()
    return got, want


SMOKE_CASES = [
    dict(ndomain=16, n_cond_channels=1),
    dict(ndomain=16, n_cond_channels=3),
    dict(ndomain=64, n_cond_channels=1),
    dict(ndomain=16, n_cond_channels=1, fused_upsample=False),
    dict(ndomain=16, n_cond_channels=3, pixelnorm_f32=False),
    dict(ndomain=64, n_cond_channels=3, fused_upsample=False,
         pixelnorm_f32=False),
]


@pytest.mark.parametrize("cfg_kw", SMOKE_CASES,
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in
                                                 kw.items()))
def test_generator_matches_jax_smoke(cfg_kw):
    # std 0.3 keeps the fractions far from uniform, so agreement means
    # something at smoke widths
    jc, tc = _pair(dict(cfg_kw, compute_dtype="float32", init_stddev=0.3))
    got, want = _run_both(jc, tc, batch=3)
    assert got.shape == want.shape == (3, 24, jc.ndomain, jc.ndomain, 1)
    assert want.std() > 1e-2  # non-trivial output
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-6)


def test_generator_matches_jax_flagship():
    jc, tc = _pair(dict(compute_dtype="float32"), smoke=False)
    assert tc.gen_channels == (256, 128, 64) and tc.latent_dim == 100
    got, want = _run_both(jc, tc, batch=2, seed=1)
    assert got.shape == (2, 24, 16, 16, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-6)


def test_generator_bf16_compute_close_to_f32():
    _, t32 = _pair(dict(ndomain=16, n_cond_channels=1,
                        compute_dtype="float32", init_stddev=0.3))
    t16 = dataclasses.replace(t32, compute_dtype="bfloat16")
    torch.manual_seed(0)
    g32 = Generator(t32)
    g16 = Generator(t16)
    g16.load_state_dict(g32.state_dict())
    lat, cond = torch.randn(2, t32.latent_dim), torch.rand(2, 16, 16, 1)
    with torch.inference_mode():
        f32, f16 = g32(lat, cond), g16(lat, cond)
    assert f16.dtype == torch.float32  # the hour softmax stays f32
    np.testing.assert_allclose(f16.sum(1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(f16.numpy(), f32.numpy(), atol=2e-2)


@pytest.mark.parametrize("cfg_kw", SMOKE_CASES[:3] + SMOKE_CASES[4:5],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in
                                                 kw.items()))
def test_generator_bf16_matches_jax_bf16(cfg_kw):
    """Both packages with bf16 convolutions on the same weights and inputs.
    They agree to 2e-2, not 1e-5, because bf16 rounds at different sites:
    XLA may fuse a chain of ops and round its result once where eager
    PyTorch rounds after each op, and the two sum the convolutions in
    different orders.  The hour softmax is f32 in both, so both conserve to
    1e-6.  Weights at std 0.1 keep the fractions away from uniform (std
    above 1e-2) without letting the softmax magnify the rounding."""
    jc, tc = _pair(dict(cfg_kw, compute_dtype="bfloat16", init_stddev=0.1))
    got, want = _run_both(jc, tc, batch=3)
    assert got.dtype == want.dtype == np.float32  # f32 hour softmax
    assert got.shape == want.shape == (3, 24, jc.ndomain, jc.ndomain, 1)
    assert want.std() > 1e-2
    for frac in (got, want):
        assert np.abs(frac.sum(axis=1) - 1.0).max() <= 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_params_from_jax_layouts():
    jc, tc = _pair(dict(ndomain=16, n_cond_channels=1))
    lat = np.zeros((1, jc.latent_dim), "f4")
    cond = np.zeros((1, 16, 16, 1), "f4")
    tree = jax.tree_util.tree_map(
        np.asarray, JaxGenerator(jc).init(jax.random.PRNGKey(0), lat, cond))
    sd = params_from_jax(tree)
    p = tree["params"]
    np.testing.assert_array_equal(sd["latent_proj.weight"].numpy(),
                                  p["latent_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["conv1.weight"].numpy(),
                                  p["conv1"]["kernel"])
    np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                  p["head"]["kernel"].transpose(4, 3, 0, 1, 2))
    assert set(sd) == set(Generator(tc).state_dict())
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_config_rejects_bad_domains():
    with pytest.raises(ValueError, match="ndomain"):
        tcfg.ModelConfig(ndomain=12)
    with pytest.raises(ValueError, match="nhours"):
        tcfg.ModelConfig(nhours=20)
    assert tcfg.ModelConfig(ndomain=64).latent_grid == (3, 8, 8)
