"""prdisagg_torch PretrainedGenerator against the JAX package's, on the CPU.

Weight files are written by the JAX package (``save_params_npz``,
``save_keras_generator_h5``) and loaded by both; with the same latents the
scenarios must agree to 1e-5 of the daily sum's scale.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.api import pretrained as tpre  # noqa: E402
from prdisagg_torch.core import config as tcfg  # noqa: E402
from prdisagg_tpu.api import pretrained as jpre  # noqa: E402
from prdisagg_tpu.core import config as jcfg  # noqa: E402
from prdisagg_tpu.models import Generator as JaxGenerator  # noqa: E402
from prdisagg_tpu.models.io import (  # noqa: E402
    save_keras_generator_h5,
    save_params_npz,
)


def _cfgs(smoke=True, **kw):
    jc = (jcfg.smoke_model_config(compute_dtype="float32") if smoke
          else jcfg.ModelConfig(compute_dtype="float32"))
    jc = dataclasses.replace(jc, **kw)
    tc = tcfg.ModelConfig(**{f.name: getattr(jc, f.name)
                             for f in dataclasses.fields(tcfg.ModelConfig)})
    return jc, tc


def _save_weights(d, **kw):
    """Smoke-width generator weights (std 0.3, far from uniform fractions)
    saved by the JAX package as .npz and Keras .h5."""
    jc, tc = _cfgs(init_stddev=0.3, **kw)
    lat = np.zeros((1, jc.latent_dim), "f4")
    cond = np.zeros((1, jc.ndomain, jc.ndomain, 1), "f4")
    params = jax.tree_util.tree_map(
        np.asarray, JaxGenerator(jc).init(jax.random.PRNGKey(3), lat, cond))
    npz, h5 = str(d / "gen.npz"), str(d / "gen.h5")
    save_params_npz(npz, params)
    save_keras_generator_h5(h5, params, jc)
    return dict(jc=jc, tc=tc, npz=npz, h5=h5, params=params)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return _save_weights(tmp_path_factory.mktemp("torch_weights"))


@pytest.fixture(scope="module")
def weights64(tmp_path_factory):
    """The same at the large domain's 64x64."""
    return _save_weights(tmp_path_factory.mktemp("torch_weights64"),
                         ndomain=64)


def _cond(nd=16, k=None, seed=0):
    rng = np.random.RandomState(seed)
    shape = (nd, nd) if k is None else (k, nd, nd)
    return rng.gamma(0.6, 12.0, shape).astype("f4")


@pytest.mark.parametrize("fmt,nd", [("npz", 16), ("h5", 16), ("npz", 64)],
                         ids=["npz", "h5", "npz-64x64"])
def test_generate_scenarios_matches_jax(request, fmt, nd):
    weights = request.getfixturevalue("weights" if nd == 16 else "weights64")
    jc, tc = weights["jc"], weights["tc"]
    if fmt == "npz":
        want_gen = jpre.PretrainedGenerator.from_npz(weights["npz"], cfg=jc)
        gen = tpre.PretrainedGenerator.from_npz(weights["npz"], cfg=tc,
                                                device="cpu")
    else:
        want_gen = jpre.PretrainedGenerator.from_keras_h5(weights["h5"],
                                                          cfg=jc)
        gen = tpre.PretrainedGenerator.from_keras_h5(weights["h5"], cfg=tc,
                                                     device="cpu")
    cond = _cond(nd)
    lat = np.random.RandomState(1).randn(5, tc.latent_dim).astype("f4")
    want = want_gen.generate_scenarios(cond, 5, latent=lat)
    got = gen.generate_scenarios(cond, 5, latent=lat)
    assert got.shape == want.shape == (5, 24, nd, nd)
    scale = cond.max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.sum(1), np.broadcast_to(cond, (5, nd, nd)),
                               rtol=1e-5, atol=1e-6 * scale)

    conds = _cond(nd, k=3, seed=2)
    lat = np.random.RandomState(4).randn(3 * 2, tc.latent_dim).astype("f4")
    want = want_gen.generate_scenarios_batch(conds, 2, latent=lat)
    got = gen.generate_scenarios_batch(conds, 2, latent=lat)
    assert got.shape == want.shape == (3, 2, 24, nd, nd)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * conds.max())


def test_flagship_from_npz_infers_config_and_matches_jax(tmp_path):
    jc, tc = _cfgs(smoke=False)
    lat = np.random.RandomState(0).randn(2, 100).astype("f4")
    cond = _cond()
    params = jax.tree_util.tree_map(np.asarray, JaxGenerator(jc).init(
        jax.random.PRNGKey(0), lat, np.zeros((2, 16, 16, 1), "f4")))
    path = str(tmp_path / "flagship.npz")
    save_params_npz(path, params)
    gen = tpre.PretrainedGenerator.from_npz(path, device="cpu")
    assert gen.cfg == tc
    want = jpre.PretrainedGenerator.from_npz(path).generate_scenarios(
        cond, 2, latent=lat)
    np.testing.assert_allclose(gen.generate_scenarios(cond, 2, latent=lat),
                               want, rtol=0, atol=1e-5 * cond.max())


def test_chunked_equals_unchunked(weights):
    tc = weights["tc"]
    whole = tpre.PretrainedGenerator.from_npz(weights["npz"], cfg=tc,
                                              device="cpu")
    chunked = tpre.PretrainedGenerator.from_npz(weights["npz"], cfg=tc,
                                                device="cpu", max_batch=3)
    lat = np.random.RandomState(5).randn(8, tc.latent_dim).astype("f4")
    cond = _cond()
    np.testing.assert_allclose(chunked.generate_scenarios(cond, 8, latent=lat),
                               whole.generate_scenarios(cond, 8, latent=lat),
                               rtol=0, atol=1e-6 * cond.max())


def test_seeded_latents_and_multi(weights):
    tc = weights["tc"]
    a = tpre.PretrainedGenerator.from_npz(weights["npz"], cfg=tc,
                                          device="cpu", seed=7, max_batch=8)
    b = tpre.PretrainedGenerator.from_npz(weights["npz"], cfg=tc,
                                          device="cpu", seed=7, max_batch=8)
    cond = _cond()
    first = a.generate_scenarios(cond, 3)
    np.testing.assert_array_equal(first, b.generate_scenarios(cond, 3))
    assert not np.allclose(first, a.generate_scenarios(cond, 3))  # advances

    a.warm(("max", "buckets:6", 5))  # must not consume the random stream
    np.testing.assert_array_equal(a.generate_scenarios(cond, 2),
                                  (b.generate_scenarios(cond, 3),
                                   b.generate_scenarios(cond, 2))[1])

    outs = a.generate_scenarios_multi([cond, 2 * cond, cond[..., None]],
                                      [2, 1, 4])
    assert [o.shape for o in outs] == [(2, 24, 16, 16), (1, 24, 16, 16),
                                       (4, 24, 16, 16)]
    for o, c in zip(outs, [cond, 2 * cond, cond]):
        np.testing.assert_allclose(o.sum(1), np.broadcast_to(c, o.shape[:1]
                                                             + c.shape),
                                   rtol=1e-5, atol=1e-6 * c.max())
    with pytest.raises(ValueError, match="equal-length"):
        a.generate_scenarios_multi([cond], [1, 2])
    assert [tpre._bucket(n) for n in range(1, 70)] == [
        jpre._bucket(n) for n in range(1, 70)]


def test_reload_params_validates_before_swap(weights, tmp_path):
    tc = weights["tc"]
    gen = tpre.PretrainedGenerator.from_npz(weights["npz"], cfg=tc,
                                            device="cpu")
    lat = np.random.RandomState(6).randn(2, tc.latent_dim).astype("f4")
    cond = _cond()
    before = gen.generate_scenarios(cond, 2, latent=lat)

    bad = dict(gen.params)
    bad["conv1.weight"] = torch.zeros(3, 3, 3, 8, 9)
    with pytest.raises(ValueError, match="conv1.weight"):
        gen.reload_params(bad)
    bad = {k: v.double() if k == "head.bias" else v
           for k, v in gen.params.items()}
    with pytest.raises(ValueError, match="head.bias"):
        gen.reload_params(bad)
    missing = {k: v for k, v in gen.params.items() if k != "head.bias"}
    with pytest.raises(ValueError, match="names mismatch"):
        gen.reload_params(missing)
    np.testing.assert_array_equal(
        gen.generate_scenarios(cond, 2, latent=lat), before)

    # a good reload (the same weights from .h5) keeps the outputs
    gen.reload_params(gen.load_weights_file(weights["h5"]))
    np.testing.assert_allclose(gen.generate_scenarios(cond, 2, latent=lat),
                               before, rtol=0, atol=1e-6 * cond.max())
    # and a different-architecture file is refused
    jc_big, _ = _cfgs(gen_channels=(8, 8, 16))
    other = jax.tree_util.tree_map(np.asarray, JaxGenerator(jc_big).init(
        jax.random.PRNGKey(0), lat, np.zeros((2, 16, 16, 1), "f4")))
    path = str(tmp_path / "other.npz")
    save_params_npz(path, other)
    with pytest.raises(ValueError, match="mismatch"):
        gen.reload_params(gen.load_weights_file(path))


def test_normalize_cond_errors_match_jax(weights):
    gen = tpre.PretrainedGenerator.from_npz(weights["npz"], cfg=weights["tc"],
                                            device="cpu")
    jgen = jpre.PretrainedGenerator.from_npz(weights["npz"],
                                             cfg=weights["jc"])
    for bad in (np.zeros((16, 16, 3)), np.zeros((8, 8)),
                np.zeros((2, 16, 16, 2))):
        with pytest.raises(ValueError) as got:
            gen._normalize_cond(bad)
        with pytest.raises(ValueError) as want:
            jgen._normalize_cond(bad)
        assert str(got.value) == str(want.value)
    ok = _cond(k=2)
    np.testing.assert_array_equal(gen._normalize_cond(ok),
                                  jgen._normalize_cond(ok))


def test_cuda_without_a_card_raises(weights):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpre.PretrainedGenerator.from_npz(weights["npz"], cfg=weights["tc"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpre.resolve_device("cuda")
