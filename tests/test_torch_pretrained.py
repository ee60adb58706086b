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


# (entry point, rows, max_batch): three chunks, the last one ragged; and
# multi's bucket padding (5 rows served from a forward of 6)
CALLS = [("single", 8, 3), ("batch", 8, 3), ("multi", 8, 3),
         ("multi-padded", 5, 8)]


def _owned(a):
    """`a` is an ordinary host array the caller owns: float32,
    C-contiguous, writable, not page-locked."""
    assert a.dtype == np.float32 and a.flags.c_contiguous
    assert a.flags.writeable
    assert not torch.from_numpy(a).is_pinned()


def _request(gen, call, rows, seed=5):
    """Serve `rows` scenarios through `call`; returns the served array
    (multi's parts joined), the whole-batch reference and the request's
    largest daily sum.  The reference is `predict_fractions` on all rows
    at once, then the scale by the daily sums and the copy to the host as
    they were before the chunks' copies overlapped: on the device in
    float32; with a float16 wire, on the host after the copy."""
    tc, nd = gen.cfg, gen.cfg.ndomain
    rng = np.random.RandomState(seed)
    if call == "single":
        cond = _cond(seed=seed)
        lat = rng.randn(rows, tc.latent_dim).astype("f4")
        got = gen.generate_scenarios(cond, rows, latent=lat)
        _owned(got)
        norm = gen._normalize_cond(cond)
        cond_batch = np.repeat(norm[None], rows, axis=0)
        cond0 = norm[..., 0]
    elif call == "batch":
        conds = _cond(k=2, seed=seed)
        lat = rng.randn(rows, tc.latent_dim).astype("f4")
        got = gen.generate_scenarios_batch(conds, rows // 2, latent=lat)
        _owned(got)
        assert got.shape[:2] == (2, rows // 2)
        got = got.reshape(rows, *got.shape[2:])
        norm = gen._normalize_cond(conds)
        cond_batch = np.repeat(norm, rows // 2, axis=0)
        cond0 = cond_batch[..., 0]
    else:
        conds = list(_cond(k=3, seed=seed))
        counts = [rows - 4, 2, 2]
        twin = tpre.PretrainedGenerator(gen.params, tc, device="cpu",
                                        seed=11, max_batch=gen.max_batch,
                                        wire_dtype=gen.wire_dtype)
        gen._rng.manual_seed(11)
        parts = gen.generate_scenarios_multi(conds, counts)
        assert [len(p) for p in parts] == counts
        for p in parts:
            _owned(p)
        got = np.concatenate(parts)
        target = max(min(tpre._bucket(rows), gen.max_batch), rows)
        lat = twin._latent(target)
        norm = np.repeat(np.stack([gen._normalize_cond(c) for c in conds]),
                         counts, axis=0)
        cond_batch = np.concatenate(
            [norm, np.zeros((target - rows, *norm.shape[1:]), "f4")])
        cond0 = norm[..., 0]
    frac = gen.predict_fractions(lat, cond_batch)[:rows].squeeze(-1)
    c = torch.as_tensor(cond0).unsqueeze(-3)
    if gen.wire_dtype is None:
        want = (frac * c * gen.norm_scale).cpu().numpy()
    else:
        want = (frac.to(torch.float16).cpu().float() * c
                * gen.norm_scale).numpy()
    assert got.shape == want.shape == (rows, tc.nhours, nd, nd)
    return got, want, cond0.max()


@pytest.mark.parametrize("wire", [None, "float16"])
@pytest.mark.parametrize("call,rows,max_batch", CALLS,
                         ids=[c[0] for c in CALLS])
def test_chunked_equals_unchunked(weights, call, rows, max_batch, wire):
    """Every entry point, on either wire, serves the whole-batch
    reference's bits into an ordinary host array the caller owns, and
    agrees with an unchunked generator to float32 rounding."""
    tc = weights["tc"]
    whole = tpre.PretrainedGenerator.from_npz(weights["npz"], cfg=tc,
                                              device="cpu", wire_dtype=wire)
    chunked = tpre.PretrainedGenerator.from_npz(
        weights["npz"], cfg=tc, device="cpu", max_batch=max_batch,
        wire_dtype=wire)
    got, want, scale = _request(chunked, call, rows)
    np.testing.assert_array_equal(got, want)
    unchunked = _request(whole, call, rows)[0]
    np.testing.assert_allclose(got, unchunked, rtol=0,
                               atol=1e-6 * scale * chunked.norm_scale)


@pytest.mark.parametrize("call", ["single", "batch", "multi"])
def test_a_reload_mid_request_never_mixes_weights(weights, monkeypatch,
                                                  call):
    """A hot reload that lands between a request's chunks (here: right
    after its first chunk's forward) leaves that request on the weights it
    started with; the next request serves the new weights."""
    tc = weights["tc"]
    gen = tpre.PretrainedGenerator.from_npz(weights["npz"], cfg=tc,
                                            device="cpu", max_batch=3)
    old = {k: v.clone() for k, v in gen.params.items()}
    new = {k: v + 0.05 for k, v in old.items()}
    real = tpre.PretrainedGenerator.predict_fractions
    calls = []

    def reloading(self, latent, cond):
        out = real(self, latent, cond)
        calls.append(len(latent))
        if len(calls) == 1:
            self.reload_params(new)
        return out

    monkeypatch.setattr(tpre.PretrainedGenerator, "predict_fractions",
                        reloading)
    got = _request(gen, call, 8)[0]
    assert calls[:3] == [3, 3, 2]  # every chunk went through the seam
    monkeypatch.setattr(tpre.PretrainedGenerator, "predict_fractions", real)
    for params, served in ((old, got), (new, _request(gen, call, 8)[0])):
        ref = tpre.PretrainedGenerator(params, tc, device="cpu", max_batch=3)
        np.testing.assert_array_equal(served, _request(ref, call, 8)[0])


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
