"""How far the port's float32 generator is from the exact result, on the CPU.

A float64 evaluation of the generator from the same parameters
(``_f64_stages``, plain torch ops in float64, none of the port's code) is
the yardstick.  The port's float32 stages are held to it one at a time:
the latent projection, which sums up to 12,296 products at the 64x64
domain (``models/generator.py`` ``latent_projection`` takes a K above
1,024 in float64), and the 3^3 head conv, whose 27 * C products a
convolution library sums in an order of its own (``head_conv_f32`` sums
them in a fixed tree of short float32 sums).  Where that changes nothing
(K up to 1,024, bfloat16) they stay bit for bit what they were.  The 64x64
generator case of ``test_torch_models.py`` is also held against JAX at two
more seeds.

``PERF.md`` has the per-stage table of both packages' distances from
float64 and the margins of the f32 parity tests.
"""

import itertools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

import test_torch_models as ttm  # noqa: E402
from prdisagg_torch.core import config as tcfg  # noqa: E402
from prdisagg_torch.models import generator as tgen  # noqa: E402
from prdisagg_torch.models.generator import Generator  # noqa: E402
from prdisagg_torch.models.io import params_from_jax  # noqa: E402
from prdisagg_torch.ops.core import (  # noqa: E402
    full_f32,
    hour_softmax,
    leaky_relu,
    pixel_norm,
    pixel_norm_mixed,
)
from prdisagg_tpu import ops as jops  # noqa: E402
from prdisagg_tpu.models import Generator as JaxGenerator  # noqa: E402
from prdisagg_tpu.models.generator import FusedUpsampleConv  # noqa: E402

# Distances from float64 as a share of the stage's largest value, above
# the largest measured at these tests' inputs (seeds 0-5): the projection
# 2.5e-8 - 4.6e-8 (one float32 F.linear over the whole K: 3.1e-7 -
# 5.7e-7), the head 1.1e-7 - 1.5e-7 at C 8 and 1.4e-7 - 2.0e-7 at C 64
# (F.conv3d: 2.9e-7 - 5.4e-7 and 9.9e-7 - 1.7e-6).  The fractions'
# absolute distance at the nd-64 cases, seeds 0-2: 1.0e-6 - 2.3e-6
# (before: 2.3e-6 - 5.6e-6).
PROJ_BOUND = 1e-7
HEAD_BOUND = 3e-7
FRAC_BOUND = 3e-6

CASES_64 = [c for c in ttm.SMOKE_CASES if c["ndomain"] == 64]


def _ids(kw):
    return "-".join(f"{k}{v}" for k, v in kw.items())


def _f64_stages(sd, cfg, lat, cond, inputs=None):
    """The generator in float64 from its state dict: the latent projection
    ("proj"), each stage's conv ("conv<i>") and its pixel-norm and
    leaky-ReLU ("stage<i>"), the head's logits ("head", (B, D, H, W)) and
    the fractions ("frac").  With `inputs` (stage name -> tensor), stage i,
    the head and the softmax each start from the given input instead of
    the previous float64 stage, which measures one stage's own error."""
    p = {k: v.detach().double() for k, v in sd.items()}
    b = lat.shape[0]
    out = {}
    x = torch.cat([lat.double(), cond.double().reshape(b, -1)], -1)
    out["proj"] = x @ p["latent_proj.weight"].T + p["latent_proj.bias"]
    h = F.leaky_relu(out["proj"], cfg.leak).reshape(
        b, *cfg.latent_grid, cfg.base_channels)
    for i in range(len(cfg.gen_channels)):
        if inputs is not None:
            h = inputs[f"stage{i}"].double()
        for axis in (1, 2, 3):
            h = h.repeat_interleave(2, axis)
        y = F.conv3d(h.permute(0, 4, 1, 2, 3),
                     p[f"conv{i}.weight"].permute(4, 3, 0, 1, 2),
                     p[f"conv{i}.bias"], padding=1).permute(0, 2, 3, 4, 1)
        out[f"conv{i}"] = y
        y = y * torch.rsqrt(torch.mean(y * y, -1, keepdim=True) + 1e-8)
        h = out[f"stage{i}"] = F.leaky_relu(y, cfg.leak)
    if inputs is not None:
        h = inputs["head"].double()
    out["head"] = F.conv3d(h.permute(0, 4, 1, 2, 3), p["head.weight"],
                           p["head.bias"], padding=1)[:, 0]
    logits = out["head"] if inputs is None else inputs["frac"].double()
    out["frac"] = torch.softmax(logits, 1)
    return out


def _port_stages(gen, lat, cond):
    """The port's float32 stages at the names of ``_f64_stages``, and the
    input each stage got; the fractions are the forward's bit for bit."""
    cfg = gen.cfg
    out, ins = {}, {}
    with torch.inference_mode(), full_f32():
        b = lat.shape[0]
        x = torch.cat([lat, cond.reshape(b, -1)], -1)
        x = out["proj"] = tgen.latent_projection(
            x, gen.latent_proj.weight, gen.latent_proj.bias)
        x = leaky_relu(x, cfg.leak).reshape(b, *cfg.latent_grid, -1)
        for i, stage in enumerate(gen.stages()):
            ins[f"stage{i}"] = x
            x = out[f"conv{i}"] = stage(x)
            x = (leaky_relu(pixel_norm(x), cfg.leak) if cfg.pixelnorm_f32
                 else leaky_relu(pixel_norm_mixed(x), cfg.leak))
            out[f"stage{i}"] = x
        ins["head"] = x
        x = gen._head(x, cfg.ndomain, None)
        out["head"] = ins["frac"] = x[:, 0]
        out["frac"] = hour_softmax(x.permute(0, 2, 3, 4, 1))[..., 0]
        assert torch.equal(out["frac"], gen(lat, cond)[..., 0])
    return out, ins


def _port_local(gen, inputs):
    """Each of the port's float32 stages (conv and norm, head, softmax) on
    the given input, at the names of ``_f64_stages``."""
    cfg, out = gen.cfg, {}
    with torch.inference_mode(), full_f32():
        for i, stage in enumerate(gen.stages()):
            x = out[f"conv{i}"] = stage(inputs[f"stage{i}"])
            out[f"stage{i}"] = (
                leaky_relu(pixel_norm(x), cfg.leak) if cfg.pixelnorm_f32
                else leaky_relu(pixel_norm_mixed(x), cfg.leak))
        out["head"] = gen._head(inputs["head"], cfg.ndomain, None)[:, 0]
        out["frac"] = hour_softmax(inputs["frac"][:, None].permute(
            0, 2, 3, 4, 1))[..., 0]
    return out


def _jax_stages(jc, params, lat, cond, inputs=None):
    """JAX's generator applied one submodule at a time (its own Dense,
    conv modules and ops on numpy inputs), at the names of
    ``_f64_stages``; with `inputs`, each stage starts from the given
    input, as there."""
    p, cd, b = params["params"], jnp.float32, lat.shape[0]
    out = {}
    x = jnp.concatenate([lat, cond.reshape(b, -1)], -1)
    x = out["proj"] = fnn.Dense(p["latent_proj"]["bias"].shape[0]).apply(
        {"params": p["latent_proj"]}, x)
    x = jops.leaky_relu(x, jc.leak).reshape(b, *jc.latent_grid, -1)
    for i, ch in enumerate(jc.gen_channels):
        if inputs is not None:
            x = jnp.asarray(inputs[f"stage{i}"].numpy())
        if jc.fused_upsample:
            conv = FusedUpsampleConv(ch, fnn.initializers.zeros, cd)
        else:
            conv = fnn.Conv(ch, (3, 3, 3), padding="SAME", dtype=cd)
            x = jops.upsample3d_nearest(x, 2)
        x = out[f"conv{i}"] = conv.apply({"params": p[f"conv{i}"]}, x)
        x = out[f"stage{i}"] = (
            jops.leaky_relu(jops.pixel_norm(x), jc.leak) if jc.pixelnorm_f32
            else jops.leaky_relu(jops.pixel_norm_mixed(x), jc.leak))
    if inputs is not None:
        x = jnp.asarray(inputs["head"].numpy())
    x = fnn.Conv(1, (3, 3, 3), padding="SAME", dtype=cd).apply(
        {"params": p["head"]}, x)
    out["head"] = x[..., 0]
    if inputs is not None:
        x = jnp.asarray(inputs["frac"].numpy())[..., None]
    out["frac"] = jops.hour_softmax(x)[..., 0]
    return {k: torch.tensor(np.asarray(v)) for k, v in out.items()}


def _share(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def stage_distances(cfg_kw, seed):
    """For the generator and inputs of test_generator_matches_jax_smoke
    (JAX's initialiser at std 0.3, batch 3, `seed`): each stage's own
    distance from float64 in the port and in JAX, as a share of the stage's
    largest value, with both packages given the float64 result of the
    stage before rounded to float32 (the projection from the inputs);
    both packages' fractions' absolute distance from float64 end to end;
    and the largest |port - JAX| of the fractions."""
    jc, tc = ttm._pair(dict(cfg_kw, compute_dtype="float32",
                            init_stddev=0.3))
    rng = np.random.RandomState(seed)
    lat = rng.randn(3, jc.latent_dim).astype("f4")
    cond = rng.rand(3, jc.ndomain, jc.ndomain,
                    jc.n_cond_channels).astype("f4")
    params = JaxGenerator(jc).init(jax.random.PRNGKey(seed), lat, cond)
    gen = Generator(tc).eval()
    gen.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    lat_t, cond_t = torch.tensor(lat), torch.tensor(cond)
    port, ins = _port_stages(gen, lat_t, cond_t)
    jax_whole = _jax_stages(jc, params, lat, cond)
    ref = _f64_stages(gen.state_dict(), tc, lat_t, cond_t)
    rounded = {k: v.float() for k, v in ref.items()}
    n = len(tc.gen_channels)
    local_in = {"stage0": F.leaky_relu(rounded["proj"], tc.leak)
                .reshape(ins["stage0"].shape),
                **{f"stage{i}": rounded[f"stage{i - 1}"]
                   for i in range(1, n)},
                "head": rounded[f"stage{n - 1}"], "frac": rounded["head"]}
    local = _f64_stages(gen.state_dict(), tc, lat_t, cond_t, local_in)
    port_local = _port_local(gen, local_in)
    jax_local = _jax_stages(jc, params, lat, cond, local_in)
    out = {"proj": (_share(port["proj"], ref["proj"]),
                    _share(jax_whole["proj"], ref["proj"]))}
    for k in port_local:
        out[k] = (_share(port_local[k], local[k]),
                  _share(jax_local[k], local[k]))
    out["frac_abs"] = tuple((f.double() - ref["frac"]).abs().max().item()
                            for f in (port["frac"], jax_whole["frac"]))
    out["gap"] = (port["frac"] - jax_whole["frac"]).abs().max().item()
    return out


@pytest.mark.parametrize("cfg_kw", CASES_64, ids=_ids)
def test_stage_distances_from_float64(cfg_kw):
    """At seed 0 the port's latent projection and head are each within
    their bound of float64 and no farther than 1.5x JAX's from the same
    input, and its fractions are within FRAC_BOUND (``pytest -s`` prints
    every stage's distances, port / JAX)."""
    d = stage_distances(cfg_kw, 0)
    print(_ids(cfg_kw), " ".join(f"{k} {v[0]:.2e}/{v[1]:.2e}" for k, v in
                                 d.items() if k != "gap"),
          f"gap {d['gap']:.2e}")
    assert sorted(d) == sorted(
        ["proj", "head", "frac", "frac_abs", "gap"]
        + [f"{s}{i}" for i, s in itertools.product(range(3),
                                                    ("conv", "stage"))])
    for k, bound in (("proj", PROJ_BOUND), ("head", HEAD_BOUND)):
        port, jax_share = d[k]
        assert port <= bound and port <= 1.5 * jax_share, (k, d[k])
    assert d["frac_abs"][0] <= FRAC_BOUND
    assert d["gap"] <= 1e-5


@pytest.mark.parametrize("n_cond", [1, 3])
def test_latent_projection_near_float64(n_cond):
    """At the 64x64 domain (K = 8 + 4096 n_cond at the smoke widths) the
    projection is within PROJ_BOUND of float64 for every seed tried, and
    its gradients are those of one float32 F.linear to 1e-6."""
    cfg = tcfg.smoke_model_config(64, n_cond, "float32")
    k = cfg.latent_dim + 64 * 64 * n_cond
    n = cfg.base_channels * int(np.prod(cfg.latent_grid))
    assert k > tgen.PROJ_F32_MAX_K
    for seed in range(3):
        rng = np.random.default_rng(seed)
        x = np.concatenate([rng.standard_normal((3, cfg.latent_dim)),
                            rng.random((3, k - cfg.latent_dim))], 1)
        x = torch.tensor(x.astype("f4"), requires_grad=True)
        w, b = (torch.tensor(0.3 * rng.standard_normal(s, np.float32),
                             requires_grad=True) for s in ((n, k), (n,)))
        got = tgen.latent_projection(x, w, b)
        want = x.double() @ w.double().T + b.double()
        assert _share(got, want) <= PROJ_BOUND, seed
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(got, (x, w, b), g)
    plain = torch.autograd.grad(F.linear(x, w, b), (x, w, b), g)
    for a, p in zip(grads, plain):
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=1e-6,
                                   atol=1e-6 * p.abs().max().item())


@pytest.mark.parametrize("k", [356, 612, 868, tgen.PROJ_F32_MAX_K])
def test_short_projection_is_f_linear_bit_for_bit(k):
    """K up to PROJ_F32_MAX_K (the flagship 16x16's 356, lon's 612, doy's
    868) runs the single float32 F.linear it ran before."""
    rng = np.random.RandomState(k)
    x, w, b = (torch.tensor(rng.randn(*s).astype("f4"))
               for s in ((5, k), (64, k), (64,)))
    assert torch.equal(tgen.latent_projection(x, w, b), F.linear(x, w, b))


@pytest.mark.parametrize("n_cond", [1, 3])
def test_bf16_projection_and_head_are_unchanged(n_cond):
    """bfloat16 compute keeps one bf16 F.linear over the whole K and the
    F.conv3d head, bit for bit."""
    _, tc = ttm._pair(dict(ndomain=64, n_cond_channels=n_cond,
                           compute_dtype="bfloat16", init_stddev=0.3))
    torch.manual_seed(n_cond)
    gen = Generator(tc)
    rng = np.random.RandomState(n_cond)
    x = torch.tensor(rng.randn(3, gen.latent_proj.in_features)
                     .astype("f4")).bfloat16()
    w, b = (p.bfloat16() for p in (gen.latent_proj.weight,
                                   gen.latent_proj.bias))
    assert torch.equal(tgen.latent_projection(x, w, b), F.linear(x, w, b))
    h = torch.tensor(rng.randn(2, 24, 64, 64, 8).astype("f4")).bfloat16()
    with torch.inference_mode():
        got = gen._head(h, 64, None)
    want = F.conv3d(h.permute(0, 4, 1, 2, 3), gen.head.weight.bfloat16(),
                    gen.head.bias.bfloat16(), padding=1)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("c", [8, 64])
def test_head_conv_near_float64(c):
    """The f32 head within HEAD_BOUND of float64 on leaky-ReLU-like inputs
    at the smoke (C 8) and flagship (C 64) widths."""
    for seed in range(3):
        rng = np.random.RandomState(seed)
        x = rng.randn(1, 24, 32, 32, c).astype("f4")
        x = torch.tensor(np.where(x > 0, x, 0.2 * x).astype("f4"))
        w = torch.tensor((0.3 * rng.randn(1, c, 3, 3, 3)).astype("f4"))
        b = torch.tensor(rng.randn(1).astype("f4"))
        with torch.inference_mode():
            got = tgen.head_conv_f32(x, w, b)
        want = F.conv3d(x.double().permute(0, 4, 1, 2, 3), w.double(),
                        b.double(), padding=1)
        assert _share(got, want) <= HEAD_BOUND, seed


@pytest.mark.parametrize("pad_h", [1, 0])
def test_head_conv_is_the_conv_and_has_its_gradient(pad_h):
    """In float64 the tap form is F.conv3d to rounding, with y padded 1
    (whole rows) or 0 (a slab with its halo rows), and its gradients and
    second derivatives are the conv's (gradcheck)."""
    g = torch.Generator().manual_seed(pad_h)
    x = torch.randn(1, 3, 3, 3, 2, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(1, 2, 3, 3, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    b = torch.randn(1, dtype=torch.float64, generator=g, requires_grad=True)
    got = tgen.head_conv_f32(x, w, b, pad_h)
    want = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, padding=(1, pad_h, 1))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    fn = lambda *a: tgen.head_conv_f32(*a, pad_h)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x, w, b))
    assert torch.autograd.gradgradcheck(fn, (x, w, b))


def test_head_on_a_slab_is_the_rows_of_the_whole_head():
    """A spatial rank's head (its rows with one halo row each side, y not
    padded) gives those rows of the whole head."""
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(2, 24, 16, 16, 8).astype("f4"))
    w = torch.tensor(rng.randn(1, 8, 3, 3, 3).astype("f4"))
    b = torch.tensor(rng.randn(1).astype("f4"))
    whole = tgen.head_conv_f32(x, w, b)
    zero = torch.zeros_like(x[:, :, :1])
    padded = torch.cat([zero, x, zero], 2)
    for c, d in ((0, 5), (5, 11), (11, 16)):
        slab = tgen.head_conv_f32(padded[:, :, c:d + 2], w, b, pad_h=0)
        torch.testing.assert_close(slab, whole[:, :, :, c:d], rtol=0,
                                   atol=1e-6 * whole.abs().max().item())


def test_projection_parameters_keep_their_layout():
    """The change is in the arithmetic only: latent_proj stays one
    nn.Linear (out, in) with its bias, and the head one (1, C, 3, 3, 3)
    conv, as the weight files expect."""
    cfg = tcfg.smoke_model_config(64, 3, "float32")
    sd = Generator(cfg).state_dict()
    k = cfg.latent_dim + 64 * 64 * 3
    n = cfg.base_channels * int(np.prod(cfg.latent_grid))
    assert sd["latent_proj.weight"].shape == (n, k)
    assert sd["latent_proj.bias"].shape == (n,)
    assert sd["head.weight"].shape == (1, cfg.gen_channels[-1], 3, 3, 3)
    assert [k for k in sd if k.startswith(("latent_proj", "head"))] == [
        "latent_proj.weight", "latent_proj.bias", "head.weight", "head.bias"]


@pytest.mark.parametrize("seed", [1, 2])
def test_generator_64x64_matches_jax_at_more_seeds(seed):
    """The nd-64, n_cond-3, unfused, mixed-pixel-norm case of
    test_generator_matches_jax_smoke at seeds 1 and 2, at its atol 1e-5
    and batch 3."""
    cfg_kw = CASES_64[1]
    assert cfg_kw == dict(ndomain=64, n_cond_channels=3,
                          fused_upsample=False, pixelnorm_f32=False)
    jc, tc = ttm._pair(dict(cfg_kw, compute_dtype="float32",
                            init_stddev=0.3))
    got, want = ttm._run_both(jc, tc, batch=3, seed=seed)
    assert want.std() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-6)
