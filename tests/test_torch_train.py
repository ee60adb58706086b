"""The port's training slice against the JAX package, on the CPU.

Modules with a kernel (the patch gather, the upsample-conv's gradient) and
the slice as a whole (sampler, critic, losses, one full step, Adam, EMA, the
Trainer) take the same seeded numpy inputs and the same weights in both
packages.  Data movement must match exactly; arithmetic within the stated
tolerance (f32 sums taken in another order); random draws are checked for
their distribution.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.core import config as tcfg  # noqa: E402
from prdisagg_torch.data.indices import compute_valid_indices  # noqa: E402
from prdisagg_torch.data.sampler import DeviceDataset  # noqa: E402
from prdisagg_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from prdisagg_torch.models.critic import Critic  # noqa: E402
from prdisagg_torch.models.generator import Generator  # noqa: E402
from prdisagg_torch.models.io import (  # noqa: E402
    critic_params_from_jax,
    params_from_jax,
    params_to_jax,
)
from prdisagg_torch.ops import gather as tgather  # noqa: E402
from prdisagg_torch.ops import upsample_conv as tuc  # noqa: E402
from prdisagg_torch.train import wgan_gp as twgan  # noqa: E402
from prdisagg_torch.train.loop import NaNLossError, Trainer  # noqa: E402
from prdisagg_torch.train.state import (  # noqa: E402
    clone_train_state,
    create_train_state,
    make_optimizer,
)
from prdisagg_tpu.core import config as jcfg  # noqa: E402
from prdisagg_tpu.data.indices import (  # noqa: E402
    compute_valid_indices as jax_valid_indices,
)
from prdisagg_tpu.data.sampler import DeviceDataset as JaxDataset  # noqa: E402
from prdisagg_tpu.models import Critic as JaxCritic  # noqa: E402
from prdisagg_tpu.models import Generator as JaxGenerator  # noqa: E402
from prdisagg_tpu.ops import fractions_and_condition as jax_frac  # noqa: E402
from prdisagg_tpu.ops.pallas_gather import gather_patches_pallas  # noqa: E402
from prdisagg_tpu.ops.pallas_upsample_conv import (  # noqa: E402
    upsample2_conv3_pallas_interpret,
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _model_pair(**kw):
    """(JAX ModelConfig, port ModelConfig) with identical fields."""
    base = dict(ndomain=16, n_cond_channels=1)
    base.update(kw)
    smoke = base.pop("smoke", True)
    if smoke:
        jc = jcfg.smoke_model_config(base.pop("ndomain"),
                                     base.pop("n_cond_channels"))
        jc = dataclasses.replace(jc, **base)
    else:
        jc = jcfg.ModelConfig(**base)
    tc = tcfg.ModelConfig(**{f.name: getattr(jc, f.name)
                             for f in dataclasses.fields(tcfg.ModelConfig)})
    return jc, tc


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

# JAX-only field: the port always gathers with its CUDA kernel on the card
JAX_ONLY_FIELDS = {"TrainConfig": {"pallas_gather"}}


@pytest.mark.parametrize("name", ["DataConfig", "ModelConfig", "TrainConfig",
                                  "EvalConfig", "RainFarmConfig"])
def test_config_fields_and_defaults_match_jax(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tcfg, name))}
    for k in JAX_ONLY_FIELDS.get(name, ()):
        del jf[k]
    assert tf == jf


@pytest.mark.parametrize("conditioning", ["base", "doy", "lon"])
def test_experiment_config_matches_jax(conditioning):
    kw = dict(conditioning=conditioning, tp_thresh_daily=2.5, ndomain=64)
    jd, td = jcfg.DataConfig(**kw), tcfg.DataConfig(**kw)
    for method in ("params_string", "data_filename", "indices_filename",
                   "doy_filename"):
        assert getattr(td, method)() == getattr(jd, method)()
    assert (td.nhours, td.n_cond_channels) == (jd.nhours, jd.n_cond_channels)
    for dtype in (None, "float32"):
        jm = jcfg.ExperimentConfig(data=jd, compute_dtype=dtype).model()
        tm = tcfg.ExperimentConfig(data=td, compute_dtype=dtype).model()
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert tcfg.TrainConfig(schedule=((2, 4), (3, 8))).total_epochs == 5


# --------------------------------------------------------------------------
# K2: the patch gather
# --------------------------------------------------------------------------

GATHER_ROWS = np.array([[0, 0, 5], [2, 16, 16], [3, 32, 24], [1, 8, 0]],
                       dtype=np.int32)


def test_gather_plain_equals_pallas_and_numpy_exactly():
    rng = np.random.RandomState(0)
    data = rng.rand(4, 24, 48, 40).astype(np.float32)
    got = tgather.gather_patches(torch.tensor(data), torch.tensor(GATHER_ROWS),
                                 16).numpy()
    pal = np.asarray(gather_patches_pallas(
        jnp.asarray(data), jnp.asarray(GATHER_ROWS), 16, interpret=True))
    assert got.shape == (4, 24, 16, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, pal)
    for i, (t, y, x) in enumerate(GATHER_ROWS):
        np.testing.assert_array_equal(got[i], data[t, :, y:y + 16, x:x + 16])


@pytest.mark.parametrize("nh,nd,x_odd", [(1, 16, True), (24, 8, True),
                                         (3, 5, False)])
def test_gather_plain_on_odd_shapes(nh, nd, x_odd):
    rng = np.random.RandomState(nh + nd)
    data = rng.rand(3, nh, 21, 19).astype(np.float32)
    rows = np.stack([rng.randint(0, 3, 9), rng.randint(0, 21 - nd + 1, 9),
                     rng.randint(0, 19 - nd + 1, 9)], 1).astype(np.int32)
    if x_odd:
        rows[0] = (2, 21 - nd, 19 - nd)  # the last row and column
    got = tgather.gather_patches(torch.tensor(data), torch.tensor(rows),
                                 nd).numpy()
    for i, (t, y, x) in enumerate(rows):
        np.testing.assert_array_equal(got[i], data[t, :, y:y + nd, x:x + nd])


def test_gather_plain_reads_data_in_place():
    """The plain version indexes a view: the unfold windows share data's
    storage, so only the B gathered windows are ever written."""
    data = torch.rand(2, 24, 32, 32)
    windows = data.unfold(2, 16, 1).unfold(3, 16, 1)
    assert (windows.untyped_storage().data_ptr()
            == data.untyped_storage().data_ptr())
    before = tgather.launches
    tgather.gather_patches(data, torch.tensor(GATHER_ROWS[:2] // 2), 16)
    assert tgather.launches == before  # the CPU never launches the kernel


def test_gather_refuses_other_devices():
    data = torch.rand(2, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgather.gather_patches(data, torch.zeros(1, 3, dtype=torch.int32), 4)


# --------------------------------------------------------------------------
# indices, synthetic data, sampler
# --------------------------------------------------------------------------

def test_synthetic_dataset_and_indices_match_jax():
    data, idx, _ = make_synthetic_dataset(n_days=3, ny=40, nx=48, seed=4)
    from prdisagg_tpu.data.synthetic import make_synthetic_dataset as jmake

    jdata, jidx, _ = jmake(n_days=3, ny=40, nx=48, seed=4)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(idx, jidx)
    data[1, :, 3:9, 20:30] = np.nan
    for kw in (dict(stride=8), dict(stride=16, n_thresh=200)):
        want = jax_valid_indices(data, jcfg.DataConfig(**kw))
        np.testing.assert_array_equal(
            compute_valid_indices(data, tcfg.DataConfig(**kw)), want)
        np.testing.assert_array_equal(
            compute_valid_indices(torch.tensor(data), tcfg.DataConfig(**kw)),
            want)


@pytest.mark.parametrize("include_last_box", [False, True])
def test_include_last_box_matches_jax(include_last_box):
    """The reference's sweep leaves out the last box that fits; the flag
    adds it.  Both settings against the JAX package's vectorised scan and
    its triple-loop oracle, on a grid where the last box starts on the
    stride (48 - 16 = 32 rows, 40 - 16 = 24 columns, stride 8)."""
    from prdisagg_torch.data.indices import sweep_starts
    from prdisagg_tpu.data import indices as jidx

    data, _, _ = make_synthetic_dataset(n_days=3, ny=48, nx=40, seed=6)
    data[2, :, 30:34, 0:5] = np.nan
    kw = dict(stride=8, n_thresh=10)
    got = compute_valid_indices(data, tcfg.DataConfig(**kw),
                                include_last_box=include_last_box)
    jc = jcfg.DataConfig(**kw)
    np.testing.assert_array_equal(
        got, jidx.compute_valid_indices(data, jc, include_last_box))
    np.testing.assert_array_equal(
        got, jidx.compute_valid_indices_bruteforce(data, jc,
                                                   include_last_box))
    for n in (48, 40, 16, 15):
        np.testing.assert_array_equal(
            sweep_starts(n, 16, 8, include_last_box),
            jidx.sweep_starts(n, 16, 8, include_last_box))
    assert (32 in got[:, 1]) == include_last_box
    assert (24 in got[:, 2]) == include_last_box
    if not include_last_box:  # the default is the reference's sweep
        np.testing.assert_array_equal(
            got, compute_valid_indices(data, tcfg.DataConfig(**kw)))


def test_synthetic_dataset_on_a_device_follows_the_recipe():
    """The chunked on-device recipe (its own random numbers) makes what the
    numpy recipe makes: the same floor, the same mean and spread to a few
    percent, from a seed and without touching the caller's random stream."""
    from prdisagg_torch.data.synthetic import make_synthetic_dataset_torch

    shape = (20, 32, 32)  # more days than one chunk
    state = torch.random.get_rng_state()
    data, idx, cfg = make_synthetic_dataset_torch(*shape, seed=5,
                                                  device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    again, _, _ = make_synthetic_dataset_torch(*shape, seed=5, device="cpu")
    assert torch.equal(data, again)
    assert data.shape == (20, 24, 32, 32) and data.dtype == torch.float32
    np.testing.assert_array_equal(idx, compute_valid_indices(data.numpy(),
                                                             cfg))
    want, _, _ = make_synthetic_dataset(*shape, seed=5)
    got = data.numpy()
    assert got.min() >= np.float32(1e-3)
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=0.05)
    np.testing.assert_allclose(got.std(), want.std(), rtol=0.1)
    # the daily cycle along hours
    np.testing.assert_allclose(got.mean(axis=(0, 2, 3)),
                               want.mean(axis=(0, 2, 3)), rtol=0.1)


@pytest.mark.parametrize("conditioning", ["base", "doy", "lon"])
def test_sampler_matches_jax_on_the_same_rows(conditioning):
    data, idx, _ = make_synthetic_dataset(
        n_days=4, ny=48, nx=40, seed=1, cfg=tcfg.DataConfig(stride=8))
    doy = (np.arange(4) * 70 + 11).astype("f4")
    ds = DeviceDataset.from_numpy(
        data, idx, tcfg.DataConfig(stride=8, conditioning=conditioning),
        doy=doy, device="cpu")
    jds = JaxDataset.from_numpy(
        data, idx, jcfg.DataConfig(stride=8, conditioning=conditioning),
        doy=doy)
    rows = idx[np.random.RandomState(2).randint(0, len(idx), 7)]
    trows = torch.tensor(rows)

    patches = np.asarray(jds._gather_patches(jnp.asarray(rows)))
    np.testing.assert_array_equal(ds.patches_from_rows(trows).numpy(),
                                  patches)
    frac, cond = ds.real_from_rows(trows)
    jfrac, jcond = jax_frac(jnp.asarray(patches), 127.4, 1e-12)
    extras = jds._extra_cond_channels(jnp.asarray(rows))
    jcond = np.concatenate([np.asarray(jcond), *map(np.asarray, extras)], -1)
    np.testing.assert_allclose(frac.numpy(), np.asarray(jfrac), rtol=1e-6)
    np.testing.assert_allclose(cond.numpy(), jcond, rtol=1e-6)

    # conditions from the daily sums: the JAX sample_cond's dynamic_slice
    dsum = np.asarray(jds.dsum)
    want = np.stack([dsum[t, y:y + 16, x:x + 16] for t, y, x in rows])
    want = np.concatenate([want[..., None] / 127.4,
                           *map(np.asarray, extras)], -1)
    np.testing.assert_allclose(ds.cond_from_rows(trows).numpy(), want,
                               rtol=1e-6)
    assert cond.shape == (7, 16, 16, ds.cfg.n_cond_channels)


def test_sampler_validates_rows_once():
    data, idx, cfg = make_synthetic_dataset(n_days=2, ny=32, nx=32, seed=0)
    bad = idx.copy()
    bad[0, 2] = 32 - 16 + 1
    with pytest.raises(ValueError, match="out of range"):
        DeviceDataset.from_numpy(data, bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="doy"):
        DeviceDataset.from_numpy(
            data, idx, tcfg.DataConfig(conditioning="doy"), device="cpu")


@pytest.mark.parametrize("entry", ["patches", "real", "cond", "step_real",
                                   "step_gen"])
@pytest.mark.parametrize("bad_row", [(2, 0, 0), (0, 17, 0), (0, 0, -1)])
def test_injected_rows_are_checked(entry, bad_row):
    """Every public entry that takes index rows refuses one outside the
    tensor before any gather (the kernel would read out of bounds)."""
    data, idx, cfg = make_synthetic_dataset(n_days=2, ny=32, nx=32, seed=0)
    ds = DeviceDataset.from_numpy(data, idx, cfg, device="cpu")
    rows = torch.tensor(np.concatenate([idx[:3], [bad_row]]),
                        dtype=torch.int32)
    good = torch.tensor(idx[:4])
    with pytest.raises(ValueError, match="out of range"):
        if entry.startswith("step"):
            draws = twgan.StepDraws(
                real_rows=rows if entry == "step_real" else good,
                latent=None, eps=None, masks=[], gp_masks=[], gen_latent=None,
                gen_rows=rows if entry == "step_gen" else good,
                gen_masks=None)
            twgan.train_step_on(None, ds, draws, tcfg.TrainConfig())
        else:
            getattr(ds, f"{entry}_from_rows")(rows)
    for name in ("patches", "real", "cond"):
        getattr(ds, f"{name}_from_rows")(good)


def test_sampler_draw_statistics():
    """Index rows uniform (chi-square over 20k draws), eps ~ U(0, 1),
    dropout keeps 75% of activations."""
    from scipy import stats

    data, idx, cfg = make_synthetic_dataset(n_days=3, ny=64, nx=64, seed=0)
    ds = DeviceDataset.from_numpy(data, idx, cfg, device="cpu")
    rows = ds.draw_rows(20000, torch.Generator().manual_seed(3)).numpy()
    flat = (rows[:, 0] * 64 + rows[:, 1]) * 64 + rows[:, 2]
    keys = (idx[:, 0] * 64 + idx[:, 1]) * 64 + idx[:, 2]
    assert np.isin(flat, keys).all()
    counts = np.unique(flat, return_counts=True)[1]
    assert len(counts) == len(idx)
    assert stats.chisquare(counts).pvalue > 1e-3

    _, mc = _model_pair(critic_channels=(1, 1, 1, 1))
    state = create_train_state(mc, tcfg.TrainConfig(n_disc=5), device="cpu")
    draws = twgan.draw_step_inputs(state, ds, 2000, 5)
    eps = draws.eps
    assert 0.49 <= eps.mean().item() <= 0.51
    assert 0.0 <= eps.min().item() and eps.max().item() < 1.0
    for masks in (draws.masks, draws.gp_masks, [draws.gen_masks]):
        keep = torch.cat([m.flatten().float() for ms in masks for m in ms])
        assert abs(keep.mean().item() - 0.75) <= 0.01
    assert draws.real_rows.shape == (10000, 3)
    assert draws.latent.shape == (10000, mc.latent_dim)


# --------------------------------------------------------------------------
# critic
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ndomain,n_cond", [(16, 1), (16, 2), (16, 3),
                                            (64, 1), (64, 3)])
def test_critic_matches_jax(ndomain, n_cond):
    jc, tc = _model_pair(ndomain=ndomain, n_cond_channels=n_cond,
                         compute_dtype="float32",
                         critic_channels=(8, 16, 8, 4))
    rng = np.random.RandomState(ndomain + n_cond)
    # no symmetry to hide a wrong padding: random, not constant, inputs
    sample = rng.rand(3, 24, ndomain, ndomain, 1).astype("f4")
    cond = rng.randn(3, ndomain, ndomain, n_cond).astype("f4")
    torch.manual_seed(n_cond)
    crit = Critic(tc)
    params = params_to_jax(crit.state_dict())
    want = np.asarray(jax.jit(JaxCritic(jc).apply)(params, sample, cond))
    with torch.no_grad():
        got = crit(torch.tensor(sample), torch.tensor(cond)).numpy()
    assert got.shape == (3, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_critic_flagship_pads_and_layout():
    """The flagship critic's SAME pads are jax.lax.padtype_to_pads's, and
    its weights round-trip through the JAX layout."""
    _, tc = _model_pair(smoke=False)
    crit = Critic(tc)
    assert crit.stage_dims == [(11, 7, 7), (6, 4, 4), (3, 2, 2), (2, 1, 1)]
    for i, shape in ((1, (11, 7, 7)), (2, (6, 4, 4)), (3, (3, 2, 2))):
        pads = jax.lax.padtype_to_pads(shape, (3, 3, 3), (2, 2, 2), "SAME")
        assert crit._pads[i] == tuple(p for lo_hi in reversed(pads)
                                      for p in lo_hi)
    tree = params_to_jax(crit.state_dict())
    assert tree["params"]["conv0"]["kernel"].shape == (3, 3, 3, 2, 64)
    assert tree["params"]["score"]["kernel"].shape == (512, 1)
    back = critic_params_from_jax(tree)
    for k, v in crit.state_dict().items():
        assert torch.equal(back[k], v), k
    # glorot-uniform bounds, as Keras and Flax initialise the critic
    limit = np.sqrt(6.0 / (27 * 2 + 27 * 64))
    w = crit.conv0.weight.detach().abs()
    assert w.max().item() <= limit and w.max().item() > 0.9 * limit


def test_pad_only_taps_have_exactly_zero_gradient_in_both_packages():
    """The critic's conv taps that read only SAME padding at the flagship
    16x16 geometry (narrow channels): where JAX's gradient of the critic
    loss, its gradient penalty included, is exactly 0, the port's is too,
    and both are the taps of ``pad_only_taps``."""
    from prdisagg_torch.models.critic import pad_only_taps

    jc, tc = _model_pair(compute_dtype="float32", dropout_rate=0.0,
                         critic_channels=(4, 8, 8, 4))
    rng = np.random.RandomState(11)
    frac = rng.rand(2, 24, 16, 16, 1).astype("f4")
    fake = rng.rand(2, 24, 16, 16, 1).astype("f4")
    cond = rng.rand(2, 16, 16, 1).astype("f4")
    eps = rng.rand(2).astype("f4")
    torch.manual_seed(4)
    crit = Critic(tc)
    cp = params_to_jax(crit.state_dict())
    (_, _), jgrads = jax.value_and_grad(
        lambda c: _jax_critic_loss(JaxCritic(jc), c, frac, cond, fake, eps,
                                   10.0), has_aux=True)(cp)
    loss = twgan.critic_loss(crit, torch.tensor(frac), torch.tensor(cond),
                             torch.tensor(fake), torch.tensor(eps), None,
                             None, 10.0)[0]
    names = [n for n, _ in crit.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss, list(crit.parameters()))))
    masks = pad_only_taps(tc)
    assert list(masks) == [3] and int(masks[3].sum()) == 15
    for i in range(4):
        want = np.asarray(jgrads["params"][f"conv{i}"]["kernel"])
        zero_jax = np.all(want == 0, axis=(3, 4))
        zero_port = (got[f"conv{i}.weight"] == 0).all(dim=-1).all(dim=-1)
        expect = masks.get(i, torch.zeros(3, 3, 3, dtype=torch.bool))
        assert np.array_equal(zero_jax, zero_port.numpy()), i
        assert np.array_equal(zero_jax, expect.numpy()), i
    assert pad_only_taps(tcfg.ModelConfig(ndomain=64)) == {}


# --------------------------------------------------------------------------
# K1's gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 2, 2, 8, 6), (1, 6, 4, 4, 8, 8)])
def test_upsample_conv_gradients_match_jax(shape):
    b, d, h, w, cin, cout = shape
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(b, d, h, w, cin).astype("f4")
    k = (0.1 * rng.randn(3, 3, 3, cin, cout)).astype("f4")
    bias = rng.randn(cout).astype("f4")
    g = rng.randn(b, 2 * d, 2 * h, 2 * w, cout).astype("f4")
    want = jax.jit(lambda *a: jax.vjp(upsample2_conv3_pallas_interpret,
                                      *a[:3])[1](a[3]))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), jnp.asarray(g))

    tx, tk, tb = (torch.tensor(a, requires_grad=True) for a in (x, k, bias))
    before = tuc.backward_calls
    out = tuc.upsample2_conv3(tx, tk, tb)
    got = torch.autograd.grad(out, (tx, tk, tb), torch.tensor(g))
    assert tuc.backward_calls == before + 1
    for a, bb in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(bb)).max())
    # the explicit backward equals autograd through the plain version
    ref = torch.autograd.grad(tuc.upsample2_conv3_reference(tx, tk, tb),
                              (tx, tk, tb), torch.tensor(g))
    for a, bb in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), bb.numpy(), rtol=1e-5,
                                   atol=1e-6 * bb.abs().max().item())


def test_fold_matrices_are_made_once_and_serve_autograd():
    """The phase-folding matrices are built once per dtype and device (a
    host-to-card copy on every call would synchronise), and a copy first
    made under inference mode, as the serving path runs, still serves a
    later backward."""
    tuc._fold_matrices.cache_clear()
    x, bias = torch.randn(1, 2, 2, 2, 4), torch.zeros(3)
    k = torch.randn(3, 3, 3, 4, 3)
    with torch.inference_mode():
        tuc.upsample2_conv3(x, k, bias)
    k.requires_grad_(True)
    for _ in range(2):
        (g,) = torch.autograd.grad(tuc.upsample2_conv3(x, k, bias).sum(), k)
        assert torch.isfinite(g).all()
    info = tuc._fold_matrices.cache_info()
    assert info.misses == 1 and info.hits >= 3


# --------------------------------------------------------------------------
# losses, gradients, one full step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_setup():
    data, idx, dcfg = make_synthetic_dataset(n_days=4, ny=32, nx=32, seed=1)
    ds = DeviceDataset.from_numpy(data, idx, tcfg.DataConfig(), device="cpu")
    jds = JaxDataset.from_numpy(data, idx, jcfg.DataConfig())
    return data, idx, ds, jds


@pytest.fixture(scope="module")
def train_setup64():
    """The 64x64 domain's data (large_domain_experiment's n_thresh 40)."""
    kw = dict(ndomain=64, n_thresh=40)
    data, idx, _ = make_synthetic_dataset(n_days=2, ny=80, nx=80, seed=1,
                                          cfg=tcfg.DataConfig(**kw))
    ds = DeviceDataset.from_numpy(data, idx, tcfg.DataConfig(**kw),
                                  device="cpu")
    jds = JaxDataset.from_numpy(data, idx, jcfg.DataConfig(**kw))
    return data, idx, ds, jds


def _nets(tc, seed=0):
    """JAX parameter trees of both nets, drawn by the port's initialisers
    (``params_to_jax`` of seeded modules: no JAX init to compile)."""
    torch.manual_seed(seed)
    return (params_to_jax(Generator(tc).state_dict()),
            params_to_jax(Critic(tc).state_dict()))


def _load_state(tc, train_cfg, gp, cp):
    state = create_train_state(tc, train_cfg, device="cpu")
    state.gen.load_state_dict(params_from_jax(gp))
    state.critic.load_state_dict(critic_params_from_jax(cp))
    return state


def _draws(jc, ds_idx, batch, n_disc, seed):
    rng = np.random.RandomState(seed)
    return dict(
        real_rows=ds_idx[rng.randint(0, len(ds_idx), n_disc * batch)],
        latent=rng.randn(n_disc * batch, jc.latent_dim).astype("f4"),
        eps=rng.rand(n_disc, batch).astype("f4"),
        gen_latent=rng.randn(batch, jc.latent_dim).astype("f4"),
        gen_rows=ds_idx[rng.randint(0, len(ds_idx), batch)])


def _jax_critic_loss(jcrit, cparams, frac, cond, fake, eps, gp_weight):
    b = frac.shape[0]
    scores = jcrit.apply(cparams, jnp.concatenate([frac, fake]),
                         jnp.concatenate([cond, cond]))
    e = eps.reshape(b, 1, 1, 1, 1)
    interp = e * frac + (1.0 - e) * fake
    g = jax.grad(lambda x: jnp.sum(jcrit.apply(cparams, x, cond)))(interp)
    norm = jnp.sqrt(jnp.sum(jnp.square(g.reshape(b, -1)), axis=1) + 1e-12)
    gp = jnp.mean(jnp.square(norm - 1.0))
    lv, lf = jnp.mean(-scores[:b]), jnp.mean(scores[b:])
    return lv + lf + gp_weight * gp, (lv, lf, gp)


def _jax_gen_loss(jgen, jcrit, gparams, cparams, lat, cond):
    return jnp.mean(-jcrit.apply(cparams, jgen.apply(gparams, lat, cond),
                                 cond))


@functools.lru_cache(maxsize=None)
def _jax_step_fns(jc, gp_weight=10.0):
    """Jitted JAX compositions of one critic and one generator update
    (loss, aux, gradients, optax.adam), compiled once per config."""
    jgen, jcrit = JaxGenerator(jc), JaxCritic(jc)
    cfg = tcfg.TrainConfig()
    tx = optax.adam(cfg.learning_rate, b1=cfg.beta1, b2=cfg.beta2)

    @jax.jit
    def critic_update(cp, c_opt, frac, cond, fake, eps):
        (loss, aux), grads = jax.value_and_grad(
            lambda c: _jax_critic_loss(jcrit, c, frac, cond, fake, eps,
                                       gp_weight), has_aux=True)(cp)
        upd, c_opt = tx.update(grads, c_opt, cp)
        return optax.apply_updates(cp, upd), c_opt, loss, aux, grads

    @jax.jit
    def gen_update(gp, g_opt, cp, lat, cond):
        loss, grads = jax.value_and_grad(
            lambda g: _jax_gen_loss(jgen, jcrit, g, cp, lat, cond))(gp)
        upd, g_opt = tx.update(grads, g_opt, gp)
        return optax.apply_updates(gp, upd), g_opt, loss, grads

    return jax.jit(jgen.apply), critic_update, gen_update, tx


def _assert_gp(got: float, want: float):
    """gp = mean((||g|| - 1)^2) cancels where ||g|| is near 1: a relative
    error of 1e-5 in the norm moves gp by about 2 * sqrt(gp) * 1e-5."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=2e-5 * np.sqrt(abs(want)))


def _assert_grads(got: dict, want: dict):
    """rtol 1e-4 and atol 1e-5 * max|g| over the net: some gradients are
    zero analytically (the head bias: the hour softmax cannot see a shift
    shared by all hours) and hold only rounding noise."""
    scale = max(np.abs(w.numpy()).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


def _assert_scores(got, want):
    """Losses that are sums of mean critic scores of either sign (d_loss,
    w_distance) cancel: hold them to 1e-5 of the terms' magnitude."""
    lv, lf = (float(a) for a in want[1:3])
    np.testing.assert_allclose(got, float(want[0]), rtol=1e-5,
                               atol=1e-5 * max(abs(lv), abs(lf)))


def test_losses_and_gradients_match_jax(train_setup):
    """f32, dropout 0: one critic loss with its GP and gradients, and one
    generator loss and gradients, against a JAX composition of the public
    Critic/Generator on the same parameters and inputs."""
    data, idx, ds, jds = train_setup
    jc, tc = _model_pair(compute_dtype="float32", dropout_rate=0.0)
    gp, cp = _nets(tc)
    jgen_apply, critic_update, gen_update, tx = _jax_step_fns(jc)
    state = _load_state(tc, tcfg.TrainConfig(), gp, cp)
    dr = _draws(jc, idx, 4, 1, seed=5)

    frac, cond = ds.real_from_rows(torch.tensor(dr["real_rows"]))
    lat = torch.tensor(dr["latent"])
    with torch.no_grad():
        fake = state.gen(lat, cond)
    loss, d_loss, gpen, w_dist = twgan.critic_loss(
        state.critic, frac, cond, fake, torch.tensor(dr["eps"][0]), None,
        None, 10.0)
    names = [n for n, _ in state.critic.named_parameters()]
    grads = torch.autograd.grad(loss, list(state.critic.parameters()))

    jfrac, jcond = jnp.asarray(frac.numpy()), jnp.asarray(cond.numpy())
    jfake = jgen_apply(gp, jnp.asarray(dr["latent"]), jcond)
    np.testing.assert_allclose(fake.numpy(), np.asarray(jfake), rtol=1e-5,
                               atol=1e-7)
    _, _, jloss, (lv, lf, jgp), jgrads = critic_update(
        cp, tx.init(cp), jfrac, jcond, jfake, jnp.asarray(dr["eps"][0]))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_scores(d_loss.item(), (0.5 * (lv + lf), lv, lf))
    _assert_scores(w_dist.item(), (-(lv + lf), lv, lf))
    _assert_gp(gpen.item(), float(jgp))
    _assert_grads(dict(zip(names, grads)),
                  critic_params_from_jax(_np(jgrads)))

    cond_g = ds.cond_from_rows(torch.tensor(dr["gen_rows"]))
    g_loss = (-state.critic(state.gen(torch.tensor(dr["gen_latent"]), cond_g),
                            cond_g)).mean()
    g_names = [n for n, _ in state.gen.named_parameters()]
    g_grads = torch.autograd.grad(g_loss, list(state.gen.parameters()))
    _, _, jg_loss, jg_grads = gen_update(
        gp, tx.init(gp), cp, jnp.asarray(dr["gen_latent"]),
        jnp.asarray(cond_g.numpy()))
    np.testing.assert_allclose(g_loss.item(), float(jg_loss), rtol=1e-5)
    _assert_grads(dict(zip(g_names, g_grads)), params_from_jax(_np(jg_grads)))


def _warm_adam(tx, params, seed):
    """An optax.adam state as after one step: count 1, no first moment,
    second moments 1e-2 * (1 + U(0, 1)).  From a cold start Adam's first
    update is lr * sign(g), which turns the rounding noise of gradients that
    are zero analytically (the head bias; last-stage critic biases whose
    activations keep one sign) into +-lr; a second moment keeps the update
    linear in the gradient, so both packages can be compared."""
    rng = np.random.RandomState(seed)
    adam, rest = tx.init(params)[0], tx.init(params)[1:]
    nu = jax.tree_util.tree_map(
        lambda p: jnp.asarray(1e-2 * (1 + rng.rand(*p.shape)), jnp.float32),
        params)
    return (adam._replace(count=jnp.ones((), jnp.int32), nu=nu), *rest)


def _load_adam(opt, module, sd_nu):
    """The same state in a torch Adam over `module`'s parameters."""
    for name, p in module.named_parameters():
        opt.state[p] = {"step": torch.tensor(1.0),
                        "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": sd_nu[name].clone()}


def _jax_full_step(jc, gp, cp, jds, dr, n_disc, batch, c_opt, g_opt,
                   grads=None):
    """The JAX package's step semantics composed from its public modules
    and optax.adam, on given draws (dropout 0).  With a list `grads`, the
    gradients that reach each update (n_disc critic trees, then the
    generator's) are appended to it."""
    jgen_apply, critic_update, gen_update, tx = _jax_step_fns(jc)
    patches = jds._gather_patches(jnp.asarray(dr["real_rows"]))
    frac, cond = jax_frac(patches, 127.4, 1e-12)
    fake = jgen_apply(gp, jnp.asarray(dr["latent"]), cond)
    frac, cond, fake = (a.reshape(n_disc, batch, *a.shape[1:])
                        for a in (frac, cond, fake))
    for i in range(n_disc):
        cp, c_opt, _, aux, c_grads = critic_update(
            cp, c_opt, frac[i], cond[i], fake[i], jnp.asarray(dr["eps"][i]))
        if grads is not None:
            grads.append(c_grads)
    dsum, nd = np.asarray(jds.dsum), jc.ndomain
    cond_g = np.stack([dsum[t, y:y + nd, x:x + nd]
                       for t, y, x in dr["gen_rows"]])[..., None] / 127.4
    gp, g_opt, g_loss, g_grads = gen_update(
        gp, g_opt, cp, jnp.asarray(dr["gen_latent"]),
        jnp.asarray(cond_g.astype("f4")))
    if grads is not None:
        grads.append(g_grads)
    return gp, cp, aux, g_loss


@pytest.mark.parametrize("smoke,n_disc,batch,ndomain",
                         [(True, 2, 4, 16), (False, 1, 2, 16),
                          (True, 2, 2, 64)],
                         ids=["smoke-ndisc2-b4", "flagship-ndisc1-b2",
                              "smoke64x64-ndisc2-b2"])
def test_full_step_matches_jax_and_optax(request, smoke, n_disc, batch,
                                         ndomain):
    """One full port step (n_disc critic updates, one generator update, Adam)
    on pre-drawn inputs, from the same mid-training optimizer state, equals
    the JAX composition plus optax.adam; at 16x16 and at the large domain's
    64x64."""
    data, idx, ds, jds = request.getfixturevalue(
        "train_setup" if ndomain == 16 else "train_setup64")
    jc, tc = _model_pair(smoke=smoke, ndomain=ndomain,
                         compute_dtype="float32", dropout_rate=0.0)
    train_cfg = tcfg.TrainConfig(n_disc=n_disc)
    gp, cp = _nets(tc, seed=1)
    state = _load_state(tc, train_cfg, gp, cp)
    tx = _jax_step_fns(jc)[3]
    c_opt, g_opt = _warm_adam(tx, cp, 1), _warm_adam(tx, gp, 2)
    _load_adam(state.critic_opt, state.critic,
               critic_params_from_jax(_np(c_opt[0].nu)))
    _load_adam(state.gen_opt, state.gen, params_from_jax(_np(g_opt[0].nu)))
    dr = _draws(jc, idx, batch, n_disc, seed=7)
    draws = twgan.StepDraws(
        real_rows=torch.tensor(dr["real_rows"]),
        latent=torch.tensor(dr["latent"]), eps=torch.tensor(dr["eps"]),
        masks=[None] * n_disc, gp_masks=[None] * n_disc,
        gen_latent=torch.tensor(dr["gen_latent"]),
        gen_rows=torch.tensor(dr["gen_rows"]), gen_masks=None)
    m = twgan.unpack_metrics(twgan.train_step_on(state, ds, draws, train_cfg)
                             ["packed"])
    assert state.step == 1 and not m["nonfinite"]

    jgp, jcp, (lv, lf, jgpen), jg_loss = _jax_full_step(
        jc, gp, cp, jds, dr, n_disc, batch, c_opt, g_opt)
    _assert_scores(m["d_loss"], (0.5 * (lv + lf), lv, lf))
    _assert_gp(m["gp"], float(jgpen))
    _assert_scores(m["g_loss"], (jg_loss, lv, lf))
    for got, want in ((state.gen.state_dict(), params_from_jax(_np(jgp))),
                      (state.critic.state_dict(),
                       critic_params_from_jax(_np(jcp)))):
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=k)


def test_adam_matches_optax_and_ema_is_exact():
    rng = np.random.RandomState(0)
    p0 = rng.randn(50).astype("f4")
    grads = [rng.randn(50).astype("f4") * s for s in (1.0, 1e-3, 30.0)]
    cfg = tcfg.TrainConfig()
    p = torch.nn.Parameter(torch.tensor(p0))
    opt = make_optimizer([p], cfg)
    tx = optax.adam(cfg.learning_rate, b1=cfg.beta1, b2=cfg.beta2)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6)

    data, idx, dcfg = make_synthetic_dataset(n_days=2, ny=32, nx=32, seed=2)
    ds = DeviceDataset.from_numpy(data, idx, dcfg, device="cpu")
    _, tc = _model_pair(compute_dtype="float32")
    train_cfg = tcfg.TrainConfig(n_disc=1, ema_decay=0.9)
    state = create_train_state(tc, train_cfg, device="cpu")
    ema0 = {k: v.numpy().copy() for k, v in state.ema_gen.state_dict().items()}
    twgan.make_train_step(tc, train_cfg, 2)(state, ds)
    d = np.float32(0.9)
    for k, p in state.gen.state_dict().items():
        want = d * ema0[k] + np.float32(1.0 - 0.9) * p.numpy()
        np.testing.assert_array_equal(state.ema_gen.state_dict()[k].numpy(),
                                      want, err_msg=k)


def test_clone_train_state_is_independent(train_setup):
    """A clone (here with dropout off) starts from the same parameters and
    optimizer moments, and stepping it leaves the original untouched."""
    _, _, ds, _ = train_setup
    _, tc = _model_pair(compute_dtype="float32")
    cfg = tcfg.TrainConfig(n_disc=1)
    state = create_train_state(tc, cfg, device="cpu")
    twgan.make_train_step(tc, cfg, 2)(state, ds)
    moments = {k: {n: v.clone() for n, v in st.items()}
               for k, st in state.critic_opt.state_dict()["state"].items()}
    params = {k: v.clone() for k, v in state.gen.state_dict().items()}
    tc0 = dataclasses.replace(tc, dropout_rate=0.0)
    clone = clone_train_state(state, tc0, cfg, "cpu")
    for k, v in clone.gen.state_dict().items():
        assert torch.equal(v, params[k]), k
    twgan.make_train_step(tc0, cfg, 2)(clone, ds)
    assert clone.step == 2 and state.step == 1
    for k, st in state.critic_opt.state_dict()["state"].items():
        for n, v in st.items():
            assert torch.equal(v, moments[k][n]), (k, n)
    for k, v in state.gen.state_dict().items():
        assert torch.equal(v, params[k]), k


def test_hoisted_chunks_count_and_equivalence(train_setup):
    cfg = tcfg.TrainConfig(n_disc=5, hoisted_chunk_samples=64)
    assert twgan.hoisted_chunk_count(cfg, 32) == 4  # 160 = 4 x 40
    assert twgan.hoisted_chunk_count(tcfg.TrainConfig(), 32) == 1
    assert twgan.hoisted_chunk_count(tcfg.TrainConfig(hoisted_chunks=5), 32) == 5
    with pytest.raises(ValueError, match="divide"):
        twgan.hoisted_chunk_count(tcfg.TrainConfig(hoisted_chunks=3), 32)

    _, idx, ds, _ = train_setup
    _, tc = _model_pair(compute_dtype="float32")
    outs = []
    for chunks in (1, 2):
        train_cfg = tcfg.TrainConfig(n_disc=2)
        state = create_train_state(tc, train_cfg, device="cpu")
        draws = twgan.draw_step_inputs(state, ds, 4, 2)
        outs.append(twgan.train_step_on(state, ds, draws, train_cfg,
                                        chunks)["packed"].numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5)


# --------------------------------------------------------------------------
# Trainer
# --------------------------------------------------------------------------

def test_trainer_fit_exports_and_nan_guard(tmp_path):
    import csv

    from prdisagg_tpu.api.pretrained import (
        PretrainedGenerator as JaxPretrained,
    )
    from prdisagg_tpu.models.io import load_params_npz as jax_load_npz

    data, idx, dcfg = make_synthetic_dataset(n_days=4, ny=32, nx=32, seed=3)
    ds = DeviceDataset.from_numpy(data, idx, dcfg, device="cpu")
    _, tc = _model_pair(compute_dtype="float32")
    exp = tcfg.ExperimentConfig(
        train=tcfg.TrainConfig(n_disc=2, schedule=((2, 4),),
                               log_every_steps=3),
        model_override=tc)
    tr = Trainer(exp, ds, str(tmp_path), steps_per_epoch=3,
                 plot_every_epochs=0, export_format="npz")
    before = [p.detach().clone() for p in tr.state.gen.parameters()]
    hist = tr.fit(progress=False)
    assert tr.epoch == 2 and tr.state.step == 6
    assert all(np.isfinite(v) for k, v in hist.items() if k != "epoch"
               for v in v)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tr.state.gen.parameters()))
    with open(tmp_path / "hist.csv") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["", "d_loss", "g_loss", "gp", "w_distance",
                       "d_grad_norm", "g_grad_norm", "epoch"]
    assert [r[0] for r in rows[1:]] == ["0", "1"]
    assert [r[-1] for r in rows[1:]] == ["1", "2"]

    gen_npz = os.path.join(
        tr.outdir, f"gen_{dcfg.params_string()}_0002.npz")
    disc_npz = os.path.join(
        tr.outdir, f"disc_{dcfg.params_string()}_0002.npz")
    tree = jax_load_npz(disc_npz)
    assert set(tree["params"]) == {"conv0", "conv1", "conv2", "conv3",
                                   "score"}
    jgen = JaxPretrained.from_npz(gen_npz)
    rng = np.random.RandomState(0)
    lat = rng.randn(5, tc.latent_dim).astype("f4")
    cond = rng.rand(5, 16, 16, 1).astype("f4")
    want = np.asarray(jgen.predict_fractions(lat, cond))
    with torch.no_grad():
        got = tr.state.gen(torch.tensor(lat), torch.tensor(cond)).numpy()
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=1e-5,
                               atol=1e-7)

    tr2 = Trainer(exp, ds, str(tmp_path / "poisoned"), steps_per_epoch=2)
    with torch.no_grad():
        next(tr2.state.critic.parameters()).view(-1)[0] = float("nan")
    with pytest.raises(NaNLossError):
        tr2.fit(progress=False)
    assert tr2.epoch == 0
