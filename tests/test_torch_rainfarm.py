"""prdisagg_torch.baselines.rainfarm against the JAX package's RainFARM, on
the CPU.

Random streams differ by design (a torch.Generator against JAX keys), so
parity goes through explicit phases: each test rebuilds the phases JAX draws
(``jax.random.uniform`` on the same split keys as the JAX functions) and
hands them to the port's ``*_from_phase`` functions.  Tolerances: fields
within 1e-5 of their maximum (the normalising std is the population std of
each realization; torch's default sample std alone is 1e-4 off), the
balanced average within 1e-6, the slopes within 1e-8 absolute, CRPS rows
within rtol 1e-5 / atol 1e-7, conservation within 1e-5 of the daily maximum.

The estimators run in float64 in the port, as numpy < 2 ran the reference's
(numpy 2 computes a float32 FFT in complex64), so the JAX estimators are
given the same batch as float64.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.baselines import rainfarm as trf  # noqa: E402
from prdisagg_torch.baselines.rainfarm import core as tcore  # noqa: E402
from prdisagg_torch.baselines.rainfarm import pipeline as tpipe  # noqa: E402
from prdisagg_torch.core import config as tcfg  # noqa: E402
from prdisagg_torch.data.sampler import DeviceDataset  # noqa: E402
from prdisagg_tpu.baselines.rainfarm import core as jcore  # noqa: E402
from prdisagg_tpu.baselines.rainfarm import pipeline as jpipe  # noqa: E402
from prdisagg_tpu.core import config as jcfg  # noqa: E402

ALPHA, BETA = 1.7, 1.1
FIELD_RTOL = 1e-5  # of the field's maximum
SLOPE_ATOL = 1e-8


def _precip(seed, shape=(16, 16)):
    return np.random.RandomState(seed).gamma(2.0, 5.0, shape).astype("f4")


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def _ensemble_phases(key, n_members, shape):
    """The phases JAX's downscale_ensemble draws from `key`, drawn as it
    draws them: uniform vmapped over the split keys.  Under the "rbg" PRNG
    (which a JAX training state sets process-wide) a vmapped draw is not
    the per-key loop's."""
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(
        jax.random.split(key, n_members)))


def _close(got, want, rtol=FIELD_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _conservation(fields, daily):
    return np.abs(fields.sum(axis=-3) - daily).max() / np.abs(daily).max()


# --------------------------------------------------------------------------
# the generation core
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_t", [24, 5])
def test_downscale_from_phase_matches_jax(n_t):
    """Four members in one batched call against JAX's per-realization core,
    vmapped; each member conserves its daily sum."""
    precip = _precip(0)
    phase = np.random.RandomState(1).rand(4, n_t, 16, 16).astype("f4")
    want = np.asarray(jax.vmap(lambda ph: jcore._downscale_from_phase(
        jnp.asarray(precip), ALPHA, BETA, ph))(jnp.asarray(phase)))
    got = tcore.downscale_from_phase(torch.tensor(precip), ALPHA, BETA,
                                     torch.tensor(phase)).numpy()
    _close(got, want)
    assert _conservation(got, precip) <= 1e-5
    # a per-member daily sum broadcasts against the batch
    daily = np.stack([precip * (1 + i) for i in range(4)])
    got = tcore.downscale_from_phase(torch.tensor(daily), ALPHA, BETA,
                                     torch.tensor(phase)).numpy()
    assert _conservation(got, daily) <= 1e-5


@pytest.mark.parametrize("entry", ["spatiotemporal", "ensemble", "spatial"])
def test_entry_points_match_jax_on_its_phases(entry):
    key = jax.random.PRNGKey(11)
    precip = _precip(2)
    if entry == "spatiotemporal":
        want = jcore.downscale_spatiotemporal(jnp.asarray(precip), ALPHA,
                                              BETA, 24, key)
        got = tcore.downscale_from_phase(
            torch.tensor(precip), ALPHA, BETA,
            torch.tensor(_uniform(key, (24, 16, 16))))
    elif entry == "ensemble":
        want = jcore.downscale_ensemble(jnp.asarray(precip), ALPHA, BETA,
                                        24, key, 6)
        got = tcore.downscale_from_phase(
            torch.tensor(precip), ALPHA, BETA,
            torch.tensor(_ensemble_phases(key, 6, (24, 16, 16))))
    else:
        precip = _precip(3, (10, 12))
        want = jcore.downscale_spatial(jnp.asarray(precip), ALPHA, 4, key)
        got = tcore.downscale_spatial_from_phase(
            torch.tensor(precip), ALPHA, 4,
            torch.tensor(_uniform(key, (40, 48))))
    _close(got.numpy(), want)


def test_drawing_wrappers_replay_from_their_generator():
    """The random entry points are their from-phase functions on phases
    drawn from the generator: the same seed gives the same fields; members
    differ; time sums conserve the daily sum."""
    precip = torch.tensor(_precip(4))
    one = trf.downscale_spatiotemporal(precip, ALPHA, BETA, 24,
                                       torch.Generator().manual_seed(5))
    phase = torch.rand((24, 16, 16), generator=torch.Generator()
                       .manual_seed(5))
    np.testing.assert_array_equal(
        one.numpy(), tcore.downscale_from_phase(precip, ALPHA, BETA,
                                                phase).numpy())
    ens = trf.downscale_ensemble(precip, ALPHA, BETA, 24,
                                 torch.Generator().manual_seed(5), 3)
    assert ens.shape == (3, 24, 16, 16)
    np.testing.assert_array_equal(ens[0].numpy(), one.numpy())
    assert not np.allclose(ens[0].numpy(), ens[1].numpy())
    assert _conservation(ens.numpy(), precip.numpy()) <= 1e-5
    sp = tcore.downscale_spatial(precip[:5, :6], ALPHA, 4,
                                 torch.Generator().manual_seed(5))
    assert sp.shape == (20, 24) and torch.isfinite(sp).all()
    assert float(sp.min()) >= 0


def test_balanced_spatial_average_matches_jax_and_scipy():
    from scipy.ndimage import convolve

    rng = np.random.RandomState(3)
    x = rng.rand(20, 24).astype("f4")
    for ds_factor in (4, 8):
        k = tcore._tophat(ds_factor)
        want = convolve(x.astype(float), k.astype(float)) / convolve(
            np.ones_like(x, dtype=float), k.astype(float))
        got = tcore._balanced_spatial_average(torch.tensor(x),
                                              torch.tensor(k)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        jx = np.asarray(jcore._balanced_spatial_average(jnp.asarray(x),
                                                        jnp.asarray(k)))
        np.testing.assert_allclose(got, jx, rtol=0, atol=1e-6)
    # batched over leading axes, and numpy's "symmetric" pad
    xs = torch.tensor(rng.rand(2, 3, 9, 7).astype("f4"))
    np.testing.assert_array_equal(
        tcore._pad_symmetric(xs, 3).numpy(),
        np.pad(xs.numpy(), ((0, 0), (0, 0), (3, 3), (3, 3)),
               mode="symmetric"))
    k = torch.tensor(tcore._tophat(4))
    np.testing.assert_allclose(
        tcore._balanced_spatial_average(xs, k)[1, 2].numpy(),
        tcore._balanced_spatial_average(xs[1, 2], k).numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="exceeds"):
        tcore._pad_symmetric(xs, 8)


# --------------------------------------------------------------------------
# the slope estimators
# --------------------------------------------------------------------------

def _slope_batch():
    """Gamma fields with zeroed points and one all-zero hour."""
    p = np.random.RandomState(7).gamma(0.6, 2.0, (12, 24, 16, 16))
    p[p < 0.4] = 0.0
    p[3, 5] = 0.0
    return p.astype("f4")


@pytest.mark.parametrize("name", ["estimate_alpha", "estimate_beta",
                                  "estimate_alpha_single"])
def test_estimators_match_jax(name):
    p = _slope_batch()
    if name == "estimate_alpha_single":
        p = p[3, 5] + p[0, 0]  # one 2-D field (with zeros)
    want = getattr(jcore, name)(p.astype(np.float64))
    for given in (p, torch.tensor(p)):
        got = getattr(tcore, name)(given)
        assert isinstance(got, float)
        assert abs(got - want) <= SLOPE_ATOL, (got, want)


def test_estimators_recover_a_known_power_law():
    rng = np.random.RandomState(2)
    n, n_t, ny, nx = 100, 24, 16, 16
    alpha_true, beta_true = 2.0, 1.4
    k = np.sqrt(np.fft.fftfreq(ny)[:, None] ** 2
                + np.fft.fftfreq(nx)[None, :] ** 2)
    om = np.abs(2 * np.pi * np.fft.fftfreq(n_t))
    with np.errstate(divide="ignore"):
        amp_k = np.where(k > 0, k ** (-alpha_true / 2), 0.0)
        amp_om = np.where(om > 0, om ** (-beta_true / 2), 0.0)
    fg = (np.exp(1j * 2 * np.pi * rng.rand(n, n_t, ny, nx))
          * amp_om[None, :, None, None] * amp_k[None, None])
    fields = np.fft.ifftn(fg, axes=(1, 2, 3)).real
    fields -= fields.min() - 1e-3
    assert abs(tcore.estimate_alpha(fields) - alpha_true) < 0.5
    assert abs(tcore.estimate_beta(fields) - beta_true) < 0.5


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------

def _reals(seed, n):
    return np.random.RandomState(seed).gamma(2.0, 1.0,
                                             (n, 24, 16, 16)).astype("f4")


def test_score_one_sample_matches_jax_crps_rainfarm_rows():
    """Each row of JAX's crps_rainfarm, scored by the port from the phases
    JAX drew for that sample."""
    reals = _reals(17, 3)
    want = jpipe.crps_rainfarm(reals, 1.5, 0.9, jcfg.RainFarmConfig(),
                               n_members=6, seed=4)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    for i, key in enumerate(keys):
        with torch.inference_mode():
            got = tpipe._score_one_sample(
                torch.tensor(reals[i]), torch.tensor(reals[i].sum(0)), 1.5,
                0.9, torch.tensor(_ensemble_phases(key, 6, (24, 16, 16))))
        np.testing.assert_allclose(got.numpy(), want[i], rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("check", ["ensemble_entry", "crps_rows"])
def test_phase_rebuilds_hold_under_the_rbg_prng(check):
    """The two rebuilds of a vmapped JAX draw hold under the "rbg" PRNG too,
    which any JAX test that makes a training state leaves set in its
    worker; the previous implementation is restored afterwards."""
    before = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "rbg")
    try:
        if check == "ensemble_entry":
            test_entry_points_match_jax_on_its_phases("ensemble")
        else:
            test_score_one_sample_matches_jax_crps_rainfarm_rows()
    finally:
        jax.config.update("jax_default_prng_impl", before)


def test_crps_rainfarm_does_not_depend_on_the_chunk(tmp_path):
    """Two chunk sizes (5 = 2 + 2 + 1 and one chunk) give identical rows,
    equal to the per-sample replay from one generator seeded with `seed`;
    the outfile holds them."""
    reals = _reals(18, 5)
    cfg = tcfg.RainFarmConfig()
    out = str(tmp_path / "sub" / "crps_results_rainfarm.pkl")
    a = tpipe.crps_rainfarm(reals, 1.5, 0.9, cfg, n_members=7, seed=3,
                            sample_chunk=2, device="cpu", outfile=out)
    b = tpipe.crps_rainfarm(reals, 1.5, 0.9, cfg, n_members=7, seed=3,
                            sample_chunk=50, device="cpu")
    assert a.shape == (5, 24) and np.isfinite(a).all() and (a >= 0).all()
    np.testing.assert_array_equal(a, b)
    with open(out, "rb") as f:
        np.testing.assert_array_equal(pickle.load(f), a)
    rng = torch.Generator().manual_seed(3)
    with torch.inference_mode():
        manual = [tpipe._score_one_sample(
            torch.tensor(r), torch.tensor(r).sum(0), 1.5, 0.9,
            torch.rand((7, 24, 16, 16), generator=rng)).numpy()
            for r in reals]
    np.testing.assert_array_equal(a, np.stack(manual))


def test_calibrate_files_and_slopes_match_jax(synthetic_dataset, tmp_path):
    """calibrate on a CPU dataset writes the JAX file names; the pickles
    load the way JAX's cmd_rainfarm_crps reads them; every repeat's slopes
    equal the JAX estimators on the batch the port drew."""
    data, indices, jdcfg = synthetic_dataset
    ds = DeviceDataset.from_numpy(
        data, indices, tcfg.DataConfig(**dataclasses.asdict(jdcfg)),
        device="cpu")
    cfg = tcfg.RainFarmConfig(n_calib=24, n_repeat=2, seed=8)
    slopes = tpipe.calibrate(ds, cfg, outdir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        "rainfarm_calibration_data.npy", "spectral_slopes_0.pkl",
        "spectral_slopes_1.pkl"]
    gen = torch.Generator().manual_seed(cfg.seed)
    for i, (alpha, beta) in enumerate(slopes):
        with open(tmp_path / f"spectral_slopes_{i}.pkl", "rb") as f:
            a, b = pickle.load(f)
        assert (a, b) == (alpha, beta)
        assert type(a) is float and type(b) is float
        batch = ds.sample_patches_raw(cfg.n_calib, gen).numpy()
        if i == 0:
            np.testing.assert_array_equal(
                np.load(tmp_path / "rainfarm_calibration_data.npy"), batch)
        assert abs(alpha - jcore.estimate_alpha(batch.astype(np.float64))
                   ) <= SLOPE_ATOL
        assert abs(beta - jcore.estimate_beta(batch.astype(np.float64))
                   ) <= SLOPE_ATOL


def test_generate_for_daily_sums_conserves():
    daily = _reals(19, 6).sum(axis=1)
    cfg = tcfg.RainFarmConfig()
    a = tpipe.generate_for_daily_sums(daily, 1.5, 0.9, cfg, seed=2,
                                      device="cpu")
    assert a.shape == (6, 24, 16, 16) and np.isfinite(a).all()
    assert _conservation(a, daily) <= 1e-5
    np.testing.assert_array_equal(
        a, tpipe.generate_for_daily_sums(daily, 1.5, 0.9, cfg, seed=2,
                                         device="cpu"))


def test_generate_and_plot_writes_the_jax_artifacts(tmp_path):
    reals = _reals(3, 3)
    kw = dict(n_map_conditions=1, n_fake_per_real=2, seed=0)
    got = tpipe.generate_and_plot(
        reals, 1.5, 0.9, tcfg.RainFarmConfig(),
        plotdir=str(tmp_path / "t" / "plots"),
        datadir=str(tmp_path / "t" / "data"), device="cpu", **kw)
    jpipe.generate_and_plot(
        reals, 1.5, 0.9, jcfg.RainFarmConfig(),
        plotdir=str(tmp_path / "j" / "plots"),
        datadir=str(tmp_path / "j" / "data"), **kw)
    for d in ("plots", "data"):
        assert sorted(os.listdir(tmp_path / "t" / d)) == sorted(
            os.listdir(tmp_path / "j" / d))
    assert "generated_precip_rainfarm_0001_allhours.png" in os.listdir(
        tmp_path / "t" / "plots")
    assert got.shape == reals.shape
    assert _conservation(got, reals.sum(axis=1)) <= 1e-5
    np.testing.assert_array_equal(
        np.load(tmp_path / "t" / "data" / "generated_samples_rainfarm.npy"),
        got)
