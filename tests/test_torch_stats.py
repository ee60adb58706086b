"""prdisagg_torch.ops.stats against the JAX package's ops/stats.py, on the CPU.

The same seeded numpy inputs go through both: CRPS within 1e-6 relative,
plus 1e-6 of the largest value (term1 - spread cancels: a few ulps of the
mean absolute error, summed in another order, show up at 1e-6 of a smaller
result), radial spectra and the scalar LSD within 1e-5, the pairwise-LSD
matrix within 2e-5 (a GEMM summed in another order), the device summary's
count identical and its median within 2e-5 of the JAX median.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.ops import stats as tstats  # noqa: E402
from prdisagg_tpu.ops import stats as jstats  # noqa: E402

CRPS_RTOL = 1e-6
LSD_RTOL = 2e-5


def _assert_crps_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=CRPS_RTOL,
                               atol=CRPS_RTOL * np.abs(want).max())


def _t(a):
    return torch.tensor(np.asarray(a))


def test_ecdf_and_radial_bins_are_the_jax_copies():
    data = np.random.RandomState(3).rand(1000)
    for cap in (2000, 100):
        for got, want in zip(tstats.ecdf_plot(data, cap=cap),
                             jstats.ecdf_plot(data, cap=cap)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(tstats.ecdf(data), jstats.ecdf(data)):
        np.testing.assert_array_equal(got, want)
    for shape in ((16, 16), (8, 8), (64, 64), (12, 20)):
        for got, want in zip(tstats._radial_bins(*shape),
                             jstats._radial_bins(*shape)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,shape", [(50, (24, 8, 8)), (1000, (24, 2, 2)),
                                     (17, ())])
def test_crps_ensemble_matches_jax(m, shape):
    rng = np.random.RandomState(m)
    obs = rng.gamma(2.0, 1.5, size=shape).astype("f4")
    ens = rng.gamma(2.0, 1.5, size=(m, *shape)).astype("f4")
    got = tstats.crps_ensemble(_t(obs), _t(ens)).numpy()
    want = np.asarray(jstats.crps_ensemble(jnp.asarray(obs),
                                           jnp.asarray(ens)))
    assert got.shape == want.shape == shape
    _assert_crps_close(got, want)


def test_crps_ensemble_fixed_matches_jax_and_per_sample():
    rng = np.random.RandomState(19)
    obs = rng.gamma(2.0, 1.0, size=(5, 6, 4, 4)).astype("f4")
    ens = rng.gamma(2.0, 1.0, size=(32, 6, 4, 4)).astype("f4")
    got = tstats.crps_ensemble_fixed(_t(obs), _t(ens))
    want = np.asarray(jstats.crps_ensemble_fixed(jnp.asarray(obs),
                                                 jnp.asarray(ens)))
    _assert_crps_close(got.numpy(), want)
    spread = tstats.ensemble_spread(_t(ens))
    torch.testing.assert_close(
        tstats.crps_ensemble_fixed(_t(obs), _t(ens), spread), got,
        rtol=0, atol=0)
    per = torch.stack([tstats.crps_ensemble(_t(obs[i]), _t(ens))
                       for i in range(5)])
    np.testing.assert_allclose(got.numpy(), per.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("ens,y,want", [
    ([0.0, 1.0], 0.5, 0.25),
    ([0.0, 1.0], 2.0, 1.25),
    ([1.0], 3.0, 2.0),
    ([0.0, 0.0, 0.0], 0.0, 0.0),
    ([1.0, 2.0, 3.0, 4.0], 2.5, 0.375),
    ([0.1, 0.5, 0.9], 0.3, 7.0 / 45.0),
])
def test_crps_hand_derived_golden_values(ens, y, want):
    """The JAX package's hand-derived constants (each the integral
    (F_ens(x) - 1{x >= y})^2 dx, exact fractions), for both estimators."""
    ens_t = torch.tensor(ens, dtype=torch.float32)
    got = float(tstats.crps_ensemble(torch.tensor(y), ens_t))
    np.testing.assert_allclose(got, want, atol=1e-6)
    gotf = float(tstats.crps_ensemble_fixed(torch.tensor([y]), ens_t)[0])
    np.testing.assert_allclose(gotf, want, atol=1e-6)


def test_radial_spectra_and_lsd_match_jax():
    rng = np.random.RandomState(4)
    for shape in ((10, 16, 16), (3, 8, 8), (2, 64, 64), (4, 12, 20)):
        xs = rng.rand(*shape).astype("f4")
        got = tstats.radial_spectra(_t(xs)).numpy()
        want = np.asarray(jstats.radial_spectra(jnp.asarray(xs)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(
            tstats.radial_spectrum(_t(xs[0])).numpy(), want[0], rtol=1e-5)
    ps1 = (rng.rand(6, 11) + 0.1).astype("f4")
    ps2 = (rng.rand(6, 11) + 0.1).astype("f4")
    got = tstats.log_spectral_distance(_t(ps1), _t(ps2)).numpy()
    want = np.asarray(jstats.log_spectral_distance(jnp.asarray(ps1),
                                                   jnp.asarray(ps2)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(tstats.log_spectral_distance(_t(ps1[0]), _t(ps1[0]))) == 0.0


@pytest.mark.parametrize("na,nb", [(9, 6), (7, 7), (40, 33)])
def test_pairwise_lsd_and_offdiag_match_jax(na, nb):
    rng = np.random.RandomState(na * nb)
    a = (rng.rand(na, 11) + 0.05).astype("f4")
    b = (rng.rand(nb, 11) + 0.05).astype("f4")
    got = tstats.pairwise_lsd(_t(a), _t(b)).numpy()
    want = np.asarray(jstats.pairwise_lsd(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (na, nb)
    np.testing.assert_allclose(got, want, rtol=LSD_RTOL, atol=1e-6)
    flat = tstats.pairwise_lsd_offdiag(_t(a), _t(b), block=4)
    jflat = jstats.pairwise_lsd_offdiag(a, b, block=4)
    assert flat.shape == jflat.shape == (na * nb - min(na, nb),)
    np.testing.assert_allclose(flat, jflat, rtol=LSD_RTOL, atol=1e-6)


def test_pairwise_lsd_zero_bin_nonfinite():
    """A spectrum with a zero bin poisons its own pairs and no other: the
    shared centre stays finite."""
    a = np.full((3, 5), 2.0, dtype="f4")
    a[1, 2] = 0.0
    mat = tstats.pairwise_lsd(_t(a), _t(a)).numpy()
    assert not np.any(np.isfinite(mat[1, [0, 2]]))
    assert not np.any(np.isfinite(mat[[0, 2], 1]))
    assert np.isfinite(mat[0, 2]) and np.isfinite(mat[2, 0])
    jmat = np.asarray(jstats.pairwise_lsd(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_array_equal(np.isfinite(mat), np.isfinite(jmat))


@pytest.mark.parametrize("na,nb,block", [(7, 7, 3), (9, 6, 4), (6, 9, 3),
                                         (8, 8, 8)])
@pytest.mark.parametrize("exclude", [True, False])
def test_pairwise_lsd_summary_matches_jax(na, nb, block, exclude):
    """The JAX test's shapes: the same n_valid, the median within 2e-5 of
    JAX's and of the full path's np.median, the whole population as the
    subsample (uncapped) in the same order."""
    rng = np.random.RandomState(7 + na + nb)
    a = (rng.rand(na, 11) + 0.1).astype("f4")
    b = a if na == nb else (rng.rand(nb, 11) + 0.1).astype("f4")
    got = tstats.pairwise_lsd_summary(_t(a), _t(b), subsample=10**9,
                                      block=block,
                                      exclude_same_index=exclude)
    want = jstats.pairwise_lsd_summary(a, b, subsample=10**9, block=block,
                                       exclude_same_index=exclude)
    assert got["n_valid"] == want["n_valid"]
    np.testing.assert_allclose(got["median"], want["median"], rtol=LSD_RTOL)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-5)
    np.testing.assert_allclose(got["subsample"], want["subsample"],
                               rtol=LSD_RTOL, atol=1e-6)
    if exclude:
        full = tstats.pairwise_lsd_offdiag(_t(a), _t(b), block=block)
        assert got["n_valid"] == len(full)
        np.testing.assert_allclose(got["median"], np.median(full),
                                   rtol=LSD_RTOL)


def test_pairwise_lsd_summary_nonfinite_and_cap():
    rng = np.random.RandomState(8)
    a = (np.full((5, 6), 2.0) + rng.rand(5, 6) * 0.5).astype("f4")
    a[1, 2] = 0.0  # log10 -> -inf poisons every pair of spectrum 1
    full = tstats.pairwise_lsd_offdiag(_t(a), _t(a), block=2)
    finite = full[np.isfinite(full)]
    s = tstats.pairwise_lsd_summary(_t(a), _t(a), subsample=10**9, block=2)
    js = jstats.pairwise_lsd_summary(a, a, subsample=10**9, block=2)
    assert s["n_valid"] == js["n_valid"] == len(finite) < len(full)
    np.testing.assert_allclose(s["median"], np.median(finite), rtol=LSD_RTOL)
    np.testing.assert_allclose(s["median"], js["median"], rtol=LSD_RTOL)
    capped = tstats.pairwise_lsd_summary(_t(a), _t(a), subsample=7, block=2)
    assert capped["subsample"].shape == (7,)
    assert capped["n_valid"] == s["n_valid"]
    # nothing valid at all: NaN median, as in the JAX package
    z = np.zeros((3, 4), "f4")
    assert np.isnan(tstats.pairwise_lsd_summary(_t(z), _t(z))["median"])


def test_pairwise_lsd_summary_capacity_guard():
    """The same populations are refused as in the JAX package, before any
    work, with the same message."""
    n = 65_536  # n*n == 2^32 exactly
    a = torch.ones((n, 2))
    with pytest.raises(ValueError, match="uint32 count capacity") as got:
        tstats.pairwise_lsd_summary(a, a, subsample=8)
    with pytest.raises(ValueError) as want:
        jstats._check_pair_count_capacity(n, n)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="uint32 count capacity"):
        tstats._check_pair_count_capacity(2**16, 2**16)
    tstats._check_pair_count_capacity(2**16 - 1, 2**16 + 1)
    tstats._check_pair_count_capacity(2**16, 2**16 - 1)
    s = tstats.pairwise_lsd_summary(a[:64], a[:64], subsample=8)
    assert s["n_valid"] == 64 * 63 and s["median"] == 0.0


def test_bisection_finds_exact_order_statistics():
    """The bit-pattern bisection returns data values themselves: on
    distances whose order statistics are known, the median pair is exact,
    including across the float32 exponent range."""
    rng = np.random.RandomState(11)
    a = _t((10.0 ** rng.uniform(-3, 3, size=(33, 7))).astype("f4"))
    a_pad = torch.cat([a, torch.ones(2, 7)])  # one block of 35 rows
    # the population as the reducer computes it: the same block GEMM
    la, lb, sq_a, sq_b = tstats._centered_logs(
        10.0 * torch.log10(a_pad), 10.0 * torch.log10(a),
        tstats._finite_center(10.0 * torch.log10(a)))
    d = tstats._gemm_dists(la, lb, sq_a, sq_b, 7)[:33]
    v = np.sort(d[~torch.eye(33, dtype=torch.bool)].numpy())
    n = len(v)
    med_pair, _, n_valid, _ = tstats._lsd_summary_device(
        a_pad, a, torch.zeros(1, dtype=torch.long),
        torch.zeros(1, dtype=torch.long), n_real=33, block=35,
        exclude_same=True)
    assert int(n_valid) == n == 33 * 32
    np.testing.assert_array_equal(med_pair.numpy(),
                                  [v[(n - 1) // 2], v[n // 2]])
    # and at another block size, within the GEMM's rounding
    s = tstats.pairwise_lsd_summary(a, a, block=5)
    np.testing.assert_allclose(s["median"], np.median(v), rtol=LSD_RTOL)
