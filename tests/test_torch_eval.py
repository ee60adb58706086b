"""prdisagg_torch.eval against the JAX package's eval/, on the CPU.

The same weights (carried over by ``params_from_jax``), latents and fields go
through both: the per-sample CRPS within 1e-5 relative, the random baseline
within the CRPS tolerance of tests/test_torch_stats.py, the analysis dict
exactly, the LSD medians within 2e-5 in both reductions.  Draws differ by
design (a torch.Generator against JAX keys), so the Evaluator's statistics
are compared in distribution: a two-sample KS test at p > 0.01.
"""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch import cli as tcli  # noqa: E402
from prdisagg_torch.api import pretrained as tpre  # noqa: E402
from prdisagg_torch.core import config as tcfg  # noqa: E402
from prdisagg_torch.data.sampler import DeviceDataset  # noqa: E402
from prdisagg_torch.eval import Evaluator  # noqa: E402
from prdisagg_torch.eval import crps as tcrps  # noqa: E402
from prdisagg_torch.eval import evaluate as tevaluate  # noqa: E402
from prdisagg_torch.eval import lsd as tlsd  # noqa: E402
from prdisagg_torch.eval import parity as tparity  # noqa: E402
from prdisagg_torch.models.io import params_from_jax  # noqa: E402
from prdisagg_torch.utils import plotting as tplotting  # noqa: E402
from prdisagg_tpu.api import pretrained as jpre  # noqa: E402
from prdisagg_tpu.core import config as jcfg  # noqa: E402
from prdisagg_tpu.data.sampler import DeviceDataset as JaxDataset  # noqa: E402
from prdisagg_tpu.eval import Evaluator as JaxEvaluator  # noqa: E402
from prdisagg_tpu.eval import crps as jcrps  # noqa: E402
from prdisagg_tpu.eval import evaluate as jevaluate  # noqa: E402
from prdisagg_tpu.eval import lsd as jlsd  # noqa: E402
from prdisagg_tpu.eval import parity as jparity  # noqa: E402
from prdisagg_tpu.models import Generator as JaxGenerator  # noqa: E402
from prdisagg_tpu.models.io import save_params_npz  # noqa: E402
from prdisagg_tpu.utils import plotting as jplotting  # noqa: E402

SMALL = dict(ndomain=16, latent_dim=8, gen_channels=(8, 8, 8),
             base_channels=8, critic_channels=(8, 8, 8, 8))
KS_P = 0.01


def _model_pair(smoke=True, **kw):
    base = dict(SMALL) if smoke else {}
    base.update(compute_dtype="float32", **kw)
    return jcfg.ModelConfig(**base), tcfg.ModelConfig(**base)


def _jax_params(jc, seed):
    lat = np.zeros((1, jc.latent_dim), "f4")
    cond = np.zeros((1, jc.ndomain, jc.ndomain, 1), "f4")
    return jax.tree_util.tree_map(
        np.asarray, JaxGenerator(jc).init(jax.random.PRNGKey(seed), lat, cond))


@pytest.fixture(scope="module")
def setup(synthetic_dataset, tmp_path_factory):
    """Both packages' datasets on the same synthetic tensor and both
    generators on the same smoke-width weights (std 0.3, far from uniform
    fractions), plus test fields in mm."""
    data, indices, jdcfg = synthetic_dataset
    dcfg = tcfg.DataConfig(**dataclasses.asdict(jdcfg))
    jc, tc = _model_pair(init_stddev=0.3)
    params = _jax_params(jc, 5)
    npz = str(tmp_path_factory.mktemp("eval_weights") / "gen.npz")
    save_params_npz(npz, params)
    rng = np.random.RandomState(9)
    fields = np.stack([data[t, :, y:y + 16, x:x + 16] for t, y, x in
                       indices[rng.choice(len(indices), 24, replace=False)]])
    return dict(
        data=data, indices=indices, dcfg=dcfg, jdcfg=jdcfg, jc=jc, tc=tc,
        params=params, npz=npz, fields=fields,
        tds=DeviceDataset.from_numpy(data, indices, dcfg, device="cpu"),
        jds=JaxDataset.from_numpy(data, indices, jdcfg),
        tgen=tpre.PretrainedGenerator(params_from_jax(params), tc, seed=354,
                                      device="cpu"),
        jgen=jpre.PretrainedGenerator(params, jc, seed=354))


# --------------------------------------------------------------------------
# configuration presets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["large_domain_experiment",
                                    "doy_experiment", "lon_experiment"])
def test_experiment_presets_match_jax(preset):
    got, want = getattr(tcfg, preset)(), getattr(jcfg, preset)()
    assert dataclasses.asdict(got.data) == dataclasses.asdict(want.data)
    assert dataclasses.asdict(got.eval) == dataclasses.asdict(want.eval)
    assert got.name == want.name
    assert dataclasses.asdict(got.model()) == dataclasses.asdict(
        want.model())


# --------------------------------------------------------------------------
# CRPS
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "flagship"])
def test_score_one_sample_matches_jax(setup, smoke):
    """One sample's area-mean CRPS row from the same weights, latents and
    field: 8 members in batches of 4."""
    jc, tc = (setup["jc"], setup["tc"]) if smoke else _model_pair(False)
    params = setup["params"] if smoke else _jax_params(jc, 2)
    gen = tpre.PretrainedGenerator(params_from_jax(params), tc,
                                   device="cpu")._gen
    real = setup["fields"][3]
    dsum = real.sum(axis=0)
    lat = np.random.RandomState(4).randn(8, jc.latent_dim).astype("f4")
    want = np.asarray(jcrps._score_one_sample(
        JaxGenerator(jc), params, jnp.asarray(real), jnp.asarray(dsum),
        jnp.asarray(lat), 8, 4, jc.latent_dim, 127.4))
    with torch.inference_mode():
        got = tcrps._score_one_sample(gen, torch.tensor(real),
                                      torch.tensor(dsum), torch.tensor(lat),
                                      8, 4, 127.4).numpy()
    assert got.shape == want.shape == (24,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_crps_gan_draws_in_sample_order(setup):
    """The result does not depend on sample_chunk (5 = 2 + 2 + 1), and
    equals the per-sample replay from one generator seeded with `seed`."""
    pg, reals = setup["tgen"], setup["fields"][:5]
    out_a = tcrps.crps_gan(pg, reals, n_members=8, member_batch=4,
                           sample_chunk=2, seed=7)
    out_b = tcrps.crps_gan(pg, reals, n_members=8, member_batch=4,
                           sample_chunk=5, seed=7)
    assert out_a.shape == (5, 24) and np.isfinite(out_a).all()
    np.testing.assert_array_equal(out_a, out_b)
    rng = torch.Generator().manual_seed(7)
    with torch.inference_mode():
        manual = [tcrps._score_one_sample(
            pg._gen, torch.tensor(r), torch.tensor(r).sum(0),
            torch.randn((8, pg.cfg.latent_dim), generator=rng), 8, 4,
            127.4).numpy() for r in reals]
    np.testing.assert_array_equal(out_a, np.stack(manual))
    with pytest.raises(ValueError, match="divisible"):
        tcrps.crps_gan(pg, reals, n_members=10, member_batch=4)


def test_crps_random_baseline_matches_jax(setup):
    reals, ens = setup["fields"][:5], setup["fields"][5:21]
    got = tcrps.crps_random_baseline(reals, ens, chunk=2, device="cpu")
    want = jcrps.crps_random_baseline(reals, ens, chunk=2)
    assert got.shape == want.shape == (5, 24)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    ones = np.ones((2, 24, 4, 4), "f4")
    np.testing.assert_allclose(
        tcrps.crps_random_baseline(ones, np.ones((8, 24, 4, 4), "f4"),
                                   device="cpu"), 0.0, atol=1e-6)


def test_analyze_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    gan = rng.rand(50, 24) * 0.5
    rnd = rng.rand(50, 24) * 0.5 + 0.3
    rf = rng.rand(50, 24)
    for rainfarm in (None, rf):
        got = tcrps.analyze(gan, rnd, rainfarm, outdir=str(tmp_path / "t"),
                            n_bootstrap=200)
        want = jcrps.analyze(gan, rnd, rainfarm, outdir=str(tmp_path / "j"),
                             n_bootstrap=200)
        assert got == want
        for d in ("t", "j"):
            with open(tmp_path / d / "crps_results.json") as f:
                assert json.load(f) == want


def test_run_crps_evaluation_artifacts(setup, tmp_path):
    reals, ens = setup["fields"][:4], setup["fields"][4:20]
    res = tcrps.run_crps_evaluation(setup["tgen"], reals, ens, n_members=8,
                                    outdir=str(tmp_path), n_bootstrap=50)
    assert res["gan"].shape == res["random"].shape == (4, 24)
    assert res["rainfarm"] is None
    assert res["gan_seconds"] > 0 and res["random_seconds"] > 0
    with open(tmp_path / "crps_results_n_sample4.pkl", "rb") as f:
        gan, rnd = pickle.load(f)
    np.testing.assert_array_equal(gan, res["gan"])
    np.testing.assert_array_equal(rnd, res["random"])
    np.testing.assert_allclose(
        rnd, jcrps.crps_random_baseline(reals, ens), rtol=1e-6,
        atol=1e-6 * np.abs(rnd).max())
    with open(tmp_path / "crps_results.json") as f:
        assert json.load(f) == res["analysis"]
    # the RainFARM arm: its pickle, and its mean in the analysis
    rf_dir = tmp_path / "rf"
    res = tcrps.run_crps_evaluation(
        setup["tgen"], reals, ens, n_members=8, outdir=str(rf_dir),
        rainfarm=(1.5, 0.9, tcfg.RainFarmConfig()), n_bootstrap=50)
    assert res["rainfarm"].shape == (4, 24) and res["rainfarm_seconds"] > 0
    assert np.isfinite(res["rainfarm"]).all() and (res["rainfarm"] >= 0).all()
    with open(rf_dir / "crps_results_rainfarm.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f), res["rainfarm"])
    assert res["analysis"]["rainfarm"] == float(res["rainfarm"].mean())
    with open(rf_dir / "crps_results.json") as f:
        assert json.load(f) == res["analysis"]
    assert sorted(os.listdir(rf_dir)) == [
        "crps_results.json", "crps_results_n_sample4.pkl",
        "crps_results_rainfarm.pkl"]


# --------------------------------------------------------------------------
# LSD
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["full", "device"])
def test_run_lsd_evaluation_matches_jax(setup, tmp_path, reduction):
    f = setup["fields"]
    real, gen, rf = f[:4], f[4:8], f[8:12]
    plot = reduction == "device"  # one KDE plot is enough
    got = tlsd.run_lsd_evaluation(real, gen, rf, n_samples=4,
                                  outdir=str(tmp_path / "t"),
                                  plotdir=str(tmp_path / "t"),
                                  make_plot=plot, reduction=reduction,
                                  device="cpu")
    want = jlsd.run_lsd_evaluation(real, gen, rf, n_samples=4,
                                   outdir=str(tmp_path / "j"),
                                   plotdir=str(tmp_path / "j"),
                                   make_plot=plot, reduction=reduction)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    assert set(got) == set(want) == set(got.medians)
    for k in want:
        np.testing.assert_allclose(got.medians[k], want.medians[k],
                                   rtol=2e-5)
        # the |a|^2 + |b|^2 - 2ab expansion's rounding is absolute: 2e-5 of
        # the population's largest distance
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5,
                                   atol=2e-5 * np.abs(want[k]).max())
    if reduction == "device":
        name = "log_spectral_distances_summary_n4.json"
        with open(tmp_path / "t" / name) as a, open(tmp_path / "j" / name) as b:
            sa, sb = json.load(a), json.load(b)
        for k in sb:
            assert sa[k]["n_valid"] == sb[k]["n_valid"]
            assert sa[k]["subsample_size"] == sb[k]["subsample_size"]
    sp = tlsd.spectra_of_fields(real, chunk=50, device="cpu")
    np.testing.assert_allclose(sp.numpy(), jlsd.spectra_of_fields(real),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="reduction"):
        tlsd.run_lsd_evaluation(real, gen, reduction="fast", device="cpu")


# --------------------------------------------------------------------------
# Evaluator
# --------------------------------------------------------------------------

def _evaluators(setup, tmp_path):
    texp = tcfg.ExperimentConfig(data=setup["dcfg"], name="test",
                                 model_override=setup["tc"])
    jexp = jcfg.ExperimentConfig(data=setup["jdcfg"], name="test",
                                 model_override=setup["jc"])
    return (Evaluator(texp, setup["tds"], setup["tgen"],
                      workdir=str(tmp_path / "t")),
            JaxEvaluator(jexp, setup["jds"], setup["jgen"],
                         workdir=str(tmp_path / "j")))


def _listing(ev):
    return {d: sorted(os.listdir(getattr(ev, d)))
            for d in ("plotdir", "datadir")}


def test_evaluator_phases_write_the_jax_file_names(setup, tmp_path):
    tev, jev = _evaluators(setup, tmp_path)
    for ev in (tev, jev):
        ev.map_grids(n_conditions=1, n_fake_per_real=2)
        res = ev.sample_statistics(n_samples=12, chunk=5)
        ev.noise_line_plots(n_conditions=1, n_free=3, n_shared=2)
        pvals = ev.conditional_distribution_check(n_pairs=1, n_members=20)
        assert res["generated_samples"].shape == (12, 24, 16, 16)
        assert len(pvals) == 1 and pvals[0].shape == (24,)
    assert _listing(tev) == _listing(jev)
    assert any(n.endswith(".png") for n in _listing(tev)["plotdir"])
    assert any(n.endswith(".csv") for n in _listing(tev)["plotdir"])
    assert "generated_samples.npy" in _listing(tev)["datadir"]


def test_run_all_without_plots(setup, tmp_path, capsys):
    """Plots off: the arrays and KS p-values, no figure, phase 4 left out
    and said so."""
    tev, _ = _evaluators(setup, tmp_path)
    res, pvals = tev.run_all(make_plots=False, n_map_conditions=1,
                             n_fake_per_real=2, n_stat_samples=10,
                             n_ks_conditions=2, n_ks_members=20)
    assert "phase 4" in capsys.readouterr().out
    listing = _listing(tev)
    assert listing["datadir"] == ["generated_samples.npy", "real_samples.npy"]
    assert len(listing["plotdir"]) == 2
    assert all(n.startswith("check_conditional_dist_samenoise_KSpval")
               and n.endswith(".txt") for n in listing["plotdir"])
    assert res["amean_gen"].shape == (10, 24) and len(pvals) == 2
    for p in pvals:
        assert np.all((p >= 0) & (p <= 1))


def test_sample_statistics_match_jax_in_distribution(setup, tmp_path):
    """Draws differ by design, so phase 2's area means are compared in
    distribution (KS, p > 0.01 at n 300 each); the generated fields
    conserve the daily sum in both; the same seed gives the same draws."""
    tev, jev = _evaluators(setup, tmp_path)
    got = tev.sample_statistics(n_samples=300, make_plots=False)
    want = jev.sample_statistics(n_samples=300, make_plots=False)
    for key in ("amean_real", "amean_gen", "amean_fraction_gen"):
        for h in (0, 11, 23):
            p = scipy.stats.ks_2samp(got[key][:, h], want[key][:, h]).pvalue
            assert p > KS_P, (key, h, p)
    np.testing.assert_allclose(got["amean_fraction_gen"].sum(1), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(got["generated_samples"].sum(1),
                               got["real_samples"].sum(1), rtol=1e-4,
                               atol=1e-4)
    corr = tevaluate.daily_cycle_correlation(got)
    assert corr == jevaluate.daily_cycle_correlation(got)
    again, _ = _evaluators(setup, tmp_path / "again")
    np.testing.assert_array_equal(
        again.sample_statistics(n_samples=300, make_plots=False)["amean_gen"],
        got["amean_gen"])


# --------------------------------------------------------------------------
# parity report and plots
# --------------------------------------------------------------------------

def _reference_like_dir(path, seed):
    import pandas as pd

    rng = np.random.RandomState(seed)
    os.makedirs(path)
    for i in range(3):
        np.savetxt(os.path.join(
            path, f"check_conditional_dist_samenoise_KSpvalx_{i:04d}.txt"),
            rng.rand(24))
        frames = [pd.DataFrame({"fraction": rng.rand(20) / 24 * (1 + h / 48),
                                "cond": c, "hour": h + 1})
                  for h in range(24) for c in (1, 2)]
        pd.concat(frames).to_csv(os.path.join(
            path, f"check_conditional_dist_samenoise_x_{i:04d}.csv"))
    return str(path)


def test_parity_report_equals_jax(tmp_path):
    ours = _reference_like_dir(tmp_path / "ours", 1)
    ref = _reference_like_dir(tmp_path / "ref", 2)
    got = tparity.parity_report(ours, ref, out_path=str(tmp_path / "t.json"))
    want = jparity.parity_report(ours, ref, out_path=str(tmp_path / "j.json"))
    assert got == want
    with open(tmp_path / "t.json") as a, open(tmp_path / "j.json") as b:
        assert json.load(a) == json.load(b)


def test_plots_draw_the_jax_mosaics():
    rng = np.random.RandomState(2)
    real = rng.rand(24, 16, 16).astype("f4")
    gen = rng.rand(3, 24, 16, 16).astype("f4")
    dsum = 30 * rng.rand(16, 16).astype("f4")
    for fractions, every in ((True, 1), (False, 3)):
        got = tplotting.map_comparison_grid(real, gen, dsum, fractions,
                                            every=every,
                                            fraction_cmap="magma_r")
        want = jplotting.map_comparison_grid(real, gen, dsum, fractions,
                                             every=every,
                                             fraction_cmap="magma_r")
        np.testing.assert_array_equal(got.axes[0].images[0].get_array(),
                                      want.axes[0].images[0].get_array())
        assert tuple(got.get_size_inches()) == tuple(want.get_size_inches())
    got = tplotting.sample_grid(gen[..., None], rng.rand(3, 16, 16, 1))
    assert len(got.axes) == 3 * 24
    tplotting.close_all()


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_cli_evaluate_crps_lsd_analyze(setup, tmp_path, capsys):
    """The eval subcommands in this process on the CPU, plots off, each
    writing the artifacts the next one reads."""
    wd = str(tmp_path)
    tcli.main(["evaluate", "--device", "cpu", "--synthetic",
               "--synthetic-days", "4", "--synthetic-size", "32",
               "--weights", setup["npz"], "--workdir", wd, "--smoke",
               "--no-plots"])
    out = capsys.readouterr().out
    assert "phase 4" in out and "evaluation artifacts in" in out
    real = np.load(os.path.join(wd, "data", "real_samples.npy"))
    assert real.shape == (50, 24, 16, 16)
    baseline = os.path.join(wd, "baseline.npy")
    np.save(baseline, real[10:40])
    crps_out = os.path.join(wd, "crps")
    tcli.main(["crps", "--device", "cpu", "--weights", setup["npz"],
               "--real", os.path.join(wd, "data", "real_samples.npy"),
               "--baseline", baseline, "--n-members", "8",
               "--n-samples", "3", "--out", crps_out])
    analysis = json.load(open(os.path.join(crps_out, "crps_results.json")))
    assert set(analysis) == {"gan", "random", "ttest_p_gan_vs_random",
                             "bootstrap_diff"}
    tcli.main(["crps-analyze", "--results",
               os.path.join(crps_out, "crps_results_n_sample3.pkl"),
               "--out", os.path.join(wd, "analyzed")])
    assert json.load(open(os.path.join(wd, "analyzed",
                                       "crps_results.json"))) == analysis
    tcli.main(["lsd", "--device", "cpu", "--reduction", "device",
               "--no-plots", "--n-samples", "3",
               "--real", os.path.join(wd, "data", "real_samples.npy"),
               "--generated", os.path.join(wd, "data",
                                           "generated_samples.npy"),
               "--out", os.path.join(wd, "lsd")])
    assert "log_spectral_distances_summary_n3.json" in os.listdir(
        os.path.join(wd, "lsd"))


def test_cli_refuses_without_figure_modules_or_card(setup, monkeypatch,
                                                    tmp_path):
    import importlib.util

    real_find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "seaborn" else real_find(name, *a)))
    with pytest.raises(SystemExit, match="--no-plots"):
        tcli.main(["evaluate", "--device", "cpu", "--synthetic",
                   "--weights", setup["npz"], "--workdir", str(tmp_path)])
    with pytest.raises(SystemExit, match="--no-plots"):
        tcli.main(["lsd", "--real", "r.npy", "--generated", "g.npy"])
    monkeypatch.undo()
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["crps", "--weights", setup["npz"], "--real", "r.npy",
                       "--baseline", "b.npy"])
