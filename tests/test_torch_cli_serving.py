"""The port's remaining API methods (save_npz, wire_dtype, plot_scenarios)
against the JAX package's, and the serving and RainFARM subcommands of
``prdisagg_torch.cli``, on the CPU (``--device cpu``) at smoke widths.

Scenarios from the same weights and latents agree within 1e-5 of the
largest daily sum (1e-3 with a float16 wire).  The subcommands run in this
process, except the SIGTERM test, which needs a process of its own.
"""

import argparse
import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch import cli as tcli  # noqa: E402
from prdisagg_torch.api import pretrained as tpre  # noqa: E402
from prdisagg_torch.api.server import request, scenarios_array  # noqa: E402
from prdisagg_torch.core import config as tcfg  # noqa: E402
from prdisagg_torch.models.io import params_from_jax  # noqa: E402
from prdisagg_tpu import cli as jcli  # noqa: E402
from prdisagg_tpu.api import pretrained as jpre  # noqa: E402
from prdisagg_tpu.core import config as jcfg  # noqa: E402
from prdisagg_tpu.models import Generator as JaxGenerator  # noqa: E402
from prdisagg_tpu.models.io import save_params_npz  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(ndomain=16, latent_dim=8, gen_channels=(8, 8, 8),
             base_channels=8, critic_channels=(8, 8, 8, 8),
             compute_dtype="float32", init_stddev=0.3)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Smoke-width generator weights (JAX-initialised, std 0.3) in the JAX
    package's .npz, both packages' configs, a condition and latents."""
    jc, tc = jcfg.ModelConfig(**SMALL), tcfg.ModelConfig(**SMALL)
    params = jax.tree_util.tree_map(np.asarray, JaxGenerator(jc).init(
        jax.random.PRNGKey(3), np.zeros((1, 8), "f4"),
        np.zeros((1, 16, 16, 1), "f4")))
    npz = str(tmp_path_factory.mktemp("serving_weights") / "gen.npz")
    save_params_npz(npz, params)
    rng = np.random.RandomState(0)
    return dict(jc=jc, tc=tc, params=params, npz=npz,
                cond=rng.gamma(0.6, 12.0, (16, 16)).astype("f4"),
                lat=rng.randn(6, 8).astype("f4"))


def _port(weights, **kw):
    return tpre.PretrainedGenerator(params_from_jax(weights["params"]),
                                    weights["tc"], device="cpu", **kw)


# --------------------------------------------------------------------------
# the API's remaining methods
# --------------------------------------------------------------------------

def test_save_npz_round_trips_through_jax(weights, tmp_path):
    gen = _port(weights)
    path = str(tmp_path / "port.npz")
    gen.save_npz(path)
    with np.load(path) as a, np.load(weights["npz"]) as b:
        assert sorted(a.files) == sorted(b.files)
    back = jpre.PretrainedGenerator.from_npz(path)
    assert back.cfg.gen_channels == weights["jc"].gen_channels
    cond, lat = weights["cond"], weights["lat"]
    want = back.generate_scenarios(cond, len(lat), latent=lat)
    got = gen.generate_scenarios(cond, len(lat), latent=lat)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * cond.max())


def test_wire_float16_matches_jax(weights):
    """The float16 wire on the same weights and latents as JAX's: within
    1e-3 of the largest daily sum, for one map and for a stack; a bad
    wire_dtype raises before any device work (here: before the missing
    card is noticed)."""
    cond, lat = weights["cond"], weights["lat"]
    gen16 = _port(weights, wire_dtype="float16")
    jgen16 = jpre.PretrainedGenerator(weights["params"], weights["jc"],
                                      wire_dtype="float16")
    assert gen16.wire_dtype == "float16"
    got = gen16.generate_scenarios(cond, len(lat), latent=lat)
    want = jgen16.generate_scenarios(cond, len(lat), latent=lat)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * cond.max())
    exact = _port(weights).generate_scenarios(cond, len(lat), latent=lat)
    err = np.abs(got.sum(axis=1) - cond).max() / cond.max()
    assert 0 < err <= 1e-3 and np.abs(got - exact).max() > 0
    stack = np.stack([cond, 2 * cond, 0.5 * cond])
    lat3 = np.concatenate([lat[:2]] * 3)
    np.testing.assert_allclose(
        gen16.generate_scenarios_batch(stack, 2, latent=lat3),
        jgen16.generate_scenarios_batch(stack, 2, latent=lat3),
        rtol=0, atol=2e-3 * cond.max())
    assert _port(weights, wire_dtype="float32").wire_dtype is None
    with pytest.raises(ValueError, match="wire_dtype"):
        tpre.PretrainedGenerator(params_from_jax(weights["params"]),
                                 weights["tc"], device="cuda",
                                 wire_dtype="int8")


@pytest.mark.parametrize("mode,hour", [("reference", 23), ("aligned", 0)])
def test_plot_scenarios_panel_hours(weights, mode, hour):
    """In "reference" mode the panel labelled 00:00 shows hour 23, as the
    reference draws it; the JAX package's figure has the same images."""
    scen = np.random.RandomState(1).rand(2, 24, 16, 16).astype("f4")
    got = _port(weights).plot_scenarios(scen, hour_labels=mode)
    want = jpre.plot_scenarios(scen, hour_labels=mode)
    panels = [ax for ax in got.axes if ax.images]
    assert len(panels) == 2 * 24
    np.testing.assert_array_equal(panels[0].images[0].get_array(),
                                  scen[0, hour])
    assert panels[0].texts[0].get_text() == "00:00"
    for a, b in zip(panels, [ax for ax in want.axes if ax.images]):
        np.testing.assert_array_equal(a.images[0].get_array(),
                                      b.images[0].get_array())
    with pytest.raises(ValueError, match="hour_labels"):
        tpre.plot_scenarios(scen, hour_labels="shifted")
    from prdisagg_torch.utils.plotting import close_all

    close_all()


# --------------------------------------------------------------------------
# the subcommands' flags
# --------------------------------------------------------------------------

def _subparser(parser, name):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[name]


SUBCOMMANDS = ["rainfarm-calibrate", "rainfarm-crps", "rainfarm-generate",
               "example", "generate", "serve", "inspect"]


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_subcommands_take_the_jax_flags(name):
    """The JAX package's flags and defaults, --dp included, plus --device
    (default cuda) where it computes."""
    mine = {a.dest: a for a in _subparser(tcli.build_parser(), name)._actions}
    theirs = {a.dest: a for a in _subparser(jcli.build_parser(),
                                            name)._actions}
    device = mine.pop("device", None)
    if name == "inspect":
        assert device is None
    else:
        assert device.default == "cuda"
    assert set(mine) == set(theirs)
    for dest, action in mine.items():
        assert action.option_strings == theirs[dest].option_strings, dest
        assert action.default == theirs[dest].default, dest
        assert action.choices == theirs[dest].choices, dest


# --------------------------------------------------------------------------
# generate, example, inspect
# --------------------------------------------------------------------------

def test_cli_generate_single_and_stack(weights, tmp_path, capsys):
    """One map with reference semantics and the same stream as the API at
    --seed; a stack as one fused batch; the float16 wire; --plot."""
    cond = weights["cond"]
    single, stack = str(tmp_path / "c.npy"), str(tmp_path / "k.npy")
    np.save(single, cond)
    np.save(stack, np.stack([cond, 2 * cond, 0.5 * cond]))
    out = str(tmp_path / "s.npy")
    tcli.main(["generate", "--device", "cpu", "--weights", weights["npz"],
               "--conds", single, "--n-scenarios", "3", "--out", out,
               "--plot", str(tmp_path / "plots")])
    assert "conservation check" in capsys.readouterr().out
    scen = np.load(out)
    want = tpre.PretrainedGenerator.from_npz(
        weights["npz"], seed=354, device="cpu").generate_scenarios(cond, 3)
    np.testing.assert_array_equal(scen, want)
    assert os.path.exists(tmp_path / "plots" / "scenarios_grid.png")
    tcli.main(["generate", "--device", "cpu", "--weights", weights["npz"],
               "--conds", stack, "--n-scenarios", "2", "--out", out,
               "--max-batch", "4"])
    many = np.load(out)
    assert many.shape == (3, 2, 24, 16, 16)
    np.testing.assert_allclose(
        many.sum(axis=2), np.load(stack)[:, None].repeat(2, 1), rtol=0,
        atol=1e-5 * 2 * cond.max())
    tcli.main(["generate", "--device", "cpu", "--weights", weights["npz"],
               "--conds", single, "--n-scenarios", "3", "--out", out,
               "--wire-dtype", "float16"])
    np.testing.assert_allclose(np.load(out), want, rtol=0,
                               atol=1e-3 * cond.max())


def test_cli_example(weights, tmp_path, capsys):
    out = str(tmp_path / "ex.png")
    tcli.main(["example", "--device", "cpu", "--weights", weights["npz"],
               "--n-scenarios", "2", "--out", out])
    assert os.path.exists(out)
    # no --weights: a seeded random flagship generator
    tcli.main(["example", "--device", "cpu", "--n-scenarios", "1",
               "--out", out])
    printed = capsys.readouterr().out
    assert "randomly initialized" in printed and "conservation" in printed


def test_cli_inspect_matches_jax(weights, tmp_path, capsys):
    """The same description as the JAX package's inspect, for a generator
    .npz (with --layers) and a critic .h5, the inferred config field for
    field."""
    from prdisagg_torch.models.critic import Critic
    from prdisagg_torch.models.io import params_to_jax, save_keras_critic_h5

    torch.manual_seed(0)
    critic = str(tmp_path / "disc.h5")
    save_keras_critic_h5(critic, params_to_jax(
        Critic(weights["tc"]).state_dict()), weights["tc"])
    for args in (["--weights", weights["npz"], "--layers"],
                 ["--weights", critic]):
        tcli.main(["inspect", *args])
        got = json.loads(capsys.readouterr().out)
        jcli.cmd_inspect(jcli.build_parser().parse_args(["inspect", *args]))
        want = json.loads(capsys.readouterr().out)
        assert got == want
    assert got["network"] == "critic" and got["format"] == "keras-h5"


def test_cli_inspect_unreadable_h5_reports_both_errors(tmp_path):
    bad = tmp_path / "bad.h5"
    bad.write_bytes(b"not an hdf5 file")
    with pytest.raises(SystemExit, match="as a generator .* or a critic"):
        tcli.main(["inspect", "--weights", str(bad)])


def test_figure_subcommands_refuse_without_matplotlib(weights, monkeypatch,
                                                       tmp_path):
    import importlib.util

    real_find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "matplotlib" else real_find(name, *a)))
    for argv in (["example", "--device", "cpu"],
                 ["rainfarm-generate", "--slopes", "s.pkl", "--real",
                  "r.npy", "--device", "cpu"],
                 ["generate", "--weights", weights["npz"], "--conds",
                  "c.npy", "--plot", str(tmp_path), "--device", "cpu"]):
        with pytest.raises(SystemExit, match="'matplotlib'"):
            tcli.main(argv)


# --------------------------------------------------------------------------
# RainFARM
# --------------------------------------------------------------------------

def test_cli_rainfarm_calibrate_crps_generate(tmp_path, capsys):
    out = str(tmp_path / "data")
    tcli.main(["rainfarm-calibrate", "--device", "cpu", "--synthetic",
               "--synthetic-days", "4", "--synthetic-size", "32",
               "--n-calib", "32", "--n-repeat", "2", "--out", out])
    assert capsys.readouterr().out.count("alpha=") == 2
    slopes = os.path.join(out, "spectral_slopes_0.pkl")
    with open(slopes, "rb") as f:
        alpha, beta = pickle.load(f)  # as JAX's cmd_rainfarm_crps reads it
    assert np.isfinite([alpha, beta]).all()
    real = os.path.join(out, "rainfarm_calibration_data.npy")
    assert np.load(real).shape == (32, 24, 16, 16)
    tcli.main(["rainfarm-crps", "--device", "cpu", "--slopes", slopes,
               "--real", real, "--n-samples", "3", "--n-members", "8",
               "--out", out])
    assert "rainfarm CRPS mean" in capsys.readouterr().out
    with open(os.path.join(out, "crps_results_rainfarm.pkl"), "rb") as f:
        assert pickle.load(f).shape == (3, 24)
    plots = str(tmp_path / "plots")
    tcli.main(["rainfarm-generate", "--device", "cpu", "--slopes", slopes,
               "--real", real, "--n-samples", "2", "--n-map-conditions", "1",
               "--n-fake-per-real", "2", "--out", out, "--plotdir", plots])
    assert "ecdf_rainfarm.png" in os.listdir(plots)
    assert np.load(os.path.join(out, "generated_samples_rainfarm.npy")
                   ).shape == (2, 24, 16, 16)


# --------------------------------------------------------------------------
# serve
# --------------------------------------------------------------------------

def _wait_for(path, proc=None, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline and not os.path.exists(path):
        assert proc is None or proc.poll() is None, "the server exited"
        time.sleep(0.1)
    assert os.path.exists(path), "the server did not bind its socket"


def test_cli_serve_answers_requests(weights, tmp_path):
    """serve warms, binds, answers a ping, a b64 map request and stats,
    then stops after --max-requests 3 and unlinks its socket; warming does
    not consume the random stream."""
    sock = str(tmp_path / "s.sock")
    thread = threading.Thread(target=tcli.main, daemon=True, args=([
        "serve", "--device", "cpu", "--weights", weights["npz"],
        "--socket", sock, "--seed", "21", "--max-batch", "8",
        "--warm", "max,2", "--max-requests", "3"],))
    thread.start()
    _wait_for(sock)
    cond = weights["cond"]
    assert request(sock, {"cmd": "ping"}, timeout=60)["ok"]
    resp = request(sock, {"cond": cond.tolist(), "n_scenarios": 2,
                          "encoding": "b64"}, timeout=120)
    want = tpre.PretrainedGenerator.from_npz(
        weights["npz"], seed=21, max_batch=8,
        device="cpu").generate_scenarios(cond, 2)
    np.testing.assert_allclose(scenarios_array(resp), want, rtol=1e-6,
                               atol=1e-6)
    stats = request(sock, {"cmd": "stats"}, timeout=60)
    assert stats["ok"] and stats["scenario_requests"] == 1
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert not os.path.exists(sock)


def test_cli_serve_stops_cleanly_on_sigterm(weights, tmp_path):
    """SIGTERM: in-flight work drains, the socket file is unlinked, the
    process exits 0 with its farewell."""
    sock = str(tmp_path / "s.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "prdisagg_torch.cli", "serve", "--device",
         "cpu", "--weights", weights["npz"], "--socket", sock,
         "--warm", "none"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        _wait_for(sock, proc, timeout=300)
        assert request(sock, {"cmd": "ping"}, timeout=60)["ok"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "shutting down" in out and "bye" in out
    assert not os.path.exists(sock)
