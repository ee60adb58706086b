"""The port's training run around the step (prdisagg_torch/train/loop.py,
checkpoint.py, artifacts.py, state.py's loaders, models/io.py's .h5 export
and cli.py's ``train``), on the CPU at smoke sizes.

They follow tests/test_loop_and_checkpoint.py: ``steps_per_call`` and exact
resume are checked bit for bit against single steps and an uninterrupted
run; weight files written by the JAX package warm-start the port, and the
port's .h5 exports load in the JAX package with the same outputs.
"""

import csv
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch import cli  # noqa: E402
from prdisagg_torch.core import config as tcfg  # noqa: E402
from prdisagg_torch.data.sampler import DeviceDataset  # noqa: E402
from prdisagg_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from prdisagg_torch.models.critic import Critic  # noqa: E402
from prdisagg_torch.models.generator import Generator  # noqa: E402
from prdisagg_torch.models.io import (  # noqa: E402
    critic_params_from_jax,
    infer_critic_config,
    load_keras_critic_h5,
    load_keras_generator_h5,
    params_from_jax,
    params_to_jax,
    save_keras_critic_h5,
    save_keras_generator_h5,
)
from prdisagg_torch.train import loop as tloop  # noqa: E402
from prdisagg_torch.train import wgan_gp as twgan  # noqa: E402
from prdisagg_torch.train.artifacts import (  # noqa: E402
    ArtifactWriter,
    SyncWriter,
)
from prdisagg_torch.train.checkpoint import CheckpointManager  # noqa: E402
from prdisagg_torch.train.loop import NaNLossError, Trainer  # noqa: E402
from prdisagg_torch.train.state import (  # noqa: E402
    create_train_state,
    infer_model_config_from_weights,
    state_tree,
    warm_start,
)
from prdisagg_tpu.api.pretrained import (  # noqa: E402
    PretrainedGenerator as JaxPretrained,
)
from prdisagg_tpu.core import config as jcfg  # noqa: E402
from prdisagg_tpu.models import Critic as JaxCritic  # noqa: E402
from prdisagg_tpu.models import io as jio  # noqa: E402
from prdisagg_tpu.train.state import (  # noqa: E402
    infer_model_config_from_weights as jax_infer_config,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TC = tcfg.smoke_model_config(compute_dtype="float32")
RUN = dict(plot_every_epochs=0, export_format="npz")


@pytest.fixture(scope="module")
def ds():
    data, idx, dcfg = make_synthetic_dataset(n_days=4, ny=32, nx=32, seed=5)
    return DeviceDataset.from_numpy(data, idx, dcfg, device="cpu")


def _exp(epochs=2, batch=4, **train_kw):
    kw = dict(n_disc=1, schedule=((epochs, batch),), log_every_steps=2,
              checkpoint_every_epochs=1)
    kw.update(train_kw)
    return tcfg.ExperimentConfig(train=tcfg.TrainConfig(**kw),
                                 model_override=TC)


def _assert_trees_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _read_hist(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


# --------------------------------------------------------------------------
# config helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["20:32,30:128", "3:4", "1:2,1:4,1:8"])
def test_parse_schedule_and_production_preset_match_jax(spec):
    assert tcfg.parse_schedule(spec) == jcfg.parse_schedule(spec)
    want = jcfg.production_train_config(seed=3)
    got = tcfg.production_train_config(seed=3)
    assert (got.schedule, got.ema_decay, got.seed) == (
        want.schedule, want.ema_decay, want.seed)
    for bad in ("", "3", "0:4", "2:x"):
        with pytest.raises(ValueError):
            tcfg.parse_schedule(bad)


# --------------------------------------------------------------------------
# steps_per_call
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_steps_per_call_equals_single_steps(ds, k):
    cfg = tcfg.TrainConfig(n_disc=2)
    a = create_train_state(TC, cfg, device="cpu")
    b = create_train_state(TC, cfg, device="cpu")
    _, got = twgan.make_train_step(TC, cfg, 4, steps_per_call=k)(a, ds)
    one = twgan.make_train_step(TC, cfg, 4)
    for _ in range(k):
        _, want = one(b, ds)
    assert a.step == b.step == k
    _assert_trees_equal(state_tree(a), state_tree(b))
    assert set(got) == set(twgan.METRIC_KEYS) | {"nonfinite", "packed"}
    assert torch.equal(got["packed"], want["packed"])
    for i, key in enumerate(twgan.METRIC_KEYS):
        assert torch.equal(got[key], want["packed"][i]), key
    assert not bool(got["nonfinite"])


def test_steps_per_call_ors_the_nonfinite_flag(ds, monkeypatch):
    """A non-finite middle step flags the call, whose other metrics are the
    last step's."""
    real, calls = twgan._train_step_on, []

    def second_is_nonfinite(*args, **kw):
        m = real(*args, **kw)
        calls.append(m["packed"].clone())
        if len(calls) == 2:
            m["nonfinite"] = torch.tensor(True)
        return m

    monkeypatch.setattr(twgan, "_train_step_on", second_is_nonfinite)
    cfg = tcfg.TrainConfig(n_disc=1)
    state = create_train_state(TC, cfg, device="cpu")
    _, m = twgan.make_train_step(TC, cfg, 4, steps_per_call=3)(state, ds)
    assert len(calls) == 3 and state.step == 3
    assert bool(m["nonfinite"]) and twgan.unpack_metrics(m["packed"])[
        "nonfinite"]
    assert torch.equal(m["packed"][:-1], calls[-1][:-1])
    with pytest.raises(ValueError, match=">= 1"):
        twgan.make_train_step(TC, cfg, 4, steps_per_call=0)


# --------------------------------------------------------------------------
# checkpoints and resume
# --------------------------------------------------------------------------

def test_checkpoint_restores_in_place(ds, tmp_path):
    """Restore copies into the existing tensors (what a captured CUDA graph
    needs), moments and the random stream included, and keeps max_to_keep
    files."""
    from prdisagg_torch.train.artifacts import snapshot

    cfg = tcfg.TrainConfig(n_disc=1, ema_decay=0.9)
    step = twgan.make_train_step(TC, cfg, 4)
    src = create_train_state(TC, cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for epoch in (1, 2, 3):
        step(src, ds)
        mgr.save(epoch, snapshot(src))
    assert mgr.epochs() == [2, 3] and mgr.latest_epoch() == 3
    dst = create_train_state(TC, cfg, seed=9, device="cpu")
    tensors = [t for net in (dst.gen, dst.critic, dst.ema_gen)
               for t in net.state_dict().values()]
    moments = [t for st in dst.critic_opt.state.values() for t in st.values()]
    ptrs = [t.data_ptr() for t in tensors + moments]
    assert mgr.restore(dst) is dst
    assert [t.data_ptr() for t in tensors + moments] == ptrs
    _assert_trees_equal(state_tree(dst), state_tree(src))
    # the restored stream continues the saved one's draws
    _, m_src = step(src, ds)
    _, m_dst = step(dst, ds)
    assert torch.equal(m_src["packed"], m_dst["packed"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(dst)
    no_ema = create_train_state(TC, tcfg.TrainConfig(n_disc=1), device="cpu")
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore(no_ema)


def test_exact_resume_matches_an_uninterrupted_run(ds, tmp_path):
    full = Trainer(_exp(2), ds, str(tmp_path / "full"), steps_per_epoch=2,
                   **RUN)
    full.fit(progress=False)
    part = Trainer(_exp(1), ds, str(tmp_path / "part"), steps_per_epoch=2,
                   **RUN)
    part.fit(progress=False)
    resumed = Trainer(_exp(2), ds, str(tmp_path / "part"), steps_per_epoch=2,
                      **RUN)
    assert resumed.maybe_resume()
    assert resumed.epoch == 1 and resumed.state.step == 2
    resumed.fit(progress=False)
    assert resumed.epoch == 2 and resumed.state.step == 4
    _assert_trees_equal(state_tree(resumed.state), state_tree(full.state))
    assert resumed.hist == full.hist
    assert (_read_hist(tmp_path / "part" / "hist.csv")
            == _read_hist(tmp_path / "full" / "hist.csv"))
    name = f"gen_{full.params_str}_0002.npz"
    with np.load(os.path.join(full.outdir, name)) as a, \
            np.load(os.path.join(resumed.outdir, name)) as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("how", ["complete", "abort"])
def test_final_checkpoint_on_completion_and_abort(ds, tmp_path, how):
    """With a cadence of 10, a 3-epoch run still leaves a checkpoint of its
    last completed epoch: epoch 3 on completion; after a NaN abort in epoch
    3, epoch 2, with the finite weights of that epoch's end."""
    saved = {}

    def poison_after_epoch_2(tr):
        if tr.epoch == 2:
            saved.update({k: v.clone() for k, v in
                          tr.state.critic.state_dict().items()})
            if how == "abort":
                with torch.no_grad():
                    next(tr.state.critic.parameters()).view(-1)[0] = np.nan

    exp = _exp(3, checkpoint_every_epochs=10)
    tr = Trainer(exp, ds, str(tmp_path), steps_per_epoch=2,
                 on_epoch_end=poison_after_epoch_2, **RUN)
    if how == "abort":
        with pytest.raises(NaNLossError):
            tr.fit(progress=False)
    else:
        tr.fit(progress=False)
    want = 3 if how == "complete" else 2
    assert tr.ckpt.epochs() == [want]
    back = Trainer(exp, ds, str(tmp_path), steps_per_epoch=2, **RUN)
    assert back.maybe_resume() and back.epoch == want
    assert back.state.step == 2 * want
    got = back.state.critic.state_dict()
    if how == "abort":
        assert all(torch.isfinite(v).all() for v in got.values())
        _assert_trees_equal(got, saved)
    else:
        _assert_trees_equal(got, tr.state.critic.state_dict())


@pytest.mark.parametrize("legacy", [False, True])
def test_resume_truncates_and_backfills_hist(ds, tmp_path, legacy):
    """Rows of epochs newer than the restored checkpoint are dropped; a
    reference-style hist.csv (d_loss, g_loss only) is kept whole, with the
    missing columns NaN (an empty cell, as pandas writes it)."""
    tr = Trainer(_exp(3), ds, str(tmp_path), steps_per_epoch=2, **RUN)
    tr.fit(progress=False)
    os.remove(tr.ckpt._path(3))
    path = tmp_path / "hist.csv"
    if legacy:
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["", "d_loss", "g_loss"])
            for i in range(5):
                w.writerow([i, 0.5 + i, -0.25 * i])
    back = Trainer(_exp(3), ds, str(tmp_path), steps_per_epoch=2, **RUN)
    assert back.maybe_resume() and back.epoch == 2
    if legacy:
        assert back.hist["d_loss"] == [0.5 + i for i in range(5)]
        for k in ("gp", "w_distance", "d_grad_norm", "g_grad_norm", "epoch"):
            assert len(back.hist[k]) == 5 and all(np.isnan(back.hist[k]))
    else:
        assert back.hist["epoch"] == [1, 2]
        for k in tloop.HIST_COLUMNS:
            assert back.hist[k] == tr.hist[k][:2], k
    back.fit(progress=False)
    rows = _read_hist(path)
    n = 6 if legacy else 3
    assert [r[0] for r in rows[1:]] == [str(i) for i in range(n)]
    assert rows[-1][-1] == "3"
    if legacy:
        assert rows[1][3] == "" and rows[1][-1] == ""


class _FakeSummaryWriter:
    """Stands in for torch.utils.tensorboard's, whose import loads
    TensorFlow where it is installed (tens of seconds)."""

    def __init__(self, logdir):
        self.logdir, self.scalars, self.flushed = logdir, [], 0
        _FakeSummaryWriter.last = self

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def flush(self):
        self.flushed += 1

    def close(self):
        pass


@pytest.mark.parametrize("cadence", [0, 2])
def test_artifact_cadences(ds, tmp_path, cadence, monkeypatch):
    """A cadence of 0 turns plots, weight exports and checkpoints off; a
    cadence of 2 writes them at epoch 2 (and the forced final checkpoint at
    3), .h5 and .npz for gen, disc and gen_ema.  The heartbeat file is
    touched, and TensorBoard gets each hist row's scalars and each epoch's
    rate."""
    import types

    monkeypatch.setenv("PRDISAGG_HEARTBEAT", str(tmp_path / "hb" / "beat"))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(
                            SummaryWriter=_FakeSummaryWriter))
    exp = _exp(3, checkpoint_every_epochs=cadence, ema_decay=0.5)
    tb = str(tmp_path / "tb") if cadence else None
    tr = Trainer(exp, ds, str(tmp_path / "w"), steps_per_epoch=1,
                 plot_every_epochs=cadence,
                 export_weights_every_epochs=cadence, export_format="both",
                 tensorboard_dir=tb)
    tr.fit(progress=False)
    exports = sorted(f for f in os.listdir(tr.outdir) if f != "ckpt")
    plots = sorted(os.listdir(tr.plotdir))
    assert os.path.exists(tmp_path / "hb" / "beat")
    assert len(_read_hist(tmp_path / "w" / "hist.csv")) == 4
    if cadence == 0:
        assert exports == [] and plots == [] and tr.ckpt.epochs() == []
        return
    assert exports == sorted(f"{p}_{tr.params_str}_0002.{ext}"
                             for p in ("gen", "disc", "gen_ema")
                             for ext in ("h5", "npz"))
    assert tr.ckpt.epochs() == [2, 3]
    assert plots == [f"fake_samples_{tr.params_str}_0002.png",
                     f"training_loss_{tr.params_str}.png"]
    sw = _FakeSummaryWriter.last
    assert sw.logdir == tb and sw.flushed == 1
    rows = [(t, s) for t, _, s in sw.scalars if t == "train/d_loss"]
    assert rows == [("train/d_loss", i) for i in (1, 2, 3)]
    assert [s for t, _, s in sw.scalars if t == "perf/steps_per_sec"] == [
        1, 2, 3]


@pytest.mark.parametrize("writer", [ArtifactWriter, SyncWriter])
def test_artifact_writer_errors_propagate(ds, tmp_path, writer):
    if writer is ArtifactWriter:
        w = writer()
        w.submit(lambda: 1 / 0)
        w.submit(lambda: [][1])
        with pytest.raises(RuntimeError, match="2 artifact writer job.*"
                           "ZeroDivisionError.*IndexError"):
            w.flush()
        w.submit(lambda: None)  # the errors were reported once
        w.close()
        with pytest.raises(RuntimeError, match="closed"):
            w.submit(lambda: None)
    else:
        with pytest.raises(ZeroDivisionError):
            writer().submit(lambda: 1 / 0)
    # a failing export surfaces from fit
    tr = Trainer(_exp(1), ds, str(tmp_path), steps_per_epoch=1,
                 async_artifacts=writer is ArtifactWriter, **RUN)
    tr.outdir = str(tmp_path / "missing" / "dir")
    with pytest.raises((RuntimeError, FileNotFoundError)):
        tr.fit(progress=False)


def test_multi_stage_schedule(ds, tmp_path, monkeypatch):
    """Each stage makes its own step at its batch size (a CUDA graph per
    stage on a card); stage boundaries are cumulative, so a run resumed in
    the second stage finishes it at that stage's batch and matches an
    uninterrupted run."""
    made = []
    real = tloop.make_train_step

    def recording(model_cfg, train_cfg, batch_size, steps_per_call=1,
                  mesh=None):
        made.append((batch_size, steps_per_call))
        return real(model_cfg, train_cfg, batch_size, steps_per_call, mesh)

    monkeypatch.setattr(tloop, "make_train_step", recording)
    sched = dict(schedule=((1, 2), (2, 4)))
    full = Trainer(_exp(**sched), ds, str(tmp_path / "full"),
                   steps_per_epoch=2, **RUN)
    full.fit(progress=False)
    assert made == [(2, 2), (4, 2)]
    assert full.epoch == 3 and full.state.step == 6
    assert full.hist["epoch"] == [1, 2, 3]

    made.clear()
    part = Trainer(_exp(schedule=((1, 2), (1, 4))), ds,
                   str(tmp_path / "part"), steps_per_epoch=2, **RUN)
    part.fit(progress=False)
    resumed = Trainer(_exp(**sched), ds, str(tmp_path / "part"),
                      steps_per_epoch=2, **RUN)
    assert resumed.maybe_resume() and resumed.epoch == 2
    resumed.fit(progress=False)
    assert made == [(2, 2), (4, 2), (4, 2)]
    _assert_trees_equal(state_tree(resumed.state), state_tree(full.state))


# --------------------------------------------------------------------------
# weight files: JAX-written in, port-written out
# --------------------------------------------------------------------------

def _jax_pair(n_cond):
    jc = jcfg.smoke_model_config(16, n_cond, compute_dtype="float32")
    tc = tcfg.ModelConfig(**{f.name: getattr(jc, f.name)
                             for f in dataclasses.fields(tcfg.ModelConfig)})
    return jc, tc


@pytest.mark.parametrize("fmt,n_cond", [("npz", 1), ("h5", 1), ("h5", 2)])
def test_warm_start_from_jax_written_weights(ds, tmp_path, fmt, n_cond):
    jc, tc = _jax_pair(n_cond)
    torch.manual_seed(n_cond)
    gp = params_to_jax(Generator(tc).state_dict())
    cp = params_to_jax(Critic(tc).state_dict())
    gen_path, critic_path = (str(tmp_path / f"{n}.{fmt}")
                             for n in ("gen", "disc"))
    if fmt == "npz":
        jio.save_params_npz(gen_path, gp)
        jio.save_params_npz(critic_path, cp)
    else:
        jio.save_keras_generator_h5(gen_path, gp, jc)
        jio.save_keras_critic_h5(critic_path, cp, jc)
    with pytest.warns(UserWarning, match="latent_dim"):
        want = jax_infer_config(gen_path, critic_path)
        got = infer_model_config_from_weights(gen_path, critic_path)
    for f in dataclasses.fields(tcfg.ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got == dataclasses.replace(tc, compute_dtype="bfloat16")

    train_cfg = tcfg.TrainConfig(n_disc=1, ema_decay=0.9)
    state = warm_start(tc, train_cfg, gen_path, critic_path, device="cpu")
    _assert_trees_equal(state.gen.state_dict(), params_from_jax(gp))
    _assert_trees_equal(state.critic.state_dict(), critic_params_from_jax(cp))
    _assert_trees_equal(state.ema_gen.state_dict(), params_from_jax(gp))
    assert state.step == 0
    assert all(not v.any() for st in state.critic_opt.state.values()
               for v in st.values())
    if n_cond == 1 and fmt == "npz":
        exp = tcfg.ExperimentConfig(train=train_cfg, model_override=tc)
        tr = Trainer(exp, ds, str(tmp_path / "w"), start_epoch=4,
                     warm_start_weights=(gen_path, None), **RUN)
        _assert_trees_equal(tr.state.gen.state_dict(), params_from_jax(gp))
        assert tr.epoch == 4
        bad = dataclasses.replace(tc, latent_dim=9)
        with pytest.raises(ValueError, match="dense kernel"):
            warm_start(bad, train_cfg, gen_path, None, device="cpu")


def test_port_h5_exports_load_in_jax(tmp_path):
    """The port's .h5 generator and critic load in the JAX package
    (PretrainedGenerator.from_keras_h5, load_keras_critic_h5) and compute
    what the port's nets compute, within 1e-5; they load back into the
    port exactly, and the critic's config is inferred as JAX infers it."""
    jc, tc = _jax_pair(1)
    torch.manual_seed(11)
    gen, crit = Generator(tc), Critic(tc)
    gen_path, critic_path = str(tmp_path / "gen.h5"), str(tmp_path / "d.h5")
    save_keras_generator_h5(gen_path, params_to_jax(gen.state_dict()), tc)
    save_keras_critic_h5(critic_path, params_to_jax(crit.state_dict()), tc)

    rng = np.random.RandomState(0)
    lat = rng.randn(5, tc.latent_dim).astype("f4")
    cond = rng.rand(5, 16, 16, 1).astype("f4")
    sample = rng.rand(5, 24, 16, 16, 1).astype("f4")
    jgen = JaxPretrained.from_keras_h5(gen_path, cfg=jc)
    want = np.asarray(jgen.predict_fractions(lat, cond))
    jcrit_params = jio.load_keras_critic_h5(critic_path, jc)
    want_score = np.asarray(jax.jit(JaxCritic(jc).apply)(
        jcrit_params, sample, cond))
    with torch.no_grad():
        got = gen(torch.tensor(lat), torch.tensor(cond)).numpy()
        got_score = crit(torch.tensor(sample), torch.tensor(cond)).numpy()
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got_score, want_score, rtol=1e-5,
                               atol=1e-5 * np.abs(want_score).max())

    _assert_trees_equal(
        params_from_jax(load_keras_generator_h5(gen_path, tc)),
        gen.state_dict())
    back = load_keras_critic_h5(critic_path)
    _assert_trees_equal(critic_params_from_jax(back), crit.state_dict())
    jinf = jio.infer_critic_config(jcrit_params)
    pinf = infer_critic_config(back)
    assert (pinf.ndomain, pinf.n_cond_channels, pinf.critic_channels) == (
        jinf.ndomain, jinf.n_cond_channels, jinf.critic_channels)
    with pytest.raises(ValueError, match="conv0 input channels"):
        load_keras_critic_h5(critic_path, dataclasses.replace(
            tc, n_cond_channels=2))


# --------------------------------------------------------------------------
# run manifest and the CLI
# --------------------------------------------------------------------------

def test_run_manifest_and_drift_warning(ds, tmp_path, capsys):
    import json

    Trainer(_exp(1), ds, str(tmp_path), **RUN)
    Trainer(_exp(1), ds, str(tmp_path), **RUN)
    assert "WARNING" not in capsys.readouterr().out
    with open(tmp_path / "run_config.json") as fh:
        manifest = json.load(fh)
    assert manifest["experiment"]["train"]["n_disc"] == 1
    assert manifest["torch_version"] == torch.__version__
    assert manifest["device"] == "cpu"
    Trainer(_exp(1, n_disc=2), ds, str(tmp_path), **RUN)
    out = capsys.readouterr().out
    assert "WARNING" in out and "train.n_disc" in out
    with open(tmp_path / "run_config.json") as fh:
        assert json.load(fh)["experiment"]["train"]["n_disc"] == 2


CLI_ARGS = ["train", "--device", "cpu", "--synthetic", "--model-preset",
            "tiny", "--synthetic-days", "4", "--synthetic-size", "32",
            "--batch-size", "4", "--n-disc", "1", "--steps-per-epoch", "2",
            "--export-format", "npz", "--plot-every-epochs", "0"]


def test_cli_train_then_resume(tmp_path, capsys):
    """``python -m prdisagg_torch.cli train`` end to end on the CPU, then
    ``--resume`` to a later epoch: it starts from the saved epoch."""
    args = CLI_ARGS + ["--workdir", str(tmp_path)]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-m", "prdisagg_torch.cli", *args,
                        "--epochs", "2"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "finished at epoch 2" in r.stdout
    cli.main(args + ["--epochs", "3", "--resume"])
    out = capsys.readouterr().out
    assert "resumed at epoch 2 (step 4)" in out
    assert "finished at epoch 3" in out and "epoch 1 " not in out
    outdir = tmp_path / "trained_models" / "wgancp_pixelnorm"
    assert CheckpointManager(str(outdir / "ckpt")).epochs() == [2, 3]
    params = tcfg.DataConfig().params_string()
    for e in (1, 2, 3):
        for p in ("gen", "disc"):
            assert (outdir / f"{p}_{params}_{e:04d}.npz").exists()
    assert [r[-1] for r in _read_hist(tmp_path / "hist.csv")[1:]] == [
        "1", "2", "3"]
    assert (tmp_path / "run_config.json").exists()


@pytest.mark.parametrize("missing,flag", [
    ("h5py", "--export-format npz"),
    ("matplotlib", "--plot-every-epochs 0")])
def test_cli_refuses_artifacts_it_cannot_write(monkeypatch, tmp_path,
                                               missing, flag):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == missing
                        else real(name, *a))
    args = ["train", "--device", "cpu", "--synthetic", "--workdir",
            str(tmp_path), "--export-format", "h5"]
    with pytest.raises(SystemExit, match=flag):
        cli.main(args)
    assert not os.listdir(tmp_path)
