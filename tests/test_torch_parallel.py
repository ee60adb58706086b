"""The port's data parallelism (prdisagg_torch/parallel/, the sharded K2
gather, the data-parallel train step, Trainer, crps_gan and
generate_scenarios over a mesh, and the CLI's --dp), on the CPU.

Sharding helpers are pure functions of (rank, size), so they are checked
rank by rank in this process against the JAX package's shard_map forms on
the 8-device CPU mesh of conftest.py.  Collectives run in worker processes
over gloo: a script written to tmp_path, launched twice with the
launcher's environment, imports torch and the port only (never JAX); the
single-process and JAX references are computed here, on the same inputs.
"""

import csv
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_train as ttt  # noqa: E402
from prdisagg_torch import cli as tcli  # noqa: E402
from prdisagg_torch.api.pretrained import PretrainedGenerator  # noqa: E402
from prdisagg_torch.core import config as tcfg  # noqa: E402
from prdisagg_torch.data.sampler import DeviceDataset  # noqa: E402
from prdisagg_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from prdisagg_torch.eval.crps import crps_gan  # noqa: E402
from prdisagg_torch.models.critic import Critic  # noqa: E402
from prdisagg_torch.models.generator import Generator  # noqa: E402
from prdisagg_torch.models.io import (  # noqa: E402
    critic_params_from_jax,
    params_from_jax,
)
from prdisagg_torch.ops.gather import gather_patches_sharded  # noqa: E402
from prdisagg_torch.parallel import distributed as tdist  # noqa: E402
from prdisagg_torch.parallel.mesh import DataMesh, batch_shard  # noqa: E402
from prdisagg_torch.train import wgan_gp as twgan  # noqa: E402
from prdisagg_torch.train.state import create_train_state  # noqa: E402
from prdisagg_tpu.ops.pallas_gather import (  # noqa: E402
    gather_patches_pallas_sharded,
)
from prdisagg_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PYTHONPATH = os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])
WORLD = 2
N_DISC, BATCH = 2, 4
TC = tcfg.smoke_model_config(compute_dtype="float32")
CRPS = dict(n_samples=5, n_members=8, member_batch=4, sample_chunk=3)
N_SCEN = 7  # odd: the mesh pads the batch to 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(args, world=WORLD, timeout=240, cwd=ROOT):
    """`args` run as `world` processes with the launcher's environment;
    returns each rank's (returncode, stdout + stderr)."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PYTHONPATH=PYTHONPATH,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, *args], cwd=cwd, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=timeout)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(rc, out) for out, rc in outs]


# --------------------------------------------------------------------------
# the sharded K2 gather and the draws' sharding: pure functions of the rank
# --------------------------------------------------------------------------

def test_gather_sharded_matches_jax_shard_map_rank_by_rank():
    """World 8: each rank's shard equals the JAX package's shard_map'd
    Pallas gather (interpret mode) on that rank's devices, bit for bit;
    both refuse a batch that does not divide, with the same message."""
    rng = np.random.RandomState(3)
    data = rng.rand(4, 24, 64, 128).astype(np.float32)
    idx = np.stack([rng.randint(0, 4, 16), rng.randint(0, 6, 16) * 8,
                    rng.randint(0, 112, 16)], axis=1).astype(np.int32)
    want = np.asarray(gather_patches_pallas_sharded(
        jnp.asarray(data), jnp.asarray(idx), 16, jax_make_mesh(8),
        interpret=True))
    td, ti = torch.tensor(data), torch.tensor(idx)
    for r in range(8):
        got = gather_patches_sharded(td, ti, 16, DataMesh(rank=r, size=8))
        np.testing.assert_array_equal(got.numpy(), want[2 * r:2 * r + 2])
    with pytest.raises(ValueError) as jerr:
        gather_patches_pallas_sharded(jnp.asarray(data), jnp.asarray(idx[:12]),
                                      16, jax_make_mesh(8), interpret=True)
    with pytest.raises(ValueError) as terr:
        gather_patches_sharded(td, ti[:12], 16, DataMesh(rank=0, size=8))
    assert str(terr.value) == str(jerr.value)


@pytest.fixture(scope="module")
def setup():
    data, idx, _ = make_synthetic_dataset(n_days=4, ny=32, nx=32, seed=1)
    ds = DeviceDataset.from_numpy(data, idx, tcfg.DataConfig(), device="cpu")
    return data, idx, ds


@pytest.mark.parametrize("world", [2, 8])
def test_step_draws_shards_concatenate_to_the_global_draws(setup, world):
    """Every StepDraws field, at worlds 2 and 8: the real rows and latents
    shard inside each critic update's B block, the 2B masks by their real
    and fake halves, the rest along B; the shards put back together are
    the global draws.  The sampler's mesh path gives each rank its shard of
    the global sample."""
    _, _, ds = setup
    mc = tcfg.smoke_model_config(compute_dtype="float32")
    state = create_train_state(mc, tcfg.TrainConfig(n_disc=3), device="cpu")
    b = 8
    draws = twgan.draw_step_inputs(state, ds, b, 3)
    shards = [twgan.shard_step_draws(draws, DataMesh(rank=r, size=world))
              for r in range(world)]

    def blocks(x):  # rank-major shards -> the global (n_disc*B, ...) order
        parts = [s.reshape(3, b // world, *s.shape[1:]) for s in x]
        return torch.cat(parts, dim=1).reshape(-1, *x[0].shape[1:])

    for f in ("real_rows", "latent"):
        assert torch.equal(blocks([getattr(s, f) for s in shards]),
                           getattr(draws, f)), f
    assert torch.equal(torch.cat([s.eps for s in shards], dim=1), draws.eps)
    for f in ("gen_latent", "gen_rows"):
        assert torch.equal(torch.cat([getattr(s, f) for s in shards]),
                           getattr(draws, f)), f
    for i in range(3):
        for st, m in enumerate(draws.masks[i]):
            parts = [s.masks[i][st] for s in shards]
            assert all(p.shape[0] == 2 * b // world for p in parts)
            half = b // world
            assert torch.equal(torch.cat([p[:half] for p in parts]), m[:b])
            assert torch.equal(torch.cat([p[half:] for p in parts]), m[b:])
        for st, m in enumerate(draws.gp_masks[i]):
            assert torch.equal(torch.cat([s.gp_masks[i][st] for s in shards]),
                               m)
    for st, m in enumerate(draws.gen_masks):
        assert torch.equal(torch.cat([s.gen_masks[st] for s in shards]), m)

    g = torch.Generator().manual_seed(4)
    want_frac, want_cond = ds.sample_real(b, g)
    lat, cond = ds.sample_latent(b, mc.latent_dim, g)
    for r in range(world):
        mesh = DataMesh(rank=r, size=world)
        g = torch.Generator().manual_seed(4)
        frac, c = ds.sample_real(b, g, mesh)
        assert torch.equal(frac, batch_shard(want_frac, mesh))
        assert torch.equal(c, batch_shard(want_cond, mesh))
        la, co = ds.sample_latent(b, mc.latent_dim, g, mesh)
        assert torch.equal(la, batch_shard(lat, mesh))
        assert torch.equal(co, batch_shard(cond, mesh))
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        twgan.shard_step_draws(draws, DataMesh(rank=0, size=3))


# --------------------------------------------------------------------------
# collectives over gloo: one 2-process run of the worker below
# --------------------------------------------------------------------------

WORKER = textwrap.dedent('''
    import os, sys
    import torch
    torch.set_num_threads(1)
    from prdisagg_torch.api.pretrained import PretrainedGenerator
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.data.synthetic import make_synthetic_dataset
    from prdisagg_torch.eval.crps import crps_gan
    from prdisagg_torch.parallel.distributed import (
        initialize_multihost, is_primary_host)
    from prdisagg_torch.parallel.mesh import make_mesh
    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.state import create_train_state

    spec = torch.load(sys.argv[1], weights_only=False)
    assert "jax" not in sys.modules
    assert initialize_multihost(device="cpu")
    mesh = make_mesh(int(os.environ["WORLD_SIZE"]), device="cpu")
    data, idx, dcfg = make_synthetic_dataset(n_days=4, ny=32, nx=32, seed=1)
    ds = DeviceDataset.from_numpy(data, idx, dcfg, device="cpu")
    out = {"primary": is_primary_host(), "rank": mesh.rank}
    for job in ("step", "step_dropout"):
        s = spec[job]
        state = create_train_state(s["tc"], s["cfg"], seed=mesh.rank + 5,
                                   device="cpu")
        state.gen.load_state_dict(s["gen"])
        state.critic.load_state_dict(s["critic"])
        for opt, net in ((state.gen_opt, "gen"),
                         (state.critic_opt, "critic")):
            for name, p in getattr(state, net).named_parameters():
                opt.state[p] = {"step": torch.tensor(1.0),
                                "exp_avg": torch.zeros_like(p),
                                "exp_avg_sq": s["nu"][net][name].clone()}
        if mesh.rank == 0:  # rank 0's values win
            state.rng.manual_seed(11)
        from prdisagg_torch.parallel.mesh import replicate
        replicate(state, mesh)
        m = wgan_gp.train_step_on(state, ds, s["draws"], s["cfg"], mesh=mesh)
        out[job] = {"gen": state.gen.state_dict(),
                    "critic": state.critic.state_dict(),
                    "packed": m["packed"], "rng": state.rng.get_state()}
    c = spec["crps"]
    gen = PretrainedGenerator(c["params"], c["tc"], seed=3, device="cpu",
                              mesh=mesh)
    out["crps"] = crps_gan(gen, c["reals"], n_members=c["n_members"],
                           member_batch=c["member_batch"],
                           sample_chunk=c["sample_chunk"], seed=4)
    out["scen"] = gen.generate_scenarios(c["cond"], c["n_scen"])
    out["batch"] = gen.generate_scenarios_batch(
        c["conds"], c["n_scen"])
    out["max_batch"] = gen.max_batch
    torch.save(out, sys.argv[2] + f"/rank{mesh.rank}.pt")
    torch.distributed.destroy_process_group()
    print("WORKER_OK", mesh.rank, flush=True)
''')


def _step_spec(idx, dropout: float, seed: int):
    """A smoke-width f32 state with mid-training Adam moments and a step's
    global draws; with dropout, the critic's masks too."""
    jc, tc = ttt._model_pair(compute_dtype="float32", dropout_rate=dropout)
    cfg = tcfg.TrainConfig(n_disc=N_DISC)
    gp, cp = ttt._nets(tc, seed=1)
    tx = ttt._jax_step_fns(jc)[3]
    c_opt, g_opt = ttt._warm_adam(tx, cp, 1), ttt._warm_adam(tx, gp, 2)
    dr = ttt._draws(jc, idx, BATCH, N_DISC, seed=seed)
    critic = Critic(tc)
    g = torch.Generator().manual_seed(seed)
    masks = [critic.draw_masks(2 * BATCH, g) for _ in range(N_DISC)]
    gp_masks = [critic.draw_masks(BATCH, g) for _ in range(N_DISC)]
    draws = twgan.StepDraws(
        real_rows=torch.tensor(dr["real_rows"]),
        latent=torch.tensor(dr["latent"]), eps=torch.tensor(dr["eps"]),
        masks=masks, gp_masks=gp_masks,
        gen_latent=torch.tensor(dr["gen_latent"]),
        gen_rows=torch.tensor(dr["gen_rows"]),
        gen_masks=critic.draw_masks(BATCH, g))
    nu = {"gen": params_from_jax(ttt._np(g_opt[0].nu)),
          "critic": critic_params_from_jax(ttt._np(c_opt[0].nu))}
    return dict(tc=tc, cfg=cfg, gen=params_from_jax(ttt._np(gp)),
                critic=critic_params_from_jax(ttt._np(cp)), draws=draws,
                nu=nu, jax=(jc, gp, cp, dr, c_opt, g_opt))


def _single_step(spec, ds):
    """The same step in this process, with no mesh."""
    state = create_train_state(spec["tc"], spec["cfg"], device="cpu")
    state.gen.load_state_dict(spec["gen"])
    state.critic.load_state_dict(spec["critic"])
    for opt, net in ((state.gen_opt, "gen"), (state.critic_opt, "critic")):
        for name, p in getattr(state, net).named_parameters():
            opt.state[p] = {"step": torch.tensor(1.0),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": spec["nu"][net][name].clone()}
    m = twgan.train_step_on(state, ds, spec["draws"], spec["cfg"])
    return state, m


@pytest.fixture(scope="module")
def gloo_run(setup, tmp_path_factory):
    """One 2-process gloo run of WORKER; returns (spec, per-rank outputs)."""
    _, idx, _ = setup
    tmp = tmp_path_factory.mktemp("dp")
    torch.manual_seed(0)
    gen_params = Generator(TC).state_dict()
    rng = np.random.RandomState(0)
    spec = {"step": _step_spec(idx, 0.0, 7),
            "step_dropout": _step_spec(idx, 0.25, 8),
            "crps": dict(
                params=gen_params, tc=TC,
                reals=rng.gamma(0.5, 0.4, (CRPS["n_samples"], 24, 16, 16))
                .astype("f4"),
                cond=rng.gamma(2.0, 5.0, (16, 16)).astype("f4"),
                conds=rng.gamma(2.0, 5.0, (3, 16, 16)).astype("f4"),
                n_scen=N_SCEN, **{k: v for k, v in CRPS.items()
                                  if k != "n_samples"})}
    worker_spec = {k: ({kk: vv for kk, vv in v.items() if kk != "jax"}
                       if k.startswith("step") else v)
                   for k, v in spec.items()}
    torch.save(worker_spec, tmp / "spec.pt")
    (tmp / "worker.py").write_text(WORKER)
    runs = _launch([str(tmp / "worker.py"), str(tmp / "spec.pt"), str(tmp)])
    for rank, (rc, out) in enumerate(runs):
        assert rc == 0 and f"WORKER_OK {rank}" in out, out[-4000:]
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return spec, outs


def _assert_same_bits(a, b, path="out"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        for k in a:
            _assert_same_bits(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, path


def test_gloo_step_matches_single_process_and_jax(setup, gloo_run):
    """A 2-process gloo step on given global draws (f32, mid-training Adam
    moments) equals the single-process train_step_on on the same draws and
    the jitted JAX composition plus optax at test_torch_train's tolerance
    (the all-reduce only reorders float sums); with dropout masks, equals
    the single-process step.  The two ranks end bit-identical, rank 0 the
    primary; replicate gave both rank 0's random stream."""
    _, _, ds = setup
    spec, outs = gloo_run
    assert [o["primary"] for o in outs] == [True, False]
    for job in ("step", "step_dropout"):
        _assert_same_bits(outs[0][job], outs[1][job], job)
        want_rng = torch.Generator().manual_seed(11).get_state()
        assert torch.equal(outs[0][job]["rng"], want_rng)
        state, m = _single_step(spec[job], ds)
        got = twgan.unpack_metrics(outs[0][job]["packed"])
        want = twgan.unpack_metrics(m["packed"])
        scale = max(abs(want[k]) for k in ("d_loss", "gp", "g_loss"))
        for k in twgan.METRIC_KEYS:
            assert abs(got[k] - want[k]) <= 1e-5 * scale + 1e-5 * abs(
                want[k]), (job, k, got[k], want[k])
        assert got["nonfinite"] is False
        for net in ("gen", "critic"):
            for k, w in getattr(state, net).state_dict().items():
                np.testing.assert_allclose(
                    outs[0][job][net][k].numpy(), w.numpy(), rtol=1e-4,
                    atol=1e-7, err_msg=f"{job} {net}.{k}")

    jc, gp, cp, dr, c_opt, g_opt = spec["step"]["jax"]
    jgp, jcp, (lv, lf, jgpen), jg_loss = ttt._jax_full_step(
        jc, gp, cp, ttt.JaxDataset.from_numpy(
            *make_synthetic_dataset(n_days=4, ny=32, nx=32, seed=1)[:2],
            ttt.jcfg.DataConfig()), dr, N_DISC, BATCH, c_opt, g_opt)
    m = twgan.unpack_metrics(outs[0]["step"]["packed"])
    ttt._assert_scores(m["d_loss"], (0.5 * (lv + lf), lv, lf))
    ttt._assert_gp(m["gp"], float(jgpen))
    ttt._assert_scores(m["g_loss"], (jg_loss, lv, lf))
    for net, want in (("gen", params_from_jax(ttt._np(jgp))),
                      ("critic", critic_params_from_jax(ttt._np(jcp)))):
        for k, w in want.items():
            np.testing.assert_allclose(outs[0]["step"][net][k].numpy(),
                                       w.numpy(), rtol=1e-4, atol=1e-7,
                                       err_msg=f"{net}.{k}")


def test_gloo_crps_gan_rows_equal_single_process(gloo_run):
    """crps_gan over the mesh (a chunk of 3 rounded to 4: a second chunk
    of 1 sample, which rank 1 pads) equals the single-process rows bit for
    bit, on both ranks."""
    spec, outs = gloo_run
    c = spec["crps"]
    gen = PretrainedGenerator(c["params"], c["tc"], seed=3, device="cpu")
    want = crps_gan(gen, c["reals"], n_members=c["n_members"],
                    member_batch=c["member_batch"],
                    sample_chunk=c["sample_chunk"], seed=4)
    assert want.shape == (CRPS["n_samples"], 24)
    for o in outs:
        np.testing.assert_array_equal(o["crps"], want)


def test_gloo_generate_scenarios_match_single_process(gloo_run):
    """generate_scenarios(_batch) over the mesh (an odd batch padded to the
    mesh) against the single-process generator from the same seed: the
    same latents, the same per-sample math, so within 1e-6 of max(cond)
    (forwards of another batch size may round differently); the ranks
    return the same bits, and max_batch rounds to the mesh."""
    spec, outs = gloo_run
    c = spec["crps"]
    gen = PretrainedGenerator(c["params"], c["tc"], seed=3, device="cpu")
    want = gen.generate_scenarios(c["cond"], c["n_scen"])
    want_batch = gen.generate_scenarios_batch(c["conds"], c["n_scen"])
    for o in outs:
        assert o["scen"].shape == (N_SCEN, 24, 16, 16)
        np.testing.assert_allclose(o["scen"], want, rtol=0,
                                   atol=1e-6 * c["cond"].max())
        np.testing.assert_allclose(o["batch"], want_batch, rtol=0,
                                   atol=1e-6 * c["conds"].max())
        assert o["max_batch"] % WORLD == 0
    _assert_same_bits(outs[0]["scen"], outs[1]["scen"])
    _assert_same_bits(outs[0]["batch"], outs[1]["batch"])


# --------------------------------------------------------------------------
# cli train at world 2, the launch policy, --dp
# --------------------------------------------------------------------------

TRAIN_ARGS = ["train", "--device", "cpu", "--synthetic", "--synthetic-days",
              "4", "--synthetic-size", "32", "--model-preset", "tiny",
              "--compute-dtype", "float32", "--batch-size", "4", "--n-disc",
              "1", "--steps-per-epoch", "2", "--export-format", "npz",
              "--plot-every-epochs", "0"]


def _files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root)
                  .rglob("*"))


def _hist(root):
    with open(os.path.join(root, "hist.csv"), newline="") as fh:
        return list(csv.DictReader(fh))


def test_cli_train_world2_writes_the_single_process_files(tmp_path):
    """cli train under a launched world of 2 trains data-parallel: rank 0
    alone prints and writes, the file set is the single-process run's, the
    losses in hist.csv agree with it (f32; the all-reduce reorders sums and
    a cold Adam's first updates are about lr * sign(gradient), so 1e-3 of
    the losses' scale), and --resume continues both ranks from epoch 2."""
    dp, single = tmp_path / "dp", tmp_path / "single"
    args = ["-m", "prdisagg_torch.cli", *TRAIN_ARGS, "--epochs", "2",
            "--workdir", str(dp)]
    runs = _launch(args)
    assert all(rc == 0 for rc, _ in runs), runs
    assert "finished at epoch 2, data-parallel over 2 rank(s)" in runs[0][1]
    assert "finished at epoch" not in runs[1][1]
    tcli.main([*TRAIN_ARGS, "--epochs", "2", "--workdir", str(single)])
    assert _files(dp) == _files(single)
    got, want = _hist(dp), _hist(single)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [
        "1", "2"]
    for k in ("d_loss", "g_loss", "gp", "w_distance"):
        g = np.array([float(r[k]) for r in got])
        w = np.array([float(r[k]) for r in want])
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)

    runs = _launch(["-m", "prdisagg_torch.cli", *TRAIN_ARGS, "--epochs", "3",
                    "--resume", "--workdir", str(dp)])
    assert all(rc == 0 for rc, _ in runs), runs
    assert "resumed at epoch 2 (step 4)" in runs[0][1]
    assert "finished at epoch 3" in runs[0][1]
    assert [r["epoch"] for r in _hist(dp)] == ["1", "2", "3"]
    ckpt = dp / "trained_models" / "wgancp_pixelnorm" / "ckpt"
    # the final checkpoint of each run (the cadence is 10 epochs)
    assert sorted(os.listdir(ckpt)) == ["epoch_00000002.pt",
                                        "epoch_00000003.pt"]


EVAL_ARGS = ["evaluate", "--device", "cpu", "--synthetic", "--synthetic-days",
             "4", "--synthetic-size", "32", "--smoke", "--no-plots"]


def test_cli_evaluate_world2_writes_the_single_process_files(tmp_path):
    """cli evaluate --dp 2 under a launched world of 2: both ranks run every
    phase with the same draws and join each split forward (with the plots
    off: phases 1, 2 and 5; phase 5 generates on every rank and writes on
    rank 0 only); rank 0 alone prints and writes, the file set is the
    single-process run's, and every array and p-value file equals it."""
    torch.manual_seed(0)
    w = str(tmp_path / "w.npz")
    PretrainedGenerator(Generator(TC).state_dict(), TC,
                        device="cpu").save_npz(w)
    dp, single = tmp_path / "dp", tmp_path / "single"
    runs = _launch(["-m", "prdisagg_torch.cli", *EVAL_ARGS, "--weights", w,
                    "--workdir", str(dp), "--dp", str(WORLD)])
    assert all(rc == 0 for rc, _ in runs), runs
    assert "evaluation artifacts in" in runs[0][1]
    assert "evaluation artifacts in" not in runs[1][1]
    tcli.main([*EVAL_ARGS, "--weights", w, "--workdir", str(single)])
    files = _files(single)
    assert _files(dp) == files
    arrays = [f for f in files if f.endswith((".npy", ".txt"))]
    assert "data/generated_samples.npy" in arrays
    assert any(f.endswith(".txt") for f in arrays)  # phase 5's p-values
    for f in arrays:
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(dp / f),
                                          np.load(single / f), err_msg=f)
        else:
            assert (dp / f).read_text() == (single / f).read_text(), f


@pytest.mark.parametrize("env", [{}, {"RANK": "0"},
                                 {"WORLD_SIZE": "2", "MASTER_ADDR": "h",
                                  "MASTER_PORT": "1"}],
                         ids=["no-launcher", "rank-only", "no-rank"])
def test_initialize_multihost_error_policy(monkeypatch, env):
    """No launcher environment at all is the single-process case (False);
    a partly set one is a misconfigured launch and raises.  num_processes
    1 is single-process too."""
    for k in tdist.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if not env:
        assert tdist.initialize_multihost(device="cpu") is False
        assert tdist.is_primary_host()
    else:
        with pytest.raises(ValueError, match="must be specified"):
            tdist.initialize_multihost(device="cpu")
    assert tdist.initialize_multihost(num_processes=1) is False
    assert not torch.distributed.is_initialized()
    assert tdist._is_no_cluster_error("could not be detected")
    assert not tdist._is_no_cluster_error("process_id must be specified")


@pytest.mark.parametrize("cmd", ["crps", "generate", "evaluate", "serve"])
def test_dp_refuses_outside_a_world_of_n(monkeypatch, tmp_path, cmd):
    """--dp 2 in a process that was not launched exits before any work,
    printing the torchrun line that launches it."""
    for k in tdist.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    w, r = str(tmp_path / "w.npz"), str(tmp_path / "r.npy")
    argv = {"crps": ["crps", "--weights", w, "--real", r, "--baseline", r],
            "generate": ["generate", "--weights", w, "--conds", r],
            "evaluate": ["evaluate", "--synthetic", "--synthetic-days", "4",
                         "--synthetic-size", "32", "--weights", w,
                         "--no-plots", "--workdir", str(tmp_path)],
            "serve": ["serve", "--weights", w, "--socket",
                      str(tmp_path / "s")]}[cmd] + ["--device", "cpu",
                                                    "--dp", "2"]
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert (f"torchrun --standalone --nproc-per-node 2 -m "
            f"prdisagg_torch.cli {' '.join(argv)}") in str(e.value.code)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("window", ["0", "5"], ids=["sequential", "batched"])
def test_serve_dp_world2_answers_through_its_follower(tmp_path, window):
    """cli serve --dp 2 under a launched world of 2: rank 0 owns the
    socket, rank 1 joins each forward; a map, a reload and a stack request
    answer as the single-process generator from the same seed does (the
    same latents; within 1e-6 of max(cond), forwards of another batch
    size), sequentially or through the micro-batcher; rank 0's stop ends
    rank 1 after it joined the three calls."""
    from prdisagg_torch.api.server import request, scenarios_array

    torch.manual_seed(0)
    gen = PretrainedGenerator(Generator(TC).state_dict(), TC, device="cpu")
    w = str(tmp_path / "w.npz")
    gen.save_npz(w)
    sock = str(tmp_path / "s.sock")
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), PYTHONPATH=PYTHONPATH,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "prdisagg_torch.cli", "serve", "--device",
             "cpu", "--dp", str(WORLD), "--weights", w, "--socket", sock,
             "--seed", "5", "--warm", "4", "--max-requests", "3",
             "--batch-window-ms", window],
            cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    rng = np.random.RandomState(1)
    cond = rng.gamma(2.0, 5.0, (16, 16)).astype("f4")
    stack = rng.gamma(2.0, 5.0, (3, 16, 16)).astype("f4")
    try:
        deadline = time.time() + 120
        while not os.path.exists(sock):
            assert time.time() < deadline and procs[0].poll() is None, (
                procs[0].communicate()[0][-3000:])
            time.sleep(0.1)
        one = request(sock, {"cond": cond.tolist(), "n_scenarios": 5,
                             "encoding": "b64"})
        reload = request(sock, {"cmd": "reload", "weights": w})
        many = request(sock, {"cond": stack.tolist(), "n_scenarios": 2,
                              "encoding": "b64"})
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "served 3 requests" in outs[0]
    assert "rank 1 joined 3 calls" in outs[1]
    assert reload["ok"], reload
    ref = PretrainedGenerator.from_npz(w, seed=5, device="cpu")
    if window == "0":
        want_one = ref.generate_scenarios(cond, 5)
        want_many = ref.generate_scenarios_batch(stack, 2)
    else:
        (want_one,) = ref.generate_scenarios_multi([cond], [5])
        want_many = np.stack(ref.generate_scenarios_multi(list(stack),
                                                          [2, 2, 2]))
    np.testing.assert_allclose(scenarios_array(one), want_one, rtol=0,
                               atol=1e-6 * cond.max())
    np.testing.assert_allclose(scenarios_array(many), want_many, rtol=0,
                               atol=1e-6 * stack.max())


@pytest.mark.parametrize("mesh_size,n_data_devices", [(None, 2), (2, 4)])
def test_trainer_refuses_a_world_of_another_size(setup, tmp_path, mesh_size,
                                                 n_data_devices):
    """TrainConfig.n_data_devices, when set, must be the run's world size
    (1 without a mesh); the Trainer refuses before it makes any state."""
    from prdisagg_torch.train.loop import Trainer

    _, _, ds = setup
    exp = tcfg.ExperimentConfig(
        train=tcfg.TrainConfig(n_data_devices=n_data_devices),
        model_override=TC)
    mesh = None if mesh_size is None else DataMesh(rank=0, size=mesh_size)
    with pytest.raises(ValueError, match=f"n_data_devices is "
                                         f"{n_data_devices}"):
        Trainer(exp, ds, str(tmp_path), mesh=mesh)
    assert not os.listdir(tmp_path)
