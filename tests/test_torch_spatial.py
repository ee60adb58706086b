"""The port's spatial (y-halo) sharding (prdisagg_torch/parallel/spatial.py,
the generator's and critic's spatial path, the (data, spatial) train
step) and the fused generator forward, on the CPU.

The partition rule and the halo plans are pure functions of (rank, size),
checked rank by rank in this process.  The exchanges run over gloo in ONE
launch of a 4-process world: a worker script in tmp_path (torch and the
port only, never JAX) runs the 64x64 nets at JAX's test widths (8) with
y split 4 ways (the world as one spatial axis) and 2 ways (the spatial
axis of a 2 x 2 grid), the data 2 x spatial 2 step, default and fused,
and the fused step over a data-parallel mesh of 4.  The references are
computed here on the same weights and inputs: JAX's replicated and 4-way
sharded forward; the port's single-process step (dropout on); and, at
dropout 0, JAX's step with optax, against which every gradient that
reaches an update is held too, with two planted faults that the check
must catch.  All steps start from mid-training Adam moments.
"""

import concurrent.futures
import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_parallel as ttp  # noqa: E402
import test_torch_train as ttt  # noqa: E402
from prdisagg_torch.core import config as tcfg  # noqa: E402
from prdisagg_torch.data.sampler import DeviceDataset  # noqa: E402
from prdisagg_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from prdisagg_torch.models.critic import Critic  # noqa: E402
from prdisagg_torch.models.generator import Generator  # noqa: E402
from prdisagg_torch.models.io import (  # noqa: E402
    critic_params_from_jax,
    params_from_jax,
)
from prdisagg_torch.parallel import spatial  # noqa: E402
from prdisagg_torch.parallel.mesh import DataMesh  # noqa: E402
from prdisagg_torch.train import wgan_gp as twgan  # noqa: E402
from prdisagg_torch.train.state import create_train_state  # noqa: E402
from prdisagg_tpu.core import config as jcfg  # noqa: E402
from prdisagg_tpu.models import Critic as JaxCritic  # noqa: E402
from prdisagg_tpu.models import Generator as JaxGenerator  # noqa: E402
from prdisagg_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402

WORLD = 4
ND, B, N_DISC = 64, 4, 2
WIDTHS = dict(ndomain=ND, latent_dim=8, gen_channels=(8, 8, 8),
              base_channels=8, critic_channels=(8, 8, 8, 8))
TOL = 1e-4  # losses of their scale, parameters of max|p|
# a gradient against JAX's, of its parameter's largest: the generator
# update's reaches through n_disc updated critics and long f32 sums at
# 64x64, where the port's single-process step differs from JAX's by up to
# 8.6e-4 (latent_proj.weight); a gradient counted twice differs by 1
GRAD_RTOL = 2e-3


def _cfgs(**kw):
    """(JAX ModelConfig, port ModelConfig) at JAX's spatial test widths,
    float32."""
    kw = dict(WIDTHS, compute_dtype="float32", **kw)
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


# --------------------------------------------------------------------------
# the partition rule and the halo plans: pure functions of (rank, size)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,size,want", [
    (31, 2, [(0, 16), (16, 31)]),
    (31, 4, [(0, 8), (8, 16), (16, 24), (24, 31)]),
    (16, 4, [(0, 4), (4, 8), (8, 12), (12, 16)]),
    (7, 4, [(0, 2), (2, 4), (4, 6), (6, 7)]),
])
def test_row_bounds_is_xlas_uneven_split(n, size, want):
    """ceil(n/P) rows a rank, the last one short: the split that pads every
    slab to one all_gather shape."""
    assert [spatial.row_bounds(n, r, size) for r in range(size)] == want
    mesh = DataMesh(rank=size - 1, size=size, axis="spatial")
    assert spatial.own_rows(n, mesh) == want[-1]


def test_too_small_to_shard_and_empty_ranks():
    """JAX's rule: y < P stays replicated (all rows on every rank); a split
    that would leave a rank no rows is refused."""
    mesh = DataMesh(rank=1, size=4, axis="spatial")
    assert not spatial.is_sharded(2, mesh) and spatial.own_rows(2, mesh) == (
        0, 2)
    assert not spatial.is_sharded(64, DataMesh(rank=0, size=1))
    assert not spatial.is_sharded(64, None)
    with pytest.raises(ValueError, match="leave rank 2 none"):
        spatial.own_rows(4, DataMesh(rank=0, size=3, axis="spatial"))


def test_halo_plans_of_the_64x64_critic_and_generator():
    """Halos come from the partitions of input and output: at 64x64 and
    P 4, stage 1 of the critic (31 -> 16 rows, pads (1, 1)) needs one row
    from the rank above, stage 2 (16 -> 8, pads (0, 1)) one from the rank
    below, and a generator stage one on each side; a halo that would reach
    past the neighbour is refused."""
    def critic_need(n_out, lo_pad, size):
        def need(r):
            c, d = spatial.row_bounds(n_out, r, size)
            return 2 * c - lo_pad, 2 * d + 1 - lo_pad
        return need

    plans = [spatial.halo_plan(31, DataMesh(rank=r, size=4), critic_need(
        16, 1, 4), 3) for r in range(4)]
    assert [(p.a, p.b) for p in plans] == [(-1, 8), (7, 16), (15, 24),
                                           (23, 32)]
    assert (plans[0].dn, plans[0].up) == (0, 1)
    plans = [spatial.halo_plan(16, DataMesh(rank=r, size=4), critic_need(
        8, 0, 4), 3) for r in range(4)]
    assert [(p.a, p.b) for p in plans] == [(0, 5), (4, 9), (8, 13), (12, 17)]
    assert (plans[0].dn, plans[0].up) == (1, 0)

    def gen_need(r):
        c, d = spatial.row_bounds(32, r, 4)
        return (c - 1) // 2, d // 2 + 1

    plan = spatial.halo_plan(16, DataMesh(rank=2, size=4), gen_need, 2)
    assert (plan.a, plan.b, plan.dn, plan.up) == (7, 13, 1, 1)
    with pytest.raises(ValueError, match="reaches past the rank below"):
        spatial.halo_plan(8, DataMesh(rank=0, size=4),
                          lambda r: (2 * r, 2 * r + 5), 2)


def test_nets_name_their_partial_gradients():
    """The parameters summed over the spatial axis: those of the stages
    whose output rows are split and the score's weight; not the latent
    projection, the score's bias, nor a stage too small to shard (at 16x16
    and P 4 the critic's last two stages, y 2 and 1)."""
    for nd, want_c in ((64, 4), (16, 2)):
        tc = tcfg.ModelConfig(**dict(WIDTHS, ndomain=nd,
                                     spatial_axis="spatial"))
        with spatial.use_mesh(DataMesh(rank=0, size=4, axis="spatial")):
            g = Generator(tc).spatial_partial_params()
            c = Critic(tc).spatial_partial_params()
        assert "latent_proj.weight" not in g and "head.weight" in g
        assert {f"conv{i}.weight" for i in range(3)} <= g
        assert "score.bias" not in c
        assert ({f"conv{i}.weight" for i in range(want_c)}
                == {k for k in c if k.endswith("weight")} - {"score.weight"})
        assert ("score.weight" in c) == (want_c == 4)
    with pytest.raises(RuntimeError, match="use_mesh"):
        Generator(tc).spatial_partial_params()


# --------------------------------------------------------------------------
# the fused generator forward, in this process
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    data, idx, _ = make_synthetic_dataset(n_days=4, ny=32, nx=32, seed=6)
    ds = DeviceDataset.from_numpy(data, idx, tcfg.DataConfig(), device="cpu")
    return ds, tcfg.smoke_model_config(compute_dtype="float32")


def _warm_state(mc, cfg, seed=0):
    """A state with mid-training Adam moments (chip_smoke's _warm_adam)."""
    state = create_train_state(mc, cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 6)
    for opt in (state.gen_opt, state.critic_opt):
        for p in [p for grp in opt.param_groups for p in grp["params"]]:
            opt.state[p] = {"step": torch.tensor(1.0),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": 1e-2 * (1.0 + torch.rand(
                                p.shape, generator=g))}
    return state


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_fused_gen_forward_matches_default(small, dropout):
    """One (n_disc+1)*B generator forward with its graph kept, the gradient
    run after the critic updates: the default step's metrics within JAX's
    rtol 2e-4 (tests/test_train_step.py), its parameters within 2e-5, the
    critic's bit for bit: at these shapes the CPU's GEMM gives the 12
    held-over rows the same bits in a batch of 16, so the critic updates
    read the same fakes (on the card cuBLAS does not, chip_smoke.py's
    ``fakes_by_layer``)."""
    ds, mc = small
    mc = dataclasses.replace(mc, dropout_rate=dropout)
    cfg = tcfg.TrainConfig(n_disc=3, seed=7)
    out = []
    for fused in (False, True):
        state = _warm_state(mc, cfg)
        draws = twgan.draw_step_inputs(state, ds, 4, cfg.n_disc)
        m = twgan.unpack_metrics(twgan.train_step_on(
            state, ds, draws, cfg, fused_gen_forward=fused)["packed"])
        out.append((m, state))
    (ma, sa), (mb, sb) = out
    for k in twgan.METRIC_KEYS:
        np.testing.assert_allclose(mb[k], ma[k], rtol=2e-4, err_msg=k)
    for a, b in zip(sa.gen.parameters(), sb.gen.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=2e-5)
    for a, b in zip(sa.critic.parameters(), sb.critic.parameters()):
        assert torch.equal(a, b)


def test_fused_gen_forward_through_make_train_step(small):
    """The step function with fused_gen_forward: two calls of two steps
    each, against the same four default steps."""
    ds, mc = small
    cfg = tcfg.TrainConfig(n_disc=2, seed=3)
    res = []
    for fused in (False, True):
        state = _warm_state(mc, cfg, seed=2)
        step = twgan.make_train_step(mc, cfg, 4, steps_per_call=2,
                                     fused_gen_forward=fused)
        for _ in range(2):
            _, m = step(state, ds)
        res.append((twgan.unpack_metrics(m["packed"]), state))
    assert res[0][1].step == res[1][1].step == 4
    for k in twgan.METRIC_KEYS:
        np.testing.assert_allclose(res[1][0][k], res[0][0][k], rtol=2e-4,
                                   err_msg=k)


def test_fused_gen_forward_and_hoisted_chunks_are_mutually_exclusive(small):
    ds, mc = small
    cfg = tcfg.TrainConfig(n_disc=2, hoisted_chunks=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        twgan.make_train_step(mc, cfg, 4, fused_gen_forward=True)
    state = create_train_state(mc, cfg, device="cpu")
    draws = twgan.draw_step_inputs(state, ds, 4, 2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        twgan.train_step_on(state, ds, draws, cfg, chunks=2,
                            fused_gen_forward=True)
    # the cap's automatic chunking counts too
    cfg = tcfg.TrainConfig(n_disc=2, hoisted_chunk_samples=4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        twgan.make_train_step(mc, cfg, 4, fused_gen_forward=True)


# --------------------------------------------------------------------------
# the exchanges over gloo: one 4-process run of the worker below
# --------------------------------------------------------------------------

WORKER = textwrap.dedent('''
    import dataclasses, os, sys
    import torch
    torch.set_num_threads(1)
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.models.critic import Critic
    from prdisagg_torch.models.generator import Generator
    from prdisagg_torch.parallel import spatial
    from prdisagg_torch.parallel.distributed import initialize_multihost
    from prdisagg_torch.parallel.mesh import make_mesh, make_mesh_2d
    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.state import create_train_state

    spec = torch.load(sys.argv[1], weights_only=False)
    assert "jax" not in sys.modules
    assert initialize_multihost(device="cpu")
    world = int(os.environ["WORLD_SIZE"])
    line = make_mesh(world, device="cpu", axis="spatial")
    grid = make_mesh_2d(2, world // 2, device="cpu")
    sp_cfg = dataclasses.replace(spec["tc"], spatial_axis="spatial")
    gen, critic = Generator(sp_cfg), Critic(sp_cfg)
    gen.load_state_dict(spec["gen"])
    critic.load_state_dict(spec["critic"])
    f = spec["fwd"]
    out = {"rank": line.rank}
    for name, mesh in (("p4", line), ("p2", grid)):
        with torch.no_grad(), spatial.use_mesh(mesh):
            rows = gen(f["latent"], f["cond"])
            sample = spatial.shard_rows(f["sample"], 2, mesh.axis_mesh(
                "spatial"))
            out[name] = {"rows": rows, "full": gen.assemble(rows),
                         "scores": critic(sample, f["cond"])}
    ds = DeviceDataset.from_numpy(*spec["data"], device="cpu")
    s, j = spec["step"], spec["jax"]
    sp0 = dataclasses.replace(j["tc"], spatial_axis="spatial")
    dp = make_mesh(world, device="cpu")
    sum_partial_grads = spatial.sum_partial_grads
    for name, fused, mesh, cfg, job, fault in (
            ("step", False, grid, sp_cfg, s, None),
            ("step_fused", True, grid, sp_cfg, s, None),
            ("step_fused_dp", True, dp, spec["tc"], s, None),
            ("jax_step", False, grid, sp0, j, None),
            ("jax_step_fused", True, grid, sp0, j, None),
            ("fault_replicated", False, grid, sp0, j, "replicated"),
            ("fault_unsummed", False, grid, sp0, j, "unsummed")):
        state = create_train_state(cfg, job["cfg"], device="cpu")
        state.gen.load_state_dict(spec["gen"])
        state.critic.load_state_dict(spec["critic"])
        grads = {"gen": [], "critic": []}
        for opt, net in ((state.gen_opt, "gen"),
                         (state.critic_opt, "critic")):
            named = list(getattr(state, net).named_parameters())
            for n, p in named:
                opt.state[p] = {"step": torch.tensor(1.0),
                                "exp_avg": torch.zeros_like(p),
                                "exp_avg_sq": spec["nu"][net][n].clone()}
            # the gradients that reach each update (_hooked_grads)
            opt.register_step_pre_hook(
                lambda o, a, k, named=named, log=grads[net]: log.append(
                    {n: p.grad.clone() for n, p in named}))
        if fault == "replicated":  # the latent projection summed over P
            partial = state.gen.spatial_partial_params
            state.gen.spatial_partial_params = (
                lambda: partial() | {"latent_proj.weight"})
        elif fault == "unsummed":  # each rank updates with its share
            spatial.sum_partial_grads = lambda g, *a: list(g)
        spatial.exchanges.clear()
        try:
            m = wgan_gp.train_step_on(state, ds, job["draws"], job["cfg"],
                                      mesh=mesh, fused_gen_forward=fused)
        finally:
            spatial.sum_partial_grads = sum_partial_grads
        out[name] = {net: {k: v.clone() for k, v in
                           getattr(state, net).state_dict().items()}
                     for net in ("gen", "critic")}
        out[name].update({"packed": m["packed"], "grads": grads,
                          "exchanges": dict(spatial.exchanges)})
    try:
        state = create_train_state(sp_cfg, s["cfg"], device="cpu")
        wgan_gp.make_train_step(sp_cfg, s["cfg"], 4, mesh=grid)(state, ds)
        out["eager_cpu_step"] = True
    except Exception as e:  # noqa: BLE001
        out["eager_cpu_step"] = repr(e)
    torch.save(out, sys.argv[2] + f"/rank{line.rank}.pt")
    torch.distributed.destroy_process_group()
    print("WORKER_OK", line.rank, flush=True)
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spec (weights, inputs, draws), the references, and each rank's
    outputs of one 4-process gloo run of WORKER."""
    tmp = tmp_path_factory.mktemp("spatial")
    jc, tc = _cfgs()
    gp, cp = ttt._nets(tc, seed=40)
    rng = np.random.RandomState(1)
    lat = rng.randn(B, 8).astype("f4")
    cond = rng.rand(B, ND, ND, 1).astype("f4")
    jgen, jcrit = JaxGenerator(jc), JaxCritic(jc)
    ref = np.asarray(jax.jit(jgen.apply)(gp, lat, cond))
    ref_scores = np.asarray(jax.jit(jcrit.apply)(cp, ref, cond))
    # JAX's own 4-way spatial forward (tests/test_parallel.py)
    js = dataclasses.replace(jc, spatial_axis="spatial")
    with jax.sharding.set_mesh(jax_make_mesh(4, axis="spatial")):
        sharded = np.asarray(jax.jit(JaxGenerator(js).apply)(gp, lat, cond))
        sharded_scores = np.asarray(jax.jit(JaxCritic(js).apply)(
            cp, jnp.asarray(ref), cond))

    data, idx, dcfg = make_synthetic_dataset(
        n_days=3, ny=96, nx=96, seed=11,
        cfg=tcfg.DataConfig(ndomain=ND, n_thresh=40))
    cfg = tcfg.TrainConfig(n_disc=N_DISC, seed=5)
    # mid-training Adam moments, in optax's state and in the port's
    jc0, tc0 = _cfgs(dropout_rate=0.0)
    tx = ttt._jax_step_fns(jc0)[3]
    c_opt, g_opt = ttt._warm_adam(tx, cp, 1), ttt._warm_adam(tx, gp, 2)
    nu = {"gen": params_from_jax(ttt._np(g_opt[0].nu)),
          "critic": critic_params_from_jax(ttt._np(c_opt[0].nu))}
    ds = DeviceDataset.from_numpy(data, idx, dcfg, device="cpu")
    state = create_train_state(tc, cfg, device="cpu")
    draws = twgan.draw_step_inputs(state, ds, B, N_DISC)
    # numpy draws for JAX's step at dropout 0 (tests/test_torch_train.py)
    dr = ttt._draws(jc0, idx, B, N_DISC, seed=7)
    spec = {"tc": tc, "gen": params_from_jax(ttt._np(gp)),
            "critic": critic_params_from_jax(ttt._np(cp)),
            "fwd": {"latent": torch.tensor(lat), "cond": torch.tensor(cond),
                    "sample": torch.tensor(ref)},
            "data": (data, idx, dcfg), "nu": nu,
            "step": {"cfg": cfg, "draws": draws},
            "jax": {"tc": tc0, "cfg": cfg, "draws": twgan.StepDraws(
                real_rows=torch.tensor(dr["real_rows"]),
                latent=torch.tensor(dr["latent"]),
                eps=torch.tensor(dr["eps"]), masks=[None] * N_DISC,
                gp_masks=[None] * N_DISC,
                gen_latent=torch.tensor(dr["gen_latent"]),
                gen_rows=torch.tensor(dr["gen_rows"]), gen_masks=None)}}
    torch.save(spec, tmp / "spec.pt")
    (tmp / "worker.py").write_text(WORKER)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        launch = pool.submit(ttp._launch, [str(tmp / "worker.py"),
                                           str(tmp / "spec.pt"), str(tmp)],
                             world=WORLD, timeout=240)
        # JAX's step while the workers run
        jax_grads = []
        jds = ttt.JaxDataset.from_numpy(data, idx, jcfg.DataConfig(
            ndomain=ND, n_thresh=40))
        jax_step = ttt._jax_full_step(jc0, gp, cp, jds, dr, N_DISC, B,
                                      c_opt, g_opt, jax_grads)
        res = launch.result()
    for rc, log in res:
        assert rc == 0 and "WORKER_OK" in log, log[-3000:]
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return dict(spec=spec, ref=ref, ref_scores=ref_scores, sharded=sharded,
                sharded_scores=sharded_scores, outs=outs, ds=ds,
                jax_step=jax_step, jax_grads=jax_grads)


@pytest.mark.parametrize("p", ["p2", "p4"])
def test_spatial_forward_matches_jax(world, p):
    """Each rank's rows, and the assembled fractions, against JAX's
    replicated forward and its own 4-way sharded one on the same weights
    (atol 1e-5); the critic's scores on the rank's rows (rtol 1e-4, atol
    1e-5 of the largest)."""
    size = 4 if p == "p4" else 2
    for rank, out in enumerate(world["outs"]):
        o = out[p]
        srank = rank % size
        lo, hi = spatial.row_bounds(ND, srank, size)
        for want in (world["ref"], world["sharded"]):
            np.testing.assert_allclose(o["rows"].numpy(), want[:, :, lo:hi],
                                       atol=1e-5)
            np.testing.assert_allclose(o["full"].numpy(), want, atol=1e-5)
        for want in (world["ref_scores"], world["sharded_scores"]):
            np.testing.assert_allclose(o["scores"].numpy(), want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("job", ["step", "step_fused", "step_fused_dp"])
def test_2d_step_matches_single_process(world, job):
    """The data 2 x spatial 2 f32 step, default and fused, and the fused
    step on a data-parallel mesh of 4 (dropout on, mid-training Adam
    moments), against the port's single-process default step on the same
    global draws: the losses within 1e-4 of their scale, every parameter,
    one by one, within 1e-4 of max|p|, and every gradient that reaches an
    update within 1e-4 of its parameter's largest plus 1e-5 of the
    update's, on every rank; on the grid the halo exchanges and the spatial
    gradient sums ran."""
    spec = world["spec"]
    state = create_train_state(spec["tc"], spec["step"]["cfg"], device="cpu")
    state.gen.load_state_dict(spec["gen"])
    state.critic.load_state_dict(spec["critic"])
    for opt, net in ((state.gen_opt, "gen"), (state.critic_opt, "critic")):
        ttt._load_adam(opt, getattr(state, net), spec["nu"][net])
    grads = _hooked_grads(state)
    want = twgan.unpack_metrics(twgan.train_step_on(
        state, world["ds"], spec["step"]["draws"], spec["step"]["cfg"])[
        "packed"])
    losses = ("d_loss", "gp", "w_distance", "g_loss")
    scale = max(abs(want[k]) for k in losses)
    for out in world["outs"]:
        o = out[job]
        got = twgan.unpack_metrics(o["packed"])
        for k in losses:
            assert abs(got[k] - want[k]) <= TOL * scale, (k, got, want)
        for k in ("d_grad_norm", "g_grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
        for net in ("gen", "critic"):
            ref = getattr(state, net).state_dict()
            pmax = max(v.abs().max().item() for v in ref.values())
            for name, v in ref.items():
                err = (o[net][name] - v).abs().max().item()
                assert err <= TOL * pmax, (net, name, err, pmax)
            assert len(o["grads"][net]) == len(grads[net])
            for i, (g, w) in enumerate(zip(o["grads"][net], grads[net])):
                gmax = max(x.abs().max().item() for x in w.values())
                for name, x in w.items():
                    err = (g[name] - x).abs().max().item()
                    assert err <= TOL * x.abs().max().item() + 1e-5 * gmax, (
                        net, i, name, err)
        if job == "step_fused_dp":
            assert not o["exchanges"]
        else:
            assert min(o["exchanges"][k] for k in (
                "halo", "halo_adjoint", "grads")) > 0


def _hooked_grads(state) -> dict:
    """The gradients that reach each update of `state`'s optimizers, by
    net, one {name: gradient} per update, as the steps run."""
    grads = {"gen": [], "critic": []}
    for opt, net in ((state.gen_opt, "gen"), (state.critic_opt, "critic")):
        named = list(getattr(state, net).named_parameters())
        opt.register_step_pre_hook(
            lambda o, a, k, named=named, log=grads[net]: log.append(
                {n: p.grad.clone() for n, p in named}))
    return grads


def _jax_step_readings(o, world) -> dict:
    """A step's distance from JAX's step on the same draws, each over its
    tolerance (at most 1 within it): every gradient that reached an update,
    within GRAD_RTOL of its parameter's largest plus 1e-5 of the update's
    largest (some are zero analytically: the head's bias); the parameters
    after the step within rtol 1e-4, atol 1e-7 (as
    tests/test_torch_train.py test_full_step_matches_jax_and_optax)."""
    jgp, jcp, _, _ = world["jax_step"]
    want_grads = ([critic_params_from_jax(ttt._np(g))
                   for g in world["jax_grads"][:-1]]
                  + [params_from_jax(ttt._np(world["jax_grads"][-1]))])
    got_grads = o["grads"]["critic"] + o["grads"]["gen"]
    assert len(got_grads) == len(want_grads) == N_DISC + 1
    grad, param, worst = 0.0, 0.0, None
    for i, (want, got) in enumerate(zip(want_grads, got_grads)):
        scale = max(w.abs().max().item() for w in want.values())
        for k, w in want.items():
            tol = GRAD_RTOL * w.abs().max().item() + 1e-5 * scale
            e = (got[k] - w).abs().max().item() / tol
            if e > grad:
                grad, worst = e, f"update {i} {k}"
    over_max = 0.0
    for net, want in (("gen", params_from_jax(ttt._np(jgp))),
                      ("critic", critic_params_from_jax(ttt._np(jcp)))):
        pmax = max(w.abs().max().item() for w in want.values())
        for k, w in want.items():
            tol = 1e-4 * w.abs() + 1e-7
            param = max(param, ((o[net][k] - w).abs() / tol).max().item())
            over_max = max(over_max, (o[net][k] - w).abs().max().item()
                           / pmax)
    return {"grad_err_over_tol": grad, "worst": worst,
            "param_err_over_tol": param, "param_err_over_max": over_max}


@pytest.mark.parametrize("job", ["jax_step", "jax_step_fused"])
def test_2d_step_matches_jax_at_dropout_0(world, job):
    """The data 2 x spatial 2 f32 step, default and fused, at dropout 0
    against the JAX package's step (tests/test_torch_train.py
    _jax_full_step, its modules and optax.adam) on the same draws and
    mid-training Adam state: on every rank, every gradient that reaches an
    update, parameter by parameter, and every parameter after the step.
    The gradients are held, not only the parameters: where g^2 outgrows
    Adam's second moment the update tends to lr * sign(g), under which a
    gradient counted twice moves a parameter hardly further.  The port's
    single-process step on the same draws is held to the same bounds."""
    spec = world["spec"]
    j = spec["jax"]
    state = create_train_state(j["tc"], j["cfg"], device="cpu")
    state.gen.load_state_dict(spec["gen"])
    state.critic.load_state_dict(spec["critic"])
    for opt, net in ((state.gen_opt, "gen"), (state.critic_opt, "critic")):
        ttt._load_adam(opt, getattr(state, net), spec["nu"][net])
    grads = _hooked_grads(state)
    twgan.train_step_on(state, world["ds"], j["draws"], j["cfg"],
                        fused_gen_forward=job == "jax_step_fused")
    single = {"gen": state.gen.state_dict(),
              "critic": state.critic.state_dict(), "grads": grads}
    for name, o in [("single process", single)] + [
            (f"rank {out['rank']}", out[job]) for out in world["outs"]]:
        r = _jax_step_readings(o, world)
        print(job, name, r)
        assert r["grad_err_over_tol"] <= 1 and r["param_err_over_tol"] <= 1, (
            name, r)


@pytest.mark.parametrize("fault", ["fault_replicated", "fault_unsummed"])
def test_2d_step_check_catches_a_planted_fault(world, fault):
    """The gradient check above fails on every rank when a fault is planted
    in the grid step: the latent projection's gradient, whole on every
    rank, summed over the spatial axis (counted P = 2 times), or the
    spatial sum of the split stages' gradients skipped (each rank updates
    with its share)."""
    for out in world["outs"]:
        r = _jax_step_readings(out[fault], world)
        print(fault, "rank", out["rank"], r)
        assert r["grad_err_over_tol"] > 1, r


def test_graphless_cpu_step_runs_on_the_grid(world):
    """make_train_step over the (data, spatial) grid runs eagerly on the
    CPU."""
    assert all(out["eager_cpu_step"] is True for out in world["outs"])
