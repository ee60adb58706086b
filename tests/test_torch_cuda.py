"""The port's CUDA kernels (and K1's gradient) against their plain PyTorch
versions, on the card.

These tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode), so
they skip elsewhere.  On a machine with a card, from the repository root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest imports JAX, which the port
does not need.)  The shapes here are the awkward ones — channel counts that
are not multiples of the kernel's tiles, rows that end mid-tile, single
voxels, patches at the tensor's last row and column, x offsets that rule out
16-byte loads; the flagship shapes are checked by chip_smoke.py.  Each K1
test asserts, through ``launches_by_variant``, which kernel variant ran.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


SHAPES = [
    (2, 3, 2, 2, 16, 4),     # Cin < 32, Cout < 64
    (3, 5, 3, 7, 40, 70),    # odd extents, Cin and Cout off the tiles
    (1, 1, 1, 1, 1, 1),      # one voxel, one channel
    (5, 6, 4, 4, 256, 128),  # flagship stage-1 widths, small batch
]
# the fast kernels' edge cases, each with the tile k1_plan gives it
FAST_EDGES = [
    ((3, 3, 2, 2, 256, 256), (64, 64)),     # stage 0 at B 3: M = 36 < 64
    ((4, 12, 8, 8, 128, 64), (128, 64)),    # Cout 64, as at stage 2
    ((16, 6, 4, 4, 64, 192), (128, 64)),    # Cin 64, Cout 192
    ((1, 12, 32, 32, 128, 64), (128, 64)),  # the 64x64 last stage at B 1
    ((33, 6, 4, 4, 256, 128), (128, 128)),  # rows end mid-tile
]
DTYPE_TOLS = [("float32", 1e-4, 1e-5), ("bfloat16", 2e-2, 2e-2)]


def _check_forward(cuda, shape, dtype, rtol, atol):
    """One launch of the kernel against the plain version; returns the
    variant that ran."""
    from prdisagg_torch.ops import upsample_conv
    from prdisagg_torch.ops.core import full_f32

    b, d, h, w, cin, cout = shape
    rng = np.random.RandomState(sum(shape))
    dt = getattr(torch, dtype)
    x = torch.tensor(rng.randn(b, d, h, w, cin).astype("f4"), device=cuda)
    k = torch.tensor(0.1 * rng.randn(3, 3, 3, cin, cout).astype("f4"),
                     device=cuda)
    bias = torch.tensor(rng.randn(cout).astype("f4"), device=cuda)
    before = upsample_conv.launches
    by_variant = dict(upsample_conv.launches_by_variant)
    with torch.inference_mode(), full_f32():
        got = upsample_conv.upsample2_conv3(x.to(dt), k, bias)
        want = upsample_conv.upsample2_conv3_reference(x.to(dt), k, bias)
    torch.cuda.synchronize()
    assert upsample_conv.launches == before + 1
    ran = [v for v, n in upsample_conv.launches_by_variant.items()
           if n != by_variant[v]]
    assert len(ran) == 1
    assert got.shape == (b, 2 * d, 2 * h, 2 * w, cout) and got.dtype == dt
    scale = want.float().abs().max().item()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=rtol, atol=atol * scale)
    return ran[0]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,rtol,atol", DTYPE_TOLS)
def test_upsample2_conv3_kernel_matches_plain(cuda, shape, dtype, rtol, atol):
    from prdisagg_torch.ops import upsample_conv

    # the odd widths take the general kernel, flagship widths the fast one
    want = "fast" if shape[-2:] == (256, 128) else "general"
    assert upsample_conv.k1_plan(getattr(torch, dtype), *shape).variant == want
    assert _check_forward(cuda, shape, dtype, rtol, atol) == want


@pytest.mark.parametrize("shape,tile", FAST_EDGES)
@pytest.mark.parametrize("dtype,rtol,atol", DTYPE_TOLS)
def test_upsample2_conv3_fast_kernel_edge_cases(cuda, shape, tile, dtype,
                                                rtol, atol):
    from prdisagg_torch.ops import upsample_conv

    plan = upsample_conv.k1_plan(getattr(torch, dtype), *shape)
    assert (plan.variant, plan.bm, plan.bn) == ("fast", *tile)
    assert _check_forward(cuda, shape, dtype, rtol, atol) == "fast"


@pytest.mark.parametrize("shape", [(2, 3, 2, 2, 16, 4), (3, 5, 3, 7, 40, 70),
                                   (4, 6, 4, 4, 256, 128)])
@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-4),
                                             ("bfloat16", 2e-2, 2e-2)])
def test_upsample2_conv3_gradients_match_plain(cuda, shape, dtype, rtol, atol):
    """The kernel's autograd.Function against autograd through the plain
    version, on the card: dx, dkernel and dbias."""
    from prdisagg_torch.ops import upsample_conv
    from prdisagg_torch.ops.core import full_f32

    b, d, h, w, cin, cout = shape
    rng = np.random.RandomState(sum(shape))
    dt = getattr(torch, dtype)
    x = torch.tensor(rng.randn(b, d, h, w, cin).astype("f4"),
                     device=cuda).to(dt)
    k = torch.tensor(0.1 * rng.randn(3, 3, 3, cin, cout).astype("f4"),
                     device=cuda)
    bias = torch.tensor(rng.randn(cout).astype("f4"), device=cuda)
    g = torch.tensor(rng.randn(b, 2 * d, 2 * h, 2 * w, cout).astype("f4"),
                     device=cuda).to(dt)
    grads = []
    before = (upsample_conv.launches, upsample_conv.backward_calls)
    with full_f32():
        for fn in (upsample_conv.upsample2_conv3,
                   upsample_conv.upsample2_conv3_reference):
            leaves = [t.detach().requires_grad_(True) for t in (x, k, bias)]
            grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
    torch.cuda.synchronize()
    assert (upsample_conv.launches, upsample_conv.backward_calls) == (
        before[0] + 1, before[1] + 1)
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = want.float().abs().max().item()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=rtol, atol=atol * scale)


def test_upsample2_conv3_kernel_refuses_what_it_cannot_take(cuda):
    from prdisagg_torch.ops import upsample_conv

    x = torch.randn(2, 3, 2, 2, 8, device=cuda)
    k = torch.randn(3, 3, 3, 8, 4, device=cuda)
    bias = torch.zeros(4, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        upsample_conv.upsample2_conv3(x.half(), k, bias)
    kp = torch.zeros(8, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        upsample_conv.upsample2_conv3_cuda(
            x.transpose(1, 2), kp, bias)
    with pytest.raises(ValueError, match="CUDA device"):
        upsample_conv.upsample2_conv3_cuda(x, kp, bias.cpu())
    with pytest.raises(ValueError, match="kp must be"):
        upsample_conv.upsample2_conv3_cuda(
            x, torch.zeros(8, 8, 8, 4, device=cuda), bias)


GATHER_CASES = [  # (D, nh, ny, nx, nd, B)
    (3, 24, 48, 40, 16, 7),      # the flagship patch, 16-byte path
    (2, 1, 21, 19, 16, 5),       # nh = 1, nx not a multiple of 4
    (4, 24, 33, 37, 16, 1),      # B = 1, nx not a multiple of 4
    (3, 5, 17, 23, 5, 9),        # nd not a multiple of 4
    (2, 9, 64, 64, 8, 300),      # a partial hour block, many patches
    (2, 24, 128, 136, 64, 160),  # nd 64: many unrolled passes a block
    (40, 24, 64, 64, 16, 5000),  # a bulk draw
    (6, 1, 48, 48, 16, 32),      # conditions: nh 1 at B 32
]


def _gather_rows(rng, n_days, ny, nx, nd, b):
    """b random rows in range, the first at the last day, row and column,
    the second at an odd x."""
    rows = np.stack([rng.randint(0, n_days, b),
                     rng.randint(0, ny - nd + 1, b),
                     rng.randint(0, nx - nd + 1, b)], 1)
    rows[0] = (n_days - 1, ny - nd, nx - nd)  # the last row and column
    if b > 1:
        rows[1, 2] = 1 + 4 * ((nx - nd) // 8)  # an odd x in any tensor
    return rows


def _check_gather(data, idx, nd):
    """One launch against the plain version, bit for bit."""
    from prdisagg_torch.ops import gather

    before = gather.launches
    got = gather.gather_patches(data, idx, nd)
    want = gather.gather_patches_reference(data, idx, nd)
    torch.cuda.synchronize()
    assert gather.launches == before + 1
    assert got.shape == (idx.shape[0], data.shape[1], nd, nd)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_kernel_equals_plain_exactly(cuda, case):
    from prdisagg_torch.ops import gather

    n_days, nh, ny, nx, nd, b = case
    rng = np.random.RandomState(sum(case))
    data = torch.tensor(rng.rand(n_days, nh, ny, nx).astype("f4"),
                        device=cuda)
    rows = _gather_rows(rng, n_days, ny, nx, nd, b)
    idx = torch.tensor(rows.astype("i4"), device=cuda)
    _check_gather(data, idx, nd)
    got = gather.gather_patches(data, idx, nd).cpu()
    cpu = data.cpu()
    for i, (t, y, x) in enumerate(rows[:64]):
        assert torch.equal(got[i], cpu[t, :, y:y + nd, x:x + nd])


def test_gather_record_cache_follows_its_sources(cuda):
    """Launch records are cached by the source's address and shape: two sources in turn, new contents at one address,
    another shape at that address, and a freed and re-allocated source all
    stay exact."""
    rng = np.random.RandomState(5)
    shape, nd = (3, 24, 48, 48), 16
    sources = [torch.tensor(rng.rand(*shape).astype("f4"), device=cuda)
               for _ in range(2)]
    idx = torch.tensor(_gather_rows(rng, 3, 48, 48, nd, 40).astype("i4"),
                       device=cuda)
    for data in sources + sources:
        _check_gather(data, idx, nd)
    buf = sources[0]
    buf.copy_(torch.from_numpy(rng.rand(*shape).astype("f4")))
    _check_gather(buf, idx, nd)
    other = buf.view(6, 12, 48, 48)  # the same address, another shape
    assert other.data_ptr() == buf.data_ptr()
    rows6 = _gather_rows(rng, 6, 48, 48, nd, 40)
    idx6 = torch.tensor(rows6.astype("i4"), device=cuda)
    _check_gather(other, idx6, nd)
    del sources, buf, other, data
    # the caching allocator hands a freed block out again, most likely at a
    # cached address; the gather must be exact wherever it lands
    again = torch.empty(shape, device=cuda)
    again.copy_(torch.from_numpy(rng.rand(*shape).astype("f4")))
    _check_gather(again, idx, nd)


@pytest.mark.parametrize("why", ["storage offset", "nx % 4", "nd % 4"])
def test_gather_scalar_path_on_odd_shapes(cuda, why):
    """What 16-byte loads cannot take goes to the scalar path, still
    exact."""
    rng = np.random.RandomState(len(why))
    nd, shape = 16, (3, 24, 40, 40)
    if why == "nx % 4":
        shape = (3, 24, 40, 42)
    elif why == "nd % 4":
        nd = 14
    flat = torch.tensor(rng.rand(int(np.prod(shape)) + 1).astype("f4"),
                        device=cuda)
    data = (flat[1:] if why == "storage offset" else flat[:-1]).view(shape)
    assert data.is_contiguous()
    idx = torch.tensor(_gather_rows(rng, 3, shape[2], shape[3], nd,
                                    33).astype("i4"), device=cuda)
    _check_gather(data, idx, nd)


def test_gather_kernel_refuses_what_it_cannot_take(cuda):
    from prdisagg_torch.ops import gather

    data = torch.rand(2, 24, 32, 32, device=cuda)
    idx = torch.zeros(3, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        gather.gather_patches(data, idx.cpu(), 16)
    with pytest.raises(TypeError, match="int32"):
        gather.gather_patches(data, idx.long(), 16)
    with pytest.raises(TypeError, match="float32"):
        gather.gather_patches(data.double(), idx, 16)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_patches(data.transpose(2, 3), idx, 16)
    with pytest.raises(ValueError, match="does not fit"):
        gather.gather_patches(data, idx, 33)


# --------------------------------------------------------------------------
# the train step as a CUDA graph (smoke width, float32)
# --------------------------------------------------------------------------

@pytest.fixture
def graph_setup(cuda):
    import dataclasses

    from prdisagg_torch.core import config as tcfg
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.data.synthetic import make_synthetic_dataset

    data, idx, dcfg = make_synthetic_dataset(n_days=4, ny=32, nx=32, seed=5)
    ds = DeviceDataset.from_numpy(data, idx, dcfg, device=cuda)
    mc = dataclasses.replace(tcfg.smoke_model_config(compute_dtype="float32"),
                             dropout_rate=0.25)
    return ds, mc, tcfg.TrainConfig(n_disc=2)


@pytest.fixture
def drawn(monkeypatch):
    """Every StepDraws the step makes; the one made under capture holds the
    graph's static buffers, which each replay refills."""
    from prdisagg_torch.train import wgan_gp

    made, real = [], wgan_gp.draw_step_inputs

    def recording(*args):
        made.append(real(*args))
        return made[-1]

    monkeypatch.setattr(wgan_gp, "draw_step_inputs", recording)
    return made


DRAW_FIELDS = ("real_rows", "latent", "eps", "gen_latent", "gen_rows")


def _draws_equal(a, b) -> bool:
    masks = zip([*a.masks, *a.gp_masks, a.gen_masks],
                [*b.masks, *b.gp_masks, b.gen_masks])
    return (all(torch.equal(getattr(a, f), getattr(b, f))
                for f in DRAW_FIELDS)
            and all(torch.equal(x, y) for ma, mb in masks
                    for x, y in zip(ma, mb)))


def _max_param_err(a, b) -> float:
    err = 0.0
    for net in ("gen", "critic"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        pmax = max(v.abs().max().item() for v in sb.values())
        err = max(err, max((sa[k] - sb[k]).abs().max().item()
                           for k in sb) / pmax)
    return err


def _warm_adam(state) -> None:
    """Mid-training Adam moments in place (step 1, first moments 0, second
    moments 1e-2 * (1 + U[0, 1))), as the full-step parity test and
    chip_smoke.py's graph check set them: from step 0 Adam's first update
    is about lr * sign(gradient), so a gradient near 0 whose sign differs
    between the graphed and the eager run by rounding moves a parameter by
    2 lr; from these moments the update is linear in the gradient."""
    g = torch.Generator(device=state.device).manual_seed(6)
    with torch.no_grad():
        for opt in (state.gen_opt, state.critic_opt):
            for group in opt.param_groups:
                for p in group["params"]:
                    opt.state[p]["step"].fill_(1.0)
                    opt.state[p]["exp_avg_sq"].copy_(1e-2 * (1.0 + torch.rand(
                        p.shape, generator=g, device=p.device)))


def test_graphed_step_matches_eager_steps(graph_setup, drawn):
    """Each replay draws what the eager step draws from the same generator
    state, bit for bit, and trains to the same parameters (1e-4 of their
    scale) and losses from mid-training Adam moments; the graph holds K1's
    6 launches, 3 backward passes and K2's 2 launches per step."""
    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.state import clone_train_state, \
        create_train_state

    ds, mc, cfg = graph_setup
    state = create_train_state(mc, cfg, device=ds.device)
    _warm_adam(state)
    eager = clone_train_state(state, mc, cfg, ds.device)
    eager.rng.set_state(state.rng.get_state())
    before = dict(wgan_gp.graph_launches)
    step = wgan_gp.make_train_step(mc, cfg, 4)
    for i in range(3):
        _, got = step(state, ds)
        static = drawn[wgan_gp.WARMUP_STEPS]
        ed = wgan_gp.draw_step_inputs(eager, ds, 4, cfg.n_disc)
        drawn.pop()
        assert _draws_equal(ed, static), f"step {i}: draws differ"
        want = wgan_gp.train_step_on(eager, ds, ed, cfg)
        g, w = got["packed"][:-1], want["packed"][:-1]
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    assert state.step == eager.step == 3
    assert torch.equal(state.rng.get_state(), eager.rng.get_state())
    assert _max_param_err(state, eager) <= 1e-4
    grew = {k: n - before.get(k, 0)
            for k, n in wgan_gp.graph_launches.items()}
    assert grew["upsample2_conv3"] == 18 and grew["gather_patches"] == 6
    assert grew["upsample2_conv3_backward"] == 9


def test_graphed_step_matches_eager_step_from_cold_adam(graph_setup, drawn):
    """From Adam's cold start (step 0, zero moments; one critic update a
    step) one replay and one eager step on the same draws see the same
    gradients, within 1e-4 of their scale: beta1 is 0, so each first moment
    is its gradient.  Cold, the update is -lr * g / (|g| + eps), about
    -lr * sign(g): every parameter agrees within 1e-4 of max|p|, except
    where the reference gradient lies within that tolerance of 0, whose
    sign rounding may flip, moving the parameter by at most 2 lr."""
    import dataclasses

    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.state import clone_train_state, \
        create_train_state

    ds, mc, cfg = graph_setup
    cfg = dataclasses.replace(cfg, n_disc=1)
    assert cfg.beta1 == 0.0
    state = create_train_state(mc, cfg, device=ds.device)
    eager = clone_train_state(state, mc, cfg, ds.device)
    eager.rng.set_state(state.rng.get_state())
    _, got = wgan_gp.make_train_step(mc, cfg, 4)(state, ds)
    ed = wgan_gp.draw_step_inputs(eager, ds, 4, cfg.n_disc)
    assert _draws_equal(ed, drawn[wgan_gp.WARMUP_STEPS])
    want = wgan_gp.train_step_on(eager, ds, ed, cfg)
    g, w = got["packed"][:-1], want["packed"][:-1]
    assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    for net in ("gen", "critic"):
        opt_s, opt_e = getattr(state, f"{net}_opt"), getattr(eager,
                                                             f"{net}_opt")
        ps = [p for grp in opt_s.param_groups for p in grp["params"]]
        pe = [p for grp in opt_e.param_groups for p in grp["params"]]
        assert all(int(opt_e.state[p]["step"]) == 1 for p in pe)
        gs = torch.cat([opt_s.state[p]["exp_avg"].reshape(-1) for p in ps])
        ge = torch.cat([opt_e.state[p]["exp_avg"].reshape(-1) for p in pe])
        g_tol = 1e-4 * ge.abs().max().item()
        assert (gs - ge).abs().max().item() <= g_tol, net
        dp = torch.cat([(a.detach() - b.detach()).reshape(-1).abs()
                        for a, b in zip(ps, pe)])
        p_tol = 1e-4 * max(b.detach().abs().max().item() for b in pe)
        near0 = ge.abs() <= g_tol
        assert dp[~near0].max().item() <= p_tol, net
        if near0.any():
            assert dp[near0].max().item() <= 2 * cfg.learning_rate + p_tol


def test_replays_draw_different_rows_and_latents(graph_setup, drawn):
    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.state import create_train_state

    ds, mc, cfg = graph_setup
    state = create_train_state(mc, cfg, device=ds.device)
    step = wgan_gp.make_train_step(mc, cfg, 4)
    step(state, ds)
    static = drawn[wgan_gp.WARMUP_STEPS]
    first = {f: getattr(static, f).clone() for f in DRAW_FIELDS}
    step(state, ds)
    assert len(drawn) == wgan_gp.WARMUP_STEPS + 1  # replays draw in-graph
    for f in DRAW_FIELDS:
        assert not torch.equal(first[f], getattr(static, f)), f


def test_graph_reads_restored_tensors(graph_setup, tmp_path):
    """A checkpoint restored in place is seen by a graph captured before the
    restore and by one captured after it: both then step as the saved
    state steps."""
    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.artifacts import snapshot
    from prdisagg_torch.train.checkpoint import CheckpointManager
    from prdisagg_torch.train.state import create_train_state

    ds, mc, cfg = graph_setup
    mgr = CheckpointManager(str(tmp_path))
    src = create_train_state(mc, cfg, device=ds.device)
    src_step = wgan_gp.make_train_step(mc, cfg, 4)
    src_step(src, ds)
    mgr.save(1, snapshot(src))
    early = create_train_state(mc, cfg, seed=7, device=ds.device)
    early_step = wgan_gp.make_train_step(mc, cfg, 4)
    early_step(early, ds)  # captured before the restore
    ptrs = [p.data_ptr() for p in early.gen.parameters()]
    mgr.restore(early)
    late = create_train_state(mc, cfg, seed=8, device=ds.device)
    mgr.restore(late)
    late_step = wgan_gp.make_train_step(mc, cfg, 4)
    _, want = src_step(src, ds)
    for st, fn in ((early, early_step), (late, late_step)):
        _, got = fn(st, ds)
        assert st.step == 2
        assert torch.allclose(got["packed"], want["packed"], rtol=1e-4,
                              atol=1e-6)
        assert _max_param_err(st, src) <= 1e-4
    assert [p.data_ptr() for p in early.gen.parameters()] == ptrs
    with pytest.raises(ValueError, match="another state"):
        late_step(src, ds)


def test_schedule_change_recaptures(graph_setup, tmp_path, monkeypatch):
    from prdisagg_torch.core import config as tcfg
    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.loop import Trainer

    ds, mc, _ = graph_setup
    graphs = []

    class Recording(wgan_gp._StepGraph):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            graphs.append(self)

    monkeypatch.setattr(wgan_gp, "_StepGraph", Recording)
    exp = tcfg.ExperimentConfig(
        train=tcfg.TrainConfig(n_disc=1, schedule=((1, 2), (1, 4)),
                               log_every_steps=2),
        model_override=mc)
    tr = Trainer(exp, ds, str(tmp_path), steps_per_epoch=2,
                 plot_every_epochs=0, export_format="npz")
    tr.fit(progress=False)
    assert len(graphs) == 2 and tr.state.step == 4
    assert [g.metrics["packed"].shape for g in graphs] == [(8,), (8,)]
    assert all(np.isfinite(v) for v in tr.hist["d_loss"])
    assert tr.ckpt.epochs() == [2]


def test_failing_capture_raises(graph_setup, monkeypatch):
    """A step that syncs with the host cannot be captured: the call raises
    and nothing ran on the state (no eager fallback)."""
    from prdisagg_torch.train import wgan_gp
    from prdisagg_torch.train.state import create_train_state

    ds, mc, cfg = graph_setup
    real = wgan_gp._train_step_on

    def host_sync(*args, **kw):
        m = real(*args, **kw)
        m["packed"].sum().item()
        return m

    monkeypatch.setattr(wgan_gp, "_train_step_on", host_sync)
    state = create_train_state(mc, cfg, device=ds.device)
    before = [p.detach().clone() for p in state.gen.parameters()]
    with pytest.raises(RuntimeError):
        wgan_gp.make_train_step(mc, cfg, 4)(state, ds)
    torch.cuda.synchronize()
    assert state.step == 0
    assert all(torch.equal(a, b) for a, b in
               zip(before, state.gen.parameters()))


# --------------------------------------------------------------------------
# evaluation on the card: contractions in full float32, the flagship
# crps_gan through K1, the Evaluator through K2
# --------------------------------------------------------------------------

@pytest.fixture
def tf32_on():
    """TF32 allowed for every float32 cuBLAS and cuDNN call, as earlier
    code may leave it: the port's contractions must turn it off."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before


@pytest.mark.parametrize("m", [1000, 5000])
def test_crps_on_the_card_in_full_float32(cuda, tf32_on, m):
    """crps_ensemble and crps_ensemble_fixed with TF32 allowed globally
    against the same ensemble in float64 on the CPU, within 1e-5 relative
    per value; the caller's TF32 setting survives."""
    from prdisagg_torch.ops import stats

    rng = np.random.RandomState(m)
    obs = rng.gamma(0.5, 4.0, size=(3, 24, 4, 4)).astype("f4")
    ens = rng.gamma(0.5, 4.0, size=(m, 24, 4, 4)).astype("f4")
    got = stats.crps_ensemble(torch.tensor(obs[0], device=cuda),
                              torch.tensor(ens, device=cuda))
    fixed = stats.crps_ensemble_fixed(torch.tensor(obs, device=cuda),
                                      torch.tensor(ens, device=cuda))
    assert torch.backends.cuda.matmul.allow_tf32
    ens64 = torch.tensor(ens, dtype=torch.float64)
    want = stats.crps_ensemble_fixed(torch.tensor(obs, dtype=torch.float64),
                                     ens64).numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want[0], rtol=1e-5)
    np.testing.assert_allclose(fixed.cpu().numpy(), want, rtol=1e-5)


def test_pairwise_lsd_on_the_card_in_full_float32(cuda, tf32_on):
    """pairwise_lsd with TF32 allowed globally against the per-pair float64
    form, within 2e-5 of the largest distance; the summary's count and
    median equal the full population's on the card."""
    from prdisagg_torch.ops import stats

    rng = np.random.RandomState(3)
    fields = rng.gamma(0.5, 2.0, size=(512, 16, 16)).astype("f4")
    sp = stats.radial_spectra(torch.tensor(fields, device=cuda))
    a, b = sp[:256], sp[256:]  # no pair of one spectrum with itself
    got = stats.pairwise_lsd(a, b).double().cpu()
    la = 10.0 * torch.log10(a.double().cpu())
    lb = 10.0 * torch.log10(b.double().cpu())
    want = torch.sqrt(((la[:, None] - lb[None]) ** 2).sum(-1)) / a.shape[-1]
    scale = want.max().item()
    assert (got - want).abs().max().item() <= 2e-5 * scale
    s = stats.pairwise_lsd_summary(a, b, block=64)
    full = stats.pairwise_lsd_offdiag(a, b, block=64)
    assert s["n_valid"] == len(full) == 256 * 256 - 256
    np.testing.assert_allclose(s["median"], np.median(full), rtol=2e-5)
    np.testing.assert_allclose(s["mean"], full.mean(), rtol=1e-5)


def _flagship_generator(device):
    """A flagship float32 PretrainedGenerator, N(0, 0.02) weights."""
    from prdisagg_torch.api.pretrained import PretrainedGenerator
    from prdisagg_torch.core.config import ModelConfig
    from prdisagg_torch.models.generator import Generator

    torch.manual_seed(0)
    cfg = ModelConfig(compute_dtype="float32")
    return PretrainedGenerator(Generator(cfg).state_dict(), cfg,
                               device=device)


def test_crps_gan_flagship_on_the_card(cuda):
    """crps_gan at 1000 members through K1 (3 fast launches per 500-member
    batch), independent of sample_chunk; one sample's row equals the CPU
    path's on the same latents within 1e-5 relative."""
    from prdisagg_torch.eval import crps
    from prdisagg_torch.ops import upsample_conv

    pg = _flagship_generator(cuda)
    rng = np.random.RandomState(1)
    reals = rng.gamma(0.5, 1.0, size=(3, 24, 16, 16)).astype("f4")
    before = dict(upsample_conv.launches_by_variant)
    out = crps.crps_gan(pg, reals, n_members=1000, sample_chunk=2)
    ran = {v: n - before[v] for v, n in
           upsample_conv.launches_by_variant.items()}
    assert ran == {"fast": 3 * 2 * 3, "general": 0}
    assert out.shape == (3, 24) and np.isfinite(out).all()
    np.testing.assert_array_equal(
        out, crps.crps_gan(pg, reals, n_members=1000, sample_chunk=3))
    cpu = _flagship_generator("cpu")
    lat = rng.randn(8, pg.cfg.latent_dim).astype("f4")
    real = torch.tensor(reals[0])
    rows = []
    for gen, dev in ((pg, cuda), (cpu, "cpu")):
        with torch.inference_mode():
            rows.append(crps._score_one_sample(
                gen._gen, real.to(dev), real.to(dev).sum(0),
                torch.tensor(lat, device=dev), 8, 4, 127.4).cpu().numpy())
    np.testing.assert_allclose(rows[0], rows[1], rtol=1e-5)


def test_evaluator_on_the_card(cuda, tmp_path):
    """Evaluator phases 2 and 5 on a card-resident dataset with plots off:
    K2 draws the rows (one launch per phase-2 chunk, two per phase-5 pair),
    every generated field conserves, the KS p-values are written."""
    from prdisagg_torch.core.config import ExperimentConfig
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.data.synthetic import make_synthetic_dataset
    from prdisagg_torch.eval import Evaluator, daily_cycle_correlation
    from prdisagg_torch.ops import gather

    data, idx, dcfg = make_synthetic_dataset(n_days=4, ny=48, nx=48, seed=2)
    ds = DeviceDataset.from_numpy(data, idx, dcfg, device=cuda)
    ev = Evaluator(ExperimentConfig(data=dcfg), ds, _flagship_generator(cuda),
                   workdir=str(tmp_path))
    before = gather.launches
    res = ev.sample_statistics(n_samples=600, make_plots=False)
    assert gather.launches - before == 2
    assert res["generated_samples"].shape == (600, 24, 16, 16)
    np.testing.assert_allclose(res["amean_fraction_gen"].sum(1), 1.0,
                               rtol=1e-5)
    assert np.isfinite(daily_cycle_correlation(res))
    before = gather.launches
    pvals = ev.conditional_distribution_check(n_pairs=2, n_members=200,
                                              make_plots=False)
    assert gather.launches - before == 4
    assert [p.shape for p in pvals] == [(24,), (24,)]
    assert len([n for n in os.listdir(ev.plotdir) if n.endswith(".txt")]) == 2


# --------------------------------------------------------------------------
# RainFARM and the float16 wire on the card
# --------------------------------------------------------------------------

def test_rainfarm_downscale_card_matches_cpu(cuda, tf32_on):
    """downscale_from_phase (8 members) and downscale_spatial_from_phase
    (ds_factor 4) on the same phases: the card within 1e-5 of the field's
    maximum of the CPU, TF32 allowed globally (the balanced average's
    convolutions must turn it off)."""
    from prdisagg_torch.baselines.rainfarm import core

    rng = np.random.RandomState(4)
    daily = rng.gamma(0.6, 12.0, (16, 16)).astype("f4")
    phase = rng.rand(8, 24, 16, 16).astype("f4")
    field = rng.gamma(2.0, 3.0, (16, 16)).astype("f4")
    sphase = rng.rand(8, 64, 64).astype("f4")
    # (function, daily field, phases, beta or ds_factor)
    for fn, p, ph, arg in ((core.downscale_from_phase, daily, phase, 1.1),
                           (core.downscale_spatial_from_phase, field, sphase,
                            4)):
        want = fn(torch.tensor(p), 1.7, arg, torch.tensor(ph)).numpy()
        got = fn(torch.tensor(p, device=cuda), 1.7, arg,
                 torch.tensor(ph, device=cuda)).cpu().numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_rainfarm_estimators_card_matches_cpu(cuda):
    """The slopes in float64 on the card and on the CPU, within 1e-8
    relative, on gamma fields with zeroed points and an all-zero hour."""
    from prdisagg_torch.baselines.rainfarm import core

    p = np.random.RandomState(5).gamma(0.6, 2.0, (200, 24, 16, 16))
    p[p < 0.4] = 0.0
    p[3, 5] = 0.0
    p = p.astype("f4")
    for name in ("estimate_alpha", "estimate_beta"):
        fn = getattr(core, name)
        want, got = fn(torch.tensor(p)), fn(torch.tensor(p, device=cuda))
        assert abs(got - want) <= 1e-8 * abs(want), (name, got, want)
    field = p[0, 0]
    want = core.estimate_alpha_single(torch.tensor(field))
    got = core.estimate_alpha_single(torch.tensor(field, device=cuda))
    assert abs(got - want) <= 1e-8 * abs(want)


def test_crps_rainfarm_on_the_card_ignores_the_chunk(cuda):
    """crps_rainfarm at 1000 members on the card: two chunk sizes give
    identical rows, finite and >= 0; the first row equals the CPU scorer's
    on the same phases within 1e-5 relative."""
    from prdisagg_torch.baselines.rainfarm import pipeline
    from prdisagg_torch.core.config import RainFarmConfig

    reals = np.random.RandomState(6).gamma(
        0.5, 1.0, (5, 24, 16, 16)).astype("f4")
    cfg = RainFarmConfig()
    a = pipeline.crps_rainfarm(reals, 1.5, 0.9, cfg, n_members=1000, seed=2,
                               sample_chunk=2, device=cuda)
    b = pipeline.crps_rainfarm(reals, 1.5, 0.9, cfg, n_members=1000, seed=2,
                               sample_chunk=5, device=cuda)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (5, 24) and np.isfinite(a).all() and (a >= 0).all()
    phases = torch.rand((1000, 24, 16, 16),
                        generator=torch.Generator(device=cuda).manual_seed(2),
                        device=cuda)
    real = torch.tensor(reals[0])
    with torch.inference_mode():
        cpu = pipeline._score_one_sample(real, real.sum(0), 1.5, 0.9,
                                         phases.cpu()).numpy()
    np.testing.assert_allclose(a[0], cpu, rtol=1e-5, atol=1e-7)


def test_wire_float16_halves_the_copied_bytes(cuda):
    """The float16 wire copies half the bytes of the float32 path from the
    card, and its scenarios stay within 1e-3 of the largest daily sum."""
    from prdisagg_torch.api.pretrained import PretrainedGenerator
    from prdisagg_torch.core.config import ModelConfig
    from prdisagg_torch.models.generator import Generator

    torch.manual_seed(0)
    cfg = ModelConfig(compute_dtype="float32")
    params = Generator(cfg).state_dict()
    cond = np.random.RandomState(7).gamma(0.6, 12.0, (16, 16)).astype("f4")
    lat = np.random.RandomState(8).randn(64, cfg.latent_dim).astype("f4")
    copied, out = {}, {}
    for wire in ("float32", "float16"):
        gen = PretrainedGenerator(params, cfg, device=cuda, wire_dtype=wire)
        fetch = gen._fetch

        def counting(t, wire=wire, fetch=fetch):
            assert t.is_cuda
            copied[wire] = t.numel() * t.element_size()
            return fetch(t)

        gen._fetch = counting
        out[wire] = gen.generate_scenarios(cond, 64, latent=lat)
    assert copied["float16"] * 2 == copied["float32"] == 64 * 24 * 256 * 4
    np.testing.assert_allclose(out["float16"], out["float32"], rtol=0,
                               atol=1e-3 * cond.max())


# --------------------------------------------------------------------------
# the data pipeline on the card: the streamed scan, the K2 patch store
# --------------------------------------------------------------------------

def _rain_tensor(days, ny, nx, seed):
    rng = np.random.RandomState(seed)
    data = rng.gamma(0.5, 3.0, size=(days, 24, ny, nx)).astype(np.float32)
    data[1, :, 5:12, 8:15] = np.nan
    return data


def test_streamed_scan_on_the_card_matches_cpu(cuda, tmp_path):
    from prdisagg_torch.core.config import DataConfig
    from prdisagg_torch.data.indices import (
        compute_valid_indices,
        compute_valid_indices_streamed,
    )

    path = str(tmp_path / "d.npy")
    np.save(path, _rain_tensor(7, 80, 72, 1))
    mm = np.load(path, mmap_mode="r")
    for include_last_box in (False, True):
        cfg = DataConfig(ndomain=16, stride=8)
        want = compute_valid_indices(np.asarray(mm), cfg, include_last_box)
        assert len(want) > 0
        for k in (1, 3, 7):
            got = compute_valid_indices_streamed(
                mm, cfg, include_last_box, device=cuda, days_per_chunk=k)
            np.testing.assert_array_equal(got, want)


def test_patch_store_through_k2_is_bit_exact(cuda, tmp_path):
    """Days with many rows, one row and none, the last row and column; one
    K2 launch per day with rows; the record cache stays bounded as B
    changes from day to day."""
    from prdisagg_torch.data.native import (
        extract_patch_store,
        gather_patches_native,
    )
    from prdisagg_torch.ops import gather

    data = _rain_tensor(6, 64, 48, 2)
    path = str(tmp_path / "d.npy")
    np.save(path, data)
    mm = np.load(path, mmap_mode="r")
    rng = np.random.RandomState(4)
    rows = [[0, 48, 32], [3, 0, 0]]  # day 3: one row; days 1 and 4: none
    for t, n in ((0, 70), (2, 5), (5, 33)):
        rows += [[t, y, x] for y, x in zip(rng.randint(0, 49, n),
                                           rng.randint(0, 33, n))]
    idx = np.array(rows, np.int32)[rng.permutation(len(rows))]
    want = extract_patch_store(mm, idx, 16, device="cpu")
    before = gather.launches
    got = extract_patch_store(mm, idx, 16, device=cuda)
    assert gather.launches - before == 4  # days 0, 2, 3 and 5
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        gather_patches_native(data, idx, 16, device=cuda), want)
    for _ in range(3):  # many more B values than records kept
        for b in range(1, 40):
            extract_patch_store(mm, idx[:b], 16, device=cuda)
    assert len(gather._records) <= gather._MAX_RECORDS
    with pytest.raises(ValueError, match="out of range"):
        extract_patch_store(mm, np.array([[0, 49, 0]], np.int32), 16,
                            device=cuda)


def test_probe_backend_on_the_card(cuda):
    from prdisagg_torch.utils.watchdog import probe_backend

    res = probe_backend("cuda", timeout_s=120)
    assert res["ok"], res
    assert res["latency_s"] is not None
