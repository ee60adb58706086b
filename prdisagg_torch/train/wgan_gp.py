"""cWGAN-GP train step: n_disc critic updates, then one generator update.

Loss semantics (parity with gan_train_cwgangp_pixelnorm.py:360-408,452-454
and the JAX package's train/wgan_gp.py):
  critic:    mean(-D(real)) + mean(D(fake)) + gp_weight * mean((||g||-1)^2)
             with fake = G(z, cond_real), g = dD/d(interp),
             interp = eps*real + (1-eps)*fake, eps ~ U(0,1) per sample
  generator: mean(-D(G(z, cond), cond)) with freshly drawn cond
  reported d_loss = mean(valid_loss, fake_loss) of the last critic update

As in the JAX package, the generator is frozen across the critic updates,
so all n_disc fake batches come from one held-over (n_disc*B) forward under
``no_grad`` (optionally in chunks), and the n_disc real batches from one
gather.  Each critic update makes one 2B real+fake call with its own
dropout mask, and the gradient penalty's call a second, independent one.

Every random draw of a step is made up front by :func:`draw_step_inputs`
and handed to :func:`train_step_on`, so a test can feed the port and the
JAX package the same latents, index rows, eps and masks.  Injected index
rows are checked against the dataset; the step's own draws, taken from its
checked rows, are not.

:func:`make_train_step` runs ``steps_per_call`` steps per call; on a card
they are replays of a CUDA graph of one step, the counterpart of the JAX
package's ``lax.scan`` of K steps in one dispatch.

With a data-parallel ``mesh`` (parallel/mesh.py) every rank draws the
global step's inputs from its replicated ``state.rng`` and runs the step on
its own shard of them (:func:`shard_step_draws`); after each critic
update's gradient and the generator's, one all-reduce averages a flat
bucket of the net's gradients and the update's loss terms, so that every
rank applies the same update and reports the global batch's metrics:
n_disc + 1 collectives a step, inside the CUDA graph on the card.

With ``ModelConfig.spatial_axis`` set and a mesh with that axis (a 1-D
spatial mesh, or the (data, spatial) grid of parallel/mesh.py
``make_mesh_2d``), the nets split the y rows of their activations over
it (parallel/spatial.py): the draws are sharded over ``data`` as above,
the real patches are gathered whole by K2 and sliced to the rank's rows,
the gradient penalty's per-sample squared norm is summed over ``spatial``,
and each gradient reaches the update summed over ``spatial`` where each
rank holds a share of it (``spatial_partial_params``), then averaged over
``data``.

``fused_gen_forward`` is the JAX package's restructure of the generator's
work: the generator update's B latents join the held-over n_disc*B in ONE
(n_disc+1)*B forward with its graph kept; the critic updates read the
detached fakes, and after the last one the generator's loss on the last
B, scored by the updated critic, runs its backward through that forward.
Same draws and semantics as the default; a bigger generator backward for
fewer, larger forwards.  It needs the one forward, so it cannot be
combined with a chunked held-over forward.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import List, Optional

import torch

from prdisagg_torch.core.config import ModelConfig, TrainConfig
from prdisagg_torch.data.sampler import DeviceDataset
from prdisagg_torch.ops import core, gather, upsample_conv
from prdisagg_torch.ops.core import full_f32
from prdisagg_torch.parallel import spatial
from prdisagg_torch.parallel.mesh import Mesh2D, all_reduce_mean, shard_bounds
from prdisagg_torch.train.state import GANTrainState

# order of the scalar metrics in the packed vector (one host fetch instead
# of seven)
METRIC_KEYS = (
    "d_loss", "d_loss_mean", "gp", "w_distance",
    "d_grad_norm", "g_loss", "g_grad_norm",
)


def unpack_metrics(packed) -> dict:
    """Packed (8,) tensor -> python dict (one host transfer)."""
    vals = packed.detach().cpu().numpy()
    m = dict(zip(METRIC_KEYS, vals[:-1].tolist()))
    m["nonfinite"] = bool(vals[-1])
    return m


def hoisted_chunk_count(train_cfg: TrainConfig, batch_size: int) -> int:
    """Number of sequential chunks of the held-over (n_disc*B) forward:
    ``train_cfg.hoisted_chunks`` when > 1, else the smallest divisor of
    n_disc*B keeping chunks at or under ``train_cfg.hoisted_chunk_samples``,
    else 1."""
    chunks = train_cfg.hoisted_chunks
    total = train_cfg.n_disc * batch_size
    if chunks <= 1 and train_cfg.hoisted_chunk_samples:
        cap = train_cfg.hoisted_chunk_samples
        chunks = next((c for c in range(max(1, -(-total // cap)), total + 1)
                       if total % c == 0 and total // c <= cap), total)
    chunks = max(chunks, 1)
    if total % chunks:
        raise ValueError(f"hoisted_chunks={chunks} must divide "
                         f"n_disc*batch_size={total}")
    return chunks


@dataclasses.dataclass
class StepDraws:
    """Every random input of one train step."""

    real_rows: torch.Tensor       # (n_disc*B, 3) int32 index rows
    latent: torch.Tensor          # (n_disc*B, latent_dim) held-over latents
    eps: torch.Tensor             # (n_disc, B) interpolation weights
    masks: List                   # n_disc keep-mask lists, 2B real+fake call
    gp_masks: List                # n_disc keep-mask lists, the GP's call
    gen_latent: torch.Tensor      # (B, latent_dim)
    gen_rows: torch.Tensor        # (B, 3) rows of the generator's conds
    gen_masks: Optional[list]     # keep masks of the generator's critic call


def draw_step_inputs(state: GANTrainState, ds: DeviceDataset,
                     batch_size: int, n_disc: int) -> StepDraws:
    g, dev = state.rng, state.device
    b, latent_dim = batch_size, state.gen.cfg.latent_dim
    critic = state.critic
    return StepDraws(
        real_rows=ds.draw_rows(n_disc * b, g),
        latent=torch.randn((n_disc * b, latent_dim), generator=g, device=dev),
        eps=torch.rand((n_disc, b), generator=g, device=dev),
        masks=[critic.draw_masks(2 * b, g) for _ in range(n_disc)],
        gp_masks=[critic.draw_masks(b, g) for _ in range(n_disc)],
        gen_latent=torch.randn((b, latent_dim), generator=g, device=dev),
        gen_rows=ds.draw_rows(b, g),
        gen_masks=critic.draw_masks(b, g))


def shard_step_draws(draws: StepDraws, mesh) -> StepDraws:
    """This rank's share of a step's global draws: its contiguous slice of
    each critic update's B block (rows, latents, eps, the GP's masks), of
    the real half and of the fake half of each update's 2B masks, and of
    the generator update's B.  Raises unless B divides over the mesh."""
    n_disc, b = draws.eps.shape
    lo, hi = shard_bounds(b, mesh)

    def blocks(x):  # (n_disc*B, ...) -> (n_disc*b_local, ...)
        return x.reshape(n_disc, b, *x.shape[1:])[:, lo:hi].reshape(
            -1, *x.shape[1:])

    def each(masks, part):
        return None if masks is None else [part(m) for m in masks]

    def real_and_fake(m):
        return torch.cat([m[lo:hi], m[b + lo:b + hi]])

    def mine(x):
        return x[lo:hi]

    return StepDraws(
        real_rows=blocks(draws.real_rows), latent=blocks(draws.latent),
        eps=draws.eps[:, lo:hi],
        masks=[each(m, real_and_fake) for m in draws.masks],
        gp_masks=[each(m, mine) for m in draws.gp_masks],
        gen_latent=mine(draws.gen_latent), gen_rows=mine(draws.gen_rows),
        gen_masks=each(draws.gen_masks, mine))


def _all_reduce_bucket(grads, terms, mesh):
    """Average a net's gradients and an update's scalar loss terms over the
    mesh in ONE all-reduce of a flat float32 bucket; returns both as views
    of the reduced bucket."""
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [t.reshape(1).float() for t in terms])
    all_reduce_mean(flat, mesh)
    parts = flat.split([g.numel() for g in grads] + [1] * len(terms))
    return ([p.view_as(g) for p, g in zip(parts, grads)],
            [p[0] for p in parts[len(grads):]])


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def critic_loss(critic, frac_real, cond, fake, eps, masks, gp_masks,
                gp_weight: float, sp=None):
    """One critic update's loss on given data, fakes, eps and masks.
    Returns (loss, d_loss, gp, w_distance); the loss keeps its graph through
    the gradient penalty's first derivative.  Under a spatial mesh `sp`,
    frac_real and fake are the rank's rows, and the penalty's per-sample
    squared norm is summed over its ranks."""
    b = frac_real.shape[0]
    scores = critic(torch.cat([frac_real, fake]), torch.cat([cond, cond]),
                    masks)
    d_real, d_fake = scores[:b], scores[b:]
    e = eps.reshape(b, 1, 1, 1, 1)
    interp = (e * frac_real + (1.0 - e) * fake).requires_grad_(True)
    (g,) = torch.autograd.grad(critic(interp, cond, gp_masks).sum(), interp,
                               create_graph=True)
    sq = g.reshape(b, -1).square().sum(dim=1)
    if spatial.is_sharded(critic.cfg.ndomain, sp):
        sq = spatial.all_reduce_sum(sq, sp)
    norm = torch.sqrt(sq + 1e-12)
    gp = (norm - 1.0).square().mean()
    loss_valid, loss_fake = (-d_real).mean(), d_fake.mean()
    loss = loss_valid + loss_fake + gp_weight * gp
    return (loss, 0.5 * (loss_valid + loss_fake), gp,
            -(loss_valid + loss_fake))


def split_mesh(mesh, model_cfg: ModelConfig) -> tuple:
    """(data mesh, spatial mesh) of a step's `mesh`: a (data, spatial)
    grid's two axes; a 1-D mesh is the spatial one when it is the axis
    that ``model_cfg.spatial_axis`` names, else the data one."""
    if mesh is None:
        return None, None
    if isinstance(mesh, Mesh2D):
        if model_cfg.spatial_axis != mesh.spatial.axis:
            raise ValueError(f"a (data, spatial) mesh needs the model's "
                             f"spatial_axis to be {mesh.spatial.axis!r}, "
                             f"got {model_cfg.spatial_axis!r}")
        return mesh.data, mesh.spatial
    if model_cfg.spatial_axis is not None \
            and mesh.axis == model_cfg.spatial_axis:
        return None, mesh
    return mesh, None


def check_fused(fused_gen_forward: bool, chunks: int) -> None:
    """Refuse a fused generator forward beside a chunked held-over one."""
    if fused_gen_forward and chunks > 1:
        raise ValueError("hoisted_chunks and fused_gen_forward are mutually "
                         "exclusive (the fused path needs one forward with "
                         "its graph)")


def train_step_on(state: GANTrainState, ds: DeviceDataset, draws: StepDraws,
                  train_cfg: TrainConfig, chunks: int = 1,
                  mesh=None, fused_gen_forward: bool = False) -> dict:
    """One fused step on given draws; updates `state` in place and returns
    the metrics as device tensors, with ``packed`` the (8,) vector of
    :data:`METRIC_KEYS` and the non-finite flag.  Raises ValueError when an
    index row of `draws` lies outside the dataset.

    With a `mesh`, `draws` are the global step's and every rank must call
    this with the same ones; `chunks` splits the rank's own held-over
    forward.  The eager data-parallel or spatial step: on the CPU, and
    over gloo."""
    check_fused(fused_gen_forward, chunks)
    ds.check_rows(draws.real_rows)
    ds.check_rows(draws.gen_rows)
    metrics = _train_step_on(state, ds, draws, train_cfg, chunks, mesh,
                             fused_gen_forward)
    state.step += 1
    return metrics


def _train_step_on(state: GANTrainState, ds: DeviceDataset, draws: StepDraws,
                   train_cfg: TrainConfig, chunks: int, mesh=None,
                   fused: bool = False) -> dict:
    dm, sp = split_mesh(mesh, state.gen.cfg)
    if dm is not None:
        draws = shard_step_draws(draws, dm)
    ambient = (spatial.use_mesh(mesh) if sp is not None
               else contextlib.nullcontext())
    with ambient:
        return _step(state, ds, draws, train_cfg, chunks, dm, sp, fused)


def _step(state: GANTrainState, ds: DeviceDataset, draws: StepDraws,
          train_cfg: TrainConfig, chunks: int, dm, sp, fused: bool) -> dict:
    gen, critic = state.gen, state.critic
    n_disc, b = draws.eps.shape
    strict = (full_f32() if gen.compute_dtype == torch.float32
              else contextlib.nullcontext())

    def reduce(grads, terms, net):
        """A net's gradients summed over `sp` where partial, then with the
        update's terms averaged over `dm`."""
        if sp is not None:
            grads = spatial.sum_partial_grads(
                grads, [n for n, _ in net.named_parameters()],
                net.spatial_partial_params(), sp)
        if dm is not None:
            grads, terms = _all_reduce_bucket(grads, terms, dm)
        return grads, terms

    with strict:
        frac, cond = ds._real_from_rows(draws.real_rows)
        frac = spatial.shard_rows(frac, 2, sp)
        if fused:
            # the generator update's B ride the held-over forward, whose
            # graph stays alive across the critic updates
            cond_g = ds._cond_from_rows(draws.gen_rows)
            fake_all = gen(torch.cat([draws.latent, draws.gen_latent]),
                           torch.cat([cond, cond_g]))
            fake = fake_all[:n_disc * b].detach()
        else:
            with torch.no_grad():
                fake = torch.cat([gen(lat, cnd) for lat, cnd in zip(
                    draws.latent.chunk(chunks), cond.chunk(chunks))])
        frac = frac.reshape(n_disc, b, *frac.shape[1:])
        cond = cond.reshape(n_disc, b, *cond.shape[1:])
        fake = fake.reshape(n_disc, b, *fake.shape[1:])

        c_params = list(critic.parameters())
        aux = []
        for i in range(n_disc):
            loss, d_loss, gp, w_dist = critic_loss(
                critic, frac[i], cond[i], fake[i], draws.eps[i],
                draws.masks[i], draws.gp_masks[i], train_cfg.gp_weight, sp)
            grads = torch.autograd.grad(loss, c_params)
            grads, terms = reduce(
                grads, (d_loss.detach(), gp.detach(), w_dist.detach()),
                critic)
            _apply(state.critic_opt, c_params, grads)
            aux.append((*terms, _global_norm(grads)))

        g_params = list(gen.parameters())
        if fused:
            fake_g = fake_all[n_disc * b:]
        else:
            cond_g = ds._cond_from_rows(draws.gen_rows)
            fake_g = gen(draws.gen_latent, cond_g)
        d_fake = critic(fake_g, cond_g, draws.gen_masks)
        g_loss = (-d_fake).mean()
        g_grads = torch.autograd.grad(g_loss, g_params)
        g_grads, (g_loss,) = reduce(g_grads, (g_loss.detach(),), gen)
        _apply(state.gen_opt, g_params, g_grads)
        if train_cfg.ema_decay > 0:
            d = train_cfg.ema_decay
            with torch.no_grad():
                for e, p in zip(state.ema_gen.parameters(), g_params):
                    e.copy_(d * e + (1.0 - d) * p)

    d_losses = torch.stack([a[0] for a in aux])
    metrics = {
        "d_loss": aux[-1][0], "d_loss_mean": d_losses.mean(),
        "gp": aux[-1][1], "w_distance": aux[-1][2],
        "d_grad_norm": aux[-1][3], "g_loss": g_loss,
        "g_grad_norm": _global_norm(g_grads),
    }
    vals = torch.stack([metrics[k].float() for k in METRIC_KEYS])
    nonfinite = ~torch.isfinite(vals).all()
    metrics["nonfinite"] = nonfinite
    metrics["packed"] = torch.cat([vals, nonfinite.float()[None]])
    return metrics


#: eager steps a new CUDA graph warms up on, on a throwaway clone of the state
WARMUP_STEPS = 3
#: what CUDA graphs of the step recorded through the kernel wrappers'
#: counters at capture (launches that did not run then), and what their
#: replays launched since (each replay runs what its capture recorded), by
#: counter name (:func:`kernel_counts`)
graph_captured = collections.Counter()
graph_launches = collections.Counter()


def kernel_counts() -> dict:
    """The kernel wrappers' counters: K1's launches, by variant too, K1's
    backward passes and its backward kernels' launches, K2's launches and
    the pixel-norm pass's."""
    return {"upsample2_conv3": upsample_conv.launches,
            **{f"upsample2_conv3_{v}": n
               for v, n in upsample_conv.launches_by_variant.items()},
            "upsample2_conv3_backward": upsample_conv.backward_calls,
            **{f"upsample2_conv3_backward_{k}": n for k, n in
               upsample_conv.backward_launches_by_variant.items()},
            "gather_patches": gather.launches,
            "pixel_norm_leaky": core.pixel_norm_launches}


def _call_metrics(last: dict, flag: torch.Tensor) -> dict:
    """What a call of K steps returns, as the JAX package's scan does: the
    last step's metrics, with the non-finite flag OR-ed over the K steps.
    Copies, so that a later step or replay does not change them."""
    packed = last["packed"].clone()
    packed[-1] = flag.float()
    metrics = {k: packed[i] for i, k in enumerate(METRIC_KEYS)}
    metrics["nonfinite"] = flag.clone()
    metrics["packed"] = packed
    return metrics


class _StepGraph:
    """One train step captured as a CUDA graph on one state and dataset.

    The captured work is the step's draws (from ``state.rng``, registered
    with the graph so that every replay draws anew from the generator's
    current offset), the step on them, and ``flag |= nonfinite``.  The graph
    records the addresses of the state's parameters, optimizer moments and
    EMA and of the dataset's tensors: the state must be loaded in place
    (train/state.py) for a replay to see a restore.

    Before capture, :data:`WARMUP_STEPS` eager steps run on a clone of the
    state on a side stream, so that cuDNN's plans, the libraries'
    workspaces, K2's launch record and K1's folding matrices exist and
    nothing is set up under capture; the state itself is untouched (capture
    records work, it runs none).  Capture mode "thread_local" leaves other
    threads, such as the artifact writer's host copies and NCCL's watchdog,
    free to run.  A data-parallel step's all-reduces are captured with the
    rest: the warm-up runs them eagerly first, on a communicator that
    ``initialize_multihost`` made when the group started."""

    def __init__(self, state: GANTrainState, ds: DeviceDataset, step_on,
                 train_cfg: TrainConfig):
        from prdisagg_torch.train.state import clone_train_state

        dev = state.device
        self.state, self.ds = state, ds
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = clone_train_state(state, state.gen.cfg, train_cfg, dev)
            for _ in range(WARMUP_STEPS):
                step_on(warm)
        torch.cuda.current_stream(dev).wait_stream(side)
        del warm
        self.flag = torch.zeros((), dtype=torch.bool, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.rng)
        before = kernel_counts()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.metrics = step_on(state)
            self.flag.logical_or_(self.metrics["nonfinite"])
        #: the kernel launches one replay makes, by counter name
        self.per_replay = {k: n - before[k]
                           for k, n in kernel_counts().items()}
        graph_captured.update(self.per_replay)

    def run(self, steps: int) -> dict:
        self.flag.zero_()
        for _ in range(steps):
            self.graph.replay()
        for k, n in self.per_replay.items():
            graph_launches[k] += n * steps
        return _call_metrics(self.metrics, self.flag)


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    batch_size: int, steps_per_call: int = 1, mesh=None,
                    fused_gen_forward: bool = False):
    """The fused train step ``(state, ds) -> (state, metrics)``, running
    `steps_per_call` steps per call: each step draws from ``state.rng``,
    then runs on those draws, whose rows need no check.  The state is
    updated in place (``state.step`` advances by `steps_per_call`) and
    returned for the JAX package's calling convention; the metrics are the
    last step's, with ``nonfinite`` OR-ed over the call's steps.

    On the CPU the steps run eagerly.  On a card the first call captures
    one step as a CUDA graph (:class:`_StepGraph`) and every call replays it
    `steps_per_call` times: the counterpart of the JAX package's
    ``lax.scan`` of K steps in one dispatch.  A capture or replay that
    fails raises; there is no eager fallback on the card (the eager step
    stays reachable as :func:`draw_step_inputs` + :func:`train_step_on`).
    The graph is bound to the state and dataset it captured: a call with
    others raises, and a new batch size needs a new step.

    With a data-parallel `mesh`, `batch_size` is the global batch, which
    must divide over the mesh, and the state must be replicated
    (train/state.py); every rank calls the step.  A mesh with the model's
    ``spatial_axis`` (1-D, or the (data, spatial) grid) splits the
    activations' rows over that axis too.  On the card the mesh must be
    NCCL's: gloo's collectives cannot be captured, and the step does not
    fall back to eager.

    `fused_gen_forward` runs the generator's forward once for the critic
    updates and its own update (see the module's docstring); it raises
    ValueError beside a chunked held-over forward."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    local_batch = batch_size
    dm = split_mesh(mesh, model_cfg)[0]
    if dm is not None:
        lo, hi = shard_bounds(batch_size, dm)
        local_batch = hi - lo
    chunks = hoisted_chunk_count(train_cfg, local_batch)
    check_fused(fused_gen_forward, chunks)
    n_disc = train_cfg.n_disc
    graphs: list = []

    def step_on(state: GANTrainState, ds: DeviceDataset) -> dict:
        draws = draw_step_inputs(state, ds, batch_size, n_disc)
        return _train_step_on(state, ds, draws, train_cfg, chunks, mesh,
                              fused_gen_forward)

    def train_step(state: GANTrainState, ds: DeviceDataset):
        if state.gen.cfg != model_cfg:
            raise ValueError("the state's model config differs from the "
                             "step's")
        dev = state.device
        if mesh is not None and mesh.device != dev:
            raise ValueError(f"the mesh computes on {mesh.device}, the state "
                             f"lies on {dev}")
        if dev.type == "cpu":
            flag = None
            for _ in range(steps_per_call):
                metrics = step_on(state, ds)
                f = metrics["nonfinite"]
                flag = f if flag is None else flag | f
            metrics = _call_metrics(metrics, flag)
        elif dev.type == "cuda":
            if mesh is not None and mesh.backend != "nccl":
                raise ValueError(
                    f"a step over a mesh on the card is a CUDA graph with "
                    f"its collectives inside, which {mesh.backend} cannot "
                    f"be captured in; use NCCL, or the eager "
                    f"draw_step_inputs + train_step_on")
            if not graphs:
                graphs.append(_StepGraph(state, ds,
                                         lambda s: step_on(s, ds), train_cfg))
            graph = graphs[0]
            if graph.state is not state or graph.ds is not ds:
                raise ValueError("this step's CUDA graph was captured on "
                                 "another state or dataset; make a new step")
            metrics = graph.run(steps_per_call)
        else:
            raise ValueError(f"the train step runs on cpu or cuda, got {dev}")
        state.step += steps_per_call
        return state, metrics

    return train_step
