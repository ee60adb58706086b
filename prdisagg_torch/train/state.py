"""Training state: generator, critic, both optimizers and the random stream.

Unlike the JAX package's immutable pytree, the port's state is updated in
place by the train step: the modules and optimizers own their tensors.  A
CUDA graph of the step (train/wgan_gp.py) records those tensors' addresses,
so everything that loads a state (:func:`load_state`, :func:`warm_start`)
copies into the existing tensors instead of replacing them.  With a
data-parallel mesh, the same functions end with a broadcast from rank 0
into those tensors (parallel/mesh.py ``replicate``): every rank then holds
the same parameters, optimizer state, EMA, step and random stream.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

from prdisagg_torch.core.config import ModelConfig, TrainConfig
from prdisagg_torch.core.device import resolve_device
from prdisagg_torch.models.critic import Critic
from prdisagg_torch.models.generator import Generator
from prdisagg_torch.parallel.mesh import replicate


def make_optimizer(params, cfg: TrainConfig,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam(1e-4, beta1=0, beta2=0.9) per the WGAN-GP paper (reference:
    gan_train_cwgangp_pixelnorm.py:384-385).  eps 1e-8 outside the square
    root and bias-corrected moments: the update ``optax.adam`` computes.

    `capturable` (for parameters on a card) keeps the step counter on the
    device, so that a CUDA graph can capture the update; Adam refuses it on
    the CPU.  The state (step 0, zero moments) is made here, as Adam would
    make it at its first step, so that a checkpoint loads into it in place
    and a graph captured before the first step finds it."""
    opt = torch.optim.Adam(params, lr=cfg.learning_rate,
                           betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                           capturable=capturable)
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {
                "step": torch.zeros((), dtype=torch.float32,
                                    device=p.device if capturable else "cpu"),
                "exp_avg": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format)}
    return opt


@dataclasses.dataclass
class GANTrainState:
    step: int
    gen: Generator
    critic: Critic
    gen_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    # every draw of the train step (index rows, latents, eps, dropout masks)
    rng: torch.Generator
    # EMA of the generator (TrainConfig.ema_decay > 0), else None
    ema_gen: Optional[Generator] = None

    @property
    def device(self) -> torch.device:
        return next(self.gen.parameters()).device


def _ema_copy(gen: Generator) -> Generator:
    return copy.deepcopy(gen).requires_grad_(False)


def _optimizers(gen, critic, train_cfg: TrainConfig, dev: torch.device):
    capturable = dev.type == "cuda"
    return (make_optimizer(gen.parameters(), train_cfg, capturable),
            make_optimizer(critic.parameters(), train_cfg, capturable))


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                       seed: Optional[int] = None,
                       device="cuda", mesh=None) -> GANTrainState:
    """Both nets initialised from `seed` (train_cfg.seed by default) on the
    CPU's random stream, without disturbing the caller's, then moved to
    `device`; the step's random stream is a generator on `device`.  With a
    `mesh`, replicated from rank 0 (a collective)."""
    seed = train_cfg.seed if seed is None else seed
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = Generator(model_cfg)
        critic = Critic(model_cfg)
    gen, critic = gen.to(dev), critic.to(dev)
    gen_opt, critic_opt = _optimizers(gen, critic, train_cfg, dev)
    state = GANTrainState(
        step=0, gen=gen, critic=critic, gen_opt=gen_opt,
        critic_opt=critic_opt,
        rng=torch.Generator(device=dev).manual_seed(seed),
        ema_gen=_ema_copy(gen) if train_cfg.ema_decay > 0 else None)
    return state if mesh is None else replicate(state, mesh)


def _opt_state(opt: torch.optim.Optimizer) -> list:
    """The optimizer's per-parameter state, in parameter order."""
    return [opt.state[p] for g in opt.param_groups for p in g["params"]]


def _load_opt_state(opt: torch.optim.Optimizer, saved: list) -> None:
    """Copy per-parameter state (:func:`_opt_state`'s layout) into the
    optimizer's existing tensors."""
    mine = _opt_state(opt)
    if len(mine) != len(saved):
        raise ValueError(f"optimizer state for {len(saved)} parameters, the "
                         f"optimizer has {len(mine)}")
    for st, sv in zip(mine, saved):
        if set(st) != set(sv):
            raise ValueError(f"optimizer state keys {sorted(sv)}, expected "
                             f"{sorted(st)}")
        for k, v in sv.items():
            st[k].copy_(v)


def state_tree(state: GANTrainState) -> dict:
    """The whole state as a tree of its live tensors, in the layout of a
    checkpoint: both nets, the EMA, both optimizers' per-parameter state,
    the step and the random stream's state."""
    return {
        "step": state.step,
        "gen": state.gen.state_dict(),
        "critic": state.critic.state_dict(),
        "ema_gen": (None if state.ema_gen is None
                    else state.ema_gen.state_dict()),
        "gen_opt": [dict(s) for s in _opt_state(state.gen_opt)],
        "critic_opt": [dict(s) for s in _opt_state(state.critic_opt)],
        "rng_device": state.rng.device.type,
        "rng": state.rng.get_state(),
    }


def load_state(state: GANTrainState, tree: dict, mesh=None) -> None:
    """Load a :func:`state_tree` (from any device) into `state` in place:
    every tensor is copied into the existing one, so a CUDA graph captured
    on `state` afterwards, or before, reads the loaded values.  With a
    `mesh`, every rank loads its tree, then takes rank 0's values."""
    if (state.ema_gen is None) != (tree["ema_gen"] is None):
        raise ValueError("the state and the saved tree disagree on the EMA "
                         "generator (TrainConfig.ema_decay)")
    if tree["rng_device"] != state.rng.device.type:
        raise ValueError(f"the saved random stream is a "
                         f"{tree['rng_device']} generator's, the state's is "
                         f"on {state.rng.device.type}: a generator's state "
                         f"does not move between device types")
    with torch.no_grad():
        # Module.load_state_dict copies into the existing parameters
        state.gen.load_state_dict(tree["gen"])
        state.critic.load_state_dict(tree["critic"])
        if state.ema_gen is not None:
            state.ema_gen.load_state_dict(tree["ema_gen"])
        _load_opt_state(state.gen_opt, tree["gen_opt"])
        _load_opt_state(state.critic_opt, tree["critic_opt"])
    state.step = int(tree["step"])
    state.rng.set_state(tree["rng"])
    if mesh is not None:
        replicate(state, mesh)


def clone_train_state(state: GANTrainState, model_cfg: ModelConfig,
                      train_cfg: TrainConfig, device) -> GANTrainState:
    """A copy of `state` (parameters, both optimizers' moments, step) on
    `device`, under `model_cfg`, which may change the compute dtype or the
    dropout rate but not a shape.  The random stream starts anew from seed
    0: a generator's state does not move between device types."""
    dev = resolve_device(device)
    with torch.device("meta"):
        gen, critic = Generator(model_cfg), Critic(model_cfg)
    for new, old in ((gen, state.gen), (critic, state.critic)):
        new.load_state_dict({k: v.detach().to(dev).clone()
                             for k, v in old.state_dict().items()},
                            strict=True, assign=True)
    gen_opt, critic_opt = _optimizers(gen, critic, train_cfg, dev)
    with torch.no_grad():
        _load_opt_state(gen_opt, _opt_state(state.gen_opt))
        _load_opt_state(critic_opt, _opt_state(state.critic_opt))
    ema = None
    if state.ema_gen is not None:
        ema = _ema_copy(gen)
        ema.load_state_dict(state.ema_gen.state_dict())
    return GANTrainState(step=state.step, gen=gen, critic=critic,
                         gen_opt=gen_opt, critic_opt=critic_opt,
                         rng=torch.Generator(device=dev).manual_seed(0),
                         ema_gen=ema)


# ---------------------------------------------------------------------------
# warm start from weight files
# ---------------------------------------------------------------------------

def _load_weight_file(path: str, loader_h5, cfg=None, **kw):
    from prdisagg_torch.models.io import load_params_npz

    if path.endswith(".h5"):
        return loader_h5(path, cfg, **kw)
    return load_params_npz(path)


def infer_model_config_from_weights(gen_weights: str,
                                    critic_weights: Optional[str] = None,
                                    compute_dtype: str = "bfloat16"
                                    ) -> ModelConfig:
    """The full ModelConfig from weight files alone (``.npz`` or reference
    ``.h5``), as the JAX package infers it: the critic, when given, pins
    the conditioning channels (conv0's input) and the stage widths; the
    generator the domain, latent size and generator widths.  A training
    entry, so `compute_dtype` defaults to bf16."""
    from prdisagg_torch.models.io import (
        infer_critic_config,
        infer_generator_config,
        load_keras_critic_h5,
        load_keras_generator_h5,
    )

    critic_params = None
    n_cond = 1
    if critic_weights is not None:
        critic_params = _load_weight_file(critic_weights,
                                          load_keras_critic_h5)
        n_cond = infer_critic_config(critic_params).n_cond_channels
    gen_params = _load_weight_file(gen_weights, load_keras_generator_h5,
                                   n_cond_channels=n_cond)
    model_cfg = infer_generator_config(gen_params, n_cond_channels=n_cond)
    if critic_params is not None:
        ccfg = infer_critic_config(critic_params, ndomain=model_cfg.ndomain)
        model_cfg = dataclasses.replace(
            model_cfg, critic_channels=ccfg.critic_channels)
    return dataclasses.replace(model_cfg, compute_dtype=compute_dtype)


def warm_start(model_cfg: Optional[ModelConfig], train_cfg: TrainConfig,
               gen_weights: str, critic_weights: Optional[str] = None,
               device="cuda", mesh=None) -> GANTrainState:
    """A training state warm-started from saved weights with fresh
    optimizers: the reference's continue-training workflow (it reloads both
    nets from .h5, gan_train_cwgangp_pixelnorm.py:520-529 + start_epoch).
    Weight files are the JAX package's ``.npz`` or reference Keras ``.h5``;
    with `model_cfg` None the architecture is inferred from them.  The EMA
    generator, when on, starts from the loaded generator (the JAX package
    keeps its fresh initialisation there).  With a `mesh`, every rank reads
    the files, then takes rank 0's values."""
    from prdisagg_torch.models.io import (
        _check_critic_shapes,
        _check_generator_shapes,
        _unwrap,
        critic_params_from_jax,
        load_keras_critic_h5,
        load_keras_generator_h5,
        params_from_jax,
    )

    if model_cfg is None:
        model_cfg = infer_model_config_from_weights(gen_weights,
                                                    critic_weights)
    state = create_train_state(model_cfg, train_cfg, device=device)
    gen_tree = _load_weight_file(gen_weights, load_keras_generator_h5,
                                 model_cfg)
    _check_generator_shapes(_unwrap(gen_tree), model_cfg, gen_weights)
    with torch.no_grad():
        state.gen.load_state_dict(params_from_jax(gen_tree))
        if state.ema_gen is not None:
            state.ema_gen.load_state_dict(state.gen.state_dict())
        if critic_weights is not None:
            critic_tree = _load_weight_file(critic_weights,
                                            load_keras_critic_h5, model_cfg)
            _check_critic_shapes(_unwrap(critic_tree), model_cfg,
                                 critic_weights)
            state.critic.load_state_dict(critic_params_from_jax(critic_tree))
    return state if mesh is None else replicate(state, mesh)
