"""Training state: generator, critic, both optimizers and the random stream.

Unlike the JAX package's immutable pytree, the port's state is updated in
place by the train step: the modules and optimizers own their tensors.
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


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam(1e-4, beta1=0, beta2=0.9) per the WGAN-GP paper (reference:
    gan_train_cwgangp_pixelnorm.py:384-385).  eps 1e-8 outside the square
    root and bias-corrected moments: the update ``optax.adam`` computes."""
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            betas=(cfg.beta1, cfg.beta2), eps=1e-8)


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


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                       seed: Optional[int] = None,
                       device="cuda") -> GANTrainState:
    """Both nets initialised from `seed` (train_cfg.seed by default) on the
    CPU's random stream, without disturbing the caller's, then moved to
    `device`; the step's random stream is a generator on `device`."""
    seed = train_cfg.seed if seed is None else seed
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = Generator(model_cfg)
        critic = Critic(model_cfg)
    gen, critic = gen.to(dev), critic.to(dev)
    return GANTrainState(
        step=0, gen=gen, critic=critic,
        gen_opt=make_optimizer(gen.parameters(), train_cfg),
        critic_opt=make_optimizer(critic.parameters(), train_cfg),
        rng=torch.Generator(device=dev).manual_seed(seed),
        ema_gen=_ema_copy(gen) if train_cfg.ema_decay > 0 else None)


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
    gen_opt = make_optimizer(gen.parameters(), train_cfg)
    critic_opt = make_optimizer(critic.parameters(), train_cfg)
    # deep copies: load_state_dict keeps a moment tensor that is already on
    # the right device, so the copy would otherwise share it with `state`
    gen_opt.load_state_dict(copy.deepcopy(state.gen_opt.state_dict()))
    critic_opt.load_state_dict(copy.deepcopy(state.critic_opt.state_dict()))
    ema = None
    if state.ema_gen is not None:
        ema = _ema_copy(gen)
        ema.load_state_dict(state.ema_gen.state_dict())
    return GANTrainState(step=state.step, gen=gen, critic=critic,
                         gen_opt=gen_opt, critic_opt=critic_opt,
                         rng=torch.Generator(device=dev).manual_seed(0),
                         ema_gen=ema)
