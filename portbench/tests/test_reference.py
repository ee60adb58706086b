"""The plain reference against the port's CPU path at small sizes, on the
same weights, inputs and draws: the generator, the critic, and whole train
steps.  The reference itself imports nothing of the port; this test may."""

import json
import pathlib

import pytest
import torch

from portbench import program, reference

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def small_model(name: str) -> dict:
    m = json.loads((CONFIGS / f"{name}.json").read_text())["model"]
    m.update(latent_dim=8, gen_channels=[8, 8, 8], base_channels=8,
             critic_channels=[8, 8, 8, 8])
    return m


@pytest.mark.parametrize("name", ["flagship16", "largedomain64"])
def test_generator_and_critic_match_the_port(name):
    from prdisagg_torch.models.critic import Critic
    from prdisagg_torch.models.generator import Generator

    model = small_model(name)
    w = reference.make_weights(model, 3, "cpu")
    mc = program.model_config(model, "float32")
    gen, crit = Generator(mc), Critic(mc)
    gen.load_state_dict(program.generator_state(w))
    crit.load_state_dict(program.critic_state(w))
    g = torch.Generator().manual_seed(4)
    nd = model["ndomain"]
    lat = torch.randn((3, model["latent_dim"]), generator=g)
    cond = torch.rand((3, nd, nd, 1), generator=g)
    with torch.no_grad():
        want = reference.generator(w, model, lat, cond)
        got = gen(lat, cond)
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()
        masks = crit.draw_masks(3, torch.Generator().manual_seed(5))
        want = reference.critic(w, model, got, cond, masks)
        have = crit(got, cond, masks)
        assert (have - want).abs().max() <= 1e-5 * want.abs().max()
