"""The output check, driven through whole runs on the CPU at a small size:
the reference follows the port exactly where both compute in float32, and
every fault that the cells can have, planted underneath the timed path,
makes ``correct`` come out false.  The chip's own look (CUDA available,
the card's facts) is skipped: ``run.run`` takes the device."""

import json

import pytest
import torch

from portbench import run as runner
from portbench.tests.small import edit_json, small_bench


def run_cell(bench, name, seed=2**31 + 11, seconds=0.3):
    args = runner.parse(["--workload", name, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", "0"])
    return runner.run(args, "cpu", bench)


@pytest.fixture
def bench(tmp_path):
    return small_bench(tmp_path, f32=True)


def test_sound_runs_are_correct(bench):
    for name in ("flagship16.serve_f32", "flagship16.train_bf16"):
        out = run_cell(bench, name)
        assert out["correct"], out["checks"]
        assert list(out)[-1] == "checks"
        assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", ["flagship16.train_bf16",
                                  "largedomain64.train_bf16"])
def test_the_reference_follows_the_f32_step(tmp_path, cell):
    """With the program in float32 its first step is the reference's up to
    rounding: the draws, the losses and Adam agree.  (Later steps drift
    apart by more at 64x64, where the program takes the latent projection
    in float64.)"""
    bench = small_bench(tmp_path, f32=True)
    edit_json(bench.root / "traffic" / "train_bf16.json",
              lambda t: t.update(check_steps=1))
    out = run_cell(bench, cell, seconds=0.1)
    c = {k: v["value"] for k, v in out["checks"].items()}
    assert c["grad"] < 1e-4 and c["change"] < 1e-4, c


def test_step_that_leaves_the_state_unchanged(bench, monkeypatch):
    from prdisagg_torch.train import wgan_gp

    monkeypatch.setattr(wgan_gp, "_apply",
                        lambda opt, params, grads: None)
    out = run_cell(bench, "flagship16.train_bf16")
    assert not out["correct"]
    assert out["checks"]["change"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(bench, monkeypatch):
    from prdisagg_torch.train import wgan_gp

    real = wgan_gp.critic_loss

    def half(critic, frac, cond, fake, eps, masks, gp_masks, w, sp=None):
        b = frac.shape[0]
        h = b // 2
        masks = [torch.cat([m[:h], m[b:b + h]]) for m in masks]
        gp_masks = [m[:h] for m in gp_masks]
        return real(critic, frac[:h], cond[:h], fake[:h], eps[:h], masks,
                    gp_masks, w, sp)

    monkeypatch.setattr(wgan_gp, "critic_loss", half)
    assert not run_cell(bench, "flagship16.train_bf16")["correct"]


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_served_answers_altered(bench, monkeypatch, fault):
    from prdisagg_torch.api.pretrained import PretrainedGenerator

    real = PretrainedGenerator.predict_fractions

    def broken(self, latent, cond):
        if fault == "half":
            n = latent.shape[0] // 2
            out = real(self, latent[:n], cond[:n])
            return torch.cat([out, out])
        out = real(self, latent, cond).clone()
        out[0] = out[0].roll(1, dims=0)  # one scenario's hours shifted
        return out

    monkeypatch.setattr(PretrainedGenerator, "predict_fractions", broken)
    out = run_cell(bench, "flagship16.serve_f32")
    assert not out["correct"]
    assert out["checks"]["max_err"]["value"] > 1e-2
