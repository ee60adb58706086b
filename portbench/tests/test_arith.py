"""The frozen FLOP and byte counts against numbers worked out by hand."""

import json
import pathlib

import pytest

from portbench import arith

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


def test_k1_serving_flops_at_16x16():
    # three stages at B 1000: 2 * 64 * B * DHW * Cin * Cout each
    cases = arith.k1_serve_cases(model("flagship16"), 1000, 8192, "float32")
    assert [c[2] for c in cases] == [(1000, 3, 2, 2, 256, 256),
                                     (1000, 6, 4, 4, 256, 128),
                                     (1000, 12, 8, 8, 128, 64)]
    flops = sum(arith.k1_forward_flops(*c[2]) for c in cases)
    assert flops == 2 * 64 * 1000 * (12 * 256 * 256 + 96 * 256 * 128
                                     + 768 * 128 * 64)
    assert round(flops / 1e12, 3) == 1.309


def test_generator_and_critic_flops_by_layer():
    m = model("flagship16")
    # projection (100 + 256) x 3072, K1 stages, head 27 * 64 * 24 * 256
    macs = (356 * 3072 + 64 * (12 * 256 * 256 + 96 * 256 * 128
                               + 768 * 128 * 64) + 27 * 64 * 6144)
    assert arith.generator_flops(m) == 2 * macs
    # (11, 7, 7) x 2 -> 64, (6, 4, 4) 64 -> 128, (3, 2, 2) 128 -> 256,
    # (2, 1, 1) 256 -> 256, dense 512 -> 1
    macs = (539 * 27 * 2 * 64 + 96 * 27 * 64 * 128 + 12 * 27 * 128 * 256
            + 2 * 27 * 256 * 256 + 512)
    assert arith.critic_flops(m) == 2 * macs
    assert round(arith.request_flops(m, 1000) / 1e12, 3) == 1.332


def test_step_terms_and_totals():
    assert arith.step_terms(5) == {"gen": 8, "critic": 62}
    m16, m64 = model("flagship16"), model("largedomain64")
    assert arith.step_flops(m16, 32, 5) == 32 * (
        8 * arith.generator_flops(m16) + 62 * arith.critic_flops(m16))
    assert round(arith.step_flops(m16, 32, 5) / 1e11, 2) == 4.89
    assert round(arith.step_flops(m64, 32, 5) / 1e12, 2) == 7.94


def test_the_64x64_request_runs_as_two_chunks():
    cases = arith.k1_serve_cases(model("largedomain64"), 1000, 512,
                                 "float32")
    assert [c[2][0] for c in cases] == [512] * 3 + [488] * 3
    assert cases[0][2][1:] == (3, 8, 8, 256, 256)


def test_bounds_and_peaks():
    assert arith.peak_flops("bfloat16") == 989e12
    assert arith.peak_flops("float32") == pytest.approx(165e12)
    # f32 is held to 3xTF32 where that beats the FMA's 67 TFLOP/s
    assert arith.bound_ms(1e12, 0, "float32") == pytest.approx(3e3 / 495)
    assert arith.bound_ms(1e12, 0, "bfloat16") == pytest.approx(1e3 / 989)
    assert arith.bound_ms(1.0, 3.35e12, "bfloat16") == pytest.approx(1e3)
    shape = (1000, 3, 2, 2, 256, 256)
    assert arith.k1_forward_bytes(*shape, "float32") == (
        4 * 12000 * 256 + 4 * 64 * 256 * 256 + 4 * 256 + 4 * 8 * 12000 * 256)
    assert arith.k1_backward_flops(*shape) == 2 * arith.k1_forward_flops(
        *shape)
