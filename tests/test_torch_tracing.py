"""The port's spans (utils/profiling.py ``span``) on the serving path, on the
CPU: off, they never reach ``record_function``; under a profiler, one
request nests its chunks' forwards, each forward its upsample-conv calls,
then the touch of the response's pages and each chunk's copy, on the
calling thread."""

import contextlib
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.api.pretrained import PretrainedGenerator  # noqa: E402
from prdisagg_torch.core.config import smoke_model_config  # noqa: E402
from prdisagg_torch.models.generator import Generator  # noqa: E402
from prdisagg_torch.utils import profiling  # noqa: E402

SPANS = ("prdisagg.request", "prdisagg.forward", "prdisagg.k1",
         "prdisagg.k1.pack", "prdisagg.pixel_norm", "prdisagg.fetch",
         "prdisagg.fetch.touch")


@pytest.fixture(scope="module")
def generator():
    """A small random 16x16 generator on the CPU, chunked at 4."""
    cfg = smoke_model_config(compute_dtype="float32")
    torch.manual_seed(0)
    return PretrainedGenerator(Generator(cfg).state_dict(), cfg,
                               device="cpu", seed=1, max_batch=4)


def _cond(seed=0):
    return np.random.RandomState(seed).gamma(0.6, 12.0, (16, 16)).astype("f4")


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name in SPANS]


def _parent_span(e):
    """The nearest enclosing span of event e, by the cpu_parent chain."""
    p = e.cpu_parent
    while p is not None and p.name not in SPANS:
        p = p.cpu_parent
    return p


def test_span_off_never_calls_record_function(generator, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with profiling.span("prdisagg.request"):
        pass
    # one shared no-op
    off = profiling.span("prdisagg.fetch.touch")
    assert off is profiling.span("a") is profiling.span("b")
    assert isinstance(off, contextlib.nullcontext)
    out = generator.generate_scenarios(_cond(), 8)
    assert out.shape == (8, 24, 16, 16)


def test_a_request_nests_its_forwards_k1_calls_and_fetch(generator):
    spans = _profiled(lambda: generator.generate_scenarios(_cond(), 8))
    by = {n: [e for e in spans if e.name == n] for n in SPANS}
    assert len(by["prdisagg.request"]) == 1
    (req,) = by["prdisagg.request"]
    assert _parent_span(req) is None
    # n_scenarios 8 at max_batch 4: two chunks, three K1 stages each
    assert len(by["prdisagg.forward"]) == 2
    for fwd in by["prdisagg.forward"]:
        assert _parent_span(fwd) is req
    assert len(by["prdisagg.k1"]) == 6
    for fwd in by["prdisagg.forward"]:
        assert sum(_parent_span(k) is fwd for k in by["prdisagg.k1"]) == 3
    # the page touch, then one copy a chunk, after every forward was queued
    (touch,) = by["prdisagg.fetch.touch"]
    fetches = by["prdisagg.fetch"]
    assert len(fetches) == 2
    for e in (touch, *fetches):
        assert _parent_span(e) is req
    order = sorted(by["prdisagg.forward"] + [touch] + fetches,
                   key=lambda e: e.time_range.start)
    assert [e.name for e in order] == [
        "prdisagg.forward", "prdisagg.forward", "prdisagg.fetch.touch",
        "prdisagg.fetch", "prdisagg.fetch"]
    for a, b in zip(order, order[1:]):  # one after another, none nested
        assert a.time_range.end <= b.time_range.start
    assert by["prdisagg.k1.pack"] == []  # the CPU runs the plain version


def test_each_forward_nests_a_pixel_norm_span_a_stage(generator):
    spans = _profiled(lambda: generator.generate_scenarios(_cond(), 8))
    fwds = [e for e in spans if e.name == "prdisagg.forward"]
    norms = [e for e in spans if e.name == "prdisagg.pixel_norm"]
    assert len(fwds) == 2 and len(norms) == 6
    for fwd in fwds:
        assert sum(_parent_span(e) is fwd for e in norms) == 3


@pytest.mark.parametrize("call", ["batch", "multi"])
def test_fused_calls_are_one_request_each(generator, call):
    conds = np.stack([_cond(1), _cond(2)])
    if call == "batch":
        def fn():
            return generator.generate_scenarios_batch(conds, 3)
    else:
        def fn():
            return generator.generate_scenarios_multi(list(conds), [3, 2])
    spans = _profiled(fn)
    reqs = [e for e in spans if e.name == "prdisagg.request"]
    assert len(reqs) == 1
    others = [e for e in spans if e.name != "prdisagg.request"]
    assert others and all(_parent_span(e) is not None for e in others)
    fwds = [e for e in spans if e.name == "prdisagg.forward"]
    assert len(fwds) == 2  # 6 and 5 (bucketed to 6) rows at max_batch 4


def test_trace_file_holds_the_span_names(generator, tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        generator.generate_scenarios(_cond(), 8)
    files = list(pathlib.Path(tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    for name in ("prdisagg.request", "prdisagg.forward", "prdisagg.k1",
                 "prdisagg.fetch", "prdisagg.fetch.touch"):
        assert name in names
