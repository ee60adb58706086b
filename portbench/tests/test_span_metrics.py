"""The readers of the program's spans (``k1_host_ms_per_request.serve``,
``k1_idle_share.serve``, ``program_idle_share.serve``,
``host_syncs_per_request.serve``) on hand-built traces whose answers are
worked out by hand."""

import random

import pytest

from portbench import harness
from portbench.trace import Trace

NEW = ("k1_host_ms_per_request.serve", "k1_idle_share.serve",
       "program_idle_share.serve", "host_syncs_per_request.serve")


def read(name, tr):
    return harness.Bench.load().reader(name).read(
        {"trace": tr, "kind_of_cell": "serve"})


def hand_trace() -> Trace:
    """A slice of 2 requests in the window [1000, 2000] us, after a warm-up
    request that must not count.

    Device busy: [1000,1120] [1180,1220] [1300,1420] [1460,1520]
    [1650,2000], 690 us; idle gaps [1120,1180] 60, [1220,1300] 80,
    [1420,1460] 40 (between the requests), [1520,1650] 130: 310 us.
    Requests [1000,1400] and [1500,1900] hold 60 + 80 + 130 = 270 us of it.
    K1 spans, overlapping, [1100,1200] and [1150,1260] (union [1100,1260],
    160 us), and [1600,1700]: they hold 60, half of the gap [1220,1300]
    (40) and 50 of [1520,1650], 150 us; 260 us of host time in all.
    Syncs inside the requests: at 1020, 1350 (a blocking memcpy), 1380
    (a ``_ptsz`` variant) and 1650, 4; outside: the warm-up's at 850, one
    between the requests at 1450 and the slice's last at 1950."""
    host = [
        # the warm-up request, before the window
        ("prdisagg.request", 100.0, 900.0),
        ("prdisagg.k1", 200.0, 300.0),
        ("cudaStreamSynchronize", 850.0, 880.0),
        # request 1
        ("prdisagg.request", 1000.0, 1400.0),
        ("cudaStreamSynchronize", 1020.0, 1030.0),
        ("prdisagg.forward", 1050.0, 1300.0),
        ("prdisagg.k1", 1100.0, 1200.0),
        ("prdisagg.k1.pack", 1100.0, 1150.0),
        ("aten::einsum", 1105.0, 1140.0),
        ("prdisagg.k1", 1150.0, 1260.0),
        ("cudaLaunchKernel", 1250.0, 1255.0),
        ("prdisagg.fetch", 1340.0, 1390.0),
        ("cudaMemcpyAsync", 1340.0, 1345.0),
        ("cudaMemcpy", 1350.0, 1360.0),
        ("cudaStreamSynchronize_ptsz", 1380.0, 1390.0),
        # the caller, between the requests
        ("cudaDeviceSynchronize", 1450.0, 1460.0),
        # request 2
        ("prdisagg.request", 1500.0, 1900.0),
        ("prdisagg.forward", 1550.0, 1800.0),
        ("prdisagg.k1", 1600.0, 1700.0),
        ("cudaEventSynchronize", 1650.0, 1660.0),
        # the slice's closing synchronise
        ("cudaStreamSynchronize", 1950.0, 1990.0),
    ]
    device = [("k1_f32_fma", 1000.0, 1120.0), ("k1_f32_fma", 1180.0, 1220.0),
              ("elementwise", 1300.0, 1420.0),
              ("Memcpy DtoH (Device -> Pageable)", 1460.0, 1520.0),
              ("k1_f32_fma", 1650.0, 2000.0)]
    return Trace(units=2, window_us=1000.0, device=device, host=host,
                 start_us=1000.0)


def without_spans(tr: Trace) -> Trace:
    return Trace(units=tr.units, window_us=tr.window_us, device=tr.device,
                 host=[h for h in tr.host if not h[0].startswith("prdisagg.")],
                 start_us=tr.start_us)


def test_k1_host_ms_is_the_union_of_k1_spans_in_the_window():
    # (160 + 100) us over 2 requests; the warm-up's span left out
    assert read("k1_host_ms_per_request.serve", hand_trace()) == \
        pytest.approx(0.13)


def test_k1_idle_share_intersects_gaps_with_k1_spans():
    # 60 + 40 (half of a gap) + 50 us of 1000
    assert read("k1_idle_share.serve", hand_trace()) == pytest.approx(15.0)


def test_program_idle_share_leaves_the_caller_out():
    tr = hand_trace()
    assert read("program_idle_share.serve", tr) == pytest.approx(27.0)
    assert read("idle_share.serve", tr) == pytest.approx(31.0)


def test_host_syncs_count_only_those_inside_requests():
    assert read("host_syncs_per_request.serve", hand_trace()) == \
        pytest.approx(2.0)


@pytest.mark.parametrize("name", NEW)
def test_a_trace_without_spans_reads_nothing(name):
    tr = hand_trace()
    assert read(name, without_spans(tr)) is None
    assert read(name, None) is None
    # a request only before the window is no request of the slice
    early = Trace(units=tr.units, window_us=tr.window_us, device=tr.device,
                  host=tr.host[:3], start_us=tr.start_us)
    assert read(name, early) is None


def test_a_spanless_trace_keeps_the_other_metrics_and_drops_the_new():
    bench = harness.Bench.load()
    metrics = bench.per_layer("flagship16.serve_f32")
    assert set(NEW) <= {m["name"] for m in metrics}
    facts = {"trace": without_spans(hand_trace()), "kind_of_cell": "serve"}
    out = harness.read_metrics(bench, metrics, facts)
    assert "idle_share.serve" in out and "d2h_ms_per_request.serve" in out
    assert not set(NEW) & set(out)


def random_trace(rng: random.Random) -> Trace:
    """A slice of requests in turn, each with K1 spans inside it, over
    device intervals drawn anywhere in the window."""
    lo, t, host = 1000.0, 1000.0, []
    units = rng.randint(1, 5)
    for _ in range(units):
        a = t + rng.uniform(0, 50)
        b = a + rng.uniform(50, 400)
        host.append(("prdisagg.request", a, b))
        for _ in range(rng.randint(0, 4)):
            s = rng.uniform(a, b)
            host.append(("prdisagg.k1", s, rng.uniform(s, b)))
        t = b
    hi = t + rng.uniform(0, 50)
    device = []
    for _ in range(rng.randint(1, 30)):
        s = rng.uniform(lo, hi)
        device.append(("k", s, min(hi, s + rng.uniform(1, 100))))
    return Trace(units=units, window_us=hi - lo, device=device, host=host,
                 start_us=lo)


def test_k1_idle_within_program_idle_within_all_idle():
    rng = random.Random(19)
    for _ in range(200):
        tr = random_trace(rng)
        k1 = read("k1_idle_share.serve", tr)
        program = read("program_idle_share.serve", tr)
        total = read("idle_share.serve", tr)
        assert 0.0 <= k1 <= program + 1e-9
        assert program <= total + 1e-9
