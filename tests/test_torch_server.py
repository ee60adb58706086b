"""prdisagg_torch ScenarioServer over a Unix socket, on the CPU generator."""

import dataclasses
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch.api.pretrained import PretrainedGenerator  # noqa: E402
from prdisagg_torch.api.server import (  # noqa: E402
    ScenarioServer,
    request,
    scenarios_array,
)
from prdisagg_torch.core.config import smoke_model_config  # noqa: E402
from prdisagg_torch.ops import upsample_conv  # noqa: E402


@pytest.fixture
def served(tmp_path):
    cfg = dataclasses.replace(smoke_model_config(compute_dtype="float32"),
                              init_stddev=0.3)
    torch.manual_seed(0)
    from prdisagg_torch.models.generator import Generator

    params = Generator(cfg).state_dict()
    gen = PretrainedGenerator(params, cfg, device="cpu", seed=1)
    npz = str(tmp_path / "gen.npz")
    # the same weights in the JAX package's flat .npz layout, for reload
    tree = {"latent_proj/kernel": params["latent_proj.weight"].T,
            "latent_proj/bias": params["latent_proj.bias"],
            "head/kernel": params["head.weight"].permute(2, 3, 4, 1, 0),
            "head/bias": params["head.bias"]}
    for i in range(3):
        tree[f"conv{i}/kernel"] = params[f"conv{i}.weight"]
        tree[f"conv{i}/bias"] = params[f"conv{i}.bias"]
    np.savez(npz, **{f"params/{k}": v.numpy() for k, v in tree.items()})
    sock = str(tmp_path / "s.sock")
    yield gen, sock, npz, cfg


def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def test_server_protocol(served):
    gen, sock, npz, cfg = served
    server = ScenarioServer(gen, sock)
    thread = _serve(server)
    cond = np.random.RandomState(0).gamma(0.6, 12.0, (16, 16)).astype("f4")
    stack = np.stack([cond, 2 * cond, 0.5 * cond])
    before = upsample_conv.launches
    try:
        assert request(sock, {"cmd": "ping"}) == {"ok": True, "pong": True}
        info = request(sock, {"cmd": "info"})
        assert info["ok"] and info["ndomain"] == 16
        assert info["compute_dtype"] == "float32"
        assert info["max_batch"] == gen.max_batch

        r = request(sock, {"cond": cond.tolist(), "n_scenarios": 3})
        listed = scenarios_array(r)
        assert listed.shape == (3, 24, 16, 16)
        r = request(sock, {"cond": cond.tolist(), "n_scenarios": 3,
                           "encoding": "b64"})
        assert r["dtype"] == "float32"
        b64 = scenarios_array(r)
        assert b64.shape == (3, 24, 16, 16)
        for s in (listed, b64):
            np.testing.assert_allclose(s.sum(1), np.broadcast_to(cond, (3, 16, 16)),
                                       rtol=1e-5, atol=1e-5)
        r = request(sock, {"cond": stack.tolist(), "n_scenarios": 2})
        many = scenarios_array(r)
        assert many.shape == (3, 2, 24, 16, 16)
        for k in range(3):
            np.testing.assert_allclose(
                many[k].sum(1), np.broadcast_to(stack[k], (2, 16, 16)),
                rtol=1e-5, atol=1e-5)

        bad = request(sock, {"cond": np.zeros((5, 5)).tolist()})
        assert not bad["ok"] and "neither" in bad["error"]
        assert not request(sock, {"cmd": "nope"})["ok"]

        r = request(sock, {"cmd": "reload", "weights": npz})
        assert r["ok"] and r["reloaded"] == npz
        r = request(sock, {"cmd": "reload",
                           "weights": os.path.join(os.path.dirname(npz),
                                                   "missing.npz")})
        assert not r["ok"] and "still serving" in r["error"]

        stats = request(sock, {"cmd": "stats"})
        assert stats["ok"] and stats["scenario_requests"] == 4
        assert stats["scenarios"] == 3 + 3 + 6 and stats["errors"] == 1
        assert stats["reloads"] == 1 and stats["latency_ms"]["count"] == 3
        assert request(sock, {"cmd": "shutdown"})["shutdown"] is True
    finally:
        server.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert not os.path.exists(sock)
    assert upsample_conv.launches == before  # CPU: the plain path only


def test_server_micro_batching_fuses_requests(served):
    gen, sock, _, _ = served
    server = ScenarioServer(gen, sock, batch_window_ms=300)
    thread = _serve(server)
    cond = np.random.RandomState(1).gamma(0.6, 12.0, (16, 16)).astype("f4")
    results = [None] * 4

    def client(i):
        results[i] = request(sock, {"cond": (cond * (i + 1)).tolist(),
                                    "n_scenarios": i + 1, "encoding": "b64"})

    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        assert all(not c.is_alive() for c in clients)
        for i, r in enumerate(results):
            s = scenarios_array(r)
            assert s.shape == (i + 1, 24, 16, 16)
            np.testing.assert_allclose(
                s.sum(1), np.broadcast_to(cond * (i + 1), (i + 1, 16, 16)),
                rtol=1e-5, atol=1e-4)
        assert 1 <= server.fused_batches < 4
        request(sock, {"cmd": "shutdown"})
    finally:
        server.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("window_ms", [0, 50])
def test_stats_report_queue_waits_of_served_requests(served, window_ms):
    """queue_wait_ms counts every served scenario request, the compute
    lock's wait unbatched and the batcher's queue batched, and each of its
    percentiles lies within the matching latency's (a request's wait is a
    part of its latency)."""
    gen, sock, _, _ = served
    server = ScenarioServer(gen, sock, batch_window_ms=window_ms)
    thread = _serve(server)
    cond = np.random.RandomState(2).gamma(0.6, 12.0, (16, 16)).astype("f4")

    def client(i):
        request(sock, {"cond": cond.tolist(), "n_scenarios": i + 1,
                       "encoding": "b64"})

    try:
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        assert all(not c.is_alive() for c in clients)
        client(3)
        bad = request(sock, {"cond": np.zeros((5, 5)).tolist()})
        assert not bad["ok"]
        stats = request(sock, {"cmd": "stats"})
        lat, wait = stats["latency_ms"], stats["queue_wait_ms"]
        assert stats["scenario_requests"] == 5 and stats["errors"] == 1
        assert wait["count"] == lat["count"] == 4
        for key in ("p50", "p90", "p99", "max"):
            assert 0 <= wait[key] <= lat[key]
        request(sock, {"cmd": "shutdown"})
    finally:
        server.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
