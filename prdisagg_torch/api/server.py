"""Persistent scenario-serving daemon over a Unix domain socket.

One resident process owns the device and keeps the generator's weights on
it; cheap clients talk newline-delimited JSON over a Unix socket.
Connections are handled in threads; compute is serialized behind one lock
(one device = one compute queue) but client I/O is not, so a stalled or
slow-reading client never blocks other clients — only its own connection
(which times out after 60 s).

Protocol — one JSON object per line, one JSON response line per request:

    {"cmd": "ping"}                    -> {"ok": true, "pong": true}
    {"cmd": "info"}                    -> {"ok": true, "ndomain": ..., ...}
    {"cmd": "stats"}                   -> {"ok": true, "uptime_s": ...,
                                           "latency_ms": {"p50": ...}, ...}
    {"cmd": "reload", "weights": "gen_epoch21.h5"}
        -> {"ok": true, "reloaded": "...", "seconds": ...}
    {"cmd": "shutdown"}                -> {"ok": true, "shutdown": true}
    {"cond": [[...]], "n_scenarios": 10}
        -> {"ok": true, "scenarios": [...], "shape": [...], "seconds": ...}
    {"cond": [[...]], "n_scenarios": 100, "encoding": "b64"}
        -> {"ok": true, "scenarios_b64": "...", "dtype": "float32",
            "shape": [...], "seconds": ...}
    {"cond_npy": "in.npy", "n_scenarios": 1000, "out": "out.npy"}
        -> {"ok": true, "out": "out.npy", "shape": [...], "seconds": ...}

`cond` / `cond_npy` may be one (nd, nd)[, 1] daily-sum map — reference
`generate_scenarios` semantics — or a (K, nd, nd)[, 1] stack, which is
served as ONE fused forward (`generate_scenarios_batch`).  Large results
must use "out" (saved atomically as .npy); inline JSON responses are capped.

Weight watching (`watch_path`): a daemon thread polls a weight file (reload
on mtime change) or a directory (reload when a newer `gen_*.h5`/`gen_*.npz`
appears — the per-epoch export layout of training runs), hot-swapping via
the same validated reload path.  `gen_*` also matches the `gen_ema_*`
exports, which a run with EMA on writes last each epoch.  A file that
fails to load (wrong architecture, torn write from a non-atomic producer)
is refused, logged, and retried on the next change; the old weights keep
serving.

Operability: `stats` reports uptime, request/error/fused-batch counters,
total scenarios generated, and client-observed latency percentiles over
the last 2048 scenario requests (wall time from request admission to
response encode — queueing and lock waits included, so it is the number
an SLA cares about), and beside them `queue_wait_ms`, the same requests'
waits from admission to the start of their compute (the batcher's queue,
or the compute lock), which tell queueing apart from compute.  `reload`
hot-swaps the served weights from a `.h5`/`.npz` file of the SAME
architecture without dropping a request
(`PretrainedGenerator.reload_params`); a mismatched file is refused and the
old weights keep serving.  The swap is atomic: an in-flight forward uses
whichever weights it already grabbed, never a mix.

Encoding: the default inline response is a nested float list — friendly
to any JSON client but paid for in host CPU (a 100-scenario flagship
response is 614k floats to format).  `"encoding": "b64"` returns the same
f32 array as base64 of its C-order bytes instead (decode with
`scenarios_array(resp)`), turning the encode into two memcpy-rate passes.
A request error never kills the server: {"ok": false, "error": "..."}.

Dynamic micro-batching (`batch_window_ms` > 0): concurrent scenario
requests arriving within the window fuse into ONE device forward
(generate_scenarios_multi) — a little queueing latency for a full batch
dimension, so K concurrent 1-scenario clients pay one forward instead of
K.  Off by default: the unbatched path replays the exact sequential
per-request random stream.

Data-parallel serving (``serve --dp N``): every rank loads the generator
with the mesh (api/pretrained.py) and warms it; rank 0 owns the socket and
serves through a :class:`MeshLeader`, which, before each forward or
reload, broadcasts a header (what to run, and the shapes) and then the
conditions to the other ranks; those run :func:`follow`, which receives
each one and joins the collective forward with the same arguments, so every
rank draws the same latents and runs its shard.  Rank 0 broadcasts a stop
when it shuts down (a shutdown request, SIGTERM, SIGINT); a follower
ignores SIGTERM and SIGINT and waits for it.
"""

from __future__ import annotations

import base64
import collections
import json
import math
import os
import socket
import threading
import time
from typing import Optional

import numpy as np
import torch

from prdisagg_torch.parallel.mesh import replicate
from prdisagg_torch.utils.watchdog import beat_if_enabled

# inline float lists above this many elements are refused (JSON encoding of
# a 1000-scenario flagship response would be ~600 MB of text); callers pass
# "out" instead and get an .npy, or "encoding": "b64" whose cheaper/denser
# wire format affords a larger cap (2^25 elements = 134 MB raw, ~179 MB b64)
INLINE_CAP = 2_000_000
B64_CAP = 1 << 25


def watch_signature(path: str):
    """(mtime_ns, path) of a watched weight file, or of the newest gen_*
    weight export in a watched directory (the per-epoch export layout);
    None while nothing matches.  Module-level so a daemon launcher can
    capture the baseline at WEIGHT-LOAD time: an export landing while the
    daemon warms up must still trigger the first watcher reload."""
    try:
        if os.path.isdir(path):
            import glob as _glob

            cands = [f for pat in ("gen_*.h5", "gen_*.npz")
                     for f in _glob.glob(os.path.join(path, pat))]
            if not cands:
                return None
            return max((os.stat(f).st_mtime_ns, f) for f in cands)
        return (os.stat(path).st_mtime_ns, path)
    except OSError:  # vanished between glob and stat, or no file yet
        return None


_BASELINE_NOW = object()  # sentinel: capture the watch baseline in __init__


def _percentiles_ms(secs: list) -> dict:
    """{count, p50, p90, p99, max} in ms of sorted seconds, nearest rank
    (ceil); {count: 0} when empty."""
    if not secs:
        return {"count": 0}

    def pct(q):
        idx = max(0, math.ceil(q * len(secs)) - 1)
        return round(1e3 * secs[min(len(secs) - 1, idx)], 2)

    return {"count": len(secs), "p50": pct(0.50), "p90": pct(0.90),
            "p99": pct(0.99), "max": round(1e3 * secs[-1], 2)}


class _Pending:
    """One scenario request waiting in the micro-batch queue."""

    __slots__ = ("cond", "n", "is_stack", "event", "scenarios", "error",
                 "seconds", "queued", "waited")

    def __init__(self, cond, n, is_stack):
        self.cond = cond
        self.n = n
        self.is_stack = is_stack
        self.event = threading.Event()
        self.scenarios = None
        self.error = None
        self.seconds = 0.0
        self.queued = time.perf_counter()
        self.waited = None  # seconds from the enqueue to its batch's start

    @property
    def samples(self) -> int:
        return (self.cond.shape[0] if self.is_stack else 1) * self.n


class ScenarioServer:
    """Serve a prdisagg_torch PretrainedGenerator over a Unix socket until
    shutdown.

    `batch_window_ms` > 0 turns on dynamic micro-batching: concurrent
    scenario requests that arrive within the window (counted from the
    first waiting request) fuse into ONE device forward
    (`generate_scenarios_multi`), so K concurrent small clients cost one
    forward instead of K.  Collection stops early once the fused batch
    reaches `max_batch` samples.  Each request still gets independent
    N(0,1) latents, but the exact values depend on which requests were
    batched together — with the window at 0 (default) the daemon keeps the
    sequential per-request random stream exactly."""

    def __init__(self, generator, socket_path: str, backlog: int = 128,
                 batch_window_ms: float = 0.0,
                 watch_path: Optional[str] = None,
                 watch_interval_s: float = 5.0,
                 watch_baseline=_BASELINE_NOW):
        self.generator = generator
        self.socket_path = socket_path
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(socket_path)
        self._sock.listen(backlog)
        self._shutdown = False
        # one device = one compute queue: requests execute one at a time
        # (the generator's random stream is a read-modify-write too), but each
        # CONNECTION gets its own thread so a stalled client's socket
        # timeout never blocks other clients
        self._compute_lock = threading.Lock()
        # admission gets its own lock: the check+count must be atomic, but
        # it must never wait behind a long forward holding _compute_lock —
        # control commands (stats: the SLA probe) are admitted and answered
        # DURING compute
        self._admission_lock = threading.Lock()
        self._served = 0  # mutated under _admission_lock only
        # observability (cmd "stats"): counters + a latency ring buffer of
        # recent scenario requests, guarded by their own lock so recording
        # never contends with compute
        self._t_start = time.time()
        self._stats_lock = threading.Lock()
        self._latencies = collections.deque(maxlen=2048)
        # the same requests' waits from admission to the start of their
        # compute (the batcher's queue, or the compute lock)
        self._queue_waits = collections.deque(maxlen=2048)
        self._scenario_requests = 0
        self._scenarios_out = 0
        self._errors = 0
        self._reloads = 0
        self._last_reload = None
        self._batch_window = batch_window_ms / 1e3
        self._queue = None
        self._batcher = None
        self.fused_batches = 0  # batches run by the batcher thread
        if self._batch_window > 0:
            import queue as _queue

            self._queue = _queue.Queue()
            self._batcher = threading.Thread(
                target=self._batcher_loop, daemon=True)
            self._batcher.start()
        # weight watching: the baseline signature marks what the served
        # weights already reflect.  Launchers that load weights long before
        # constructing the server (warming up in between) pass the
        # signature captured at LOAD time, so an export
        # landing inside that window still triggers the first reload;
        # direct constructions default to "now" (the generator was just
        # loaded).
        self._watch_path = watch_path
        self._watch_interval = watch_interval_s
        self._watcher = None
        if watch_path is not None:
            self._watch_sig = (self._watch_signature()
                               if watch_baseline is _BASELINE_NOW
                               else watch_baseline)
            self._watcher = threading.Thread(
                target=self._watcher_loop, daemon=True)
            self._watcher.start()

    # -- request handling ------------------------------------------------------
    def handle_request(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd == "ping":
            return {"ok": True, "pong": True}
        if cmd == "info":
            cfg = self.generator.cfg
            return {
                "ok": True, "ndomain": cfg.ndomain, "nhours": cfg.nhours,
                "latent_dim": cfg.latent_dim,
                "compute_dtype": cfg.compute_dtype,
                "wire_dtype": getattr(self.generator, "wire_dtype", None),
                "max_batch": self.generator.max_batch,
                "batch_window_ms": self._batch_window * 1e3,
                "fused_batches": self.fused_batches,
                "served": self._served,
            }
        if cmd == "stats":
            return self._stats()
        if cmd == "reload":
            return self._reload(req)
        if cmd == "shutdown":
            self._shutdown = True
            return {"ok": True, "shutdown": True}
        if cmd is not None:
            return {"ok": False, "error": f"unknown cmd {cmd!r}"}

        parsed = self._parse_scenario(req)
        if isinstance(parsed, dict):
            return parsed
        cond, n, is_stack, encoding, out = parsed
        t0 = time.perf_counter()
        if is_stack:  # (K, nd, nd)[, 1] stack -> one fused batch
            scenarios = self.generator.generate_scenarios_batch(cond, n)
        else:
            scenarios = self.generator.generate_scenarios(cond, n)
        return self._encode_response(
            scenarios, encoding, out, time.perf_counter() - t0)

    # -- operability: stats + hot reload ---------------------------------------
    def _stats(self) -> dict:
        with self._stats_lock:
            lats = sorted(self._latencies)
            waits = sorted(self._queue_waits)
            out = {
                "ok": True,
                "uptime_s": round(time.time() - self._t_start, 1),
                "served": self._served,
                "scenario_requests": self._scenario_requests,
                "scenarios": self._scenarios_out,
                "errors": self._errors,
                "fused_batches": self.fused_batches,
                "batch_window_ms": self._batch_window * 1e3,
                "reloads": self._reloads,
                "last_reload": self._last_reload,
                "watch_path": self._watch_path,
            }
        out["latency_ms"] = _percentiles_ms(lats)
        if lats:
            out["latency_ms"]["mean"] = round(1e3 * sum(lats) / len(lats), 2)
        out["queue_wait_ms"] = _percentiles_ms(waits)
        return out

    def _reload(self, req: dict) -> dict:
        """Hot-swap the served weights from a .h5/.npz of the same
        architecture.  The load + validation happen on the host; the swap
        is one atomic assignment (PretrainedGenerator.reload_params), so
        the random stream is untouched.  A mismatched or unreadable file is
        refused and the old weights keep serving."""
        path = req.get("weights")
        if not path:
            return {"ok": False, "error": "reload needs 'weights': <path "
                                          "to a .h5 or .npz of the same "
                                          "architecture>"}
        return self._reload_from(path)

    def _reload_from(self, path: str) -> dict:
        t0 = time.perf_counter()
        try:
            params = self.generator.load_weights_file(path)
            self.generator.reload_params(params)
        except Exception as err:  # noqa: BLE001 — refuse, keep serving
            return {"ok": False,
                    "error": f"reload refused ({type(err).__name__}: {err}); "
                             "still serving the previous weights"}
        with self._stats_lock:
            self._reloads += 1
            self._last_reload = path
        return {"ok": True, "reloaded": path,
                "seconds": round(time.perf_counter() - t0, 3)}

    # -- weight watching ---------------------------------------------------------
    def _watch_signature(self):
        return watch_signature(self._watch_path)

    def _watcher_loop(self) -> None:
        """Poll the watch path and hot-swap when a newer weight file
        appears.  A failing load (mismatched architecture, torn write from
        a non-atomic producer) is logged and retried on the NEXT signature
        change — the signature is still advanced, so one bad file cannot
        spin the loop."""
        next_check = 0.0
        while not self._shutdown:
            # 0.2 s granularity keeps shutdown responsive at any interval
            time.sleep(0.2)
            now = time.monotonic()
            if now < next_check:
                continue
            next_check = now + self._watch_interval
            sig = self._watch_signature()
            if sig is None or sig == self._watch_sig:
                continue
            self._watch_sig = sig
            resp = self._reload_from(sig[1])
            if resp.get("ok"):
                print(f"[serve] reloaded {sig[1]} "
                      f"({resp['seconds']}s)", flush=True)
            else:
                print(f"[serve] watch: {resp['error']}", flush=True)

    def _record_scenario(self, resp: dict, wall_s: float,
                         wait_s: Optional[float]) -> None:
        """Fold one scenario request into the stats (wire-level wall time:
        admission -> response built, queue/lock waits included; `wait_s`
        the part of it before its compute started)."""
        per_scenario = (self.generator.cfg.nhours
                        * self.generator.cfg.ndomain ** 2)
        with self._stats_lock:
            self._scenario_requests += 1
            if resp.get("ok"):
                n = 1
                for d in resp.get("shape", []):
                    n *= d
                self._scenarios_out += n // per_scenario
                self._latencies.append(wall_s)
                self._queue_waits.append(wait_s)
            else:
                self._errors += 1

    def _parse_scenario(self, req):
        """Validate a scenario request.  Returns (cond, n, is_stack,
        encoding, out), or an error-response dict.  Runs in the handler
        thread so bad input (and cond_npy disk I/O) never reaches the
        compute path."""
        if "cond_npy" in req:
            cond = np.load(req["cond_npy"])
        elif "cond" in req:
            cond = np.asarray(req["cond"], dtype=np.float32)
        else:
            return {"ok": False,
                    "error": "request needs 'cond', 'cond_npy', or 'cmd'"}
        n = int(req.get("n_scenarios", 10))
        if n < 1:
            return {"ok": False, "error": f"n_scenarios must be >= 1, got {n}"}
        encoding = req.get("encoding", "list")
        if encoding not in ("list", "b64"):
            return {"ok": False,
                    "error": f"unknown encoding {encoding!r} "
                             "(expected 'list' or 'b64')"}
        nd = self.generator.cfg.ndomain
        nc = self.generator.cfg.n_cond_channels
        # base (nc == 1) keeps the channel-less forms; variant generators
        # (doy nc=3, lon nc=2) need explicit channels-last conditioning
        is_map = cond.shape[:2] == (nd, nd) and (
            (cond.ndim == 2 and nc == 1)
            or (cond.ndim == 3 and cond.shape[2] == nc))
        is_stack = ((cond.ndim == 3 and nc == 1
                     and cond.shape[1:] == (nd, nd)) or (
            cond.ndim == 4 and cond.shape[1:] == (nd, nd, nc))
        ) and cond.shape[0] >= 1
        if not (is_map or is_stack):
            ch = "[, 1]" if nc == 1 else f", {nc}"
            return {"ok": False,
                    "error": f"cond shape {cond.shape} is neither one "
                             f"({nd}, {nd}{ch}) map nor a "
                             f"(K, {nd}, {nd}{ch}) stack"}
        return cond, n, is_stack, encoding, req.get("out")

    def _encode_response(self, scenarios, encoding, out, seconds) -> dict:
        resp = {"ok": True, "shape": list(scenarios.shape),
                "seconds": round(seconds, 4)}
        if out:
            # atomic like the weight exports: a client killed mid-response
            # must never leave a truncated .npy behind
            tmp = f"{out}.tmp-{os.getpid()}"
            with open(tmp, "wb") as fh:
                np.save(fh, scenarios.astype(np.float32))
            os.replace(tmp, out)
            resp["out"] = out
        elif encoding == "b64":
            if scenarios.size > B64_CAP:
                return {"ok": False,
                        "error": f"result has {scenarios.size} elements "
                                 f"(> b64 cap {B64_CAP}); pass 'out' "
                                 "to receive an .npy path"}
            arr = np.ascontiguousarray(scenarios, dtype=np.float32)
            resp["scenarios_b64"] = base64.b64encode(arr.tobytes()).decode(
                "ascii")
            resp["dtype"] = "float32"
        elif scenarios.size <= INLINE_CAP:
            resp["scenarios"] = scenarios.tolist()
        else:
            return {"ok": False,
                    "error": f"result has {scenarios.size} elements "
                             f"(> inline cap {INLINE_CAP}); pass 'out' to "
                             "receive an .npy path, or 'encoding': 'b64'"}
        return resp

    # -- micro-batching ----------------------------------------------------------
    def _submit_batched(self, req: dict) -> tuple:
        """Parse in this handler thread, enqueue for the batcher thread,
        wait, then encode here (disk I/O and JSON/b64 encode stay off the
        compute path and overlap across clients).  Returns the response
        and the seconds the request waited in the queue (None if its
        compute never started)."""
        parsed = self._parse_scenario(req)
        if isinstance(parsed, dict):
            return parsed, None
        cond, n, is_stack, encoding, out = parsed
        item = _Pending(cond, n, is_stack)
        self._queue.put(item)
        # generous: a first fused batch may also pay the kernel build
        if not item.event.wait(timeout=1200.0):
            return {"ok": False, "error": "batched compute timed out"}, None
        if item.error is not None:
            return {"ok": False, "error": item.error}, item.waited
        return self._encode_response(item.scenarios, encoding, out,
                                     item.seconds), item.waited

    def _batcher_loop(self) -> None:
        """Single compute thread: collect requests for up to the batch
        window (from the first waiting request) or until `max_batch`
        samples, then run them as ONE fused forward.  Exits on the None
        sentinel; keeps draining queued requests after shutdown so no
        waiting client is orphaned."""
        import queue as _queue

        while True:
            try:
                first = self._queue.get(timeout=0.2)
            except _queue.Empty:
                if self._shutdown:
                    return
                continue
            if first is None:
                return
            batch, total = [first], first.samples
            deadline = time.perf_counter() + self._batch_window
            stop = False
            while total < self.generator.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except _queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
                total += item.samples
            try:
                self._run_batch(batch)
            except Exception as err:  # noqa: BLE001 — the batcher thread
                # must survive anything; orphaned waiters get the error
                for item in batch:
                    if not item.event.is_set():
                        item.error = f"{type(err).__name__}: {err}"
                        item.event.set()
            beat_if_enabled()
            if stop:
                return

    def _run_batch(self, batch: list) -> None:
        t_run = time.perf_counter()
        for item in batch:
            if item.waited is None:  # a retry alone keeps the first start
                item.waited = t_run - item.queued
        conds, ns, spans = [], [], []
        for item in batch:
            if item.is_stack:
                for row in item.cond:  # each stack row is its own cond
                    conds.append(row)
                    ns.append(item.n)
                spans.append(item.cond.shape[0])
            else:
                conds.append(item.cond)
                ns.append(item.n)
                spans.append(1)
        t0 = time.perf_counter()
        try:
            outs = self.generator.generate_scenarios_multi(conds, ns)
        except Exception as err:  # noqa: BLE001 — fail-isolate, serve on
            if len(batch) == 1:
                item = batch[0]
                item.error = f"{type(err).__name__}: {err}"
                item.event.set()
                return
            # one request's failure (e.g. an absurd n_scenarios OOMing the
            # fused allocation) must not fail innocent co-batched clients:
            # retry each request as its own batch, isolating the offender
            for item in batch:
                self._run_batch([item])
            return
        seconds = time.perf_counter() - t0
        self.fused_batches += 1
        j = 0
        for item, k in zip(batch, spans):
            item.scenarios = (np.stack(outs[j:j + k]) if item.is_stack
                              else outs[j])
            item.seconds = seconds
            j += k
            item.event.set()

    # -- accept loop ------------------------------------------------------------
    def _handle_connection(self, conn, max_requests: Optional[int]) -> None:
        try:
            rfile = conn.makefile("rb")
            for line in rfile:
                line = line.strip()
                if not line:
                    continue
                # admission is atomic (check + count under one lock), so
                # max_requests bounds total served even across connections
                with self._admission_lock:
                    stop = self._shutdown or (
                        max_requests is not None
                        and self._served >= max_requests)
                    if not stop:
                        self._served += 1
                        beat_if_enabled()
                if stop:
                    break
                try:
                    req = json.loads(line)
                    if not isinstance(req, dict):
                        raise TypeError(
                            f"request must be a JSON object, got "
                            f"{type(req).__name__}")
                except Exception as err:  # noqa: BLE001 — serve on
                    req = None
                    resp = {"ok": False,
                            "error": f"{type(err).__name__}: {err}"}
                if req is not None:
                    is_scenario = req.get("cmd") is None
                    t_req = time.perf_counter()
                    wait_s = None
                    try:
                        if self._queue is not None and is_scenario:
                            # micro-batched: EVERY scenario compute runs in
                            # the batcher thread (this thread parses, waits,
                            # encodes) — including {"cmd": null, "cond": ...},
                            # which must not race the batcher's random stream
                            resp, wait_s = self._submit_batched(req)
                        elif is_scenario:
                            # compute + the generator's random stream are
                            # single-file; the sendall below is NOT, so a
                            # slow reader only delays itself
                            with self._compute_lock:
                                wait_s = time.perf_counter() - t_req
                                resp = self.handle_request(req)
                        else:
                            # control commands never wait on compute: stats
                            # must answer DURING a long forward (it is the
                            # SLA probe), and reload's swap is one atomic
                            # assignment an in-flight forward never sees
                            # half-done (reload_params) — the watcher already
                            # runs the identical path lock-free
                            resp = self.handle_request(req)
                    except Exception as err:  # noqa: BLE001 — serve on
                        resp = {"ok": False,
                                "error": f"{type(err).__name__}: {err}"}
                    if is_scenario:
                        self._record_scenario(
                            resp, time.perf_counter() - t_req, wait_s)
                conn.sendall(json.dumps(resp).encode() + b"\n")
                if self._shutdown or (max_requests is not None
                                      and self._served >= max_requests):
                    break
        except (socket.timeout, BrokenPipeError, ConnectionError):
            pass  # that client is gone; keep serving others
        finally:
            conn.close()

    def serve_forever(self, max_requests: Optional[int] = None) -> int:
        """Accept connections until a shutdown request (or max_requests
        total responses, for tests/smoke runs).  Each connection runs in
        its own thread.  Returns the number of requests served."""
        threads = []
        self._sock.settimeout(1.0)  # poll for shutdown set by a handler
        try:
            while not self._shutdown:
                if max_requests is not None and self._served >= max_requests:
                    break
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break  # listener closed under us
                # a stalled client must not wedge its handler forever
                conn.settimeout(60.0)
                t = threading.Thread(
                    target=self._handle_connection,
                    args=(conn, max_requests), daemon=True)
                t.start()
                threads = [x for x in threads if x.is_alive()]
                threads.append(t)
        finally:
            # handler threads first: the batcher keeps draining queued
            # requests after shutdown, so waiting handlers still complete
            for t in threads:
                t.join(timeout=120)
            if self._watcher is not None:
                self._watcher.join(timeout=10)  # exits on the shutdown flag
            if self._queue is not None:
                self._queue.put(None)  # sentinel: batcher exits when reached
                self._batcher.join(timeout=120)
                while True:  # orphan anything enqueued after the sentinel
                    try:
                        item = self._queue.get_nowait()
                    except Exception:  # noqa: BLE001 — queue.Empty
                        break
                    if isinstance(item, _Pending):
                        item.error = "server shut down"
                        item.event.set()
            self.close()
        return self._served

    def shutdown(self) -> None:
        """Ask serve_forever to stop: finish in-flight requests, drain the
        batcher, join the watcher, close and unlink the socket.  Signal-safe
        (only sets a flag — the accept loop polls it at 1 s granularity), so
        a SIGTERM handler can call it for clean daemon stops."""
        self._shutdown = True

    def close(self) -> None:
        self._sock.close()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)


def scenarios_array(resp: dict) -> np.ndarray:
    """Decode a successful scenario response into an ndarray, whichever
    inline wire encoding it used ("scenarios" float lists or
    "scenarios_b64" raw bytes)."""
    if not resp.get("ok"):
        raise ValueError(f"response is not a success: {resp.get('error')!r}")
    shape = tuple(resp["shape"])
    if "scenarios_b64" in resp:
        raw = base64.b64decode(resp["scenarios_b64"])
        return np.frombuffer(raw, dtype=resp.get("dtype", "float32")).reshape(
            shape)
    if "scenarios" in resp:
        return np.asarray(resp["scenarios"], dtype=np.float32).reshape(shape)
    raise ValueError("response carries no inline scenarios "
                     "(an 'out' .npy response? load that path instead)")


def request(socket_path: str, req: dict, timeout: float = 600.0) -> dict:
    """One-shot client: send a request line, return the parsed response.

    Connect is retried on a full listen backlog: `settimeout` makes the
    socket non-blocking, so a burst of concurrent clients (more than the
    daemon's backlog connecting in the same instant) surfaces EAGAIN from
    `connect` instead of queueing.  Only EAGAIN retries
    (bounded by the request timeout): ECONNREFUSED means a dead daemon
    behind a stale socket file and must fail fast."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        deadline = time.monotonic() + timeout
        while True:
            try:
                s.connect(socket_path)
                break
            except (BlockingIOError, InterruptedError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        s.sendall(json.dumps(req).encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 20)
            if not chunk:
                # the server closed the connection without completing a
                # response (per-connection timeout or shutdown mid-flight);
                # a bare json error here reads as a protocol bug
                raise ConnectionError(
                    f"server on {socket_path} closed the connection "
                    f"mid-response ({len(buf)} bytes received)")
            buf += chunk
    return json.loads(buf)


# -- data-parallel serving ---------------------------------------------------

#: what a leader's header tells the followers to run
_OPS = ("stop", "scenarios", "batch", "multi", "reload")


def _channels_last(cond, ndim: int) -> np.ndarray:
    """A map (ndim 3) or a stack (ndim 4) of conditions with the channel
    axis, which generate_scenarios* add where it is missing."""
    cond = np.ascontiguousarray(cond, dtype=np.float32)
    return cond if cond.ndim == ndim else cond[..., None]


def _send(mesh, op: str, conds=None, ns=()) -> None:
    """Rank 0: the header (op, K, and the (nd, nd, C) of the K conditions),
    then the conditions and their scenario counts."""
    k = 0 if conds is None else len(conds)
    shape = conds.shape[1:] if k else (0, 0, 0)
    replicate(torch.tensor([_OPS.index(op), k, *shape]), mesh)
    if k:
        replicate(torch.from_numpy(conds), mesh)
        replicate(torch.tensor(list(ns), dtype=torch.int64), mesh)


def _receive(mesh):
    """A follower: (op, conditions or None, scenario counts) from rank 0."""
    header = torch.zeros(5, dtype=torch.int64)
    replicate(header, mesh)
    op, k, *shape = header.tolist()
    if not k:
        return _OPS[op], None, []
    conds = torch.empty((k, *shape), dtype=torch.float32)
    ns = torch.empty(k, dtype=torch.int64)
    replicate(conds, mesh)
    replicate(ns, mesh)
    return _OPS[op], conds.numpy(), ns.tolist()


def _run(generator, op: str, conds, ns):
    if op == "scenarios":
        return generator.generate_scenarios(conds[0], ns[0])
    if op == "batch":
        return generator.generate_scenarios_batch(conds, ns[0])
    return generator.generate_scenarios_multi(list(conds), ns)


class MeshLeader:
    """Rank 0's generator in a data-parallel server: a PretrainedGenerator
    with a mesh whose forwards and reloads first tell the followers
    (:func:`follow`) what to run, one call at a time, so that every rank
    makes the same collectives in the same order.  Everything else
    (``cfg``, ``max_batch``, ``load_weights_file``, ...) is the
    generator's."""

    def __init__(self, generator):
        self.generator = generator
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.generator, name)

    def _collective(self, op: str, conds, ns):
        with self._lock:
            _send(self.generator.mesh, op, conds, ns)
            return _run(self.generator, op, conds, ns)

    def generate_scenarios(self, cond, n_scenarios: int):
        return self._collective("scenarios", _channels_last(cond, 3)[None],
                                [n_scenarios])

    def generate_scenarios_batch(self, conds, n_scenarios: int):
        conds = _channels_last(conds, 4)
        return self._collective("batch", conds, [n_scenarios] * len(conds))

    def generate_scenarios_multi(self, conds: list, n_list: list):
        if len(conds) != len(n_list) or not conds:
            raise ValueError("conds and n_list must be equal-length and "
                             "non-empty")
        return self._collective(
            "multi", np.stack([_channels_last(c, 3) for c in conds]),
            [int(n) for n in n_list])

    def reload_params(self, params) -> None:
        """Validated here first, so that a refused file sends nothing; the
        followers then take rank 0's weights by broadcast."""
        params = self.generator.check_params(params)
        with self._lock:
            _send(self.generator.mesh, "reload")
            self.generator.reload_params(params)

    def stop(self) -> None:
        """Release the followers."""
        with self._lock:
            _send(self.generator.mesh, "stop")


def follow(generator) -> int:
    """A follower rank of a data-parallel server: run what rank 0's
    :class:`MeshLeader` sends until it sends a stop.  Returns the number
    of calls joined."""
    calls = 0
    while True:
        op, conds, ns = _receive(generator.mesh)
        if op == "stop":
            return calls
        if op == "reload":  # the weights come from rank 0 in the broadcast
            generator.reload_params({k: v.clone() for k, v in
                                     generator.params.items()})
        else:
            _run(generator, op, conds, ns)
        calls += 1
