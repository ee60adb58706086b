"""Device health probing and hang-surviving supervision.

A device can stop answering: every launch or copy then blocks forever, a
hung call cannot be interrupted from Python, and only killing the process
and resuming recovers the run (the reference has no notion of this: its
SLURM job dies and is resubmitted by hand).  This module holds the JAX
package's recovery pattern:

* :func:`probe_backend`: one small computation and a host fetch on the
  device, in a fresh subprocess with a hard timeout, so a wedged device can
  never hang the caller;
* :class:`Heartbeat`: a liveness file the Trainer touches after every
  metrics fetch (set ``PRDISAGG_HEARTBEAT`` to a path; no cost when unset);
* :func:`supervise`: run a training command as a child process group, kill
  the group when the heartbeat goes stale, wait for the device to answer
  probes again, and relaunch.  With the Trainer's checkpoints and
  ``--resume``, a wedge costs at most ``stall_timeout_s`` plus the epochs
  since the last checkpoint, not the run;
* :func:`acquire_workdir_lock`: one resumable protocol per working
  directory.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Optional, Sequence

# imports torch alone: the probe must not depend on this repository
_PROBE_SRC = """
import time
import torch
t0 = time.perf_counter()
x = torch.ones(8, device={device!r})
s = float(x.sum())  # the host fetch waits for the device
print("PROBE_OK", s, time.perf_counter() - t0)
"""


def probe_backend(platform: Optional[str] = None,
                  timeout_s: float = 60.0) -> dict:
    """One small tensor made, reduced and fetched on `platform` ('cuda', the
    default, or 'cpu') in a fresh ``python -c`` subprocess.

    Returns ``{"ok": bool, "latency_s": float|None, "detail": str}``, the
    latency from after torch's import.  ``ok=False`` with
    ``detail="timeout"`` is the wedge signature (the subprocess is killed;
    the caller never blocks past ``timeout_s``).
    """
    src = _PROBE_SRC.format(device=platform or "cuda")
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, "-c", src], capture_output=True,
                             text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"ok": False, "latency_s": None, "detail": "timeout"}
    out = (res.stdout or "") + (res.stderr or "")
    for line in (res.stdout or "").splitlines():
        if line.startswith("PROBE_OK"):
            parts = line.split()
            lat = float(parts[2]) if len(parts) > 2 else \
                time.perf_counter() - t0
            return {"ok": True, "latency_s": round(lat, 4), "detail": "ok"}
    return {"ok": False, "latency_s": None,
            "detail": f"rc={res.returncode}: {out.strip()[-500:]}"}


class Heartbeat:
    """Liveness file whose mtime :meth:`beat` bumps, for a supervisor that
    watches it.  The Trainer beats once per log interval, after the metrics
    fetch, that is only on progress the device confirmed."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def beat(self) -> None:
        # create-or-touch: never leaves a half-written file
        with open(self.path, "a"):
            os.utime(self.path, None)

    def age_s(self) -> Optional[float]:
        """Seconds since the last beat, or None if no beat yet."""
        try:
            return max(0.0, time.time() - os.stat(self.path).st_mtime)
        except OSError:
            return None

    @staticmethod
    def from_env() -> Optional["Heartbeat"]:
        """The heartbeat of the PRDISAGG_HEARTBEAT file, None when unset."""
        p = os.environ.get("PRDISAGG_HEARTBEAT")
        return Heartbeat(p) if p else None


_env_hb: Optional[Heartbeat] = None


def beat_if_enabled() -> None:
    """Touch the PRDISAGG_HEARTBEAT liveness file if the env var is set, so
    a supervisor watching its mtime sees the process is alive (long host
    loops such as the evaluation's chunks beat between Trainer beats).
    No-op (one dict lookup) when the env var is unset; the Heartbeat is
    cached for its path."""
    global _env_hb
    p = os.environ.get("PRDISAGG_HEARTBEAT")
    if not p:
        return
    if _env_hb is None or _env_hb.path != p:
        _env_hb = Heartbeat(p)
    _env_hb.beat()


def acquire_workdir_lock(workdir: str, name: str = ".lock"):
    """Exclusive advisory lock on a working directory, held for the caller's
    process lifetime (the fd is returned and must be kept referenced).

    Two instances of a resumable protocol sharing a workdir corrupt each
    other's checkpoints, hist.csv and stage cache.  flock is released when
    the last fd on the open file description closes, on any process death,
    SIGKILL included, so a crashed run never wedges the lock.  The lock
    lives on the open file description: Python's fds are not inherited by
    children (PEP 446); do not pass this one to a long-lived child, or the
    child keeps the workdir locked after the parent dies.

    Raises RuntimeError naming the holder's pid when already locked.
    """
    import fcntl

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, name)
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        holder = ""
        try:
            holder = os.read(fd, 64).decode(errors="replace").strip()
        except OSError:
            pass
        os.close(fd)
        raise RuntimeError(
            f"workdir {workdir} is locked by another running instance"
            + (f" (pid {holder})" if holder else "")
            + "; refusing to run two protocols in one workdir")
    os.ftruncate(fd, 0)
    os.write(fd, str(os.getpid()).encode())
    return fd


@dataclass
class SuperviseResult:
    returncode: int
    restarts: int
    stalls: int
    wall_s: float


def _cpu_seconds(pid: int) -> Optional[float]:
    """User+system CPU seconds of one process from /proc (Linux)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            parts = f.read().rsplit(")", 1)[1].split()
        # fields 14/15 of stat are utime/stime; after stripping pid+comm
        # they land at indices 11/12
        return (int(parts[11]) + int(parts[12])) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def supervise(
    argv: Sequence[str],
    heartbeat_path: str,
    stall_timeout_s: float = 900.0,
    startup_timeout_s: Optional[float] = None,
    max_restarts: int = 3,
    poll_s: float = 10.0,
    busy_cpu_fraction: float = 0.2,
    probe_platform: Optional[str] = None,
    probe_on_stall: bool = True,
    probe_timeout_s: float = 60.0,
    probe_interval_s: float = 120.0,
    probe_max_wait_s: float = 6 * 3600.0,
    log=print,
) -> SuperviseResult:
    """Run ``argv`` under heartbeat supervision; restart on stall.

    The child gets ``PRDISAGG_HEARTBEAT=heartbeat_path`` in its environment
    (the Trainer beats automatically) and runs in its own session, so a
    stall kill reaps its whole process group.  A stall is declared when the
    heartbeat file is older than ``stall_timeout_s`` (or, before the first
    beat, when the child has been silent ``startup_timeout_s``, default
    ``4 * stall_timeout_s``, for kernel builds and graph captures).  After
    a stall kill, if ``probe_on_stall``, the relaunch waits until
    :func:`probe_backend` on ``probe_platform`` (default cuda) succeeds: a
    wedged device would hang the relaunched child the same way.

    A heartbeat-silent child that is BUSY is not a stall: builds and long
    device chunks can go beat-less legitimately, but they burn host CPU,
    while a wedged process blocks at ~0%.  A kill therefore also requires
    the child's CPU use over the trailing stall window (from /proc; the
    direct child only) to be below ``busy_cpu_fraction``.  Set 0.0 to kill
    on silence alone.

    A clean child exit (rc == 0) ends supervision; a nonzero exit is
    returned as-is without restart (crashes are the caller's bug; only
    HANGS are the device's).  SIGTERM and SIGINT to the supervisor kill the
    child's group, then exit with 128 + the signal.  Restarts resume
    training through ``--resume`` as long as the command's workdir is
    stable.
    """
    if startup_timeout_s is None:
        startup_timeout_s = 4 * stall_timeout_s
    hb = Heartbeat(heartbeat_path)
    env = dict(os.environ, PRDISAGG_HEARTBEAT=heartbeat_path)
    restarts = stalls = 0
    t_all = time.time()

    # The child lives in its own process group, so an outer timeout/TERM on
    # the supervisor would orphan it: forward termination.  The handlers
    # are installed once, before the first launch, leaving no window where
    # a TERM kills the supervisor and the child runs on detached.
    child = None

    def _forward(sig, frame):
        if child is not None:
            try:
                os.killpg(child.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        raise SystemExit(128 + sig)

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _forward)
        except ValueError:  # not the main thread: no forwarding
            pass

    try:
        while True:
            # stale beats from a previous attempt must not mask a startup hang
            try:
                os.remove(heartbeat_path)
            except OSError:
                pass
            t_start = time.time()
            log(f"[supervise] launch (attempt {restarts + 1}): "
                f"{' '.join(argv)}", flush=True)
            child = subprocess.Popen(list(argv), env=env,
                                     start_new_session=True)
            stalled = False
            cpu_samples: list = []  # (wall_t, cpu_seconds) for the busy check
            last_busy_log = 0.0
            while True:
                rc = child.poll()
                if rc is not None:
                    break
                now = time.time()
                age = hb.age_s()
                silent = (now - t_start if age is None else age)
                limit = startup_timeout_s if age is None else stall_timeout_s
                cpu = _cpu_seconds(child.pid)
                if cpu is not None:
                    cpu_samples.append((now, cpu))
                    # keep one applicable window: averaging over the (4x
                    # longer) startup window after beats began would let
                    # earlier CPU use mask a wedge
                    horizon = now - limit
                    while len(cpu_samples) > 2 and cpu_samples[1][0] < horizon:
                        cpu_samples.pop(0)
                if silent > limit:
                    busy = None
                    if busy_cpu_fraction > 0 and len(cpu_samples) >= 2:
                        (t0c, c0), (t1c, c1) = cpu_samples[0], cpu_samples[-1]
                        if t1c > t0c:
                            busy = (c1 - c0) / (t1c - t0c)
                    if busy is not None and busy >= busy_cpu_fraction:
                        # silent but computing: not the wedge signature
                        if now - last_busy_log > 300:
                            last_busy_log = now
                            log(f"[supervise] heartbeat silent {silent:.0f}s "
                                f"but child busy ({busy:.0%} CPU); not a "
                                f"stall", flush=True)
                        time.sleep(poll_s)
                        continue
                    stalled = True
                    phase = "startup" if age is None else "step"
                    log(f"[supervise] {phase} stall: heartbeat silent "
                        f"{silent:.0f}s > {limit:.0f}s"
                        + (f", child idle ({busy:.0%} CPU)"
                           if busy is not None else "")
                        + f"; killing process group {child.pid}", flush=True)
                    try:
                        os.killpg(child.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                    child.wait()
                    break
                time.sleep(poll_s)

            if not stalled:
                log(f"[supervise] child exited rc={child.returncode} after "
                    f"{restarts} restart(s)", flush=True)
                return SuperviseResult(child.returncode, restarts, stalls,
                                       time.time() - t_all)

            stalls += 1
            if restarts >= max_restarts:
                log(f"[supervise] giving up: {stalls} stall(s), "
                    f"max_restarts={max_restarts} exhausted", flush=True)
                return SuperviseResult(-1, restarts, stalls,
                                       time.time() - t_all)

            if probe_on_stall:
                t_probe = time.time()
                while True:
                    r = probe_backend(probe_platform,
                                      timeout_s=probe_timeout_s)
                    if r["ok"]:
                        log(f"[supervise] device healthy (probe "
                            f"{r['latency_s']}s); relaunching", flush=True)
                        break
                    waited = time.time() - t_probe
                    if waited > probe_max_wait_s:
                        log(f"[supervise] device still down after "
                            f"{waited / 3600:.1f}h of probes; giving up",
                            flush=True)
                        # restarts counts relaunches that happened: this
                        # exit never relaunched after the stall kill
                        return SuperviseResult(-1, restarts, stalls,
                                               time.time() - t_all)
                    log(f"[supervise] device unhealthy ({r['detail']}); "
                        f"retry in {probe_interval_s:.0f}s", flush=True)
                    time.sleep(probe_interval_s)
            restarts += 1
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
