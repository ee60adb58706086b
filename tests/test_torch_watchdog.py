"""The port's watchdog (prdisagg_torch/utils/watchdog.py) and ``cli doctor``
/ ``cli supervise``, case for case as tests/test_watchdog.py holds the JAX
package's, with the same plain-python children and timings: probe,
heartbeat, stall kill and resume, startup stall, max restarts, a busy child
spared, SIGTERM forwarding, crash propagation, and the workdir lock across
two processes.  The probe subprocess imports torch alone and runs on the
CPU here.
"""

import os
import signal
import stat
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from prdisagg_torch import cli  # noqa: E402
from prdisagg_torch.utils import watchdog as wd  # noqa: E402
from prdisagg_torch.utils.watchdog import (  # noqa: E402
    Heartbeat,
    acquire_workdir_lock,
    beat_if_enabled,
    probe_backend,
    supervise,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda *a, **k: None)


def test_heartbeat_beat_and_age(tmp_path):
    hb = Heartbeat(str(tmp_path / "hb"))
    assert hb.age_s() is None  # no beat yet
    hb.beat()
    age = hb.age_s()
    assert age is not None and age < 5.0
    m0 = os.stat(hb.path).st_mtime
    time.sleep(0.05)
    hb.beat()
    assert os.stat(hb.path).st_mtime >= m0


def test_beat_if_enabled_caches_and_retargets(tmp_path, monkeypatch):
    monkeypatch.delenv("PRDISAGG_HEARTBEAT", raising=False)
    beat_if_enabled()  # no-op without the env var
    p = str(tmp_path / "hb")
    monkeypatch.setenv("PRDISAGG_HEARTBEAT", p)
    beat_if_enabled()
    assert os.path.exists(p)
    cached = wd._env_hb
    beat_if_enabled()
    assert wd._env_hb is cached  # one Heartbeat per path
    p2 = str(tmp_path / "hb2")
    monkeypatch.setenv("PRDISAGG_HEARTBEAT", p2)
    beat_if_enabled()
    assert os.path.exists(p2) and wd._env_hb.path == p2


def test_probe_backend_cpu_ok():
    res = probe_backend("cpu", timeout_s=120)
    assert res["ok"], res
    assert res["latency_s"] is not None and res["detail"] == "ok"


def test_probe_backend_timeout_signature():
    # a wedged device == a probe that never returns; importing torch alone
    # outlasts 0.5 s
    res = probe_backend("cpu", timeout_s=0.5)
    assert res == {"ok": False, "latency_s": None, "detail": "timeout"}


def test_probe_backend_reports_a_failing_device():
    res = probe_backend("no_such_device", timeout_s=120)
    assert not res["ok"] and res["detail"].startswith("rc=1")


def _child_script(tmp_path, body):
    p = tmp_path / "child.py"
    p.write_text(textwrap.dedent(body))
    os.chmod(p, os.stat(p).st_mode | stat.S_IXUSR)
    return [sys.executable, str(p)]


def test_supervise_clean_exit(tmp_path):
    argv = _child_script(tmp_path, """
        import os
        open(os.environ["PRDISAGG_HEARTBEAT"], "a").close()
    """)
    res = supervise(argv, str(tmp_path / "hb"), stall_timeout_s=5,
                    poll_s=0.2, probe_on_stall=False, **QUIET)
    assert res.returncode == 0 and res.restarts == 0 and res.stalls == 0


def test_supervise_kills_stall_and_resumes(tmp_path):
    # first run: beats once, then hangs (the wedge signature); second run:
    # finds the marker and exits cleanly (the resume)
    marker = tmp_path / "attempted_once"
    argv = _child_script(tmp_path, f"""
        import os, sys, time
        hb = os.environ["PRDISAGG_HEARTBEAT"]
        open(hb, "a").close()
        os.utime(hb, None)
        marker = {str(marker)!r}
        if os.path.exists(marker):
            sys.exit(0)
        open(marker, "w").close()
        time.sleep(600)
    """)
    t0 = time.time()
    res = supervise(argv, str(tmp_path / "hb"), stall_timeout_s=1.5,
                    startup_timeout_s=30, poll_s=0.2, max_restarts=2,
                    probe_on_stall=False, **QUIET)
    assert res.returncode == 0
    assert res.restarts == 1 and res.stalls == 1
    assert time.time() - t0 < 60  # the 600 s sleep was killed


def test_supervise_probes_before_relaunch(tmp_path, monkeypatch):
    """After a stall kill the relaunch waits for a passing probe."""
    probes = iter([{"ok": False, "latency_s": None, "detail": "timeout"},
                   {"ok": True, "latency_s": 0.1, "detail": "ok"}])
    calls = []

    def fake_probe(platform, timeout_s=60):
        calls.append(platform)
        return next(probes)

    monkeypatch.setattr(wd, "probe_backend", fake_probe)
    marker = tmp_path / "attempted_once"
    argv = _child_script(tmp_path, f"""
        import os, sys, time
        marker = {str(marker)!r}
        if os.path.exists(marker):
            sys.exit(0)
        open(marker, "w").close()
        time.sleep(600)
    """)
    res = supervise(argv, str(tmp_path / "hb"), stall_timeout_s=0.5,
                    startup_timeout_s=10.0, poll_s=0.2, max_restarts=1,
                    probe_platform="cpu", probe_interval_s=0.01, **QUIET)
    assert res.returncode == 0 and res.restarts == 1 and res.stalls == 1
    assert calls == ["cpu", "cpu"]


def test_supervise_startup_stall(tmp_path):
    # never beats: the startup grace (not the step timeout) applies
    marker = tmp_path / "attempted_once"
    argv = _child_script(tmp_path, f"""
        import os, sys, time
        marker = {str(marker)!r}
        if os.path.exists(marker):
            sys.exit(0)
        open(marker, "w").close()
        time.sleep(600)
    """)
    res = supervise(argv, str(tmp_path / "hb"), stall_timeout_s=0.5,
                    startup_timeout_s=10.0, poll_s=0.2, max_restarts=1,
                    probe_on_stall=False, **QUIET)
    assert res.returncode == 0 and res.restarts == 1


def test_supervise_gives_up_after_max_restarts(tmp_path):
    argv = _child_script(tmp_path, """
        import time
        time.sleep(600)
    """)
    res = supervise(argv, str(tmp_path / "hb"), stall_timeout_s=1,
                    startup_timeout_s=1, poll_s=0.2, max_restarts=1,
                    probe_on_stall=False, **QUIET)
    assert res.returncode == -1
    assert res.restarts == 1 and res.stalls == 2


def test_supervise_spares_busy_child(tmp_path):
    # silent but computing (~100% CPU) is not the wedge signature
    argv = _child_script(tmp_path, """
        import time
        t0 = time.time()
        while time.time() - t0 < 6:
            sum(i * i for i in range(10000))
    """)
    res = supervise(argv, str(tmp_path / "hb"), stall_timeout_s=0.5,
                    startup_timeout_s=3.0, poll_s=0.2, max_restarts=0,
                    probe_on_stall=False, **QUIET)
    assert res.returncode == 0 and res.stalls == 0


def test_supervise_forwards_sigterm_to_child_group(tmp_path):
    # a TERM on the supervisor must not orphan the child, which lives in
    # its own process group
    pidfile = tmp_path / "child_pid"
    hb = str(tmp_path / "hb")
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(f"""
        import os, time
        open({str(pidfile)!r}, "w").write(str(os.getpid()))
        hb = {hb!r}
        while True:
            open(hb, "a").close(); os.utime(hb, None)
            time.sleep(0.2)
    """))
    sup = tmp_path / "sup.py"
    sup.write_text(textwrap.dedent(f"""
        import sys
        from prdisagg_torch.utils.watchdog import supervise
        supervise([sys.executable, {str(child)!r}], {hb!r},
                  stall_timeout_s=60, poll_s=0.2, probe_on_stall=False,
                  log=lambda *a, **k: None)
    """))
    env = dict(os.environ,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, str(sup)], cwd=ROOT, env=env)
    t0 = time.time()
    while not pidfile.exists() and time.time() - t0 < 60:
        time.sleep(0.2)
    assert pidfile.exists(), "child never started"
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 143  # 128 + SIGTERM: the handler ran
    m0 = os.stat(hb).st_mtime
    time.sleep(1.5)
    assert os.stat(hb).st_mtime == m0, \
        "the child kept beating after the supervisor's termination"


def test_supervise_propagates_crash_without_restart(tmp_path):
    argv = _child_script(tmp_path, """
        import sys
        sys.exit(3)
    """)
    res = supervise(argv, str(tmp_path / "hb"), stall_timeout_s=5,
                    poll_s=0.2, probe_on_stall=False, **QUIET)
    assert res.returncode == 3 and res.restarts == 0


def test_cli_supervise_runs_the_command(tmp_path, capsys):
    argv = _child_script(tmp_path, """
        import os
        open(os.environ["PRDISAGG_HEARTBEAT"], "a").close()
    """)
    hb = str(tmp_path / "beat")
    with pytest.raises(SystemExit) as e:
        cli.main(["supervise", "--heartbeat", hb, "--stall-timeout", "5",
                  "--no-probe", "--", *argv])
    assert e.value.code == 0
    assert "rc=0 restarts=0 stalls=0" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no command given"):
        cli.main(["supervise", "--"])


def test_cli_doctor_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["doctor", "--platform", "cpu", "--timeout", "120"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert '"ok": true' in out and '"platform": "cpu"' in out


def test_cli_doctor_timeout(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["doctor", "--platform", "cpu", "--timeout", "0.5"])
    assert e.value.code == 1
    assert '"detail": "timeout"' in capsys.readouterr().out


def test_cli_doctor_wait_until_recovery(capsys, monkeypatch):
    seq = iter([{"ok": False, "latency_s": None, "detail": "timeout"},
                {"ok": False, "latency_s": None, "detail": "timeout"},
                {"ok": True, "latency_s": 0.1, "detail": "ok"}])
    platforms = []

    def fake_probe(p, timeout_s=60):
        platforms.append(p)
        return next(seq)

    monkeypatch.setattr(wd, "probe_backend", fake_probe)
    with pytest.raises(SystemExit) as e:
        cli.main(["doctor", "--wait", "999", "--wait-interval", "0.01"])
    assert e.value.code == 0
    assert '"ok": true' in capsys.readouterr().out
    assert platforms == ["cuda"] * 3  # the card unless asked otherwise


def test_cli_doctor_wait_budget_exhausted(capsys, monkeypatch):
    monkeypatch.setattr(
        wd, "probe_backend",
        lambda p, timeout_s=60: {"ok": False, "latency_s": None,
                                 "detail": "timeout"})
    with pytest.raises(SystemExit) as e:
        cli.main(["doctor", "--wait", "0.05", "--wait-interval", "0.02"])
    assert e.value.code == 1
    assert "waited_s" in capsys.readouterr().out


def test_workdir_lock_excludes_a_second_process(tmp_path):
    """Held here, the lock refuses another process, naming this pid; once
    released, that process takes it."""
    workdir = str(tmp_path / "run")
    fd = acquire_workdir_lock(workdir)
    with pytest.raises(RuntimeError, match="locked by another"):
        acquire_workdir_lock(workdir)
    src = textwrap.dedent(f"""
        import sys
        from prdisagg_torch.utils.watchdog import acquire_workdir_lock
        try:
            acquire_workdir_lock({workdir!r})
        except RuntimeError as e:
            print(e)
            sys.exit(3)
        print("acquired")
    """)
    env = dict(os.environ,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    other = subprocess.run([sys.executable, "-c", src], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=60)
    assert other.returncode == 3, other.stderr
    assert f"(pid {os.getpid()})" in other.stdout
    os.close(fd)
    other = subprocess.run([sys.executable, "-c", src], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=60)
    assert other.returncode == 0 and "acquired" in other.stdout


def test_trainer_beats_heartbeat(tmp_path, monkeypatch):
    from prdisagg_torch.core import config as tcfg
    from prdisagg_torch.data.sampler import DeviceDataset
    from prdisagg_torch.data.synthetic import make_synthetic_dataset
    from prdisagg_torch.train.loop import Trainer

    hb_path = str(tmp_path / "hb")
    monkeypatch.setenv("PRDISAGG_HEARTBEAT", hb_path)
    data, idx, dcfg = make_synthetic_dataset(n_days=4, ny=32, nx=32, seed=5)
    ds = DeviceDataset.from_numpy(data, idx, dcfg, device="cpu")
    exp = tcfg.ExperimentConfig(
        data=dcfg,
        train=tcfg.TrainConfig(n_disc=1, schedule=((1, 4),),
                               checkpoint_every_epochs=0),
        model_override=tcfg.smoke_model_config(compute_dtype="float32"),
        name="hbtest")
    tr = Trainer(exp, ds, workdir=str(tmp_path), steps_per_epoch=2,
                 plot_every_epochs=0, export_format="npz")
    assert tr.heartbeat is not None
    tr.fit(progress=False)
    assert Heartbeat(hb_path).age_s() < 120
