"""Liveness heartbeat for long-running loops and the serving daemon."""

from __future__ import annotations

import os


def beat_if_enabled() -> None:
    """Touch the PRDISAGG_HEARTBEAT liveness file if the env var is set, so
    a supervisor watching its mtime sees the process is alive.  No-op (one
    dict lookup) when the env var is unset."""
    path = os.environ.get("PRDISAGG_HEARTBEAT")
    if not path:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a"):
        os.utime(path, None)
