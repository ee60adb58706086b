"""Liveness heartbeat for long-running loops and the serving daemon."""

from __future__ import annotations

import os
from typing import Optional


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

    @staticmethod
    def from_env() -> Optional["Heartbeat"]:
        """The heartbeat of the PRDISAGG_HEARTBEAT file, None when unset."""
        p = os.environ.get("PRDISAGG_HEARTBEAT")
        return Heartbeat(p) if p else None


def beat_if_enabled() -> None:
    """Touch the PRDISAGG_HEARTBEAT liveness file if the env var is set, so
    a supervisor watching its mtime sees the process is alive.  No-op (one
    dict lookup) when the env var is unset."""
    hb = Heartbeat.from_env()
    if hb is not None:
        hb.beat()
