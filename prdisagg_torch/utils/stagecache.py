"""Persistent stage cache for long multi-stage protocols.

A JSON file mapping stage name -> payload dict, the JAX package's file
format, so a cache written by either package reads in the other.  A long
script marks each stage done with its scalar outputs; a rerun in the same
workdir (e.g. a ``cli supervise`` relaunch after a wedge) skips completed
stages.  Array-valued intermediates stay in the stage's own artifacts
(.npy/.pkl); the cache holds only scalars and the pointers to reload them.

Writes are atomic (a pid-unique tmp file, then rename), so a kill
mid-write never corrupts the state file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional


class StageCache:
    def __init__(self, path: str):
        self.path = path
        self._state: dict = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self._state = json.load(f)
            except (json.JSONDecodeError, OSError):
                # a corrupt state file means "no cache", never a crash
                self._state = {}

    def done(self, stage: str) -> bool:
        return stage in self._state

    def get(self, stage: str, default: Any = None) -> Optional[dict]:
        return self._state.get(stage, default)

    def mark(self, stage: str, **payload) -> dict:
        self._state[stage] = payload
        self._flush()
        return payload

    def clear(self, *stages: str) -> None:
        """Remove the named stages (or everything when none given)."""
        if stages:
            for s in stages:
                self._state.pop(s, None)
        else:
            self._state = {}
        self._flush()

    def _flush(self) -> None:
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        # pid-unique tmp name: two writers racing a shared tmp path can
        # steal each other's rename.  Concurrent writers are still wrong
        # (acquire_workdir_lock guards against them) but degrade to
        # last-writer-wins instead of crashing.
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(self._state, f, indent=2, sort_keys=True)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
