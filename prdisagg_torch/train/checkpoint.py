"""Checkpoint and exact resume of the full GAN training state.

The JAX package keeps its whole state pytree in Orbax checkpoints; the port
writes one ``torch.save`` file per epoch, ``epoch_{epoch:08d}.pt``, holding
both nets, the EMA, both optimizers' per-parameter state (moments and the
step counter), the step, the epoch and the random stream's state
(train/state.py ``state_tree``).  A file is written to a temporary name and
moved into place with ``os.replace``, so a crash never leaves half a
checkpoint.  Restore copies into the existing tensors (``load_state``), so
a CUDA graph of the step captured on the state reads the restored values.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from prdisagg_torch.train.artifacts import Snapshot
from prdisagg_torch.train.state import GANTrainState, load_state

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:08d}.pt")

    def epochs(self) -> list:
        """The epochs on disk, oldest first."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def save(self, epoch: int, snap: Snapshot) -> None:
        """Write `snap` (train/artifacts.py ``snapshot``) as the checkpoint
        of `epoch`, then drop the oldest beyond ``max_to_keep``."""
        path = self._path(epoch)
        tmp = f"{path}.tmp-{os.getpid()}"
        torch.save({**snap.host(), "epoch": epoch}, tmp)
        os.replace(tmp, path)
        if self.max_to_keep:
            for old in self.epochs()[:-self.max_to_keep]:
                os.remove(self._path(old))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, state: GANTrainState, epoch: Optional[int] = None,
                mesh=None) -> GANTrainState:
        """Load the checkpoint of `epoch` (the latest by default) into
        `state` in place; returns `state`.  With a data-parallel `mesh`,
        every rank reads the file, then takes rank 0's values."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        tree = torch.load(self._path(epoch), map_location="cpu",
                          weights_only=True)
        load_state(state, tree, mesh)
        return state

    def close(self) -> None:
        pass
