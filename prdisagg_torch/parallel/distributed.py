"""Process-group start-up: the port's counterpart of the JAX package's
``jax.distributed.initialize`` wrapper (parallel/distributed.py there).

One process per device.  A launcher (``torchrun``, or any script that sets
the same variables) gives each process ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
:func:`initialize_multihost` reads them, or takes the coordinator, the
world size and the rank as arguments, and starts ``torch.distributed``:
NCCL when the port runs on the card, gloo on the CPU.  On the card the
process's device is ``cuda:{LOCAL_RANK}``, made current before the group
starts, since the kernel wrappers launch on the current device's stream.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

#: the launcher's variables, as torchrun sets them
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def _rendezvous(coordinator_address: Optional[str],
                num_processes: Optional[int],
                process_id: Optional[int]):
    """(init_method, world size, rank, local rank) from the arguments,
    each missing one from the launcher's environment.  Raises RuntimeError
    with the no-cluster signature when neither gives anything, and
    ValueError when they give only part of a launch."""
    env = {k: os.environ.get(k) for k in LAUNCHER_ENV}
    if (coordinator_address is None and num_processes is None
            and process_id is None and not any(env.values())):
        raise RuntimeError(
            "the launcher environment could not be detected: none of "
            + ", ".join(LAUNCHER_ENV) + " is set")
    init_method = f"tcp://{coordinator_address}"
    if coordinator_address is None:
        # env:// reads MASTER_ADDR and MASTER_PORT (and, under torchrun,
        # joins the launcher's own store)
        init_method = ("env://" if env["MASTER_ADDR"] and env["MASTER_PORT"]
                       else None)
    world = num_processes if num_processes is not None else env["WORLD_SIZE"]
    rank = process_id if process_id is not None else env["RANK"]
    missing = [name for name, v in (("the coordinator address (MASTER_ADDR "
                                     "and MASTER_PORT)", init_method),
                                    ("the world size (WORLD_SIZE)", world),
                                    ("the rank (RANK)", rank)) if v is None]
    if missing:
        raise ValueError("a partly detected launch: "
                         + ", ".join(missing) + " must be specified")
    world, rank = int(world), int(rank)
    local = int(env["LOCAL_RANK"]) if env["LOCAL_RANK"] else rank
    return init_method, world, rank, local


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> bool:
    """Start the default process group under a multi-process launcher.

    Returns True when the group was started, False when the process runs
    alone (no launcher environment at all, or ``num_processes <= 1``
    given).  `coordinator_address` is ``host:port``; the arguments default
    to the launcher's variables.  `device` ("cuda" or "cpu") is where the
    process computes, ``cuda:{LOCAL_RANK}`` on the card; `backend` defaults
    to NCCL there and to gloo on the CPU ("gloo" on the card runs several
    ranks on one card, which NCCL refuses).

    Error policy: ONLY the no-cluster-environment signature degrades to
    single-process.  Any other failure — a partly set environment, a wrong
    coordinator address, a second initialize, a dead coordinator — is
    logged and re-raised: silently falling back to single-process on a
    genuinely misconfigured launch is the hardest failure to notice (every
    process trains its own replica and the losses "work")."""
    if num_processes is not None and num_processes <= 1:
        return False
    try:
        init_method, world, rank, local = _rendezvous(
            coordinator_address, num_processes, process_id)
        device = torch.device(device)
        kw = {}
        if device.type == "cuda":
            torch.cuda.set_device(local)
        elif device.type != "cpu":
            raise ValueError(f"data parallelism runs on cuda or cpu, got "
                             f"{device}")
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        elif backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
        if backend == "nccl":
            if device.type != "cuda":
                raise ValueError("NCCL runs on the card; pass device='cuda' "
                                 "or backend='gloo'")
            kw["device_id"] = torch.device("cuda", local)
        dist.init_process_group(
            backend,
            init_method=init_method, world_size=world, rank=rank, **kw)
        return True
    except (ValueError, RuntimeError) as e:
        msg = str(e).lower()
        if coordinator_address is None and _is_no_cluster_error(msg):
            # auto-detection found no launcher environment -> single process
            return False
        logging.getLogger(__name__).error(
            "torch.distributed.init_process_group failed (NOT the "
            "no-cluster signature) — refusing to silently degrade to "
            "single-process: %s", e)
        raise


def _is_no_cluster_error(msg: str) -> bool:
    """True ONLY for the nothing-was-detected signature (the benign
    single-process case).  Deliberately narrow: a PARTIALLY detected
    cluster (e.g. coordinator found but 'process_id must be specified')
    is a misconfigured launch and must re-raise — matching generic
    'must be specified' here would reintroduce the silent degradation
    this policy exists to eliminate."""
    return any(s in msg for s in (
        "none of the distributed environment detectors",
        "could not be detected",
        "unable to detect",
        # jax's exact wording when auto-detection found no launcher at all
        "coordinator_address should be defined",
    ))


def is_primary_host() -> bool:
    """True on rank 0, and in a process that runs alone."""
    return not dist.is_initialized() or dist.get_rank() == 0
