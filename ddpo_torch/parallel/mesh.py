"""Data parallelism over processes: the dp part of ddpo_tpu/parallel/mesh.py.

The port runs one process per card (or several on one card, or on the CPU)
under ``torchrun`` or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``. With none of them set it
is one process, and nothing here talks to anything.

  - ``maybe_initialize_distributed`` starts the default process group, on
    gloo, so the host collectives (rewards, prompts, digests, barriers) work
    whatever the device;
  - ``gradient_group`` picks the group the gradients are reduced over: NCCL
    when every rank has a card of its own (decided by gathering each rank's
    card UUID over gloo), else the gloo default group: ranks that share a
    card (NCCL refuses two ranks on one device) and ranks on the CPU. The
    topology decides, never a caught error;
  - JAX's ``shard_batch`` assembles a global array from each process's local
    rows and ``local_shard`` fetches them back; here each rank simply holds
    its own rows, and ``local_shard`` takes rank r's contiguous slice of an
    array every rank holds whole (the gathered advantages);
  - ``local_batch_size`` / ``global_batch_size``: one device per process, so
    the per-device size is the per-process size, and the global size is
    that times the world size.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def env_world_size() -> int:
    """WORLD_SIZE as the launcher set it (1 when unset)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_rank() -> int:
    """LOCAL_RANK as the launcher set it (0 when unset): rank r's card is
    cuda:LOCAL_RANK."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def maybe_initialize_distributed() -> bool:
    """Start the default (gloo) process group when the launcher asked for
    more than one process; True when a group is up. Idempotent: a second
    driver ``main`` in the same process reuses the group."""
    if dist.is_available() and dist.is_initialized():
        return True
    if env_world_size() <= 1:
        return False
    missing = [v for v in LAUNCH_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE > 1 but the launcher did not set {missing}")
    dist.init_process_group("gloo", init_method="env://")
    return True


def destroy_distributed() -> None:
    """End the process group, if one is up (a driver's last act)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def gradient_group(device: torch.device) -> Tuple[Optional[object], str]:
    """(group, backend name) for the gradient all-reduce.

    NCCL when every rank drives a card of its own; gloo (the default group,
    ``None``) when two ranks share a card or the ranks run on the CPU. One
    process: (None, "none").
    """
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return None, "none"
    key = (str(torch.cuda.get_device_properties(device).uuid)
           if device.type == "cuda" else None)
    keys = [None] * dist.get_world_size()
    dist.all_gather_object(keys, key)
    if all(k is not None for k in keys) and len(set(keys)) == len(keys):
        return dist.new_group(backend="nccl"), "nccl"
    return None, "gloo"


def local_shard(x: np.ndarray) -> np.ndarray:
    """Rank r's contiguous rows of an array every rank holds whole (the
    inverse of gathering each rank's rows in rank order)."""
    if not (dist.is_available() and dist.is_initialized()):
        return x
    world = dist.get_world_size()
    return x.reshape(world, -1, *x.shape[1:])[dist.get_rank()]


def local_batch_size(per_device: int) -> int:
    """Per-process batch size: one device per process."""
    return per_device


def global_batch_size(per_device: int) -> int:
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return per_device * world
