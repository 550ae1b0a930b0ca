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
    that times the world size;
  - ``create_mesh`` lays the ranks out as JAX lays its devices out,
    ``reshape(dp, sp, tp)`` (ddpo_tpu/parallel/mesh.py): rank r has
    dp_index r // sp and sp_index r % sp, so the ranks of one sp group are
    consecutive. Every rank creates every sp and dp group, in the same
    order. An sp group carries device tensors (halo rows, moments, K/V):
    NCCL when it has more than one rank and its ranks' cards all differ,
    else gloo (the ``gradient_group`` rule). A dp group carries host data
    (rewards, prompts, infos), so it is gloo. The tp axis is not ported
    yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

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
    if _backend_for(_card_keys(device)) == "nccl":
        return dist.new_group(backend="nccl"), "nccl"
    return None, "gloo"


def _card_keys(device: torch.device) -> List[Optional[str]]:
    """Each rank's card UUID (None on the CPU), gathered over gloo."""
    key = (str(torch.cuda.get_device_properties(device).uuid)
           if device.type == "cuda" else None)
    keys = [None] * dist.get_world_size()
    dist.all_gather_object(keys, key)
    return keys


def _backend_for(keys: List[Optional[str]]) -> str:
    """NCCL when there are several ranks and each has a card of its own,
    else gloo."""
    distinct = all(k is not None for k in keys) and len(set(keys)) == len(keys)
    return "nccl" if len(keys) > 1 and distinct else "gloo"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1  # -1: all remaining ranks
    sp: int = 1  # spatial / sequence parallelism over the latent's H
    tp: int = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (dp, sp, tp) layout of the ranks, and this rank's place in it.

    ``sp_group`` holds this rank's sp group (its dp_index's consecutive
    ranks) and ``dp_group`` its dp group (the ranks of its sp_index); both
    None in one process. ``axis("sp")`` is the ops' view of the sp axis."""

    dp: int
    sp: int
    tp: int
    dp_index: int = 0
    sp_index: int = 0
    sp_group: object = None
    dp_group: object = None
    sp_backend: str = "gloo"

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp, "tp": self.tp}

    def axis(self, name: str = "sp"):
        from ddpo_torch.ops.spatial import Axis

        if name != "sp":
            raise NotImplementedError(f"mesh axis {name!r} is not ported yet")
        return Axis("sp", self.sp, self.sp_index, self.sp_group, self.sp_backend)


def create_mesh(config: MeshConfig = MeshConfig(), device: torch.device = torch.device("cpu")
                ) -> Mesh:
    """The (dp, sp, tp) mesh over the world's ranks (JAX's ``create_mesh``
    over its devices, with its ValueError when the sizes do not multiply to
    the rank count)."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    tp, sp = config.tp, config.sp
    dp = config.dp if config.dp != -1 else n // (tp * sp)
    if dp * sp * tp != n:
        raise ValueError(f"mesh {dp}x{sp}x{tp} != {n} devices")
    if tp > 1:
        raise NotImplementedError("the tp mesh axis is not ported yet")
    if n == 1:
        return Mesh(dp, sp, tp)
    rank = dist.get_rank()
    if sp == 1:  # data parallel only: the default group is the dp group
        return Mesh(dp, sp, tp, dp_index=rank)
    keys = _card_keys(device)
    groups = {}
    for d in range(dp):  # every rank creates every group, in this order
        ranks = list(range(d * sp, (d + 1) * sp))
        backend = _backend_for([keys[r] for r in ranks])
        groups["sp", d] = (dist.new_group(ranks, backend=backend), backend)
    for s in range(sp):
        groups["dp", s] = dist.new_group(list(range(s, n, sp)), backend="gloo")
    dp_index, sp_index = rank // sp, rank % sp
    sp_group, sp_backend = groups["sp", dp_index]
    return Mesh(dp, sp, tp, dp_index, sp_index, sp_group, groups["dp", sp_index], sp_backend)


def local_shard(x: np.ndarray, mesh: Optional[Mesh] = None) -> np.ndarray:
    """This rank's contiguous rows of an array every rank holds whole (the
    inverse of gathering each rank's rows in rank order); with a ``mesh``,
    its dp_index's rows of an array gathered once per dp group (the sp
    ranks of a group hold the same rows)."""
    if not (dist.is_available() and dist.is_initialized()):
        return x
    if mesh is not None:
        return x.reshape(mesh.dp, -1, *x.shape[1:])[mesh.dp_index]
    world = dist.get_world_size()
    return x.reshape(world, -1, *x.shape[1:])[dist.get_rank()]


def local_batch_size(per_device: int) -> int:
    """Per-process batch size: one device per process."""
    return per_device


def global_batch_size(per_device: int) -> int:
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return per_device * world
