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
    tp_index r % tp, sp_index (r // tp) % sp and dp_index r // (sp tp), so
    the ranks of one tp group are consecutive, and with tp = 1 so are those
    of one sp group (dp_index r // sp, sp_index r % sp). Every rank creates
    every sp, tp and dp group, in the same order. sp and tp groups carry
    device tensors (halo rows, moments, K/V; the tp all-reduces): NCCL when
    the group has more than one rank and its ranks' cards all differ, else
    gloo (the ``gradient_group`` rule). A dp group (the ranks of one
    (sp_index, tp_index)) carries host data (rewards, prompts, infos), so it
    is gloo. Under tp the gradients' mean over dp runs in a second group of
    the same ranks, ``grad_group``, on the same rule as the sp and tp
    groups: NCCL when the ranks' cards differ, else the gloo dp group.
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

    ``sp_group`` holds this rank's sp group, ``tp_group`` its tp group and
    ``dp_group`` its dp group (the ranks of its sp_index and tp_index); all
    None in one process, and ``dp_group`` None (the default group) when dp
    is the only axis. ``grad_group`` (with ``grad_backend``) is the dp group
    the gradients are averaged over under tp (None otherwise).
    ``axis(name)`` is the ops' view of one axis."""

    dp: int
    sp: int
    tp: int
    dp_index: int = 0
    sp_index: int = 0
    sp_group: object = None
    dp_group: object = None
    sp_backend: str = "gloo"
    tp_index: int = 0
    tp_group: object = None
    tp_backend: str = "gloo"
    grad_group: object = None
    grad_backend: str = "gloo"

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp, "tp": self.tp}

    def axis(self, name: str = "sp"):
        from ddpo_torch.ops.spatial import Axis

        if name == "sp":
            return Axis("sp", self.sp, self.sp_index, self.sp_group, self.sp_backend)
        if name == "tp":
            return Axis("tp", self.tp, self.tp_index, self.tp_group, self.tp_backend)
        if name == "dp":
            return Axis("dp", self.dp, self.dp_index, self.dp_group, "gloo")
        raise ValueError(f"no mesh axis {name!r} (dp, sp, tp)")


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
    if n == 1:
        return Mesh(dp, sp, tp)
    rank = dist.get_rank()
    if sp == 1 and tp == 1:  # data parallel only: the default group is the dp group
        return Mesh(dp, sp, tp, dp_index=rank)

    def rank_of(d, s, t):
        return (d * sp + s) * tp + t

    keys = _card_keys(device)
    groups = {}

    def device_group(ranks):
        backend = _backend_for([keys[r] for r in ranks])
        return dist.new_group(ranks, backend=backend), backend

    # every rank creates every group, in this order
    if sp > 1:
        for d in range(dp):
            for t in range(tp):
                groups["sp", d, t] = device_group([rank_of(d, s, t) for s in range(sp)])
    if tp > 1:
        for d in range(dp):
            for s in range(sp):
                groups["tp", d, s] = device_group([rank_of(d, s, t) for t in range(tp)])
    for s in range(sp):
        for t in range(tp):
            ranks = [rank_of(d, s, t) for d in range(dp)]
            groups["dp", s, t] = dist.new_group(ranks, backend="gloo")
            if tp > 1 and dp > 1:
                # the gradients' mean over dp: on the cards when they differ
                groups["grad", s, t] = (device_group(ranks)
                                        if _backend_for([keys[r] for r in ranks]) == "nccl"
                                        else (groups["dp", s, t], "gloo"))
    dp_index, sp_index, tp_index = rank // (sp * tp), (rank // tp) % sp, rank % tp
    sp_group, sp_backend = groups.get(("sp", dp_index, tp_index), (None, "gloo"))
    tp_group, tp_backend = groups.get(("tp", dp_index, sp_index), (None, "gloo"))
    grad_group, grad_backend = groups.get(("grad", sp_index, tp_index), (None, "gloo"))
    return Mesh(dp, sp, tp, dp_index, sp_index, sp_group, groups["dp", sp_index, tp_index],
                sp_backend, tp_index, tp_group, tp_backend, grad_group, grad_backend)


def local_shard(x: np.ndarray, mesh: Optional[Mesh] = None) -> np.ndarray:
    """This rank's contiguous rows of an array every rank holds whole (the
    inverse of gathering each rank's rows in rank order); with a ``mesh``,
    its dp_index's rows of an array gathered once per dp group (the sp and
    tp ranks of a dp index hold the same rows)."""
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
