"""Sequence-parallel (sp) attention over a mesh axis: the attention mode of sp.

Port of ddpo_tpu/parallel/sequence.py. In JAX a shard_map hands each device
its query rows and K/V rows and all-gathers K/V inside. Here every rank of
an sp group holds the activations whole (they are computed replicated over
sp, as JAX's GSPMD computes everything outside the attention shard_map), so
each rank attends with its own query rows to the K/V it already holds, and
the output rows are all-gathered (ops/spatial.py):

  - q: ``shard_rows``, whose backward all-gathers the dq rows;
  - k, v: ``replicated``, whose backward all-reduces (sums) dk and dv;
  - out: ``gather_rows``, whose backward takes this rank's rows.

So the cotangents that leave the attention are whole on every rank, and
so are the parameter gradients: the gradient reduce is the mean over the
world. The local attention dispatches through ``ops.attention`` (the flash
kernels on the card at local Sq >= 256).
"""

from __future__ import annotations

from typing import Optional

import torch

from ddpo_torch.ops.spatial import gather_rows, replicated, shard_rows


def sequence_parallel_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: Optional[float] = None, axis: str = "sp") -> torch.Tensor:
    """Attention with the query sequence split over ``axis``.

    q: (B, Sq, H, D), k/v: (B, Sk, H, D), whole on every rank of the axis;
    Sq must divide by the axis size. Returns the whole (B, Sq, H, D). Each
    rank holds only its dp rows, so JAX's ``batch_axis`` has no port.
    """
    from ddpo_torch.ops.attention import attention

    ax = mesh.axis(axis)
    out = attention(shard_rows(q, ax, 1, "seq_q"), replicated(k, ax, "seq_k"),
                    replicated(v, ax, "seq_v"), scale)
    return gather_rows(out, ax, 1, "seq_out")
