"""Tensor parallelism over the mesh's tp axis: the collectives of the
column- and row-parallel Linears, in Megatron's pattern.

In JAX (ddpo_tpu/parallel/sharding.py) the partition rules annotate the
parameters and GSPMD inserts every collective. Here each rank of a tp group
holds its slices of the sharded Linears (parallel/sharding.py) and runs the
transformer blocks on them, and the collectives are written out:

  - ``copy_to_tp``: identity forward, all-reduce (sum) of the cotangent
    backward. It goes on each input of a column-parallel group (the
    self-attention's x before q/k/v, the cross-attention's x before to_q,
    the feed-forward's x): each rank's backward gives only its columns'
    part of dx, and the sum is the whole;
  - ``reduce_from_tp``: all-reduce (sum) forward, identity backward. It goes
    after a row-parallel product (to_out.0, ff.net.2), whose partials each
    rank computes from its own input columns. Each partial comes out of its
    product in the input dtype (bf16 in training); the partials are summed
    in fp32 and returned in fp32, and ``row_parallel_linear`` adds the bias
    once, after the reduce, and rounds the total to the input dtype;
  - ``gather_columns``: every rank's columns of a column-parallel output,
    whose backward sums the ranks' cotangents and takes this rank's
    columns: JAX's fallback when the heads do not divide over tp, where the
    attention runs on every head on every rank.

Neither Function saves a tensor, so remat (``torch.utils.checkpoint``)
recomputes them as they are. Each collective is counted in ops/spatial.py's
``COMM`` table under its own kind: ``tp_reduce`` (forward),
``tp_copy.bwd`` (backward), ``tp_gather`` and ``tp_gather.bwd``. On one
card two ranks share, the tp group is gloo and each tensor is staged
through pinned host memory.
"""

from __future__ import annotations

import torch

from ddpo_torch.ops import invariance
from ddpo_torch.ops.spatial import Axis, all_reduce, gather_rows, replicated


def copy_to_tp(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x``, whole on every rank of the tp group; the backward all-reduces
    the cotangent."""
    return replicated(x, axis, "tp_copy")


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, axis: Axis):
        ctx.dtype = partial.dtype
        return all_reduce(partial, axis, "tp_reduce", torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def reduce_from_tp(partial: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over the tp group of each rank's ``partial``, in fp32; the
    backward passes the cotangent on, in the partial's dtype."""
    if axis.size == 1:
        return partial.float()
    return _ReduceFromTP.apply(partial, axis)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, bias, axis: Axis
                        ) -> torch.Tensor:
    """A row-parallel Linear: this rank's input columns ``x`` times its
    slice of the weight's input dim (a partial in ``x``'s dtype), the
    partials summed over the group in fp32, the (replicated) bias added
    once after the sum, and the total rounded to ``x``'s dtype. The
    product runs batch-invariantly, as the tp group's other Linears
    (ops/invariance.py ``linear``)."""
    total = reduce_from_tp(invariance.linear(x, weight, None, True), axis)
    if bias is not None:
        total = total + bias.float()
    return total.to(x.dtype)


def gather_columns(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's last-dim columns of ``t``, concatenated in rank order;
    the backward sums the cotangents over the group and takes this rank's
    columns (the transpose of the gather when each rank goes on with its
    own columns of the result)."""
    if axis.size == 1:
        return t
    return replicated(gather_rows(t, axis, t.dim() - 1, "tp_gather"), axis, "tp_gather")


def local_columns(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's contiguous last-dim columns of ``t``."""
    cols = t.shape[-1] // axis.size
    return t.narrow(t.dim() - 1, axis.index * cols, cols)
