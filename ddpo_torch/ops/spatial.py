"""Spatial-sharding primitives: halo exchange and global statistics for sp UNets.

Port of ddpo_tpu/ops/spatial.py. There the whole UNet forward runs inside
one shard_map with the latent's H dimension sharded over the mesh's sp
axis; here each rank of an sp group runs the UNet on its own rows
(parallel/spatial.py), and the collectives below link them over the
group's process group. The port is NCHW, so the sharded dim is H = dim 2
(JAX's NHWC has it at dim 1).

  - 3x3 stride-1 SAME convs take one boundary row from each H neighbour
    (``halo_exchange_rows``); edge shards get zero rows, which is
    ppermute's zero fill and global SAME padding;
  - 3x3 stride-2 downsamples need only the top halo row (``halo_top_row``):
    with even local H every stride-2 window that starts in a shard ends in
    it, and global SAME padding at even H never reads the bottom pad row;
  - GroupNorm's per-(batch, group) sums are additive over H, so the global
    statistics are one small all-reduce (``psum_moments``);
  - self-attention all-gathers K/V over the axis, in rank order, which is
    the H-major token order (``gather_kv``).

Three more cover the edges of a sharded region, JAX's shard_map in and out
specs: ``shard_rows`` takes this rank's rows of a tensor every rank holds
whole, ``gather_rows`` gives every rank the whole of a row-sharded one, and
``replicated`` marks a whole tensor each rank uses for its own part.

Each collective is a ``torch.autograd.Function`` whose backward is the
forward's exact transpose: the cotangent of a received halo row goes back
to its sender and is added to the sender's boundary row; the all-reduce's
is an all-reduce; the K/V gather's a reduce-scatter (sum, as an all-reduce
and a slice: gloo has no reduce-scatter). ``gather_rows`` differs on
purpose: every rank of the group computes the same loss from the gathered
tensor, so its cotangent is replicated, and the transpose takes this
rank's slice without summing (a sum would scale every gradient by the
axis size). ``shard_rows``' transpose gathers the cotangent's slices.

An ``Axis`` is what JAX's axis name is inside a shard_map: the group, its
size and this rank's index in it. Size 1 needs no process group: the halo
is zero rows and the collectives are identities. Over gloo a CUDA tensor
is staged through host memory (gloo reduces and gathers host memory), the
card synchronized first, so the seconds in ``COMM`` are the staging and
the collective, including the wait for the other ranks to arrive; over
NCCL the tensors stay on the card. Gathers move bytes (any dtype, bit for
bit); bf16 tensors are reduced in fp32.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist


class Axis:
    """One mesh axis as the ops see it (JAX's axis name in a shard_map)."""

    def __init__(self, name: str = "sp", size: int = 1, index: int = 0, group=None,
                 backend: str = "gloo"):
        if not 0 <= index < size:
            raise ValueError(f"axis {name}: index {index} outside size {size}")
        self.name, self.size, self.index = name, size, index
        self.group, self.backend = group, backend

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index}, {self.backend})"

    def __deepcopy__(self, memo):  # a communicator handle: copies share it
        return self


# kind -> [calls, bytes this rank put in, seconds]; backward collectives
# under "<kind>.bwd"
COMM: Dict[str, List[float]] = {}


def reset_comm() -> None:
    COMM.clear()


def comm_counts() -> Dict[str, Tuple[int, int, float]]:
    return {k: (int(c), int(b), s) for k, (c, b, s) in sorted(COMM.items())}


def _record(kind: str, t: torch.Tensor, start: float) -> None:
    entry = COMM.setdefault(kind, [0, 0, 0.0])
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()
    entry[2] += time.perf_counter() - start


def _staged(t: torch.Tensor, axis: Axis) -> bool:
    return t.is_cuda and axis.backend == "gloo"


def _start(t: torch.Tensor) -> float:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return time.perf_counter()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_gather(t: torch.Tensor, axis: Axis, kind: str) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in the axis' rank order."""
    if axis.size == 1:
        return [t]
    start = _start(t)
    src = t.contiguous()
    bits = src.view(torch.uint8)  # gathered as bytes: any dtype, bit for bit
    staged = _staged(t, axis)
    if staged:
        bits = _to_host(bits)
    out = torch.empty((axis.size, *bits.shape), dtype=bits.dtype, device=bits.device,
                      pin_memory=staged)
    dist.all_gather(list(out.unbind(0)), bits, group=axis.group)
    if staged:
        out = out.to(t.device, non_blocking=True)
    out = out.view(src.dtype)
    _record(kind, t, start)
    return list(out.unbind(0))


def all_reduce(t: torch.Tensor, axis: Axis, kind: str) -> torch.Tensor:
    """The sum over the axis of ``t``, in fp32 for bf16, in ``t``'s dtype back."""
    if axis.size == 1:
        return t
    start = _start(t)
    work = t.float() if t.dtype == torch.bfloat16 else t
    staged = _staged(t, axis)
    buf = _to_host(work) if staged else work.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, group=axis.group)
    out = buf.to(t.device, non_blocking=True) if staged else buf
    _record(kind, t, start)
    return out.to(t.dtype)


def _zero_rows(x: torch.Tensor) -> torch.Tensor:
    return x.new_zeros((*x.shape[:2], 1, *x.shape[3:]))


class _Halo(torch.autograd.Function):
    """(B, C, H, W) -> (B, C, H + 2, W), or (B, C, H + 1, W) with
    ``top_only``: the previous rank's last row above, the next rank's first
    row below, zero rows at the global edges."""

    @staticmethod
    def forward(ctx, x, axis: Axis, top_only: bool):
        ctx.axis, ctx.top_only = axis, top_only
        i, n = axis.index, axis.size
        if top_only:
            parts = all_gather(x[:, :, -1:], axis, "halo_top")
            top = parts[i - 1] if i > 0 else _zero_rows(x)
            return torch.cat([top, x], 2)
        parts = all_gather(torch.cat([x[:, :, :1], x[:, :, -1:]], 2), axis, "halo")
        top = parts[i - 1][:, :, 1:] if i > 0 else _zero_rows(x)
        bottom = parts[i + 1][:, :, :1] if i < n - 1 else _zero_rows(x)
        return torch.cat([top, x, bottom], 2)

    @staticmethod
    def backward(ctx, g):
        axis, top_only = ctx.axis, ctx.top_only
        i, n = axis.index, axis.size
        if top_only:
            # my top row's cotangent belongs to the previous rank's last row
            parts = all_gather(g[:, :, :1], axis, "halo_top.bwd")
            gx = g[:, :, 1:].clone()
            if i < n - 1:
                gx[:, :, -1:] += parts[i + 1]
            return gx, None, None
        parts = all_gather(torch.cat([g[:, :, :1], g[:, :, -1:]], 2), axis, "halo.bwd")
        gx = g[:, :, 1:-1].clone()
        if i < n - 1:  # the next rank's top halo is my last row
            gx[:, :, -1:] += parts[i + 1][:, :, :1]
        if i > 0:  # the previous rank's bottom halo is my first row
            gx[:, :, :1] += parts[i - 1][:, :, 1:]
        return gx, None, None


def halo_exchange_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Pad a (B, C, H_local, W) shard with one row from each H neighbour:
    (B, C, H_local + 2, W); edge shards receive zero rows."""
    if axis.size == 1:
        return torch.nn.functional.pad(x, (0, 0, 1, 1))
    return _Halo.apply(x, axis, False)


def halo_top_row(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Pad a (B, C, H_local, W) shard with the previous shard's last row
    (zeros on shard 0, the global top pad row): (B, C, H_local + 1, W)."""
    if axis.size == 1:
        return torch.nn.functional.pad(x, (0, 0, 1, 0))
    return _Halo.apply(x, axis, True)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis: Axis, kind: str):
        ctx.axis, ctx.kind = axis, kind
        return all_reduce(t, axis, kind)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis, ctx.kind + ".bwd"), None, None


def psum_moments(sums: torch.Tensor, sq_sums: torch.Tensor, axis: Axis
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """All-reduce per-(batch, group) moment partial sums over the axis, in
    one collective. Returns (global sums, global sq_sums, axis size): the
    caller scales its local denominator by the axis size."""
    if axis.size == 1:
        return sums, sq_sums, 1
    total = _AllReduce.apply(torch.stack([sums, sq_sums]), axis, "psum")
    return total[0], total[1], axis.size


class _GatherKV(torch.autograd.Function):
    """(B, S_local, H, D) K and V -> (B, S_global, H, D), in rank order;
    the backward reduce-scatters (sums) the cotangents."""

    @staticmethod
    def forward(ctx, k, v, axis: Axis):
        ctx.axis, ctx.s = axis, k.shape[1]
        parts = all_gather(torch.stack([k, v]), axis, "gather_kv")
        full = torch.cat(parts, 2)
        return full[0], full[1]

    @staticmethod
    def backward(ctx, gk, gv):
        axis, s = ctx.axis, ctx.s
        total = all_reduce(torch.stack([gk, gv]), axis, "gather_kv.bwd")
        mine = total[:, :, axis.index * s:(axis.index + 1) * s]
        return mine[0], mine[1], None


def gather_kv(k: torch.Tensor, v: torch.Tensor, axis: Axis
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather K/V (B, S_local, H, D) -> (B, S_global, H, D) in rank
    order, which is the H-major flattening of the spatial grid: softmax
    statistics over the gathered sequence are exactly the unsharded ones."""
    if axis.size == 1:
        return k, v
    return _GatherKV.apply(k, v, axis)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis, dim: int, kind: str):
        ctx.axis, ctx.dim, ctx.rows = axis, dim, x.shape[dim]
        return torch.cat(all_gather(x, axis, kind), dim)

    @staticmethod
    def backward(ctx, g):
        start = ctx.axis.index * ctx.rows
        return g.narrow(ctx.dim, start, ctx.rows).contiguous(), None, None, None


def gather_rows(x: torch.Tensor, axis: Axis, dim: int, kind: str = "gather_out") -> torch.Tensor:
    """Every rank's rows of ``x`` along ``dim``, concatenated in rank order;
    the backward takes this rank's slice of the (replicated) cotangent."""
    if axis.size == 1:
        return x
    return _GatherRows.apply(x, axis, dim, kind)


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis, dim: int, kind: str):
        ctx.axis, ctx.dim, ctx.kind = axis, dim, kind
        rows = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * rows, rows).contiguous()

    @staticmethod
    def backward(ctx, g):
        full = torch.cat(all_gather(g, ctx.axis, ctx.kind + ".bwd"), ctx.dim)
        return full, None, None, None


def shard_rows(x: torch.Tensor, axis: Axis, dim: int, kind: str = "shard_rows") -> torch.Tensor:
    """This rank's contiguous rows of ``x`` (which every rank holds whole)
    along ``dim``; the backward gathers every rank's slice of the cotangent."""
    if axis.size == 1:
        return x
    if x.shape[dim] % axis.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{axis.name}={axis.size}")
    return _ShardRows.apply(x, axis, dim, kind)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: Axis, kind: str):
        ctx.axis, ctx.kind = axis, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis, ctx.kind + ".bwd"), None, None


def replicated(x: torch.Tensor, axis: Axis, kind: str = "replicated") -> torch.Tensor:
    """``x``, which every rank holds whole and each uses for its own part
    of a computation: the backward sums the ranks' cotangents."""
    if axis.size == 1:
        return x
    return _Replicated.apply(x, axis, kind)


def validate_spatial_geometry(height: int, axis_name: str, axis_n: int, levels: int = 3) -> None:
    """Check H divides the sp axis at every UNet resolution level.

    height: latent H at the UNet input (64 for 512 px). levels: number of
    stride-2 downsamples (3 for SD-1.4). Raises naming the failing level;
    also enforces even local H wherever a downsample happens (the
    halo_top_row scheme needs it). JAX's messages.
    """
    h = height
    for level in range(levels + 1):
        if h % axis_n:
            raise ValueError(
                f"spatial sharding: H={h} at UNet level {level} does not "
                f"divide {axis_name}={axis_n} (input H={height})"
            )
        local = h // axis_n
        if level < levels and local % 2:
            raise ValueError(
                f"spatial sharding: local H={local} at level {level} must "
                f"be even for the stride-2 downsample halo "
                f"({axis_name}={axis_n}, input H={height})"
            )
        h //= 2

