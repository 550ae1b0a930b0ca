"""GroupNorm (+ optional SiLU) for NCHW feature maps, fp32 statistics.

Port of ddpo_tpu/ops/groupnorm.py. The per-(batch, group) sum and sum of
squares come from ``group_stats``: the CUDA kernel (csrc/gn_stats.cu,
replacing the Pallas ``_gn_stats_kernel``) for a CUDA tensor, the plain
version for a CPU tensor. Normalize, affine and SiLU stay in PyTorch, as
they stayed in XLA. The port keeps PyTorch's NCHW layout, where each
(n, group) is one contiguous run of (C/G)*H*W elements.

Under autograd the statistics go through ``GroupStats``, on both devices:
its forward is ``group_stats`` and its backward the analytic one of JAX's
``_moments_bwd``, in plain torch as JAX's is plain XLA.

The fused GN+SiLU Pallas kernel is opt-in in JAX and not ported yet;
``group_norm_silu`` is ``group_norm(silu=True)``, JAX's default path.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ddpo_torch.ops import _build


def num_groups_for(channels: int, num_groups: int) -> int:
    """The gcd clamp of narrow layers (tiny test configs); SD has c % 32 == 0."""
    return num_groups if channels % num_groups == 0 else math.gcd(channels, num_groups)


def group_stats_reference(x: torch.Tensor, g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, c, *spatial) -> (sums (n, g), sq_sums (n, g)), in fp32."""
    xf = x.reshape(x.shape[0], g, -1).float()
    return xf.sum(dim=-1), (xf * xf).sum(dim=-1)


def group_stats(x: torch.Tensor, g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, group) sums and sums of squares of an NCHW map, fp32.

    CUDA tensors run the kernel; CPU tensors take the plain version.
    """
    if x.dim() < 2 or x.shape[1] % g:
        raise ValueError(f"channels {tuple(x.shape)[1:2]} do not split into {g} groups")
    if x.device.type == "cpu":
        return group_stats_reference(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"no group-stats kernel for device {x.device}")
    code = _build.dtype_code(x.dtype)
    if not x.is_contiguous():
        raise ValueError("group_stats needs a contiguous NCHW map")
    n = x.shape[0]
    n_runs = n * g
    run_len = x.numel() // n_runs
    kl = _build.load_library()
    nchunks = -(-run_len // kl.gn_chunk)
    partials = torch.empty(2 * n_runs * nchunks, dtype=torch.float32, device=x.device)
    sums = torch.empty((n, g), dtype=torch.float32, device=x.device)
    sq_sums = torch.empty((n, g), dtype=torch.float32, device=x.device)
    err = kl.lib.ddpo_gn_stats(
        x.data_ptr(), partials.data_ptr(), sums.data_ptr(), sq_sums.data_ptr(),
        code, n_runs, run_len, nchunks, _build.stream_handle(x.device),
    )
    kl.check(err, "gn_stats launch")
    _build.launches["gn_stats"] += 1
    return sums, sq_sums


class GroupStats(torch.autograd.Function):
    """``group_stats`` with the analytic backward of JAX's ``_moments_bwd``:
    d sums / dx = 1 and d sq_sums / dx = 2x within each group, so
    gx = g_sums[n, g] + 2 x g_sq[n, g], cast to x's dtype."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.save_for_backward(x)
        ctx.groups = g
        return group_stats(x, g)

    @staticmethod
    def backward(ctx, g_sums, g_sq):
        (x,) = ctx.saved_tensors
        xf = x.reshape(x.shape[0], ctx.groups, -1).float()
        gx = g_sums[..., None] + 2.0 * xf * g_sq[..., None]
        return gx.to(x.dtype).reshape(x.shape), None


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    silu: bool = False,
) -> torch.Tensor:
    """GroupNorm over an NCHW (or N, C, ...) tensor with fp32 statistics.

    var = E[x^2] - E[x]^2 as in the JAX package; the output has x's dtype.
    """
    n, c = x.shape[:2]
    g = num_groups_for(c, num_groups)
    denom = float(x.numel() // n // g)

    sums, sq_sums = GroupStats.apply(x, g)
    mean = sums / denom
    var = sq_sums / denom - mean**2
    rstd = torch.rsqrt(var + eps)

    xf = x.reshape(n, g, -1).float()
    out = ((xf - mean[..., None]) * rstd[..., None]).reshape(n, c, -1)
    out = out * scale.float()[None, :, None] + bias.float()[None, :, None]
    if silu:
        out = F.silu(out)
    return out.to(x.dtype).reshape(x.shape)


def group_norm_silu(x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    return group_norm(x, scale, bias, num_groups, eps, silu=True)
