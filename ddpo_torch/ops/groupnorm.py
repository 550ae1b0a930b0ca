"""GroupNorm (+ optional SiLU) for NCHW feature maps, fp32 statistics.

Port of ddpo_tpu/ops/groupnorm.py. The per-(batch, group) sum and sum of
squares come from ``group_stats``: the CUDA kernel (csrc/gn_stats.cu,
replacing the Pallas ``_gn_stats_kernel``) for a CUDA tensor, the plain
version for a CPU tensor. Normalize, affine and SiLU stay in PyTorch, as
they stayed in XLA. The port keeps PyTorch's NCHW layout, where each
(n, group) is one contiguous run of (C/G)*H*W elements.

Under autograd the statistics go through ``GroupStats``, on both devices:
its forward is ``group_stats`` and its backward the analytic one of JAX's
``_moments_bwd``, in plain torch as JAX's is plain XLA. Without autograd
(no grad mode, or an x that needs no gradient) ``group_norm`` calls
``group_stats`` itself: the same numbers.

``group_norm_silu`` follows JAX's opt-in: by default it is
``group_norm(silu=True)``; with ``use_kernel=True`` a CUDA tensor runs the
fused kernel (csrc/gn_silu.cu, replacing the Pallas ``_gn_silu_kernel``:
statistics, normalize, affine and SiLU in one launch, forward only) and a
CPU tensor ``group_norm(silu=True)``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

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


# the C functions, bound at the first CUDA call
_gn_stats = None
_gn_silu = None


def group_stats(x: torch.Tensor, g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, group) sums and sums of squares of an NCHW map, fp32: the
    two rows of one (2, n, g) tensor.

    CUDA tensors run the kernel, one launch; CPU tensors take the plain version.
    """
    global _gn_stats
    if x.dim() < 2 or x.shape[1] % g:
        raise ValueError(f"channels {tuple(x.shape)[1:2]} do not split into {g} groups")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return torch.stack(group_stats_reference(x, g)).unbind(0)
        raise ValueError(f"no group-stats kernel for device {x.device}")
    code = _build.dtype_code(x.dtype)
    if not x.is_contiguous():
        raise ValueError("group_stats needs a contiguous NCHW map")
    n = x.shape[0]
    out = torch.empty((2, n, g), dtype=torch.float32, device=x.device)
    if _gn_stats is None:
        _gn_stats = _build.load_library().lib.ddpo_gn_stats
    err = _gn_stats(x.data_ptr(), out.data_ptr(), code, n * g, x.numel() // (n * g),
                    _build.stream_handle(x.device))
    if err:
        _build.load_library().check(err, "gn_stats launch")
    _build.launches["gn_stats"] += 1
    return out.unbind(0)


GN_SILU_MODES = ("cached", "streamed", "scalar")  # ddpo_gn_silu_plan's mode codes


def gn_stats_cluster_size(run_len: int, dtype) -> int:
    """The cluster size (blocks a run) ``group_stats`` launches with on a
    CUDA map whose (n, group) runs are ``run_len`` elements of ``dtype``."""
    return int(_build.load_library().lib.ddpo_gn_cluster_size(run_len, _build.dtype_code(dtype)))


def gn_silu_plan(cpg: int, hw: int, dtype) -> Tuple[int, str]:
    """(cluster size, way through) of the fused kernel on a 16-byte-aligned
    map of ``cpg`` channels a group and ``hw`` pixels: "cached" (one read,
    through shared memory), "streamed" (two reads) or "scalar"."""
    kl = _build.load_library()
    k, mode = ctypes.c_int(), ctypes.c_int()
    kl.check(kl.lib.ddpo_gn_silu_plan(cpg, hw, _build.dtype_code(dtype), ctypes.byref(k),
                                      ctypes.byref(mode)), "gn_silu plan")
    return k.value, GN_SILU_MODES[mode.value]


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


def _normalize(x, sums, sq_sums, scale, bias, g, eps, silu):
    """Normalize, affine and optional SiLU from the group sums, in fp32;
    var = E[x^2] - E[x]^2 as in the JAX package; the output has x's dtype."""
    n, c = x.shape[:2]
    denom = float(x.numel() // n // g)
    mean = sums / denom
    var = sq_sums / denom - mean**2
    rstd = torch.rsqrt(var + eps)

    xf = x.reshape(n, g, -1).float()
    out = ((xf - mean[..., None]) * rstd[..., None]).reshape(n, c, -1)
    out = out * scale.float()[None, :, None] + bias.float()[None, :, None]
    if silu:
        out = F.silu(out)
    return out.to(x.dtype).reshape(x.shape)


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
    g = num_groups_for(x.shape[1], num_groups)
    if torch.is_grad_enabled() and x.requires_grad:
        sums, sq_sums = GroupStats.apply(x, g)
    else:  # the same numbers without autograd's bookkeeping (the sampler's path)
        sums, sq_sums = group_stats(x, g)
    return _normalize(x, sums, sq_sums, scale, bias, g, eps, silu)


def group_norm_silu_reference(x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    """The fused kernel's plain version, which the card checks hold it
    against: ``group_norm(silu=True)`` with the statistics from
    ``group_stats_reference``, on any device."""
    g = num_groups_for(x.shape[1], num_groups)
    sums, sq_sums = group_stats_reference(x, g)
    return _normalize(x, sums, sq_sums, scale, bias, g, eps, True)


def gn_silu_kernel(x, scale, bias, num_groups: int, eps: float) -> torch.Tensor:
    """Launch csrc/gn_silu.cu on a contiguous CUDA map whose channels split
    into ``num_groups``; the output has x's dtype. Scale and bias, on x's
    device in fp32 or bf16, are read in their own dtype. No backward: JAX's
    kernel has none either."""
    global _gn_silu
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("the fused GN+SiLU kernel is forward only, as in JAX")
    code = _build.dtype_code(x.dtype)
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError("gn_silu needs a contiguous NCHW map")
    n, c = x.shape[:2]
    if c % num_groups or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"gn_silu: {c} channels, {num_groups} groups, scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)}")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError(f"gn_silu: scale on {scale.device} and bias on {bias.device}, "
                         f"x on {x.device}")
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty_like(x)
    if _gn_silu is None:
        _gn_silu = _build.load_library().lib.ddpo_gn_silu
    err = _gn_silu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), code,
        _build.dtype_code(scale.dtype), _build.dtype_code(bias.dtype), n * num_groups,
        num_groups, c // num_groups, x.numel() // (n * c), float(eps),
        _build.stream_handle(x.device),
    )
    if err:
        _build.load_library().check(err, "gn_silu launch")
    _build.launches["gn_silu"] += 1
    return out


def group_norm_silu(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Fused GroupNorm + SiLU, JAX's ``group_norm_silu``.

    ``use_kernel`` None means False, as in JAX, where XLA's fusion matched
    the kernel. With ``use_kernel=True`` and channels that split into
    ``num_groups``, a CUDA tensor runs the kernel; a CPU tensor, and other
    channel counts, take ``group_norm`` (with its gcd clamp).
    JAX's VMEM budget (map size, c % 128, s % 8) is the TPU's and is not
    carried over: the kernel takes every NCHW map.
    """
    if not use_kernel or x.shape[1] % num_groups or x.device.type == "cpu":
        return group_norm(x, scale, bias, num_groups, eps, silu=True)
    if x.device.type != "cuda":
        raise ValueError(f"no gn_silu kernel for device {x.device}")
    return gn_silu_kernel(x, scale, bias, num_groups, eps)
