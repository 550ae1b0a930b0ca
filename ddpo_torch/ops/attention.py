"""Attention: the plain PyTorch version and the CUDA flash-attention forward.

Port of ddpo_tpu/ops/attention.py. Layout as in the JAX package: q
(B, Sq, H, D), k/v (B, Sk, H, D) -> out (B, Sq, H, D); the softmax runs in
float32 whatever the input dtype.

``attention`` dispatches as JAX's does, with "on a TPU" read as "on a CUDA
tensor": long self-attention (Sq >= 256, Sk >= 256, D <= 256) goes to the
kernel (csrc/flash_fwd.cu, replacing the Pallas ``_flash_kernel``); the
77-token cross-attention, the 8x8 mid-block, the VAE's single-head D=512
attention and everything on the CPU take the plain version. A CUDA tensor
that meets the gate goes to the kernel or raises.

The flash backward is not ported yet, so the kernel path refuses tensors
that require grad instead of returning an output without a gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ddpo_torch.ops import _build


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Plain attention, fp32 softmax (JAX's ``xla_attention``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    weights = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
    return out.to(q.dtype)


def attention_lse_reference(
    q: torch.Tensor, k: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Row logsumexp of the scaled scores, (B, H, Sq) fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return torch.logsumexp(logits * scale, dim=-1)


def _check_flash_inputs(q, k, v) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    _build.dtype_code(q.dtype)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 1 <= d <= 256:
        raise ValueError(f"flash kernel takes head dims 1..256, got {d}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k, v need a unit stride over D")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("the flash backward kernel is not ported yet")


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward -> (out (B, Sq, H, D), lse (B, H, Sq) fp32).

    CUDA tensors run the kernel; CPU tensors take the plain version.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale), attention_lse_reference(q, k, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    _check_flash_inputs(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    kl = _build.load_library()
    err = kl.lib.ddpo_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _build.dtype_code(q.dtype), b, h, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), _build.stream_handle(q.device),
    )
    kl.check(err, "flash_fwd launch")
    _build.launches["flash_fwd"] += 1
    return out, lse


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Dispatching entry point used by the models (JAX's gate minus on_tpu)."""
    use_flash = (
        q.is_cuda
        and q.shape[1] >= 256
        and k.shape[1] >= 256
        and q.shape[-1] <= 256
    )
    if use_flash:
        return flash_attention_fwd(q, k, v, scale)[0]
    return attention_reference(q, k, v, scale)
