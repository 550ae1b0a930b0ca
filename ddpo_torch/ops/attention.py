"""Attention: the plain PyTorch versions and the CUDA flash-attention kernels.

Port of ddpo_tpu/ops/attention.py. Layout as in the JAX package: q
(B, Sq, H, D), k/v (B, Sk, H, D) -> out (B, Sq, H, D); the softmax runs in
float32 whatever the input dtype.

``attention`` dispatches as JAX's does, with "on a TPU" read as "on a CUDA
tensor": long self-attention (Sq >= 256, Sk >= 256, D <= 256) goes to the
kernels; the 77-token cross-attention, the 8x8 mid-block, the VAE's
single-head D=512 attention and everything on the CPU take the plain
version. A CUDA tensor that meets the gate goes to the kernels or raises.

Kernels (each replaces a Pallas kernel of the JAX package):
  - csrc/flash_fwd.cu ``flash_fwd``: out and the row logsumexp
    (``_flash_kernel``);
  - csrc/flash_bwd.cu ``flash_bwd_dq`` and ``flash_bwd_dkv``: dq, and dk/dv,
    recomputing P from the logsumexp (``_flash_bwd_dq_kernel``,
    ``_flash_bwd_dkv_kernel``).

In bf16 both files run every product on Hopper's tensor cores (wgmma, fed
by TMA). The fp32 forward (csrc/flash_fwd_tf32.cu) runs there too, as
3xTF32 products: each operand split into two tf32 values and three tf32
products summed in fp32, about 22 of fp32's 24 bits, so the fp32 bounds
hold. The fp32 backward is autograd through the plain version (below).

``attention(..., spatial=axis)`` (JAX's ``spatial_axis``, self-attention
of a UNet whose H is sharded over the axis): K/V are all-gathered over the
axis (ops/spatial.py ``gather_kv``) and the dispatch runs on the local
shapes, Sq local and Sk whole. At SD-1.4 with sp = 2 the local Sq is 2048,
512, 128 and 32 against Sk 4096, 1024, 256 and 64, so the flash kernels
take the two top levels (10 of the 16 self-attentions) and the 16x16 level
the plain path.

``set_attention_sharding(mesh, batch_axis, heads_axis, seq_axis)`` is JAX's
context for the attention mode of sp: while set, a self-attention whose
sequence splits over ``seq_axis`` runs parallel/sequence.py's
``sequence_parallel_attention``. Its ``heads_axis`` is tp: there the heads
are already local after the column-parallel projections
(models/layers.py ``CrossAttention``), so the kernels see (B, S, H / tp, D)
with no collective, and heads that do not divide over tp run whole
(JAX's fallback, in ``CrossAttention``).

Under autograd the gate goes through ``FlashAttention``, whose backward
follows JAX's ``_use_pallas_bwd``: the backward kernels for bf16, autograd
through ``attention_reference`` for fp32. Inside
``invariance.batch_invariant()`` the plain version runs in pieces of
``invariance.ATTENTION_PIECE`` samples on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ddpo_torch.ops import _build, invariance
from ddpo_torch.ops.spatial import gather_kv


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
    return flash_fwd(q, k, v, scale)


def flash_fwd(q, k, v, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_fwd`` on checked CUDA inputs -> (out, lse);
    ``flash_attention_fwd`` checks them first."""
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


def flash_uses_tma(t: torch.Tensor) -> bool:
    """Whether the flash kernels' producers load this (B, S, H, D) CUDA
    tensor by TMA: in bf16 the forward's, dq's and dk/dv's, in fp32 the
    forward's Q and K (V is transposed by plain loads). Else they stage it
    with plain loads (a base off 16 bytes, or a stride off a whole 16
    bytes); the consumers' bits are the same either way. A kernel takes TMA
    only where all its inputs allow it."""
    b, s, h, d = t.shape
    kl = _build.load_library()
    return bool(kl.lib.ddpo_flash_tma_ok(t.data_ptr(), b, s, h, d, t.stride(0), t.stride(1),
                                         t.stride(2), t.element_size()))


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain flash backward in fp32 -> (dq, dk, dv), fp32.

    The math of JAX's ``_flash_backward``: P = exp(s - lse) is recomputed
    from the forward's logsumexp (B, H, Sq), never taken from a stored
    softmax; delta = rowsum(dO * O), dS = P * (dO V^T - delta),
    dQ = scale * dS K, dK = scale * dS^T Q, dV = P^T dO.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    delta = _delta(out, do)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vf) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq, dk, dv


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32, (B, H, Sq) contiguous; plain torch, as JAX
    computes it in XLA outside its kernels."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward -> (dq, dk, dv) in the dtypes of q, k, v.

    CUDA tensors run the two kernels; CPU tensors take the plain version.
    ``out`` and ``lse`` are what ``flash_attention_fwd`` returned.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    _check_flash_inputs(q, k, v)
    b, sq, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dout {tuple(do.shape)} {do.dtype} does not match q")
    if do.stride(-1) != 1:
        do = do.contiguous()
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous (B, H, Sq) fp32, got {tuple(lse.shape)}")
    delta = _delta(out, do)
    return (flash_bwd_dq(q, k, v, do, lse, delta, scale),
            *flash_bwd_dkv(q, k, v, do, lse, delta, scale))


def _bwd_common(q, k, v, do, lse, delta, scale):
    """The leading and trailing ctypes arguments both backward kernels take."""
    b, sq, h, d = q.shape
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v, do) for i in range(3)))
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr())
    shape = (_build.dtype_code(q.dtype), b, h, sq, k.shape[1], d, strides, float(scale),
             _build.stream_handle(q.device))
    return inputs, shape


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """Launch ``flash_bwd_dq`` on checked CUDA inputs -> dq in q's dtype.
    ``delta`` is ``_delta(out, do)``; ``flash_attention_bwd`` checks the rest."""
    inputs, shape = _bwd_common(q, k, v, do, lse, delta, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kl = _build.load_library()
    kl.check(kl.lib.ddpo_flash_bwd_dq(*inputs, dq.data_ptr(), *shape), "flash_bwd_dq launch")
    _build.launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_bwd_dkv`` on checked CUDA inputs -> (dk, dv)."""
    inputs, shape = _bwd_common(q, k, v, do, lse, delta, scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    kl = _build.load_library()
    kl.check(kl.lib.ddpo_flash_bwd_dkv(*inputs, dk.data_ptr(), dv.data_ptr(), *shape),
             "flash_bwd_dkv launch")
    _build.launches["flash_bwd_dkv"] += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention under autograd (JAX's ``flash_attention`` custom_vjp).

    The forward is ``flash_attention_fwd``. The backward follows JAX's
    ``_use_pallas_bwd`` gate: bf16 runs ``flash_attention_bwd`` from the
    saved (q, k, v, out, lse); fp32 keeps only (q, k, v) and differentiates
    ``attention_reference``, as JAX's XLA-recompute VJP does.
    """

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale)
        if q.dtype == torch.bfloat16:
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        # read once: under a non-reentrant checkpoint a second read raises
        saved = ctx.saved_tensors
        if len(saved) == 5:
            dq, dk, dv = flash_attention_bwd(*saved, do, ctx.scale)
            return dq, dk, dv, None
        q, k, v = (t.detach().requires_grad_() for t in saved)
        with torch.enable_grad():
            ref = attention_reference(q, k, v, ctx.scale)
        dq, dk, dv = torch.autograd.grad(ref, (q, k, v), do)
        return dq, dk, dv, None


# the attention mode's context (set_attention_sharding), read at each call
_SHARD_CTX: Optional[dict] = None


def set_attention_sharding(mesh=None, batch_axis: Optional[str] = None,
                           heads_axis: Optional[str] = None,
                           seq_axis: Optional[str] = None) -> None:
    """Shard self-attention over mesh axes (a None mesh disables).

    ``mesh`` is a parallel.mesh.Mesh. ``seq_axis``: the query sequence
    splits over it and each rank attends with its rows to the whole K/V
    (parallel/sequence.py). ``batch_axis`` is accepted as JAX's is: each
    rank already holds only its dp rows. ``heads_axis`` (tp) is accepted
    and needs nothing here: a tp layer's projections already give this
    rank its local heads (module docstring).
    """
    global _SHARD_CTX
    if mesh is None:
        _SHARD_CTX = None
        return
    _SHARD_CTX = {"mesh": mesh, "seq": seq_axis}


def attention_sharded() -> bool:
    """Whether ``set_attention_sharding`` has set a context."""
    return _SHARD_CTX is not None


def _sharded_self_attention(q, k, v, scale):
    """The attention mode's self-attention, or None where the context has
    nothing to shard (a size-1 axis, or a sequence that does not split)."""
    mesh, seq = _SHARD_CTX["mesh"], _SHARD_CTX["seq"]
    n = mesh.shape.get(seq, 1) if seq else 1
    if n == 1 or q.shape[1] % n or k.shape[1] % n:
        return None
    from ddpo_torch.parallel.sequence import sequence_parallel_attention

    return sequence_parallel_attention(mesh, q, k, v, scale, axis=seq)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    spatial=None,
) -> torch.Tensor:
    """Dispatching entry point used by the models (JAX's gate minus on_tpu).

    ``spatial``: the axis the sequence is sharded over (module docstring).
    """
    if spatial is not None:
        k, v = gather_kv(k, v, spatial)
        return attention(q, k, v, scale)
    if _SHARD_CTX is not None and q.shape[1] == k.shape[1]:
        out = _sharded_self_attention(q, k, v, scale)
        if out is not None:
            return out
    use_flash = (
        q.is_cuda
        and q.shape[1] >= 256
        and k.shape[1] >= 256
        and q.shape[-1] <= 256
    )
    if not use_flash:
        if q.is_cuda and invariance.enabled():
            return invariance.in_pieces(
                lambda *qkv: attention_reference(*qkv, scale), [q, k, v],
                invariance.ATTENTION_PIECE)
        return attention_reference(q, k, v, scale)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)[0]
