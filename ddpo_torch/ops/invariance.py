"""Batch invariance: an image's bits that do not depend on its batch.

The DDPO trainer recomputes the sampler's log-probs at its own batch shape
(2B = 4 against the sampler's 2B = 16) and in its own order, so every op of
the UNet must give an image the same bits in any batch and at any position.
The port's kernels do (chip_smoke.py phases 3-3d), and on the H100 so do
cuBLAS's Linear products, the 1x1 convs, LayerNorm and GroupNorm. cuDNN's 3x3
convs do not: an image's bits change with the batch size and, at one size,
with its position in the batch (ddpo_torch/bench/batch_invariance.py).

Inside ``batch_invariant()``, on CUDA tensors:
  - the stride-1 3x3 convs run the tap-GEMM kernel (ops/conv.py), as with
    ``set_conv_kernel_enabled(True)``, unless the kernel is forbidden;
  - the other library 3x3 convs (stride 2, or the kernel forbidden) run
    their forward one image a call;
  - the plain attention runs in pieces of ``ATTENTION_PIECE`` samples;
  - under spatial sharding (parallel/spatial.py) the transformer blocks'
    Linears run in pieces of ``ATTENTION_PIECE`` samples too (``linear``):
    the sharded shapes put cuBLAS at small M (2B x 32 tokens at the 8x8
    level with sp = 2), where its kernel, and a row's bits, change with M:
    one of the 8 Linears at 2B x 32 differs between 2B = 4 and 2B = 2 on
    the H100 (chip_smoke.py 14b's module table). The unsharded
    shapes agree (phase 6b), so there they stay one call.

The DDPO driver (pipelines/policy_gradient.py) enters it around the
sampler's and the trainer's UNet calls; serving does not need it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

# samples per plain-attention call inside batch_invariant(): the trainer's
# 2B at the default train batch of 2, so the update makes one call
ATTENTION_PIECE = 4

_ENABLED = False


def enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def batch_invariant(on: bool = True):
    """Run the enclosed ops batch-invariantly (``on``) or as they are."""
    global _ENABLED
    previous, _ENABLED = _ENABLED, on
    try:
        yield
    finally:
        _ENABLED = previous


def in_pieces(fn: Callable, tensors: Sequence[torch.Tensor], piece: int) -> torch.Tensor:
    """fn over pieces of ``piece`` rows of the tensors (sharing dim 0), the
    last piece padded with zero rows whose outputs are dropped, so every
    call has ``piece`` rows."""
    n = tensors[0].shape[0]
    if n == piece:
        return fn(*tensors)
    pad = -n % piece
    if pad:
        tensors = [torch.cat([t, t.new_zeros((pad, *t.shape[1:]))]) for t in tensors]
    out = torch.cat([fn(*parts) for parts in zip(*(t.split(piece) for t in tensors))])
    return out[:n] if pad else out


def linear(x: torch.Tensor, weight: torch.Tensor, bias, sharded: bool) -> torch.Tensor:
    """``F.linear``; for a ``sharded`` map's tokens (B, S, C) inside
    ``batch_invariant()`` on the card, in pieces of ``ATTENTION_PIECE``
    samples, so every call has one M whatever the batch."""
    if sharded and _ENABLED and x.is_cuda and x.dim() >= 3:
        return in_pieces(lambda part: F.linear(part, weight, bias), [x], ATTENTION_PIECE)
    return F.linear(x, weight, bias)
