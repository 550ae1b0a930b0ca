"""LoRA adapters: low-rank finetuning of the UNet's attention projections.

Port of ddpo_tpu/models/lora.py. The base UNet stays frozen; each targeted
Linear gets rank-r factors A (in, r) and B (r, out), JAX's orientation, so
the numbers carry across unchanged (``models.convert.lora_from_flax``):

    merged weight = weight + ((A @ B) * alpha / r)^T

The adapters are a flat dict keyed by the torch module path, "<path>.a" and
"<path>.b" (``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.a``),
so the train state, the optimizer and the checkpoints take them as they
take the UNet's parameters. ``merge_lora`` returns the dict of parameters
``torch.func.functional_call`` takes, differentiable in A and B: the trainer
merges once per UNet apply, outside its remat boundary, and the sampler's
UNet gets the same merge of the same tensors once per epoch, so both run the
same bits. At SD-1.4 width, r = 8 gives 256 adapter tensors with 1,594,368
parameters (16 transformer blocks x 8 projections).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import torch
import torch.nn as nn

# SD attention projections: per-block self and cross attention q/k/v/out
DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out.0")

Tensors = Dict[str, torch.Tensor]


def _params(unet_or_params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Mapping:
    if isinstance(unet_or_params, nn.Module):
        return dict(unet_or_params.named_parameters())
    return unet_or_params


def target_paths(params: Mapping[str, torch.Tensor],
                 targets: Sequence[str] = DEFAULT_TARGETS) -> List[str]:
    """Module paths of the targeted 2-D weights, in the params' order."""
    paths = []
    for key, value in params.items():
        path, _, leaf = key.rpartition(".")
        if leaf == "weight" and value.dim() == 2 and any(
                path == t or path.endswith("." + t) for t in targets):
            paths.append(path)
    return paths


def init_lora(
    unet_or_params: Union[nn.Module, Mapping[str, torch.Tensor]],
    rank: int,
    generator: torch.Generator,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.float32,
) -> Tensors:
    """Adapters for every targeted weight: A ~ N(0, 1) / rank, B = 0.

    With B = 0 the merged model is the base model at init, so a LoRA run
    starts on-policy. A is drawn from ``generator`` on its device, in the
    params' order, and placed on its weight's device.
    """
    if rank <= 0:
        raise ValueError(f"rank must be positive, got {rank}")
    params = _params(unet_or_params)
    paths = target_paths(params, targets)
    if not paths:
        raise ValueError(f"no LoRA targets {tuple(targets)} found in the parameters")
    adapters = {}
    for path in paths:
        weight = params[path + ".weight"]
        d_out, d_in = weight.shape
        a = torch.randn((d_in, rank), generator=generator, dtype=dtype,
                        device=generator.device) / rank
        adapters[path + ".a"] = a.to(weight.device)
        adapters[path + ".b"] = torch.zeros((rank, d_out), dtype=dtype, device=weight.device)
    return adapters


def lora_scale(adapters: Mapping[str, torch.Tensor], alpha: Optional[float] = None) -> float:
    """alpha / rank; alpha defaults to the rank (scale 1.0)."""
    rank = next(v.shape[1] for k, v in adapters.items() if k.endswith(".a"))
    return float(alpha if alpha is not None else rank) / float(rank)


def merge_lora(base: Mapping[str, torch.Tensor], adapters: Mapping[str, torch.Tensor],
               alpha: Optional[float] = None) -> Tensors:
    """``base`` with each targeted weight replaced by its merge; the other
    entries are the base's tensors themselves.

    As JAX's merge_lora: delta = (A @ B) * scale in the adapters' dtype,
    cast to the weight's dtype, then transposed to the weight's (out, in)
    and added in the weight's dtype.
    """
    scale = lora_scale(adapters, alpha)
    merged = dict(base)
    for key, a in adapters.items():
        if not key.endswith(".a"):
            continue
        path = key[:-2]
        weight = base[path + ".weight"]
        delta = (a @ adapters[path + ".b"]) * scale
        merged[path + ".weight"] = weight + delta.to(weight.dtype).T
    return merged


def n_lora_params(adapters: Mapping[str, torch.Tensor]) -> int:
    return sum(v.numel() for v in adapters.values())
