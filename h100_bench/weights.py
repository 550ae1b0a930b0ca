"""Random weights from the seed, made on the device in a few large calls.

Both sides get the same numbers: the program's modules and the reference's
have the same parameter names and shapes, and ``fill_`` draws by sorted
name, so equal (seed, names, shapes) give equal tensors on one device.

The distribution is Flax's defaults, which the JAX package's random model
uses and the port's ``init_weights_`` copies (a model drawn from PyTorch's
own defaults does not stay finite through 50 bf16 sampling steps):
truncated lecun-normal kernels (variance 1 / fan_in, cut at two standard
deviations), zero biases, ones for the norms' scales, normal(0.02) for the
text encoder's token and position embeddings.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

EMBEDDINGS = ("token_embedding.weight", "position_embedding.weight")
# the standard deviation of N(0, 1) cut at +-2
TRUNC_STD = 0.87962566103423978

# one generator stream per module, so that a side may hold a subset of modules
STREAMS = {"text_encoder": 1, "vae": 2, "unet": 3, "lora": 4, "sampler": 5}


def generator(seed: int, module: str, device) -> torch.Generator:
    """The stream of ``module`` for ``seed`` (any whole number >= 0)."""
    mixed = (int(seed) * 1_000_003 + STREAMS[module]) % (2**63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def _flat_draw(tensors, gen, draw) -> list:
    """One draw over all ``tensors``' elements, split back into their shapes."""
    sizes = [t.numel() for t in tensors]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=tensors[0].device)
    draw(flat, gen)
    return [v.view(t.shape) for v, t in zip(flat.split(sizes), tensors)]


@torch.no_grad()
def fill_(params: Dict[str, torch.Tensor], gen: torch.Generator) -> None:
    """Fill every tensor of ``params`` (name -> fp32 parameter) in place."""
    names = sorted(params)
    embeds = [n for n in names if n.endswith(EMBEDDINGS)]
    kernels = [n for n in names if params[n].dim() >= 2 and n not in embeds]
    ones = [n for n in names if params[n].dim() == 1 and n.endswith("weight")]
    zeros = [n for n in names if n.endswith("bias")]
    rest = set(names) - set(embeds) - set(kernels) - set(ones) - set(zeros)
    if rest:
        raise ValueError(f"no initialiser for parameters {sorted(rest)[:5]}")
    if kernels:
        views = _flat_draw([params[n] for n in kernels], gen,
                           lambda t, g: torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                                                     generator=g))
        scales = [math.sqrt(1.0 / params[n][0].numel()) / TRUNC_STD for n in kernels]
        torch._foreach_mul_(views, scales)
        torch._foreach_copy_([params[n] for n in kernels], views)
        del views
    if embeds:
        views = _flat_draw([params[n] for n in embeds], gen,
                           lambda t, g: t.normal_(0.0, 0.02, generator=g))
        torch._foreach_copy_([params[n] for n in embeds], views)
    if zeros:
        torch._foreach_zero_([params[n] for n in zeros])
    if ones:
        torch._foreach_zero_([params[n] for n in ones])
        torch._foreach_add_([params[n] for n in ones], 1.0)


def fill_module_(module: torch.nn.Module, seed: int, name: str) -> None:
    """``fill_`` of every parameter of ``module`` from the stream ``name``."""
    params = dict(module.named_parameters())
    fill_(params, generator(seed, name, next(iter(params.values())).device))


@torch.no_grad()
def fill_lora_(adapters: Dict[str, torch.Tensor], seed: int) -> None:
    """LoRA's initial adapters, as models/lora.py draws them: each "<path>.a"
    (in, r) from N(0, 1) / r, each "<path>.b" zero, by sorted name."""
    names = sorted(adapters)
    a_names = [n for n in names if n.endswith(".a")]
    b_names = [n for n in names if n.endswith(".b")]
    if len(a_names) + len(b_names) != len(names):
        raise ValueError("adapter names end in .a or .b")
    device = adapters[names[0]].device
    views = _flat_draw([adapters[n] for n in a_names], generator(seed, "lora", device),
                       lambda t, g: t.normal_(0.0, 1.0, generator=g))
    rank = adapters[a_names[0]].shape[1]
    torch._foreach_mul_(views, 1.0 / rank)
    torch._foreach_copy_([adapters[n] for n in a_names], views)
    torch._foreach_zero_([adapters[n] for n in b_names])
