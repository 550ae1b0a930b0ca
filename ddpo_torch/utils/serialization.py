"""Model-stack construction with random weights.

Port of ddpo_tpu/utils/serialization.py's ``load_stable_diffusion`` for the
random-init case: the SD-1.4 weights are not in the repository, so the stack
is built at the full SD-1.4 geometry (``sd14``) or the CPU fixture's
(``tiny``) with random weights drawn from a seeded ``torch.Generator``.
Loading a local diffusers checkpoint, and overlaying a finetuned UNet, are
not ported yet.

The initialisation mirrors Flax's defaults, which the JAX package's random
model uses: lecun-normal (truncated) kernels, zero biases, ones and zeros
for the norms, normal(0.02) for the CLIP embeddings. PyTorch's own defaults
differ, and a model drawn from them does not stay finite through 50 bf16
sampling steps the way the Flax-initialised one does.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn as nn

from ddpo_torch.core.scheduler import DDIMScheduler
from ddpo_torch.models import (
    AutoencoderKL,
    CLIPTextConfig,
    CLIPTextModel,
    UNet2DCondition,
    UNetConfig,
    VAEConfig,
)
from ddpo_torch.models.layers import GroupNorm
from ddpo_torch.models.tokenizer import get_tokenizer, warn_if_fallback


class StableModels(NamedTuple):
    tokenizer: Any
    text_encoder: CLIPTextModel
    vae: AutoencoderKL
    unet: UNet2DCondition
    scheduler: DDIMScheduler


def sd_scheduler() -> DDIMScheduler:
    """SD-1.4 DDIM configuration."""
    return DDIMScheduler(
        num_train_timesteps=1000,
        beta_start=0.00085,
        beta_end=0.012,
        beta_schedule="scaled_linear",
        set_alpha_to_one=False,
        steps_offset=1,
        prediction_type="epsilon",
    )


def tiny_configs():
    """Miniature stack for CPU tests (model_preset='tiny')."""
    text_cfg = CLIPTextConfig(
        vocab_size=49408, hidden_size=32, intermediate_size=64,
        num_layers=2, num_heads=4,
    )
    unet_cfg = UNetConfig(
        sample_size=8, block_out_channels=(32, 64), layers_per_block=1,
        attention_heads=2, cross_attention_dim=32,
        down_block_has_attn=(True, False),
    )
    vae_cfg = VAEConfig(block_out_channels=(16, 32), layers_per_block=1)
    return text_cfg, unet_cfg, vae_cfg


def resolve_device(device: Any) -> torch.device:
    """``device`` as a torch.device; "cuda" raises at once when torch finds
    no card, so nothing meant for the card runs on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for, but torch finds no CUDA device; "
            "pass --device cpu (device='cpu') to run on the CPU"
        )
    return device


def build_models(model_preset: str = "sd14", device: Any = "cuda"):
    """(text_encoder, vae, unet) with uninitialised storage on ``device``."""
    device = resolve_device(device)
    if model_preset == "tiny":
        text_cfg, unet_cfg, vae_cfg = tiny_configs()
    elif model_preset == "sd14":
        text_cfg, unet_cfg, vae_cfg = CLIPTextConfig(), UNetConfig(), VAEConfig()
    else:
        raise ValueError(f"unknown model_preset {model_preset!r} (sd14|tiny)")
    with torch.device("meta"):
        modules = (CLIPTextModel(text_cfg), AutoencoderKL(vae_cfg), UNet2DCondition(unet_cfg))
    return tuple(m.to_empty(device=device) for m in modules)


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax lecun_normal: truncated normal at +-2 std, variance 1/fan_in."""
    fan_in = weight[0].numel()  # Linear (out, in); Conv (out, in, kh, kw)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # std of N(0,1) cut at +-2
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax-style random init of every parameter of ``module``, in place."""
    done = set()
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        else:
            continue
        done.update(id(p) for p in m.parameters(recurse=False))
    missed = [n for n, p in module.named_parameters() if id(p) not in done]
    if missed:
        raise RuntimeError(f"no initialiser for parameters {missed[:5]}")


def load_stable_diffusion(
    pretrained_model: Optional[str] = None,
    model_preset: str = "sd14",
    device: Any = "cuda",
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
) -> StableModels:
    """Build the stack on ``device`` in ``dtype`` with random weights.

    ``pretrained_model`` names the tokenizer vocabulary to look for; the
    weights are always random (checkpoint loading is not ported yet).
    """
    device = torch.device(device)
    text_encoder, vae, unet = build_models(model_preset, device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    for module in (unet, vae, text_encoder):
        init_weights_(module, generator)
        module.to(dtype).eval().requires_grad_(False)
    tokenizer = get_tokenizer(pretrained_model)
    if model_preset != "tiny":  # the tiny preset is a test fixture by design
        warn_if_fallback(tokenizer, "serialization")
    return StableModels(
        tokenizer=tokenizer,
        text_encoder=text_encoder,
        vae=vae,
        unet=unet,
        scheduler=sd_scheduler(),
    )
