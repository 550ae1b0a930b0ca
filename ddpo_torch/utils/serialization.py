"""Model-stack construction (a local checkpoint or random weights), the
finetuned-UNet overlay, and the stack's export.

Port of ddpo_tpu/utils/serialization.py. ``load_stable_diffusion`` loads a
local diffusers checkpoint directory (the diffusers-Flax msgpack layout or
the torch-safetensors one, through models/convert.py
``load_sd_checkpoint``) when ``pretrained_model`` names one. Otherwise it
says so, as JAX does, and builds the stack at the full SD-1.4 geometry
(``sd14``) or the CPU fixture's (``tiny``) with random weights drawn from
a seeded ``torch.Generator``. ``load_unet`` overlays a finetuned UNet on
that stack, and ``save_stable_diffusion_export`` writes the stack in the
diffusers-Flax msgpack layout, which either package's loader reads.
``sync_to_bucket`` / ``async_to_bucket`` stream a run's artifacts to its
gs:// savepath.

The random initialisation mirrors Flax's defaults, which the JAX package's
random model uses: lecun-normal (truncated) kernels, zero biases, ones and
zeros for the norms, normal(0.02) for the CLIP embeddings. PyTorch's own
defaults differ, and a model drawn from them does not stay finite through
50 bf16 sampling steps the way the Flax-initialised one does.
"""

from __future__ import annotations

import math
import os
import re
import threading
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
from ddpo_torch.models.clip import CLIPVisionEmbeddings
from ddpo_torch.models.layers import GroupNorm
from ddpo_torch.parallel.collectives import process_index
from ddpo_torch.utils import filesystem as fs
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
    no card, so nothing meant for the card runs on the CPU unasked.

    For "cuda" it is also the port's device setup: fp32 matmuls and
    convolutions stay IEEE fp32 (PyTorch lets cuDNN run them in TF32 by
    default), so every entry point computes what chip_smoke.py checks.
    Under a launcher that sets LOCAL_RANK, "cuda" is cuda:LOCAL_RANK, made
    the current device.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for, but torch finds no CUDA device; "
                "pass --device cpu (device='cpu') to run on the CPU"
            )
        if device.index is None and "LOCAL_RANK" in os.environ:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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
        elif isinstance(m, CLIPVisionEmbeddings):
            m.class_embedding.normal_(0.0, 0.02, generator=generator)
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
    """Build the stack on ``device`` in ``dtype``: the weights of the local
    checkpoint directory ``pretrained_model`` names, else random ones drawn
    from ``seed``. ``pretrained_model`` also names the tokenizer vocabulary
    to look for."""
    device = resolve_device(device)
    if pretrained_model is not None and os.path.isdir(pretrained_model):
        from ddpo_torch.models.convert import load_sd_checkpoint

        print(f"[ serialization ] loading local checkpoint: {pretrained_model}")
        modules = build_models(model_preset, "meta")
        state = load_sd_checkpoint(pretrained_model)
        # transformers text encoders may lack the top-level text_model key
        if not any(k.startswith("text_model.") for k in state["text_encoder"]):
            state["text_encoder"] = {f"text_model.{k}": v for k, v in state["text_encoder"].items()}
        text_encoder, vae, unet = (m.to(dtype).to_empty(device=device) for m in modules)
        for name, module in (("unet", unet), ("vae", vae), ("text_encoder", text_encoder)):
            module.load_state_dict(state.pop(name), strict=True)  # copies, cast to dtype
            module.eval().requires_grad_(False)
    else:
        if pretrained_model is not None:
            print(
                f"[ serialization ] '{pretrained_model}' is not a local "
                "directory; random-initializing SD-1.4 (zero-egress env)"
            )
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


def load_unet(
    loadpath: Optional[str],
    epoch="latest",
    pretrained_model: Optional[str] = None,
    model_preset: str = "sd14",
    device: Any = "cuda",
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
) -> StableModels:
    """The stack of ``load_stable_diffusion``, with a finetuned UNet over it.

    loadpath formats (as the JAX package's ``load_unet``):
      - None or "": the random stack only;
      - a directory holding unet_{epoch}.pkl (the Flax-layout export of
        ``utils.checkpoints.save_unet``, of either package), read with
        ``epoch`` ("latest" or an int);
      - "orbax:<savepath>": the params of the newest full-state checkpoint
        under <savepath>/checkpoints. The port writes no Orbax: this reads
        its own ``state.pt``. A LoRA run's checkpoint holds adapters only;
        they are merged onto this stack's UNet, the frozen base of a run
        with the same seed and preset.
    """
    from ddpo_torch.models.convert import flax_tree_to_state_dict
    from ddpo_torch.utils.checkpoints import load_unet_pickle, restore_train_state

    models = load_stable_diffusion(pretrained_model, model_preset=model_preset,
                                   device=device, dtype=dtype, seed=seed)
    if not loadpath:
        return models
    if loadpath.startswith("orbax:"):
        restored, step = restore_train_state(loadpath[len("orbax:"):])
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {loadpath}")
        print(f"[ serialization ] restored checkpoint of epoch {step}")
        state = restored["state"]["params"] if "state" in restored else restored["params"]
        if any(k.endswith(".a") for k in state):
            from ddpo_torch.models.lora import merge_lora

            base = dict(models.unet.named_parameters())
            adapters = {k: v.to(device) for k, v in state.items()}
            with torch.no_grad():
                state = merge_lora(base, adapters)
    else:
        print(f"[ serialization ] loading finetuned unet from {loadpath}")
        state = flax_tree_to_state_dict(load_unet_pickle(loadpath, epoch=epoch))
    with torch.no_grad():
        models.unet.load_state_dict(state, strict=True)  # copies, cast to dtype
    return models


def save_stable_diffusion_export(savepath: str, models) -> str:
    """Write the stack's weights in the diffusers-Flax layout,
    {unet,vae,text_encoder}/*.msgpack under ``savepath``, as ddpo_tpu's
    export does: Flax trees (``models.convert.to_flax``), bf16 kept as
    bf16. Both packages' ``load_stable_diffusion`` read the directory.
    ``models`` is a StableModels (or anything with unet, vae and
    text_encoder attributes)."""
    from ddpo_torch.models.convert import FLAX_FILES, to_flax
    from ddpo_torch.utils.tensor_files import write_msgpack

    for sub, fname in FLAX_FILES.items():
        module = getattr(models, sub)
        subdir = os.path.join(savepath, sub)
        os.makedirs(subdir, exist_ok=True)
        write_msgpack(os.path.join(subdir, fname),
                      to_flax(module.state_dict(), module, keep_bf16=True))
    return savepath


def _other_ranks_file(rel: str) -> bool:
    """A host pickle of a rank r > 0: that rank uploads its own."""
    return re.search(r"_host_p\d+\.pkl$", rel) is not None


def sync_to_bucket(localpath: str, savepath: str) -> int:
    """Synchronous artifact sync localpath -> savepath (local or gs://),
    incremental (``fs.put_dir``), without the other ranks' host pickles
    (each rank uploads its own). Reference: utils/serialization.py:374-381;
    ddpo_tpu/utils/serialization.py:225-232."""
    return fs.put_dir(localpath, savepath, exclude=_other_ranks_file)


def async_to_bucket(localpath: str, savepath: str, wait: bool = False):
    """``sync_to_bucket`` on a background thread, on rank 0 only (reference
    utils/serialization.py:383-399: an async gsutil rsync). Returns the
    thread (None on the other ranks); ``wait`` joins it."""
    if process_index() != 0:
        return None
    thread = threading.Thread(target=sync_to_bucket, args=(localpath, savepath), daemon=True)
    thread.start()
    if wait:
        thread.join()
    return thread
