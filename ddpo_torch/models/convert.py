"""The weight bridge between the JAX package's Flax parameter trees and the
port's torch state_dicts, in both directions.

The port's modules use diffusers' (and transformers') torch key layout.
``from_flax`` is the inverse of ddpo_tpu/models/convert.py's
``torch_key_to_flax_path`` and ``convert_torch_tensor``: "_<digit>" path
segments split back into ".<digit>" (down_blocks_0 -> down_blocks.0,
to_out_0 -> to_out.0), Flax leaf names become "weight" (kernel, scale,
embedding), conv kernels go from HWIO to OIHW and Dense kernels are
transposed. ``to_flax`` undoes it: ".<digit>" joins its stem again, each
"weight" takes back its Flax name from its module's type (kernel for
Linear and Conv2d, scale for the norms, embedding for nn.Embedding), conv
weights go from OIHW to HWIO and Dense weights are transposed, so
``to_flax(from_flax(tree))`` is the tree, bit for bit. ``lora_from_flax``
flattens JAX's LoRA tree into the port's adapter dict (models/lora.py); A
and B keep their orientation in both packages.

VAE attention: the JAX tree and the port both use diffusers' older names
(query/key/value/proj_attn); ``_alias_vae_attention`` maps a newer torch
checkpoint's (to_q/to_k/to_v/to_out.0) onto them, as ddpo_tpu's does.

Every model of the stack converts whole, the VAE's encoder and quant_conv
included, so the export of a VAE round-trips too. CLIP trees keep their
encoder layers under a digit key of their own ("layers" / "0"), as JAX's
text and vision encoders do, in both directions.

``load_sd_checkpoint`` and ``load_clip_checkpoint`` read a local diffusers
(or transformers) checkpoint directory, in the diffusers-Flax msgpack
layout or the torch-safetensors one, through the port's own readers
(utils/tensor_files.py), into the port's state_dicts.

``load_blip2`` reads a transformers BLIP-2 (OPT) directory, or a Hub name
found in the Hub cache (``resolve_pretrained``), onto the port's
models/blip2.py: safetensors (one file or shards) or pytorch_model*.bin.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ddpo_torch.models.layers import GroupNorm

# flax names ending in _<digit> that are literal module names in torch
_LITERAL_UNDERSCORE_STEMS = ("linear",)  # time_embedding.linear_1/linear_2


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """('down_blocks_0', 'resnets_1', 'conv1', 'kernel') -> 'down_blocks.0.resnets.1.conv1.weight'."""
    out = []
    for part in path[:-1]:
        stem, _, idx = part.rpartition("_")
        if stem and idx.isdigit() and stem not in _LITERAL_UNDERSCORE_STEMS:
            out.extend([stem, idx])
        else:
            out.append(part)
    leaf = path[-1]
    if leaf in ("scale", "embedding", "kernel"):
        leaf = "weight"
    return ".".join(out + [leaf])


def convert_flax_tensor(path: Tuple[str, ...], x: np.ndarray) -> np.ndarray:
    """Flax layout -> torch layout (conv HWIO -> OIHW, Dense (in, out) -> (out, in))."""
    x = np.asarray(x)
    if path[-1] == "kernel":
        if x.ndim == 4:
            return np.ascontiguousarray(np.transpose(x, (3, 2, 0, 1)))
        if x.ndim == 2:
            return np.ascontiguousarray(x.T)
    return x


def iter_flax_leaves(tree: dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict) or hasattr(node, "items"):
            yield from iter_flax_leaves(dict(node), prefix + (str(key),))
        else:
            yield prefix + (str(key),), node


def flax_tree_to_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    """One model's nested Flax tree -> its torch state_dict of CPU tensors:
    numpy leaves (of any float type) become fp32, torch leaves (the file
    readers') keep their dtype."""
    state = {}
    for path, x in iter_flax_leaves(tree):
        if isinstance(x, torch.Tensor):
            if path[-1] == "kernel" and x.ndim in (2, 4):
                x = (x.permute(3, 2, 0, 1) if x.ndim == 4 else x.t()).contiguous()
        else:
            arr = convert_flax_tensor(path, np.asarray(x, dtype=np.float32))
            x = torch.tensor(arr)  # a copy: jax's arrays are read-only
        state[flax_path_to_torch_key(path)] = x
    return state


def from_flax(params: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"unet", "vae", "text_encoder"} Flax trees -> the port's state_dicts."""
    return {name: flax_tree_to_state_dict(tree) for name, tree in params.items()}


def lora_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX's LoRA tree ({..., "to_q": {"a", "b"}}) -> the port's adapters
    ("<module path>.a" / ".b", fp32 CPU tensors, A (in, r) and B (r, out))."""
    return {flax_path_to_torch_key(path): torch.tensor(np.asarray(x, dtype=np.float32))
            for path, x in iter_flax_leaves(tree)}


# Flax's name for a module's "weight", by the module's type
_FLAX_WEIGHT_NAMES = (
    ((nn.Linear, nn.Conv2d), "kernel"),
    ((nn.LayerNorm, nn.GroupNorm, GroupNorm), "scale"),
    ((nn.Embedding,), "embedding"),
)


def torch_key_to_flax_path(key: str, module: nn.Module) -> Tuple[str, ...]:
    """'down_blocks.0.resnets.1.conv1.weight' -> ('down_blocks_0', 'resnets_1',
    'conv1', 'kernel'); ``module`` is the one that owns the parameter."""
    parts = key.split(".")
    path = []
    for part in parts[:-1]:
        if part.isdigit() and path and path[-1] != "layers":  # CLIP: layers / 0
            path[-1] = f"{path[-1]}_{part}"
        else:
            path.append(part)
    leaf = parts[-1]
    if leaf == "weight":
        leaf = next((name for types, name in _FLAX_WEIGHT_NAMES if isinstance(module, types)),
                    leaf)
    return tuple(path) + (leaf,)


def to_flax(state: Mapping[str, torch.Tensor], model: nn.Module, keep_bf16: bool = False) -> dict:
    """A model's torch state_dict (the UNet's, the VAE's or a CLIP tower's)
    -> its nested Flax tree of numpy arrays.

    ``model`` is the module the state belongs to (its module types name the
    leaves). Conv weights go OIHW -> HWIO and Dense weights are transposed.
    bf16 tensors become float32, which holds them exactly (numpy has no
    bfloat16), unless ``keep_bf16``: then they stay bf16 CPU tensors, which
    ``utils.tensor_files.write_msgpack`` writes under the name "bfloat16".
    Other dtypes keep theirs.
    """
    owners = dict(model.named_modules())
    tree: dict = {}
    for key, value in state.items():
        module = owners[key.rpartition(".")[0]]
        path = torch_key_to_flax_path(key, module)
        x = value.detach().cpu()
        if path[-1] == "kernel":
            x = x.permute(2, 3, 1, 0) if x.ndim == 4 else x.t()
        if x.dtype == torch.bfloat16 and not keep_bf16:
            x = x.float()
        x = x.contiguous()
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = x if x.dtype == torch.bfloat16 else x.numpy()
    return tree


# ------------------------ local checkpoint directories ------------------------ #

# the diffusers-Flax pipeline layout's file per submodule
FLAX_FILES = {
    "unet": "diffusion_flax_model.msgpack",
    "vae": "diffusion_flax_model.msgpack",
    "text_encoder": "flax_model.msgpack",
}

_VAE_ATTN_ALIASES = {"to_q": "query", "to_k": "key", "to_v": "value"}


def _alias_vae_attention(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Newer diffusers torch VAEs name the mid-block attention to_q/to_k/
    to_v/to_out.0; the port's VAESelfAttention (and older checkpoints) use
    query/key/value/proj_attn. Renamed where present."""
    out = {}
    for key, value in state.items():
        parts = key.replace(".to_out.0.", ".proj_attn.").split(".")
        out[".".join(_VAE_ATTN_ALIASES.get(p, p) for p in parts)] = value
    return out


def _drop_position_ids(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """transformers checkpoints may carry the CLIP embeddings' position_ids
    buffer; the port's modules have none (JAX leaves it unused)."""
    return {k: v for k, v in state.items() if not k.endswith("embeddings.position_ids")}


def _cast(state: Dict[str, torch.Tensor], dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    if dtype is None:
        return state
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}


def load_sd_checkpoint(path: str, dtype: Optional[torch.dtype] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """A local SD-1.4 checkpoint directory -> {unet, vae, text_encoder}
    state_dicts of CPU tensors (the file's dtype, or ``dtype``).

    Per submodule, the diffusers-Flax msgpack file if there is one, else the
    torch safetensors one; the file names and the FileNotFoundError are
    ddpo_tpu's (models/convert.py ``load_sd_checkpoint``).
    """
    from ddpo_torch.utils.tensor_files import read_msgpack, read_safetensors

    out = {}
    for sub, fname in FLAX_FILES.items():
        subdir = os.path.join(path, sub)
        flax_path = os.path.join(subdir, fname)
        st_candidates = [
            os.path.join(subdir, "diffusion_pytorch_model.safetensors"),
            os.path.join(subdir, "model.safetensors"),
        ]
        if os.path.exists(flax_path):
            state = flax_tree_to_state_dict(read_msgpack(flax_path))
        else:
            st_path = next((p for p in st_candidates if os.path.exists(p)), None)
            if st_path is None:
                raise FileNotFoundError(f"no flax/safetensors weights under {subdir}")
            state = read_safetensors(st_path)
            if sub == "vae":
                state = _alias_vae_attention(state)
        out[sub] = _cast(_drop_position_ids(state), dtype)
    return out


def load_clip_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A local CLIP checkpoint directory (openai/clip-vit-large-patch14
    layout) -> one state_dict under transformers' torch keys: text_model.*,
    vision_model.*, visual_projection.weight, text_projection.weight and
    the bare logit_scale, as the CLIP rewards take it.

    transformers' Flax msgpack (flax_model.msgpack) if there is one, else
    torch safetensors (model.safetensors); local files only.
    """
    from ddpo_torch.utils.tensor_files import read_msgpack, read_safetensors

    flax_path = os.path.join(path, "flax_model.msgpack")
    if os.path.exists(flax_path):
        state = flax_tree_to_state_dict(read_msgpack(flax_path))
    else:
        st_path = os.path.join(path, "model.safetensors")
        if not os.path.exists(st_path):
            raise FileNotFoundError(f"no flax/safetensors CLIP weights under {path}")
        state = read_safetensors(st_path)
    return _drop_position_ids(state)


# ----------------------------------- BLIP-2 ---------------------------------- #

# keys of a BLIP-2 checkpoint that generation never reads: the Q-Former's
# text FFN and text embeddings, and position_ids buffers
_BLIP2_UNUSED = re.compile(
    r"^qformer\.(encoder\.layer\.\d+\.(intermediate|output)\.|embeddings\.)|position_ids$")
_QKV_BIAS = re.compile(r"^(vision_model\.encoder\.layers\.\d+\.self_attn\.)(q_bias|v_bias)$")


def hub_cache_dir() -> str:
    """The Hub cache transformers reads offline: HF_HUB_CACHE (or the older
    HUGGINGFACE_HUB_CACHE), else HF_HOME/hub, where HF_HOME defaults to
    $XDG_CACHE_HOME/huggingface, then ~/.cache/huggingface."""
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or "~/.cache", "huggingface")
    cache = (os.environ.get("HF_HUB_CACHE") or os.environ.get("HUGGINGFACE_HUB_CACHE")
             or os.path.join(home, "hub"))
    return os.path.expanduser(cache)


def resolve_pretrained(name: str) -> str:
    """A model name as transformers resolves it offline: a local
    directory, else the Hub cache's snapshot of ``refs/main``
    (``<cache>/models--{org}--{name}/snapshots/<commit>``); otherwise
    FileNotFoundError naming every path tried. Nothing is downloaded."""
    if os.path.isdir(name):
        return name
    repo = os.path.join(hub_cache_dir(), "models--" + name.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    tried = [os.path.abspath(name), ref]
    if os.path.isfile(ref):
        with open(ref) as f:
            snapshot = os.path.join(repo, "snapshots", f.read().strip())
        if os.path.isdir(snapshot):
            return snapshot
        tried.append(snapshot)
    raise FileNotFoundError(
        f"{name!r} is neither a local directory nor in the Hub cache; tried "
        + ", ".join(tried) + " (the port downloads nothing: put the model's files in one "
        "of these places, or set HF_HOME or HF_HUB_CACHE)")


def read_pretrained_weights(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict a transformers directory holds: model.safetensors,
    pytorch_model.bin (read with ``weights_only``), or the shards that
    either's ``.index.json`` names, as CPU tensors."""
    from ddpo_torch.utils.tensor_files import read_safetensors

    def read_bin(fname):
        return torch.load(fname, map_location="cpu", weights_only=True, mmap=True)

    for fname, read in (("model.safetensors", read_safetensors), ("pytorch_model.bin", read_bin)):
        full = os.path.join(path, fname)
        if os.path.exists(full):
            return dict(read(full))
        if os.path.exists(full + ".index.json"):
            with open(full + ".index.json") as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            state = {}
            for shard in shards:
                state.update(read(os.path.join(path, shard)))
            return state
    raise FileNotFoundError(f"no weights under {path}: looked for model.safetensors, "
                            "pytorch_model.bin and their .index.json")


def blip2_state_dict(state: Mapping[str, torch.Tensor], model: nn.Module) -> Dict[str, torch.Tensor]:
    """transformers' Blip2ForConditionalGeneration keys -> ``model``'s
    (models/blip2.py): the same names, but the tower's separate q_bias and
    v_bias become qkv.bias (k's part zero), lm_head.weight is left to
    embed_tokens (the head is tied), and the keys generation never reads are dropped.
    Unknown or missing keys raise, naming them."""
    out, split = {}, {}
    for key, value in state.items():
        match = _QKV_BIAS.match(key)
        if match:
            split.setdefault(match.group(1), {})[match.group(2)] = value
        elif not _BLIP2_UNUSED.search(key) and key != "language_model.lm_head.weight":
            out[key] = value
    for prefix, parts in split.items():
        if set(parts) != {"q_bias", "v_bias"}:
            raise KeyError(f"{prefix}: q_bias and v_bias come in pairs, found {sorted(parts)}")
        out[prefix + "qkv.bias"] = torch.cat(
            [parts["q_bias"], torch.zeros_like(parts["q_bias"]), parts["v_bias"]])
    want = set(model.state_dict())
    unknown, missing = sorted(set(out) - want), sorted(want - set(out))
    if unknown or missing:
        raise KeyError(f"BLIP-2 checkpoint keys: unknown {unknown[:8]}, missing {missing[:8]}")
    return out


def load_blip2(name: str, device):
    """A BLIP-2 (OPT) directory or Hub name -> (model on ``device`` at fp32,
    Blip2Processor, greedy settings of generation_config.json). The model
    is built on the meta device and its storage made on ``device``, then
    filled from the checkpoint."""
    from ddpo_torch.models.blip2 import Blip2Config, Blip2Processor, build_blip2, greedy_settings

    path = resolve_pretrained(name)
    with open(os.path.join(path, "config.json")) as f:
        cfg = Blip2Config.from_dict(json.load(f))
    generation = {"bos_token_id": cfg.text.bos_token_id, "eos_token_id": cfg.text.eos_token_id,
                  "pad_token_id": cfg.text.pad_token_id}
    gen_path = os.path.join(path, "generation_config.json")
    if os.path.exists(gen_path):
        with open(gen_path) as f:
            generation = json.load(f)
    processor = Blip2Processor.from_dir(path)
    model = build_blip2(cfg, device)
    model.load_state_dict(blip2_state_dict(read_pretrained_weights(path), model))
    return model, processor, greedy_settings(generation)
