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
(query/key/value/proj_attn), so no alias is needed here; ddpo_tpu's
``_alias_vae_attention`` maps newer torch checkpoints (to_q/to_k/to_v/
to_out.0) onto those names when loading them into JAX.

Every model of the stack converts whole, the VAE's encoder and quant_conv
included, so the export of a VAE round-trips too.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

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
    """One model's nested Flax tree -> its torch state_dict (fp32 CPU tensors)."""
    state = {}
    for path, x in iter_flax_leaves(tree):
        arr = convert_flax_tensor(path, np.asarray(x, dtype=np.float32))
        state[flax_path_to_torch_key(path)] = torch.tensor(arr)  # a copy: jax's arrays are read-only
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
        if part.isdigit() and path:
            path[-1] = f"{path[-1]}_{part}"
        else:
            path.append(part)
    leaf = parts[-1]
    if leaf == "weight":
        leaf = next((name for types, name in _FLAX_WEIGHT_NAMES if isinstance(module, types)),
                    leaf)
    return tuple(path) + (leaf,)


def to_flax(state: Mapping[str, torch.Tensor], model: nn.Module) -> dict:
    """The UNet's (or the VAE's) torch state_dict -> its nested Flax tree of
    numpy arrays.

    ``model`` is the module the state belongs to (its module types name the
    leaves). The CLIP text tree nests its layers under digit keys of their
    own ("layers" / "0"), which this does not rebuild. Conv weights go OIHW -> HWIO and Dense weights are transposed.
    bf16 tensors are written as float32, which holds them exactly (numpy
    has no bfloat16); other dtypes keep theirs.
    """
    owners = dict(model.named_modules())
    tree: dict = {}
    for key, value in state.items():
        module = owners[key.rpartition(".")[0]]
        path = torch_key_to_flax_path(key, module)
        x = value.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.cpu().numpy()
        if path[-1] == "kernel":
            x = np.transpose(x, (2, 3, 1, 0)) if x.ndim == 4 else x.T
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(x)
    return tree
