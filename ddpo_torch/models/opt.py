"""OPT decoder: the language model of BLIP-2 opt-2.7b (the vqa reward).

Port of transformers' OPTForCausalLM as BLIP-2's greedy ``generate`` runs
it, at fp32: learned positions with OPT's offset of 2, taken by the caller
from the attention mask's cumsum (a right-padded row's tokens keep their
own positions); pre-LN blocks with biases and affine LayerNorms, a ReLU
FFN, ``final_layer_norm``, and an ``lm_head`` that is ``embed_tokens``.
That is every BLIP-2 OPT checkpoint (opt-2.7b, opt-6.7b and their coco
variants); ``OPTConfig.from_dict`` refuses by name a config.json that
asks for anything else (post-LN, a projected word embedding, an untied
head, ...). Attention is the plain fp32 product with the query scaled
before the product, as transformers' OPT does, under an additive mask
(causal and padding) that uses the dtype's lowest finite value.
``KVCache`` holds the keys and values of earlier steps for decoding.

Parameter keys are transformers' under ``language_model.``:
model.decoder.embed_tokens.weight, model.decoder.embed_positions.weight,
model.decoder.layers.<i>.self_attn.q_proj.weight, ...; lm_head.weight, where
a checkpoint holds it, is embed_tokens.weight's copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

POSITION_OFFSET = 2  # OPT's learned positions start at row 2


def require(d: dict, settings: dict, where: str) -> None:
    """Raise NotImplementedError naming each key of ``settings`` that ``d``
    sets to another value than the one the port implements."""
    for key, ported in settings.items():
        if key in d and d[key] != ported:
            raise NotImplementedError(f"{where} {key}={d[key]!r} is not ported (only {ported!r})")


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    """transformers' OPTConfig fields that the decoder reads, with its
    class defaults (a config.json leaves out what equals them)."""

    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    pad_token_id: Optional[int] = 1
    bos_token_id: Optional[int] = 2
    eos_token_id: Optional[int] = 2

    @classmethod
    def from_dict(cls, d: dict) -> "OPTConfig":
        if d.get("model_type", "opt") != "opt":
            raise NotImplementedError(
                f"BLIP-2's language model is {d.get('model_type')!r}; only OPT is ported")
        require(d, {"do_layer_norm_before": True, "_remove_final_layer_norm": False,
                    "activation_function": "relu", "enable_bias": True,
                    "layer_norm_elementwise_affine": True, "tie_word_embeddings": True,
                    "word_embed_proj_dim": d.get("hidden_size", cls.hidden_size)}, "OPT")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# blip2-opt-2.7b's language model (facebook/opt-2.7b)
OPT_2_7B = OPTConfig(hidden_size=2560, ffn_dim=10240, num_hidden_layers=32,
                     num_attention_heads=32)


class KVCache:
    """Keys and values of every layer, (layers, B, H, max_len, D), filled
    from position 0 up to ``length``."""

    def __init__(self, cfg: OPTConfig, batch: int, max_len: int, device, dtype=torch.float32):
        heads = cfg.num_attention_heads
        shape = (cfg.num_hidden_layers, batch, heads, max_len, cfg.hidden_size // heads)
        self.k = torch.empty(shape, device=device, dtype=dtype)
        self.v = torch.empty(shape, device=device, dtype=dtype)
        self.length = 0

    def update(self, layer: int, k: torch.Tensor, v: torch.Tensor):
        """Store this step's (B, H, T, D) keys and values for ``layer`` at
        ``length`` and return all keys and values so far."""
        end = self.length + k.shape[2]
        self.k[layer, :, :, self.length:end] = k
        self.v[layer, :, :, self.length:end] = v
        return self.k[layer, :, :, :end], self.v[layer, :, :, :end]


class OPTAttention(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, d, bias=True)
        self.k_proj = nn.Linear(d, d, bias=True)
        self.v_proj = nn.Linear(d, d, bias=True)
        self.out_proj = nn.Linear(d, d, bias=True)

    def forward(self, x, mask, cache: Optional[KVCache], layer: int):
        b, t, d = x.shape
        hd = d // self.num_heads

        def heads(y):
            return y.reshape(b, t, self.num_heads, hd).transpose(1, 2)

        q = heads(self.q_proj(x) * hd ** -0.5)
        k, v = heads(self.k_proj(x)), heads(self.v_proj(x))
        if cache is not None:
            k, v = cache.update(layer, k, v)
        logits = torch.matmul(q, k.transpose(-1, -2)) + mask
        weights = torch.softmax(logits, dim=-1, dtype=torch.float32).to(q.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(out)


class OPTDecoderLayer(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.self_attn = OPTAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.hidden_size)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.hidden_size)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size)

    def forward(self, x, mask, cache, layer):
        x = x + self.self_attn(self.self_attn_layer_norm(x), mask, cache, layer)
        return x + self.fc2(F.relu(self.fc1(self.final_layer_norm(x))))


class OPTDecoder(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings + POSITION_OFFSET, d)
        self.final_layer_norm = nn.LayerNorm(d)
        self.layers = nn.ModuleList([OPTDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class OPTForCausalLM(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.config = cfg
        self.model = nn.Module()
        self.model.decoder = OPTDecoder(cfg)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.model.decoder.embed_tokens(ids)

    def forward(self, inputs_embeds: torch.Tensor, attention_mask: torch.Tensor,
                position_ids: torch.Tensor, cache: Optional[KVCache] = None,
                last_only: bool = False) -> torch.Tensor:
        """Logits (B, T, V), or (B, V) of the last position with
        ``last_only``. ``attention_mask`` (B, past + T) marks the keys to
        attend to (the cache's and these T); ``position_ids`` (B, T) are
        the positions before OPT's offset."""
        dec = self.model.decoder
        b, t, _ = inputs_embeds.shape
        past = cache.length if cache is not None else 0
        total = past + t
        if attention_mask.shape != (b, total):
            raise ValueError(f"attention_mask {tuple(attention_mask.shape)} != {(b, total)}")
        device, dtype = inputs_embeds.device, inputs_embeds.dtype
        query_at = torch.arange(past, total, device=device)[:, None]
        allowed = (torch.arange(total, device=device)[None] <= query_at)[None] \
            & attention_mask.bool()[:, None, :]
        mask = torch.zeros(allowed.shape, device=device, dtype=dtype)
        mask = mask.masked_fill(~allowed, torch.finfo(dtype).min)[:, None]

        x = inputs_embeds + dec.embed_positions(position_ids + POSITION_OFFSET)
        for i, layer in enumerate(dec.layers):
            x = layer(x, mask, cache, i)
        if cache is not None:
            cache.length = total
        if last_only:
            x = x[:, -1]
        return F.linear(dec.final_layer_norm(x), dec.embed_tokens.weight)
