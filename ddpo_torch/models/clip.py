"""CLIP text encoder (prompt conditioning).

Port of the text tower of ddpo_tpu/models/clip.py (the vision towers are
not ported yet). SD-1.4's text encoder is the CLIP ViT-L/14 text tower:
vocab 49408, hidden 768, 12 layers, 12 heads, 77 positions, quick_gelu,
causal attention. Parameter keys are transformers' torch keys
(text_model.encoder.layers.<i>.self_attn.q_proj.weight, ...).

The causal attention is the plain fp32-softmax product, as in JAX: at 77
tokens it never meets the flash kernel's gate.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


SD14_TEXT = CLIPTextConfig()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """Causal multi-head self-attention with an fp32 softmax."""

    def __init__(self, hidden: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.num_heads
        q = self.q_proj(x).reshape(b, s, self.num_heads, hd)
        k = self.k_proj(x).reshape(b, s, self.num_heads, hd)
        v = self.v_proj(x).reshape(b, s, self.num_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd**-0.5
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, -1e10))
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        return self.token_embedding(ids) + self.position_embedding(pos)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.final_layer_norm(self.encoder(self.embeddings(ids)))


class CLIPTextModel(nn.Module):
    """input_ids (B, 77) -> last_hidden_state (B, 77, hidden)."""

    def __init__(self, config: CLIPTextConfig = SD14_TEXT):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_model(input_ids.long())
