"""CLIP text encoder (prompt conditioning) and vision tower (the CLIP rewards).

Port of ddpo_tpu/models/clip.py. SD-1.4's text encoder is the CLIP
ViT-L/14 text tower: vocab 49408, hidden 768, 12 layers, 12 heads, 77
positions, quick_gelu, causal attention. The vision tower
(``CLIPImageEncoder``, CLIPModel.get_image_features) is ViT-L/14 for the
aesthetic, rotational and thumbnail rewards (24 layers, hidden 1024, 16
heads, 257 tokens, about 304M parameters) and ViT-B/32 with the B/32 text
tower for the consistency reward. Parameter keys are transformers' torch
keys (text_model.encoder.layers.<i>.self_attn.q_proj.weight,
vision_model.embeddings.patch_embedding.weight, visual_projection.weight).

Both attentions are the plain fp32-softmax product, as in JAX: the text
tower's causal one, and the vision tower's ``attention_reference`` (JAX's
``xla_attention``), which the tower calls directly, since ViT-L/14's
S = 257 would meet the flash kernel's gate and JAX does not take it there.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ddpo_torch.ops.attention import attention_reference


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


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5


VIT_L_14 = CLIPVisionConfig()

# openai/clip-vit-base-patch32, the consistency reward's CLIP
VIT_B_32 = CLIPVisionConfig(
    image_size=224, patch_size=32, hidden_size=768, intermediate_size=3072,
    num_layers=12, num_heads=12, projection_dim=512,
)
B32_TEXT = CLIPTextConfig(hidden_size=512, intermediate_size=2048, num_layers=12, num_heads=8)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """Multi-head self-attention with an fp32 softmax, causal (the text
    tower) or not (the vision tower)."""

    def __init__(self, hidden: int, num_heads: int, causal: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
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
        if not self.causal:
            return self.out_proj(attention_reference(q, k, v).reshape(b, s, d))
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
    def __init__(self, cfg, causal: bool = True):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads, causal)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg, causal: bool = True):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg, causal) for _ in range(cfg.num_layers)])

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


class CLIPVisionEmbeddings(nn.Module):
    """Patch conv (no bias), then the class token, then learned positions."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, cfg.hidden_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixels.to(self.patch_embedding.weight.dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, patches, hidden), row-major patches
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight


class CLIPVisionTransformer(nn.Module):
    """pixel_values (B, 3, S, S) -> the pooled CLS embedding (B, hidden):
    pre_layrnorm (sic), the non-causal encoder, post_layernorm on token 0."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg, causal=False)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixels)))
        return self.post_layernorm(x[:, 0])


class CLIPImageEncoder(nn.Module):
    """The vision tower and its projection: CLIPModel.get_image_features,
    (B, 3, S, S) -> (B, projection_dim)."""

    def __init__(self, config: CLIPVisionConfig = VIT_L_14):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixel_values))
