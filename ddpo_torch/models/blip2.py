"""BLIP-2 (ViT-g tower, Q-Former, OPT decoder): the vqa reward's model.

Port of transformers' Blip2ForConditionalGeneration with an OPT language
model, its greedy ``generate``, its processor (the slow
BlipImageProcessor and the GPT-2 byte-level BPE, models/gpt2_bpe.py) and
its config.json, at fp32. blip2-opt-2.7b (``BLIP2_OPT_2_7B``):

- vision: ViT-g/14, 39 pre-LN layers of width 1408, 16 heads, MLP 6144
  with exact GELU, 224 px in 14 px patches (256 + a class token), one
  fused qkv Linear whose bias is q's, zeros and v's, LayerNorm eps 1e-6,
  ``post_layernorm``;
- Q-Former: 32 learned query tokens (LayerNorm first), 12 BERT-style
  post-LN layers of width 768, 12 heads, cross-attention to the vision
  output in every 2nd layer, the query FFN (3072), then
  ``language_projection`` 768 -> 2560;
- language model: OPT-2.7b (models/opt.py), 32 layers, width 2560, vocab
  50272, 2048 positions.

Attention in the tower and the Q-Former is ``ops.attention``'s plain fp32
product (``attention_reference``), as models/clip.py's ViT-L/14 runs it:
the JAX package runs transformers on the host here, no Pallas kernel.

``generate`` lays the prompt out in one of two ways. When the processor
config holds ``num_query_tokens``, the prompt starts with that many
``<image>`` ids and the projected query outputs take their places
(``image_token_index``), as transformers does. Without it, the legacy
layout puts the projected query outputs before the text embeddings, with
a mask of ones; transformers 4.57 no longer runs that layout, and on the
same weights it gives the ``<image>`` layout's new ids (the embeddings,
mask and positions are the same). Either way the returned ids are the
prompt's followed by the new ones, and a finished row is padded with the
pad id, as greedy search does.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ddpo_torch.models.gpt2_bpe import GPT2BPETokenizer
from ddpo_torch.models.opt import OPT_2_7B, KVCache, OPTConfig, OPTForCausalLM, require
from ddpo_torch.ops.attention import attention_reference


def _known(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclasses.dataclass(frozen=True)
class Blip2VisionConfig:
    """transformers' Blip2VisionConfig defaults: ViT-g/14."""

    hidden_size: int = 1408
    intermediate_size: int = 6144
    num_hidden_layers: int = 39
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class Blip2QFormerConfig:
    """transformers' Blip2QFormerConfig defaults."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    cross_attention_frequency: int = 2
    encoder_hidden_size: int = 1408
    layer_norm_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class Blip2Config:
    vision: Blip2VisionConfig = Blip2VisionConfig()
    qformer: Blip2QFormerConfig = Blip2QFormerConfig()
    text: OPTConfig = OPTConfig()
    num_query_tokens: int = 32
    image_token_index: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict) -> "Blip2Config":
        """A BLIP-2 config.json (a sub-config leaves out its defaults).
        What no BLIP-2 OPT checkpoint sets is refused by name: a T5
        language model, another activation, a tower without qkv biases,
        relative positions in the Q-Former."""
        if not d.get("use_decoder_only_language_model", True):
            raise NotImplementedError("BLIP-2 with an encoder-decoder language model (T5) "
                                      "is not ported")
        require(d.get("vision_config", {}), {"hidden_act": "gelu", "qkv_bias": True}, "vision")
        require(d.get("qformer_config", {}),
                {"hidden_act": "gelu", "position_embedding_type": "absolute"}, "Q-Former")
        vision = Blip2VisionConfig(**_known(Blip2VisionConfig, d.get("vision_config", {})))
        qformer = dict(d.get("qformer_config", {}), encoder_hidden_size=vision.hidden_size)
        qformer = Blip2QFormerConfig(**_known(Blip2QFormerConfig, qformer))
        return cls(vision, qformer, OPTConfig.from_dict(d.get("text_config", {})),
                   d.get("num_query_tokens", 32), d.get("image_token_index"))

    def with_layers(self, vision: int, qformer: int, text: int) -> "Blip2Config":
        """The same widths at other depths."""
        return dataclasses.replace(
            self, vision=dataclasses.replace(self.vision, num_hidden_layers=vision),
            qformer=dataclasses.replace(self.qformer, num_hidden_layers=qformer),
            text=dataclasses.replace(self.text, num_hidden_layers=text))


# Salesforce/blip2-opt-2.7b; <image> is the id after OPT's 50265 tokens
BLIP2_OPT_2_7B = Blip2Config(Blip2VisionConfig(), Blip2QFormerConfig(), OPT_2_7B, 32, 50265)


# ------------------------------- vision tower -------------------------------- #


class Blip2VisionEmbeddings(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        d = cfg.hidden_size
        positions = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.empty(1, 1, d))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size)
        self.position_embedding = nn.Parameter(torch.empty(1, positions, d))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(len(pixels), 1, -1), patches], dim=1)
        if x.shape[1] != self.position_embedding.shape[1]:
            raise ValueError(f"{x.shape[1]} tokens for {self.position_embedding.shape[1]} "
                             "positions: the image is not the config's image_size")
        return x + self.position_embedding


class Blip2Attention(nn.Module):
    """The tower's attention: one qkv Linear (its bias holds q's, k's and
    v's; the checkpoints' separate q_bias and v_bias load into it with k's
    zero) and ``projection``."""

    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.qkv = nn.Linear(d, 3 * d)
        self.projection = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        q, k, v = self.qkv(x).reshape(b, s, 3, self.num_heads, d // self.num_heads).unbind(2)
        return self.projection(attention_reference(q, k, v).reshape(b, s, d))


class Blip2MLP(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Blip2EncoderLayer(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        self.self_attn = Blip2Attention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = Blip2MLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class Blip2VisionModel(nn.Module):
    def __init__(self, cfg: Blip2VisionConfig):
        super().__init__()
        self.embeddings = Blip2VisionEmbeddings(cfg)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [Blip2EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> the last hidden state after post_layernorm."""
        x = self.embeddings(pixels)
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x)


# --------------------------------- Q-Former ---------------------------------- #


class Blip2QFormerMultiHeadAttention(nn.Module):
    def __init__(self, cfg: Blip2QFormerConfig, cross: bool):
        super().__init__()
        d = cfg.hidden_size
        kv_in = cfg.encoder_hidden_size if cross else d
        self.num_heads = cfg.num_attention_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(kv_in, d)
        self.value = nn.Linear(kv_in, d)

    def forward(self, x, context):
        b, s, d = x.shape
        hd = d // self.num_heads
        q = self.query(x).reshape(b, s, self.num_heads, hd)
        k = self.key(context).reshape(b, context.shape[1], self.num_heads, hd)
        v = self.value(context).reshape(b, context.shape[1], self.num_heads, hd)
        return attention_reference(q, k, v).reshape(b, s, d)


class Blip2QFormerOutput(nn.Module):
    """dense, then LayerNorm of the sum with the block's input (BERT's
    SelfOutput and Output)."""

    def __init__(self, cfg: Blip2QFormerConfig, width: int):
        super().__init__()
        self.dense = nn.Linear(width, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class Blip2QFormerAttention(nn.Module):
    def __init__(self, cfg: Blip2QFormerConfig, cross: bool = False):
        super().__init__()
        self.attention = Blip2QFormerMultiHeadAttention(cfg, cross)
        self.output = Blip2QFormerOutput(cfg, cfg.hidden_size)

    def forward(self, x, context=None):
        return self.output(self.attention(x, x if context is None else context), x)


class Blip2QFormerIntermediate(nn.Module):
    def __init__(self, cfg: Blip2QFormerConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))


class Blip2QFormerLayer(nn.Module):
    """The query path of a Q-Former layer: self-attention, cross-attention
    to the image in every ``cross_attention_frequency``-th layer, the query
    FFN. (The text FFN, ``intermediate``/``output``, serves text inputs,
    which generation never gives the Q-Former.)"""

    def __init__(self, cfg: Blip2QFormerConfig, index: int):
        super().__init__()
        self.attention = Blip2QFormerAttention(cfg)
        self.crossattention = (Blip2QFormerAttention(cfg, cross=True)
                               if index % cfg.cross_attention_frequency == 0 else None)
        self.intermediate_query = Blip2QFormerIntermediate(cfg)
        self.output_query = Blip2QFormerOutput(cfg, cfg.intermediate_size)

    def forward(self, x, image):
        x = self.attention(x)
        if self.crossattention is not None:
            x = self.crossattention(x, image)
        return self.output_query(self.intermediate_query(x), x)


class Blip2QFormerModel(nn.Module):
    def __init__(self, cfg: Blip2QFormerConfig):
        super().__init__()
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            [Blip2QFormerLayer(cfg, i) for i in range(cfg.num_hidden_layers)])

    def forward(self, queries: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        x = self.layernorm(queries)
        for layer in self.encoder.layer:
            x = layer(x, image)
        return x


# ------------------------------- the whole model ------------------------------ #

# generation_config.json settings that change what greedy search emits,
# with the values at which they do nothing; any other value is refused
_GREEDY_NEUTRAL = {
    "do_sample": False, "num_beams": 1, "num_beam_groups": 1, "penalty_alpha": None,
    "repetition_penalty": 1.0, "no_repeat_ngram_size": 0, "min_length": 0,
    "min_new_tokens": None, "bad_words_ids": None, "suppress_tokens": None,
    "begin_suppress_tokens": None, "forced_bos_token_id": None, "forced_eos_token_id": None,
    "sequence_bias": None, "exponential_decay_length_penalty": None, "guidance_scale": None,
    "num_return_sequences": 1, "stop_strings": None, "max_time": None,
    "assistant_model": None, "watermarking_config": None,
}


def greedy_settings(generation: dict) -> dict:
    """eos ids and pad id of a generation_config.json for greedy search;
    a setting that greedy search would honour and this port does not
    raises, naming it."""
    for key, neutral in _GREEDY_NEUTRAL.items():
        if generation.get(key, neutral) != neutral:
            raise NotImplementedError(
                f"generation_config {key}={generation[key]!r} is not ported: the port "
                "decodes greedily with no logits processor")
    eos = generation.get("eos_token_id")
    eos = [] if eos is None else list(eos) if isinstance(eos, (list, tuple)) else [eos]
    pad = generation.get("pad_token_id")
    if pad is None and eos:
        pad = eos[0]  # transformers pads with the first eos id then
    return {"eos_token_ids": eos, "pad_token_id": pad}


class Blip2ForConditionalGeneration(nn.Module):
    def __init__(self, cfg: Blip2Config):
        super().__init__()
        self.config = cfg
        self.vision_model = Blip2VisionModel(cfg.vision)
        self.query_tokens = nn.Parameter(torch.empty(1, cfg.num_query_tokens,
                                                     cfg.qformer.hidden_size))
        self.qformer = Blip2QFormerModel(cfg.qformer)
        self.language_projection = nn.Linear(cfg.qformer.hidden_size, cfg.text.hidden_size)
        self.language_model = OPTForCausalLM(cfg.text)

    def image_features(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> the projected query outputs (B, Q, D of the LM)."""
        image = self.vision_model(pixels)
        queries = self.qformer(self.query_tokens.expand(len(pixels), -1, -1), image)
        return self.language_projection(queries)

    def prompt_embeds(self, features: torch.Tensor, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor, image_tokens: bool):
        """The LM's (inputs_embeds, attention_mask) for the prompt: the
        query outputs in place of the ``<image>`` ids, or before the text."""
        embeds = self.language_model.embed(input_ids)
        if image_tokens:
            if self.config.image_token_index is None:
                raise ValueError("the prompt has <image> ids, but config.json has no "
                                 "image_token_index")
            where = (input_ids == self.config.image_token_index)[..., None].expand_as(embeds)
            return embeds.masked_scatter(where, features.to(embeds.dtype)), attention_mask
        ones = torch.ones(features.shape[:2], dtype=attention_mask.dtype,
                          device=attention_mask.device)
        return torch.cat([features, embeds], dim=1), torch.cat([ones, attention_mask], dim=1)

    @torch.no_grad()
    def generate(self, pixel_values: torch.Tensor, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor, max_new_tokens: int,
                 eos_token_ids: Sequence[int] = (), pad_token_id: Optional[int] = None,
                 image_tokens: bool = True) -> torch.Tensor:
        """Greedy decoding: (B, prompt + up to ``max_new_tokens``) ids."""
        lm = self.language_model
        features = self.image_features(pixel_values)
        embeds, mask = self.prompt_embeds(features, input_ids, attention_mask, image_tokens)
        b, t = mask.shape
        cache = KVCache(lm.config, b, t + max_new_tokens, embeds.device, embeds.dtype)
        positions = (mask.cumsum(-1) - 1).masked_fill(mask == 0, 1)
        logits = lm(embeds, mask, positions, cache, last_only=True)
        ids = input_ids
        eos = torch.as_tensor(list(eos_token_ids), device=ids.device, dtype=ids.dtype)
        unfinished = torch.ones(b, dtype=torch.bool, device=ids.device)
        for step in range(max_new_tokens):
            next_ids = logits.argmax(-1)
            if len(eos):
                if pad_token_id is None:
                    raise ValueError("eos ids without a pad id")
                next_ids = torch.where(unfinished, next_ids, pad_token_id)
            ids = torch.cat([ids, next_ids[:, None]], dim=1)
            mask = torch.cat([mask, mask.new_ones(b, 1)], dim=1)
            if len(eos):
                unfinished &= ~torch.isin(next_ids, eos)
            if step + 1 == max_new_tokens or not bool(unfinished.any()):
                break
            position = mask.sum(-1, keepdim=True) - 1
            logits = lm(lm.embed(next_ids[:, None]), mask, position, cache, last_only=True)
        return ids


def init_random_(model: nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """Random weights in place: N(0, std) for every matrix, embedding,
    position table and the query tokens; LayerNorms 1 and 0; biases 0."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, std, generator=generator)
            elif "norm" in name.lower() and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()


def build_blip2(cfg: Blip2Config, device) -> Blip2ForConditionalGeneration:
    """The model with uninitialised fp32 storage on ``device`` (built on
    the meta device, so nothing is allocated on the CPU first)."""
    with torch.device("meta"):
        model = Blip2ForConditionalGeneration(cfg)
    return model.to_empty(device=device).eval().requires_grad_(False)


# ------------------------------ the processor -------------------------------- #


@dataclasses.dataclass(frozen=True)
class BlipImageProcessor:
    """transformers' slow BlipImageProcessor on (H, W, 3) uint8 images:
    PIL resize to ``size`` with ``resample``, ``rescale_factor`` in
    float64 then float32, normalize in float32, channels first. Every
    BLIP-2 checkpoint resizes, rescales and normalizes; a config that
    turns one of them off is refused by name."""

    height: int = 384
    width: int = 384
    resample: int = 3
    rescale_factor: float = 1 / 255
    image_mean: Sequence[float] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Sequence[float] = (0.26862954, 0.26130258, 0.27577711)

    @classmethod
    def from_dict(cls, d: dict) -> "BlipImageProcessor":
        kind = d.get("image_processor_type", "BlipImageProcessor")
        if kind != "BlipImageProcessor":
            raise NotImplementedError(f"image processor {kind!r} is not ported")
        require(d, {"do_resize": True, "do_rescale": True, "do_normalize": True}, kind)
        size = d.get("size", {"height": 384, "width": 384})
        if isinstance(size, int):
            size = {"height": size, "width": size}
        if set(size) != {"height", "width"}:
            raise ValueError(f"size {size}: BlipImageProcessor needs height and width")
        fields = _known(cls, d)
        return cls(**dict(fields, height=size["height"], width=size["width"]))

    def __call__(self, images: Sequence[np.ndarray]) -> np.ndarray:
        from PIL import Image

        out = []
        for image in images:
            image = np.asarray(image)
            if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] != 3:
                raise ValueError("images must be (H, W, 3) uint8")
            image = np.array(Image.fromarray(image).resize(
                (self.width, self.height), resample=self.resample))
            image = (image.astype(np.float64) * self.rescale_factor).astype(np.float32)
            mean = np.array(self.image_mean, dtype=np.float32)
            std = np.array(self.image_std, dtype=np.float32)
            out.append(((image - mean) / std).transpose(2, 0, 1))
        return np.stack(out)


class Blip2Processor:
    """Images and prompts -> (pixel_values, input_ids, attention_mask), as
    transformers' Blip2Processor makes them; ``batch_decode``."""

    def __init__(self, image_processor: BlipImageProcessor, tokenizer: GPT2BPETokenizer,
                 num_query_tokens: Optional[int] = None):
        self.image_processor = image_processor
        self.tokenizer = tokenizer
        self.num_query_tokens = num_query_tokens
        self.image_token_id = tokenizer.encoder.get("<image>")

    @classmethod
    def from_dir(cls, path: str) -> "Blip2Processor":
        def read(name, required):
            full = os.path.join(path, name)
            if not os.path.exists(full):
                if required:
                    raise FileNotFoundError(f"no {name} under {path}")
                return {}
            with open(full, encoding="utf-8") as f:
                return json.load(f)

        processor = read("processor_config.json", False)
        return cls(BlipImageProcessor.from_dict(read("preprocessor_config.json", True)),
                   GPT2BPETokenizer.from_dir(path), processor.get("num_query_tokens"))

    @property
    def image_tokens(self) -> bool:
        """Whether prompts start with ``num_query_tokens`` <image> ids."""
        return self.num_query_tokens is not None

    def __call__(self, images: Sequence[np.ndarray], texts: Sequence[str]) -> Dict[str, np.ndarray]:
        ids, mask = self.tokenizer.encode(texts)
        if self.image_tokens:
            if self.image_token_id is None:
                raise ValueError("processor_config.json sets num_query_tokens, but the "
                                 "tokenizer has no <image> token")
            n = self.num_query_tokens
            ids = np.concatenate([np.full((len(ids), n), self.image_token_id, np.int64), ids], 1)
            mask = np.concatenate([np.ones((len(mask), n), np.int64), mask], 1)
        return {"pixel_values": self.image_processor(images), "input_ids": ids,
                "attention_mask": mask}

    def batch_decode(self, rows, skip_special_tokens: bool = False) -> List[str]:
        return self.tokenizer.batch_decode(rows, skip_special_tokens)


def flops_per_image(cfg: Blip2Config) -> float:
    """Multiply-adds x 2 of the vision tower and the Q-Former for one image."""
    v, q = cfg.vision, cfg.qformer
    s = (v.image_size // v.patch_size) ** 2 + 1
    d = v.hidden_size
    vision = v.num_hidden_layers * (2 * s * (4 * d * d + 2 * d * v.intermediate_size)
                                    + 4 * s * s * d) + 2 * (s - 1) * 3 * v.patch_size ** 2 * d
    n, e = cfg.num_query_tokens, q.hidden_size
    cross = math.ceil(q.num_hidden_layers / q.cross_attention_frequency)
    qformer = (q.num_hidden_layers * (2 * n * (4 * e * e + 2 * e * q.intermediate_size)
                                      + 4 * n * n * e)
               + cross * (2 * n * 2 * e * e + 2 * s * 2 * q.encoder_hidden_size * e
                          + 4 * n * s * e)
               + 2 * n * e * cfg.text.hidden_size)
    return float(vision + qformer)
