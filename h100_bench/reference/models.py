"""Plain PyTorch SD-1.4 stack: the UNet, the VAE and the CLIP text encoder.

A frozen copy of the architecture the port builds (ddpo_torch/models),
written with plain torch operations and nothing of the port: F.conv2d,
F.linear, a GroupNorm with fp32 statistics (var = E[x^2] - E[x]^2, the
group count clamped to gcd(C, 32) for narrow layers), exact-erf GEGLU,
quick-GELU in the text encoder, and scaled dot-product attention. The
parameter names and shapes are diffusers' torch ones, as the port's, so
``weights.fill_`` gives both sides the same tensors.

Every product (convolution, linear, attention's q, k and v) reads its
operands through ``Precision.round``: identity for the reference itself,
float8 e4m3 with a per-tensor scale for the control that stands in for a
lower-precision program (gradients pass straight through the rounding).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest float8 e4m3 value


class Precision:
    """How the operands of each product are rounded: "fp32" (not at all) or
    "fp8" (float8 e4m3, scaled per tensor so that its largest magnitude
    maps to 448)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r} is fp32 or fp8")
        self.kind = kind

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x).detach()


class Module(nn.Module):
    precision = Precision()

    def r(self, x):
        return self.precision.round(x)


def set_precision(model: nn.Module, precision: Precision) -> nn.Module:
    for m in model.modules():
        if isinstance(m, Module):
            m.precision = precision
    return model


class Conv(Module, nn.Conv2d):
    def forward(self, x):
        return F.conv2d(self.r(x), self.r(self.weight), self.bias, self.stride, self.padding)


class Lin(Module, nn.Linear):
    def forward(self, x):
        return F.linear(self.r(x), self.r(self.weight), self.bias)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, silu: bool = False, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups = groups if channels % groups == 0 else math.gcd(channels, groups)
        self.silu, self.eps = silu, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        n, c = x.shape[:2]
        xf = x.reshape(n, self.groups, -1).float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True) - mean**2
        out = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(n, c, -1)
        out = out * self.weight[None, :, None] + self.bias[None, :, None]
        out = F.silu(out) if self.silu else out
        return out.reshape(x.shape)


def sdpa(module: Module, q, k, v, heads: int, causal: bool = False):
    """(b, s, heads * d) q, k, v -> (b, sq, heads * d)."""
    b, sq, inner = q.shape
    d = inner // heads
    q, k, v = (module.r(t).reshape(b, t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    return out.transpose(1, 2).reshape(b, sq, inner)


# ----------------------------------- UNet ----------------------------------- #

class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int] = None):
        super().__init__()
        self.norm1 = GroupNorm(cin, silu=True)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.time_emb_proj = Lin(temb, cout) if temb else None
        self.norm2 = GroupNorm(cout, silu=True)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        return h + (x if self.conv_shortcut is None else self.conv_shortcut(x))


class Attention(Module):
    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.to_q = Lin(dim, dim, bias=False)
        self.to_k = Lin(context_dim or dim, dim, bias=False)
        self.to_v = Lin(context_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([Lin(dim, dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        out = sdpa(self, self.to_q(x), self.to_k(context), self.to_v(context), self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Lin(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), Lin(4 * dim, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.attn1 = Attention(dim, heads)
        self.attn2 = Attention(dim, heads, context_dim)
        self.ff = FeedForward(dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=1e-5) for _ in range(3))

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class Transformer(nn.Module):
    def __init__(self, channels: int, heads: int, context_dim: int):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.proj_in = Conv(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([Block(channels, heads, context_dim)])
        self.proj_out = Conv(channels, channels, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            y = block(y, context)
        return self.proj_out(y.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


class Sampler2D(nn.Module):
    """Downsampler (3x3 stride 2, padding 1, or the VAE's pad (0, 1) and no
    conv padding) or upsampler (nearest 2x, then a 3x3 conv)."""

    def __init__(self, channels: int, kind: str):
        super().__init__()
        self.kind = kind
        stride, pad = {"down": (2, 1), "down_asym": (2, 0), "up": (1, 1)}[kind]
        self.conv = Conv(channels, channels, 3, stride=stride, padding=pad)

    def forward(self, x):
        if self.kind == "up":
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        elif self.kind == "down_asym":
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class UNetBlock(nn.Module):
    def __init__(self, ins: List[int], cout: int, heads: int, attn: bool, sampler: str,
                 temb: int, ctx: int):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(cin, cout, temb) for cin in ins])
        self.attentions = nn.ModuleList([Transformer(cout, heads, ctx) for _ in ins]
                                        if attn else [])
        _samplers(self, cout, sampler)


def _samplers(block: nn.Module, channels: int, kind: str) -> None:
    """``upsamplers`` and ``downsamplers``, one of them holding a ``kind``
    sampler when ``kind`` is given."""
    block.upsamplers = nn.ModuleList([Sampler2D(channels, kind)] if kind == "up" else [])
    block.downsamplers = nn.ModuleList([Sampler2D(channels, kind)]
                                       if kind.startswith("down") else [])


class UNet(nn.Module):
    """SD-1.x conditional UNet from diffusers' unet/config.json keys."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch = list(cfg["block_out_channels"])
        heads, ctx, lpb = cfg["attention_head_dim"], cfg["cross_attention_dim"], cfg["layers_per_block"]
        down_attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
        up_attn = [t.startswith("CrossAttn") for t in cfg["up_block_types"]]
        temb = 4 * ch[0]
        self.ch0 = ch[0]
        self.freq_shift = cfg["freq_shift"]
        self.conv_in = Conv(cfg["in_channels"], ch[0], 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Lin(ch[0], temb)
        self.time_embedding.linear_2 = Lin(temb, temb)
        skips, cin = [ch[0]], ch[0]
        self.down_blocks = nn.ModuleList()
        for i, cout in enumerate(ch):
            down = i < len(ch) - 1
            self.down_blocks.append(UNetBlock([cin] + [cout] * (lpb - 1), cout, heads,
                                              down_attn[i], "down" if down else "", temb, ctx))
            skips += [cout] * (lpb + int(down))
            cin = cout
        self.mid_block = UNetBlock([ch[-1], ch[-1]], ch[-1], heads, False, "", temb, ctx)
        self.mid_block.attentions = nn.ModuleList([Transformer(ch[-1], heads, ctx)])
        self.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for i, cout in enumerate(reversed(ch)):
            block_skips = [skips.pop() for _ in range(lpb + 1)]
            ins = [c + s for c, s in zip([prev] + [cout] * lpb, block_skips)]
            self.up_blocks.append(UNetBlock(ins, cout, heads, up_attn[i],
                                            "up" if i < len(ch) - 1 else "", temb, ctx))
            prev = cout
        self.conv_norm_out = GroupNorm(ch[0], silu=True)
        self.conv_out = Conv(ch[0], cfg["out_channels"], 3, padding=1)

    def time_features(self, t):
        half = self.ch0 // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                              device=t.device)
                          / (half - self.freq_shift))
        args = t.float()[:, None] * freqs[None]
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)

    def forward(self, x, t, context):
        """x (B, 4, h, w), t (B,), context (B, 77, D) -> eps (B, 4, h, w)."""
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(
            self.time_features(t))))
        x = self.conv_in(x)
        residuals = [x]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(x, temb)
                if len(block.attentions):
                    x = block.attentions[j](x, context)
                residuals.append(x)
            for down in block.downsamplers:
                x = down(x)
                residuals.append(x)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, temb), context), temb)
        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, residuals.pop()], dim=1), temb)
                if len(block.attentions):
                    x = block.attentions[j](x, context)
            for up in block.upsamplers:
                x = up(x)
        return self.conv_out(self.conv_norm_out(x))


# ------------------------------------ VAE ------------------------------------ #

class VAEAttention(Module):
    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels)
        self.query, self.key, self.value, self.proj_attn = (Lin(channels, channels)
                                                            for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = self.proj_attn(sdpa(self, self.query(y), self.key(y), self.value(y), 1))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class VAEBlock(nn.Module):
    def __init__(self, ins: List[int], cout: int, sampler: str):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(cin, cout) for cin in ins])
        _samplers(self, cout, sampler)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        for s in [*self.downsamplers, *self.upsamplers]:
            x = s(x)
        return x


class VAEMid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(channels, channels) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAE(nn.Module):
    """SD's AutoencoderKL from diffusers' vae/config.json keys; the encoder
    is built for its parameter names only (the DDPO epoch decodes)."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch, lpb, lat = list(cfg["block_out_channels"]), cfg["layers_per_block"], cfg["latent_channels"]
        self.scaling_factor = cfg["scaling_factor"]
        enc = self.encoder = nn.Module()
        enc.conv_in = Conv(cfg["in_channels"], ch[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, cout in enumerate(ch):
            enc.down_blocks.append(VAEBlock([prev] + [cout] * (lpb - 1), cout,
                                            "down_asym" if i < len(ch) - 1 else ""))
            prev = cout
        enc.mid_block = VAEMid(ch[-1])
        enc.conv_norm_out = GroupNorm(ch[-1], silu=True)
        enc.conv_out = Conv(ch[-1], 2 * lat, 3, padding=1)
        dec = self.decoder = nn.Module()
        rch = list(reversed(ch))
        dec.conv_in = Conv(lat, rch[0], 3, padding=1)
        dec.mid_block = VAEMid(rch[0])
        dec.up_blocks = nn.ModuleList()
        prev = rch[0]
        for i, cout in enumerate(rch):
            dec.up_blocks.append(VAEBlock([prev] + [cout] * lpb, cout,
                                          "up" if i < len(rch) - 1 else ""))
            prev = cout
        dec.conv_norm_out = GroupNorm(rch[-1], silu=True)
        dec.conv_out = Conv(rch[-1], cfg["out_channels"], 3, padding=1)
        self.quant_conv = Conv(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv(lat, lat, 1)

    def decode_images(self, latents):
        """Scaled latents (B, 4, h, w) -> images (B, H, W, 3) in [0, 1]."""
        dec = self.decoder
        x = dec.mid_block(dec.conv_in(self.post_quant_conv(latents / self.scaling_factor)))
        for block in dec.up_blocks:
            x = block(x)
        x = dec.conv_out(dec.conv_norm_out(x))
        return torch.clamp(x / 2 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)


# -------------------------------- text encoder -------------------------------- #

class CLIPLayer(Module):
    def __init__(self, d: int, inner: int, heads: int, eps: float):
        super().__init__()
        self.heads = heads
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, Lin(d, d))
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = Lin(d, inner), Lin(inner, d)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)

    def forward(self, x):
        a = self.self_attn
        h = self.layer_norm1(x)
        x = x + a.out_proj(sdpa(self, a.q_proj(h), a.k_proj(h), a.v_proj(h), self.heads,
                                causal=True))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))


class TextEncoder(nn.Module):
    """CLIP ViT-L/14's text tower from transformers' text_encoder/config.json
    keys: ids (B, 77) -> last hidden state (B, 77, 768)."""

    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([
            CLIPLayer(d, cfg["intermediate_size"], cfg["num_attention_heads"], eps)
            for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, ids):
        tm = self.text_model
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = tm.embeddings.token_embedding(ids.long()) + tm.embeddings.position_embedding(pos)
        for layer in tm.encoder.layers:
            x = layer(x)
        return tm.final_layer_norm(x)
