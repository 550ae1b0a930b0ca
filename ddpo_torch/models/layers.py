"""Shared building blocks of the SD-1.4 model stack.

Port of ddpo_tpu/models/layers.py. The modules run NCHW (PyTorch's conv
layout) and compute in the dtype of their parameters (bf16 on the card,
fp32 in the CPU parity tests). GroupNorm statistics and the attention
softmax are fp32 (ddpo_torch/ops).

Module and parameter names follow diffusers' torch layout (to_q, to_out.0,
ff.net.0.proj, norm1.weight, ...), so models/convert.py maps the JAX
package's Flax trees, and diffusers checkpoints, onto them by name.

``spatial`` (JAX's ``spatial_axis`` field; None, or an ops.spatial.Axis set
on the built modules by ``UNet2DCondition.set_spatial``): the module runs
on this rank's rows of a map whose H is sharded over the axis
(parallel/spatial.py). Conv3x3 exchanges halo rows, GroupNorm all-reduces
its moments, CrossAttention gathers K/V for self-attention only, and the
stride-2 conv of Downsample2D takes the top halo row and pads (0, 1), and
the transformer blocks' Linears run batch-invariantly at the sharded
shapes (ops/invariance.py ``linear``); the blocks built from them
(ResnetBlock2D, Transformer2D, Upsample2D, whose nearest 2x upsample is
shard-local) follow. The parameters do not change.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ddpo_torch.ops import invariance
from ddpo_torch.ops.attention import attention
from ddpo_torch.ops.conv import conv3x3, library_conv
from ddpo_torch.ops.groupnorm import group_norm
from ddpo_torch.ops.spatial import halo_top_row


class Linear(nn.Linear):
    """nn.Linear of the transformer blocks; under ``spatial`` it goes
    through ops/invariance.py ``linear``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.spatial = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return invariance.linear(x, self.weight, self.bias, self.spatial is not None)


class Conv3x3(nn.Conv2d):
    """3x3 stride-1 SAME conv dispatching through ops/conv.py.

    ``quant`` (JAX's field of the same name, set on the built module by
    ``UNet2DCondition.set_quant``): the W8A8 int8 inference conv of
    ops/quant.py. The parameters are the same either way.
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self.quant = False
        self.spatial = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3(x, self.weight, self.bias, quant=self.quant, spatial=self.spatial)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    max_period: float = 10000.0,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
) -> torch.Tensor:
    """Sinusoidal timestep features, SD convention (cos first).

    timesteps: (B,) int/float -> (B, dim) float32.
    """
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / (half - freq_shift)
    )
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer MLP over sinusoidal features (diffusers: time_embedding)."""

    def __init__(self, in_features: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_features, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class GroupNorm(nn.Module):
    """GroupNorm with fp32 stats (ops/groupnorm.py), optionally with SiLU.

    Unlike torch.nn.GroupNorm it clamps the group count to gcd(C, 32) for
    narrow layers, as the JAX package does.
    """

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.silu = silu
        self.spatial = None
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, self.silu,
                          spatial=self.spatial)


class ResnetBlock2D(nn.Module):
    """GN+SiLU -> conv -> +time -> GN+SiLU -> conv, with a 1x1 skip conv
    when the channel count changes (output_scale_factor 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, silu=True)
        self.conv1 = Conv3x3(in_channels, out_channels)
        self.time_emb_proj = (
            nn.Linear(temb_channels, out_channels) if temb_channels else None
        )
        self.norm2 = GroupNorm(out_channels, silu=True)
        self.conv2 = Conv3x3(out_channels, out_channels)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + residual


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None.

    Long self-attention dispatches to the flash kernel (ops/attention.py);
    the 77-token cross-attention takes the plain path.
    """

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads = heads
        self.dim_head = dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, inner)])
        self.spatial = None

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        # under spatial sharding self-attention gathers K/V; the text
        # context of cross-attention is whole on every rank
        spatial = self.spatial if context is None else None
        context = x if context is None else context
        b, sq, _ = x.shape
        sk = context.shape[1]
        q = self.to_q(x).reshape(b, sq, self.heads, self.dim_head)
        k = self.to_k(context).reshape(b, sk, self.heads, self.dim_head)
        v = self.to_v(context).reshape(b, sk, self.heads, self.dim_head)
        out = attention(q, k, v, spatial=spatial).reshape(b, sq, self.heads * self.dim_head)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) GELU, as flax approximate=False


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP: project to 2*4*dim, gate with GELU, project back.

    net.1 is diffusers' dropout slot (identity at inference)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """LN->self-attn, LN->cross-attn, LN->GEGLU FF, each with residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.ff = GEGLUFeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> 1x1 conv in -> blocks -> 1x1 conv out (+res)."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 depth: int = 1):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, dim_head, context_dim)
             for _ in range(depth)]
        )
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        x = self.proj_in(self.norm(x))
        # H-major token order, as the JAX package's NHWC reshape
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, context)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()
        return self.proj_out(x) + residual


class StridedConv3x3(nn.Conv2d):
    """3x3 stride-2 conv (padding 1 or 0) through ops/conv.py's library_conv.

    Under ``spatial`` the shard takes only the previous shard's last row and
    pads (0, 1): with even local H every stride-2 window that starts in a
    shard ends in it, and global SAME padding at even H never reads the
    bottom pad row."""

    def __init__(self, channels: int, padding: int = 1):
        super().__init__(channels, channels, 3, stride=2, padding=padding)
        self.spatial = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spatial is not None:
            return library_conv(halo_top_row(x, self.spatial), self.weight, self.bias,
                                stride=2, padding=(0, 1))
        return library_conv(x, self.weight, self.bias, stride=2, padding=self.padding[0])


class Downsample2D(nn.Module):
    """3x3 stride-2 conv: symmetric padding 1 (the UNet variant), or with
    ``asymmetric_pad`` one zero row and column on the bottom and right and
    no conv padding (the VAE encoder's, diffusers' pad (0, 1))."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = StridedConv3x3(channels, padding=0 if asymmetric_pad else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VAESelfAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid blocks.

    Names follow diffusers' older VAE layout (group_norm/query/key/value/
    proj_attn), the names of the JAX package's Flax tree.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        x = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.query(x), self.key(x), self.value(x)
        out = attention(q[:, :, None, :], k[:, :, None, :], v[:, :, None, :])[:, :, 0, :]
        out = self.proj_attn(out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous() + residual
