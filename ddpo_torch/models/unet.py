"""SD-1.4 conditional UNet (the DDPO policy network, ~860M params).

Port of ddpo_tpu/models/unet.py. I/O stays NCHW as in the JAX package
(latents are (B, 4, H/8, W/8)), and the module computes in its parameters'
dtype (bf16 on the card) and returns eps in fp32. Self-attention at
S >= 256 runs the flash kernel and every GroupNorm the statistics kernel
when the module lives on a CUDA device.

Architecture (SD-1.4 / v1.5 UNet config): block_out_channels (320, 640,
1280, 1280), layers_per_block 2, 8 attention heads at every resolution,
cross_attention_dim 768, down: CrossAttn x3 + plain, mid: CrossAttn,
up: plain + CrossAttn x3. Parameter keys are diffusers' torch keys.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn as nn

from ddpo_torch.models.layers import (
    Conv3x3,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_heads: int = 8
    cross_attention_dim: int = 768
    # which down blocks carry cross-attention transformers (True) vs plain
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    freq_shift: float = 0.0


SD14_UNET = UNetConfig()


class DownBlock2D(nn.Module):
    """num_layers resnets (+ transformers) and a downsampler; returns the
    output plus every intermediate residual for the skip connections."""

    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 heads: int, has_attn: bool, add_downsample: bool,
                 temb_channels: int, context_dim: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels,
                           temb_channels) for j in range(num_layers)]
        )
        self.attentions = nn.ModuleList(
            [Transformer2D(out_channels, heads, out_channels // heads, context_dim)
             for _ in range(num_layers)] if has_attn else []
        )
        self.downsamplers = nn.ModuleList(
            [Downsample2D(out_channels)] if add_downsample else []
        )

    def forward(self, x, temb, context):
        residuals = []
        for j, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if len(self.attentions):
                x = self.attentions[j](x, context)
            residuals.append(x)
        for down in self.downsamplers:
            x = down(x)
            residuals.append(x)
        return x, residuals


class UpBlock2D(nn.Module):
    """num_layers resnets over concat(x, skip) (+ transformers, + upsample)."""

    def __init__(self, prev_channels: int, skip_channels: List[int],
                 out_channels: int, heads: int, has_attn: bool, add_upsample: bool,
                 temb_channels: int, context_dim: int):
        super().__init__()
        ins = [prev_channels] + [out_channels] * (len(skip_channels) - 1)
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin + skip, out_channels, temb_channels)
             for cin, skip in zip(ins, skip_channels)]
        )
        self.attentions = nn.ModuleList(
            [Transformer2D(out_channels, heads, out_channels // heads, context_dim)
             for _ in skip_channels] if has_attn else []
        )
        self.upsamplers = nn.ModuleList(
            [Upsample2D(out_channels)] if add_upsample else []
        )

    def forward(self, x, residuals, temb, context):
        for j, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, residuals.pop()], dim=1), temb)
            if len(self.attentions):
                x = self.attentions[j](x, context)
        for up in self.upsamplers:
            x = up(x)
        return x


class MidBlock2D(nn.Module):
    def __init__(self, channels: int, heads: int, temb_channels: int, context_dim: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(channels, channels, temb_channels) for _ in range(2)]
        )
        self.attentions = nn.ModuleList(
            [Transformer2D(channels, heads, channels // heads, context_dim)]
        )

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig = SD14_UNET):
        super().__init__()
        self.config = cfg = config
        channels = cfg.block_out_channels
        temb = channels[0] * 4
        heads = cfg.attention_heads
        ctx = cfg.cross_attention_dim
        n_blocks = len(channels)

        self.conv_in = Conv3x3(cfg.in_channels, channels[0])
        self.time_embedding = TimestepEmbedding(channels[0], temb)

        # skip channels, in push order: conv_in, each resnet, each downsampler
        skips = [channels[0]]
        self.down_blocks = nn.ModuleList()
        cin = channels[0]
        for i, cout in enumerate(channels):
            add_down = i < n_blocks - 1
            self.down_blocks.append(DownBlock2D(
                cin, cout, cfg.layers_per_block, heads, cfg.down_block_has_attn[i],
                add_down, temb, ctx,
            ))
            skips += [cout] * (cfg.layers_per_block + int(add_down))
            cin = cout

        self.mid_block = MidBlock2D(channels[-1], heads, temb, ctx)

        self.up_blocks = nn.ModuleList()
        prev = channels[-1]
        for i, cout in enumerate(reversed(channels)):
            block_skips = [skips.pop() for _ in range(cfg.layers_per_block + 1)]
            self.up_blocks.append(UpBlock2D(
                prev, block_skips, cout, heads,
                list(reversed(cfg.down_block_has_attn))[i], i < n_blocks - 1,
                temb, ctx,
            ))
            prev = cout
        assert not skips

        self.conv_norm_out = GroupNorm(channels[0], silu=True)
        self.conv_out = Conv3x3(channels[0], cfg.out_channels)

    def set_quant(self, quant: bool) -> "UNet2DCondition":
        """JAX's ``unet.clone(quant=...)`` on the built module: the W8A8 int8
        conv (ops/quant.py) in each resnet's conv1 and conv2 and each
        upsampler's conv, 47 convs at SD-1.4, for inference sampling.
        conv_in, conv_out, the stride-2 downsamplers and the 1x1 shortcuts
        stay float. The parameters do not change. Returns the module."""
        for block in [*self.down_blocks, self.mid_block, *self.up_blocks]:
            for resnet in block.resnets:
                resnet.conv1.quant = resnet.conv2.quant = quant
            for up in getattr(block, "upsamplers", ()):
                up.conv.quant = quant
        return self

    def set_spatial(self, axis) -> "UNet2DCondition":
        """JAX's ``unet.clone(spatial_axis=axis)`` on the built module: every
        conv, GroupNorm, self-attention and stride-2 conv runs on this
        rank's rows of an H sharded over ``axis`` (an ops.spatial.Axis;
        None undoes it). The parameters do not change. Returns the module."""
        for m in self.modules():
            if hasattr(m, "spatial"):
                m.spatial = axis
        return self

    def forward(
        self,
        sample: torch.Tensor,  # (B, C, H, W)
        timesteps: torch.Tensor,  # (B,) or scalar
        encoder_hidden_states: torch.Tensor,  # (B, 77, D)
    ) -> torch.Tensor:
        dtype = self.conv_in.weight.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])

        x = sample.to(dtype)
        context = encoder_hidden_states.to(dtype)
        t_emb = timestep_embedding(
            timesteps, self.config.block_out_channels[0],
            freq_shift=self.config.freq_shift,
        )
        temb = self.time_embedding(t_emb.to(dtype))

        x = self.conv_in(x)
        residuals = [x]
        for block in self.down_blocks:
            x, res = block(x, temb, context)
            residuals.extend(res)
        x = self.mid_block(x, temb, context)
        for block in self.up_blocks:
            x = block(x, residuals, temb, context)
        assert not residuals

        x = self.conv_out(self.conv_norm_out(x))
        return x.float()
