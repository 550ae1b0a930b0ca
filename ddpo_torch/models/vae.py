"""SD-1.4 VAE (AutoencoderKL), decoder path: latents -> pixels.

Port of the decode half of ddpo_tpu/models/vae.py (the encoder and
quant_conv are not ported yet). Architecture (SD-1.4 VAE config):
block_out_channels (128, 256, 512, 512), 3 resnets per decoder block,
single-head spatial attention in the mid block, latent_channels 4, scaling
factor 0.18215 applied by callers. NCHW throughout; every GroupNorm runs
the statistics kernel on a CUDA device, while the mid-block attention
(D = 512) takes the plain path, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from ddpo_torch.models.layers import GroupNorm, ResnetBlock2D, Upsample2D, VAESelfAttention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    scaling_factor: float = 0.18215


SD14_VAE = VAEConfig()


class MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels) for _ in range(2)])
        self.attentions = nn.ModuleList([VAESelfAttention(channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels)
             for j in range(num_layers)]
        )
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)] if upsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for up in self.upsamplers:
            x = up(x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        channels = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, channels[0], 3, padding=1)
        self.mid_block = MidBlock(channels[0])
        self.up_blocks = nn.ModuleList()
        prev = channels[0]
        for i, cout in enumerate(channels):
            self.up_blocks.append(UpDecoderBlock2D(
                prev, cout, cfg.layers_per_block + 1, i < len(channels) - 1
            ))
            prev = cout
        self.conv_norm_out = GroupNorm(channels[-1], silu=True)
        self.conv_out = nn.Conv2d(channels[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """decode: latent NCHW -> image NCHW in [-1, 1] (fp32)."""

    def __init__(self, config: VAEConfig = SD14_VAE):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """NCHW latents (unscaled) -> NCHW image in [-1, 1]."""
        z = latents.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z)).float()
