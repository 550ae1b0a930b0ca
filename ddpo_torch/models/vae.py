"""SD-1.4 VAE (AutoencoderKL): pixels <-> latents.

Port of ddpo_tpu/models/vae.py. Architecture (SD-1.4 VAE config):
block_out_channels (128, 256, 512, 512), 2 resnets per encoder block and 3
per decoder block, single-head spatial attention in both mid blocks,
latent_channels 4 (8 moments), scaling factor 0.18215 applied by callers.
NCHW throughout; every GroupNorm runs the statistics kernel on a CUDA
device, while the mid-block attentions (D = 512) take the plain path, as in
JAX. The encoder's and decoder's conv_in and conv_out are plain
``nn.Conv2d``, as JAX's are plain ``nn.Conv``: with the conv switch on
(ops/conv.py) only the ResnetBlock and upsampler 3x3 convs take the kernel.

``encode`` gives the posterior moments the RWR collection stores (the
``vae`` reward, training/callbacks.py); ``DiagonalGaussian`` samples them in
the finetune step (training/diffusion.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ddpo_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    VAESelfAttention,
)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    scaling_factor: float = 0.18215


SD14_VAE = VAEConfig()


class DiagonalGaussian:
    """Posterior q(z|x) from concatenated (mean, logvar) moments along
    ``dim``; logvar clipped to [-30, 20], as diffusers' distribution.

    ``sample`` draws its noise from an explicit ``torch.Generator``, or
    takes it injected (``noise``, the mean's shape), never from a global
    seed.
    """

    def __init__(self, moments: torch.Tensor, dim: int = -1):
        self.mean, logvar = moments.chunk(2, dim=dim)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean


class MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels) for _ in range(2)])
        self.attentions = nn.ModuleList([VAESelfAttention(channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels)
             for j in range(num_layers)]
        )
        self.downsamplers = nn.ModuleList(
            [Downsample2D(out_channels, asymmetric_pad=True)] if downsample else []
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for down in self.downsamplers:
            x = down(x)
        return x


class Encoder(nn.Module):
    """Image in [-1, 1] -> 2 * latent_channels moment channels, at 1/8 the
    resolution (SD-1.4)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        channels = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, channels[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = channels[0]
        for i, cout in enumerate(channels):
            self.down_blocks.append(DownEncoderBlock2D(
                prev, cout, cfg.layers_per_block, i < len(channels) - 1
            ))
            prev = cout
        self.mid_block = MidBlock(channels[-1])
        self.conv_norm_out = GroupNorm(channels[-1], silu=True)
        self.conv_out = nn.Conv2d(channels[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


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
    """encode: image NCHW -> moments NCHW (8 channels); decode: latent NCHW
    -> image NCHW in [-1, 1]; both return fp32 and compute in the
    parameters' dtype."""

    def __init__(self, config: VAEConfig = SD14_VAE):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def encode(self, sample: torch.Tensor) -> torch.Tensor:
        """NCHW image in [-1, 1] -> NCHW moments (2 * latent_channels)."""
        x = sample.to(self.quant_conv.weight.dtype)
        return self.quant_conv(self.encoder(x)).float()

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """NCHW latents (unscaled) -> NCHW image in [-1, 1]."""
        z = latents.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z)).float()

    def forward(self, sample: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode, sample the posterior (``noise`` injected or drawn from
        ``generator``), decode."""
        z = DiagonalGaussian(self.encode(sample), dim=1).sample(generator, noise)
        return self.decode(z)
