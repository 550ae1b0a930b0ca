from ddpo_torch.models.unet import UNet2DCondition, UNetConfig, SD14_UNET
from ddpo_torch.models.vae import AutoencoderKL, VAEConfig, SD14_VAE
from ddpo_torch.models.clip import CLIPTextModel, CLIPTextConfig, SD14_TEXT

__all__ = [
    "UNet2DCondition",
    "UNetConfig",
    "SD14_UNET",
    "AutoencoderKL",
    "VAEConfig",
    "SD14_VAE",
    "CLIPTextModel",
    "CLIPTextConfig",
    "SD14_TEXT",
]
