from ddpo_torch.utils import filesystem as fs
from ddpo_torch.utils.imagenet import imagenet_classes, imagenet_colors
from ddpo_torch.utils.loaders import load_lines, load_general_prompts
from ddpo_torch.utils.logger import init_logging
from ddpo_torch.utils.progress import Progress, Silent
from ddpo_torch.utils.timer import Timer
from ddpo_torch.utils.images import encode_png, save_image, save_images

__all__ = [
    "fs",
    "imagenet_classes",
    "imagenet_colors",
    "load_lines",
    "load_general_prompts",
    "init_logging",
    "Progress",
    "Silent",
    "Timer",
    "encode_png",
    "save_image",
    "save_images",
]
