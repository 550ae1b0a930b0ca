from ddpo_torch.training import prompts
from ddpo_torch.training.prompts import make_prompts

__all__ = ["prompts", "make_prompts"]
