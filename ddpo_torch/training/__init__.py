from ddpo_torch.training import callbacks, diffusion, policy_gradient, prompts
from ddpo_torch.training.callbacks import callback_fns, evaluate_callbacks
from ddpo_torch.training.policy_gradient import AccumulatingTrainState
from ddpo_torch.training.prompts import make_prompts
from ddpo_torch.training.stat_tracking import PerPromptStatTracker

__all__ = [
    "diffusion",
    "policy_gradient",
    "prompts",
    "callbacks",
    "AccumulatingTrainState",
    "make_prompts",
    "callback_fns",
    "evaluate_callbacks",
    "PerPromptStatTracker",
]
