"""Per-prompt reward normalization for advantage computation.

Port of ddpo_tpu/training/stat_tracking.py: numpy only, so the code is the
same.

Ring-buffer tracker with the reference's exact semantics
(ddpo/utils/stat_tracking.py:6-35): keep the most recent ``buffer_size``
rewards per prompt; once a prompt has >= ``min_count`` observations its own
mean/std normalize its advantages, otherwise fall back to the global batch
statistics. Host-side (prompts are strings); runs between the sampling and
training phases.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class PerPromptStatTracker:
    def __init__(self, buffer_size: int, min_count: int):
        self.buffer_size = buffer_size
        self.min_count = min_count
        self.stats: dict[str, deque] = {}

    def update(self, prompts: np.ndarray, rewards: np.ndarray) -> np.ndarray:
        prompts = np.asarray(prompts)
        rewards = np.asarray(rewards, dtype=np.float64)
        advantages = np.empty_like(rewards)
        for prompt in np.unique(prompts):
            prompt_rewards = rewards[prompts == prompt]
            buf = self.stats.setdefault(prompt, deque(maxlen=self.buffer_size))
            buf.extend(prompt_rewards)
            if len(buf) < self.min_count:
                mean = np.mean(rewards)
                std = np.std(rewards) + 1e-6
            else:
                mean = np.mean(buf)
                std = np.std(buf) + 1e-6
            advantages[prompts == prompt] = (prompt_rewards - mean) / std
        return advantages

    def get_stats(self):
        return {
            k: {"mean": np.mean(v), "std": np.std(v), "count": len(v)}
            for k, v in self.stats.items()
        }

    def state_dict(self) -> dict:
        """Serializable buffer contents (checkpointed for true resume)."""
        return {k: list(v) for k, v in self.stats.items()}

    def load_state_dict(self, state: dict) -> None:
        self.stats = {
            k: deque(v, maxlen=self.buffer_size) for k, v in state.items()
        }
