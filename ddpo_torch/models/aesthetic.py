"""LAION aesthetic predictor: a 5-layer MLP over CLIP ViT-L/14 features.

Port of ddpo_tpu/models/aesthetic.py. The torch checkpoint
``sac+logos+ava1-l14-linearMSE.pth`` is the state of an nn.Sequential
whose Linear layers sit at 0, 2, 4, 6 and 7 (dropout between them, never
active in the reference). This module keeps those positions, with
identities in place of the dropouts, so the checkpoint loads as it is:
768 -> 1024 -> 128 -> 64 -> 16 -> 1.

The port has no downloader: a missing file raises ddpo_tpu's
``allow_download=False`` FileNotFoundError.
"""

from __future__ import annotations

import os
from typing import Mapping

import torch
import torch.nn as nn

WEIGHTS_FNAME = "sac+logos+ava1-l14-linearMSE.pth"
WIDTHS = (768, 1024, 128, 64, 16, 1)


class AestheticClassifier(nn.Module):
    def __init__(self):
        super().__init__()
        linears = [nn.Linear(i, o) for i, o in zip(WIDTHS[:-1], WIDTHS[1:])]
        self.layers = nn.Sequential(linears[0], nn.Identity(), linears[1], nn.Identity(),
                                    linears[2], nn.Identity(), linears[3], linears[4])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


def set_weights(state: Mapping[str, torch.Tensor]) -> AestheticClassifier:
    """The ``layers.{0,2,4,6,7}`` state dict -> the classifier on the CPU in
    fp32 (strict: a missing or unexpected key raises)."""
    model = AestheticClassifier()
    model.load_state_dict({k: torch.as_tensor(v).float() for k, v in state.items()}, strict=True)
    return model.eval().requires_grad_(False)


def load_weights(cache: str = "cache") -> AestheticClassifier:
    """The classifier from ``<cache>/sac+logos+ava1-l14-linearMSE.pth``."""
    loadpath = os.path.join(cache, WEIGHTS_FNAME)
    if not os.path.exists(loadpath):
        raise FileNotFoundError(
            f"aesthetic weights not found at {loadpath}; place "
            f"{WEIGHTS_FNAME} there (no network in this environment)"
        )
    return set_weights(torch.load(loadpath, map_location="cpu", weights_only=True))
