"""ImageNet-1k class names + color words (data asset, assets/imagenet.json).

Consumed by the prompt functions (imagenet_animals samples classes 0-397,
imagenet_dogs 151-268; reference: ddpo/training/prompts.py:125-149 over
ddpo/utils/imagenet.py).
"""

import functools
import json
import os

_ASSET = os.path.join(
    os.path.dirname(__file__), "..", "..", "assets", "imagenet.json"
)


@functools.cache
def _load():
    with open(os.path.abspath(_ASSET)) as f:
        return json.load(f)


def imagenet_classes():
    return _load()["classes"]


def imagenet_colors():
    return _load()["colors"]
