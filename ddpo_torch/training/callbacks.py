"""Reward callbacks: name-addressed factories returning score functions.

Port of ddpo_tpu/training/callbacks.py, the dependency-free rewards and the
registry. Each factory returns fn(images, prompts, metadata) -> (scores,
info), where images are (N, H, W, 3) float in [0, 1]. ``evaluate_callbacks``
runs every registered fn, choosing a random training prompt per sample when
prompts are lists.

Ported: jpeg, neg_jpeg, arange, mirror, mirror_corr, rotational_corr. The
model-based and server-based rewards (vae, aesthetic, consistency,
rotational, thumbnail, vqa, llava_vqa, llava_bertscore) are in the registry
and raise "not ported yet" when built.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Tuple

import numpy as np

RewardFn = Callable[[np.ndarray, list, list], Tuple[np.ndarray, dict]]


def jpeg_fn(**kwargs) -> RewardFn:
    """Negative JPEG size in KB: reward for compressible images.

    Encodes the whole batch through the native multithreaded libjpeg path
    (ddpo_torch/native), which raises if the library cannot be built.
    """
    from ddpo_torch.native import jpeg_sizes

    def _fn(images, prompts, metadata):
        del prompts, metadata
        sizes_kb = jpeg_sizes(images, quality=95) / 1000.0
        return -np.asarray(sizes_kb, dtype=np.float64)[:, None], {}

    return _fn


def neg_jpeg_fn(*args, **kwargs) -> RewardFn:
    _jpeg = jpeg_fn(*args, **kwargs)

    def _fn(*a, **kw):
        scores, infos = _jpeg(*a, **kw)
        return -scores, infos

    return _fn


def arange_fn(**kwargs) -> RewardFn:
    """Debug reward: the sample index (a plumbing test)."""

    def _fn(images, prompts, metadata):
        del prompts, metadata
        return np.arange(len(images))[:, None], {}

    return _fn


def mirror_symmetry_fn(**kwargs) -> RewardFn:
    """Negative MSE between the image and its horizontal mirror."""

    def _fn(images, prompts, metadata):
        del prompts, metadata
        imgs = (np.clip(images, 0, 1) * 255).astype(np.uint8).astype(np.int64)
        mirrored = imgs[:, :, ::-1]
        scores = ((imgs - mirrored) ** 2).mean(axis=(1, 2, 3)).astype(np.float64)
        return -scores, {}

    return _fn


def _cov(X, Y):
    assert X.ndim == Y.ndim == 2
    return ((X - X.mean(-1, keepdims=True)) * (Y - Y.mean(-1, keepdims=True))).sum(-1)


def mirror_correlation_fn(**kwargs) -> RewardFn:
    """Negative Pearson correlation between image and its mirror."""

    def _fn(images, prompts, metadata):
        del prompts, metadata
        imgs = np.clip(images, 0, 1).astype(np.float32)
        mirrored = imgs[:, :, ::-1]
        flat = imgs.reshape(len(images), -1)
        mflat = mirrored.reshape(len(images), -1)
        scores = _cov(flat, mflat) / np.sqrt(_cov(flat, flat) * _cov(mflat, mflat))
        return -scores, {}

    return _fn


def rotational_correlation_fn(**kwargs) -> RewardFn:
    """Negative MSE between the image and its 180-degree rotation."""

    def _fn(images, prompts, metadata):
        del prompts, metadata
        imgs = (np.clip(images, 0, 1) * 255).astype(np.uint8).astype(np.int64)
        rotated = imgs[:, ::-1, ::-1]
        scores = ((imgs - rotated) ** 2).mean(axis=(1, 2, 3)).astype(np.float64)
        return -scores, {}

    return _fn


def _not_ported(name: str) -> Callable[..., RewardFn]:
    def factory(*args, **kwargs) -> RewardFn:
        raise NotImplementedError(f"the {name!r} reward is not ported yet")

    return factory


def evaluate_callbacks(fns: Dict[str, RewardFn], images, prompts, metadata):
    """Run every registered reward fn."""
    if len(prompts) and isinstance(prompts[0], (list, tuple)):
        prompts = [random.choice(p) for p in prompts]
    images = np.asarray(images, dtype=np.float32)
    return {key: fn(images, prompts, metadata) for key, fn in fns.items()}


callback_fns: Dict[str, Callable[..., RewardFn]] = {
    "vae": _not_ported("vae"),
    "aesthetic": _not_ported("aesthetic"),
    "consistency": _not_ported("consistency"),
    "jpeg": jpeg_fn,
    "neg_jpeg": neg_jpeg_fn,
    "rotational": _not_ported("rotational"),
    "rotational_corr": rotational_correlation_fn,
    "mirror": mirror_symmetry_fn,
    "mirror_corr": mirror_correlation_fn,
    "thumbnail": _not_ported("thumbnail"),
    "arange": arange_fn,
    "vqa": _not_ported("vqa"),
    "llava_vqa": _not_ported("llava_vqa"),
    "llava_bertscore": _not_ported("llava_bertscore"),
}
