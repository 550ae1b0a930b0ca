"""Reward maskers for RWR dataset filtering + streaming average.

Port of ddpo_tpu/utils/maskers.py (numpy, unchanged semantics): percentile
(per batch), streaming percentile (over all rewards seen), and absolute
threshold; the mask keeps samples with reward >= the cutoff.
"""

from __future__ import annotations

import numpy as np


class Masker:
    p: float
    _name: str

    def __repr__(self):
        return f"[ {self._name} | {self.p} ]"

    def mask(self, xs: np.ndarray) -> np.ndarray:
        return xs >= self.p


class StreamingAverage:
    def __init__(self):
        self.n = 0
        self.avg = 0.0
        self._name = "streaming_average"

    def __call__(self, x: float) -> None:
        self.n += 1
        self.avg = self.avg * (self.n - 1) / self.n + x / self.n


class Percentile(Masker):
    """Cutoff = q-th percentile of the current batch."""

    def __init__(self, q: float = 90, maxsize: float = 5e6):
        del maxsize
        self.q = q
        self._name = f"percentile: {q}"

    def __call__(self, xs: np.ndarray) -> np.ndarray:
        if xs.ndim == 2:
            xs = xs.squeeze(axis=-1)
        self.p = np.percentile(xs, self.q)
        return self.mask(xs)


class StreamingPercentile(Masker):
    """Cutoff = q-th percentile of every reward seen so far."""

    def __init__(self, q: float = 90, maxsize: float = 5e6):
        self.q = q
        self.xs = np.zeros(int(maxsize))
        self.size = 0
        self._name = f"streaming_percentile: {q}"

    def __call__(self, xs: np.ndarray) -> np.ndarray:
        if xs.ndim == 2:
            xs = xs.squeeze(axis=-1)
        n = len(xs)
        self.xs[self.size : self.size + n] = xs[:]
        self.size += n
        self.p = np.percentile(self.xs[: self.size], self.q)
        return self.mask(xs)


class Threshold(Masker):
    def __init__(self, threshold: float = 0.95):
        self.p = threshold
        self._name = f"threshold: {threshold}"

    def __call__(self, xs: np.ndarray) -> np.ndarray:
        if xs.ndim == 2:
            xs = xs.squeeze(axis=-1)
        return self.mask(xs)


def make_masker(mode: str, param: float) -> Masker:
    return {
        "percentile": Percentile,
        "streaming_percentile": StreamingPercentile,
        "threshold": Threshold,
    }[mode](param)
