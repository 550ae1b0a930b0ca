"""The reductions the RWR drivers take from ddpo_tpu/parallel/collectives.py,
for one process.

The port runs one process on one device (more is not ported yet), so the
process is rank 0 of 1: ``worker_sum`` is the value itself and
``sharded_softmax`` the softmax of the one local vector.
"""

from __future__ import annotations

import numpy as np
import torch


def process_index() -> int:
    return 0


def process_count() -> int:
    return 1


def worker_sum(value: float) -> float:
    """The sum of one scalar over the processes: this process's value."""
    return float(value)


def softmax_ref(x: np.ndarray, temperature: float = 1.0) -> np.ndarray:
    """Sequential oracle (reference: utils/array.py:32-41). The logits are
    multiplied by ``temperature``."""
    assert x.ndim == 1
    x = x * temperature
    z = x - x.max()
    numer = np.exp(z)
    return numer / numer.sum()


def sharded_softmax(x: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """softmax(x * temperature) over the whole (here: local) batch vector."""
    z = x * temperature
    numer = torch.exp(z - z.max())
    return numer / numer.sum()
