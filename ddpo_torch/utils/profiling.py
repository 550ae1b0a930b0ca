"""Profiling hooks on torch.profiler: traces and named step timers.

Port of ddpo_tpu/utils/profiling.py. ``trace(path)`` records the host and,
on a card, its kernels with ``torch.profiler`` and writes a Chrome trace
(JSON) to ``path`` (no-op for None); ``annotate(name)`` marks a region in
the trace (``record_function``); ``StepTimer`` accumulates wall-clock time
per named phase.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(path: Optional[str]):
    """torch.profiler over the block, exported as a Chrome trace to
    ``path``; no-op when path is None."""
    if path is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Accumulate wall-clock per named phase; report means."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def means(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(1, self.counts[k]) for k in self.totals}

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.3f}s" for k, v in self.means().items())
