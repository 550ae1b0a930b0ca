"""Profiling hooks on torch.profiler: traces and named step timers.

Port of ddpo_tpu/utils/profiling.py. ``trace(path)`` records the host and,
on a card, its kernels with ``torch.profiler`` and writes a Chrome trace
(JSON) to ``path`` (no-op for None); ``annotate(name)`` marks a region in
the trace (``record_function``); ``StepTimer`` accumulates wall-clock time
per named phase. ``process_seconds`` reads this process's age from
Linux's /proc (None elsewhere), and ``launch_timeline`` puts it together
with a run's start-up, work and exit: the DDPO driver and sp_check print
it as their last line.
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


def process_seconds() -> Optional[float]:
    """Seconds since this process started: the system's uptime less the
    process's start time (/proc, clock ticks), so 0.01 s steps; None where
    /proc has neither."""
    try:
        with open("/proc/self/stat") as f:
            # the fields after the command's closing parenthesis start at
            # field 3; field 22 is the start time
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def launch_timeline(entered: float, before_main: Optional[float], boot: StepTimer,
                    work_start: float, work_end: float,
                    leave: Optional[StepTimer] = None) -> dict:
    """One run's seconds, from ``time.perf_counter()`` stamps:
    ``before_main``, the process's age when the run's ``main`` was entered
    at ``entered`` (the interpreter and the imports); ``main_to_work``, from
    there to ``work_start``, and ``startup``, its parts (``boot``) and their
    rest; ``work``, to ``work_end``; ``exit``, the parts after that
    (``leave``) and their rest to now, ``exit_to_return`` in all; and
    ``returned_at``, the wall clock now (a launcher's exit time less it is
    the process's teardown)."""
    now = time.perf_counter()
    startup = {k: round(v, 4) for k, v in boot.totals.items()}
    startup["rest"] = round(work_start - entered - sum(boot.totals.values()), 4)
    leaving = {k: round(v, 4) for k, v in (leave.totals if leave else {}).items()}
    leaving["rest"] = round(now - work_end - sum(leaving.values()), 4)
    return {"before_main": before_main, "main_to_work": round(work_start - entered, 4),
            "startup": startup, "work": round(work_end - work_start, 4), "exit": leaving,
            "exit_to_return": round(now - work_end, 4), "returned_at": time.time()}
