"""Profiling hooks on torch.profiler: the span recorder, traces and named
step timers.

Port of ddpo_tpu/utils/profiling.py. ``span(name)`` times a region of the
host's work on ``time.perf_counter()``, the clock the benchmark ties to the
device trace (h100_bench/trace.py), and keeps it with the span it ran
inside (per thread) in a bounded store that ``spans()`` reads and
``self_seconds`` takes apart. The recorder is always on: a span costs a
few microseconds of the host, never synchronizes and touches no device.
``trace(path)`` records the host and, on a card, its kernels with
``torch.profiler`` and writes a Chrome trace (JSON) to ``path`` (no-op for
None); while it is on, each span is also a ``record_function`` range in
that trace, over the kernels it launched. ``StepTimer`` accumulates
wall-clock time per named phase, through spans. ``process_seconds`` reads
this process's age from Linux's /proc (None elsewhere), and
``launch_timeline`` puts it together with a run's start-up, work and exit:
the DDPO pipeline and sp_check print it as their last line.

The port's spans, by layer (a name's prefix): ``epoch`` (``policy_gradient.main``'s
loop); ``sampler.trajectories``, ``sampler.step`` (one
denoising step), ``sampler.decode``; ``train.inner_epoch``, ``train.apply``
(one trained timestep: ``train.forward``, then ``train.backward``),
``train.optimizer`` (the reduce, if any, and the step) with
``train.optimizer.sync`` (the clip's read-back of the norm), ``train.refresh``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

import torch

# spans kept, the oldest dropped first: an SD-1.4 DDPO epoch records about
# 120, so this holds over 100 epochs
SPAN_CAPACITY = 1 << 14

_SPANS: deque = deque(maxlen=SPAN_CAPACITY)
_IDS = itertools.count()
_TRACING = False


class _Open(threading.local):
    """Each thread's open spans, innermost last."""

    def __init__(self):
        self.stack: List["span"] = []


_OPEN = _Open()


class span:
    """A timed region of the host's work: ``with span(name):``.

    Once closed it is the record: ``name``, ``start`` and ``end`` (seconds
    on ``time.perf_counter()``), ``ident`` (unique in the process),
    ``parent`` (the ``ident`` of the span open around it on its thread,
    None at the top) and ``thread`` (``threading.get_ident()``). It is
    stored when it closes, also on an exception.
    """

    __slots__ = ("name", "ident", "parent", "thread", "start", "end", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        stack = _OPEN.stack
        self.parent = stack[-1].ident if stack else None
        self.ident = next(_IDS)
        self.thread = threading.get_ident()
        stack.append(self)
        self._range = None
        if _TRACING:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _OPEN.stack.pop()
        _SPANS.append(self)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def spans(name: Optional[str] = None, since: Optional[float] = None) -> List[span]:
    """The closed spans kept, in the order they closed: those named
    ``name``, and that started at ``since`` or later (``perf_counter``
    seconds); all by default."""
    kept = list(_SPANS)
    return [s for s in kept if (name is None or s.name == name)
            and (since is None or s.start >= since)]


def self_seconds(parent: span, recorded: List[span]) -> float:
    """``parent``'s duration less the time its children among ``recorded``
    cover (children on one thread do not overlap)."""
    return parent.seconds - sum(s.seconds for s in recorded if s.parent == parent.ident)


@contextlib.contextmanager
def trace(path: Optional[str]):
    """torch.profiler over the block, exported as a Chrome trace to
    ``path``, with each span a ``record_function`` range; no-op when path
    is None."""
    global _TRACING
    if path is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        _TRACING = True
        try:
            yield
        finally:
            _TRACING = False
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)


class StepTimer:
    """Accumulate wall-clock per named phase, each a ``span``; report means."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        timed = span(name)
        try:
            with timed:
                yield
        finally:
            self.totals[name] += timed.seconds
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
