"""Device time from torch.profiler over the window, by kernel family, and
the idle gaps labelled with the benchmark span the host was in.

Copied from the port's chip_smoke.py ``device_breakdown``: CUDA activity
only (no host-op recording), busy time as the union of the device
intervals, idle share = 1 - busy / the host's wall time of the window. The
kernel families are data (``kernel_families.json``): a kernel belongs to the
first family one of whose words its lower-cased name holds.

The host's clock and the profiler's are tied by a marker kernel
(``torch.cuda._sleep``, named ``spin_kernel``) launched right after a
synchronize at the window's start: its device start is taken as that host
instant, which places each device gap in the host span it fell in, to
within the launch latency.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from typing import Dict, List, Optional, Tuple

FAMILIES_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernel_families.json")
MARKER = "spin_kernel"


def load_families(path: str = FAMILIES_FILE) -> List[Tuple[str, Tuple[str, ...]]]:
    with open(path) as f:
        return [(name, tuple(words)) for name, words in json.load(f)["families"]]


def family_of(kernel: str, families) -> str:
    lower = kernel.lower()
    return next((name for name, words in families if any(w in lower for w in words)), "other")


def short_name(kernel: str) -> str:
    name = kernel.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0][:80]


def busy_seconds(intervals: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy


def summarize(kernels: List[Tuple[str, float, float]], host_spans: Dict[str, list],
              host_origin: float, device_origin: float, window_s: float,
              families) -> dict:
    """``kernels``: (name, start_s, end_s) on the device clock. Returns the
    busy seconds, seconds by family, the ten costliest kernels and the idle
    seconds by host span."""
    by_family: Dict[str, float] = {}
    by_kernel: Dict[str, float] = {}
    for name, t0, t1 in kernels:
        fam = family_of(name, families)
        by_family[fam] = by_family.get(fam, 0.0) + (t1 - t0)
        key = f"{fam}: {short_name(name)}"
        by_kernel[key] = by_kernel.get(key, 0.0) + (t1 - t0)
    labelled = sorted((a - host_origin, b - host_origin, name)
                      for name, spans in host_spans.items() for a, b in spans
                      if b > host_origin)
    idle: Dict[str, float] = {}
    end = 0.0
    for _, t0, t1 in sorted(((n, a - device_origin, b - device_origin) for n, a, b in kernels),
                            key=lambda k: k[1]):
        if t0 > end:
            _label_gap(idle, labelled, end, t0)
        end = max(end, t1)
    if window_s > end:
        _label_gap(idle, labelled, end, window_s)
    busy = busy_seconds([(a, b) for _, a, b in kernels])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s, "by_family": by_family,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def _label_gap(idle: Dict[str, float], labelled, t0: float, t1: float) -> None:
    """Add the gap [t0, t1) to the spans it overlaps (``labelled``: sorted,
    one after another); what no span covers is "between spans"."""
    covered = 0.0
    i = bisect.bisect_left(labelled, (t1,)) - 1
    while i >= 0 and labelled[i][1] > t0:
        a, b, name = labelled[i]
        overlap = min(b, t1) - max(a, t0)
        if overlap > 0:
            idle[name] = idle.get(name, 0.0) + overlap
            covered += overlap
        i -= 1
    if t1 - t0 - covered > 0:
        idle["between spans"] = idle.get("between spans", 0.0) + (t1 - t0 - covered)


class Profiler:
    """torch.profiler with CUDA activity only, over the window."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None
        self.why: Optional[str] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if not self.cuda:
            self.why = "no card"
            return
        torch.cuda.synchronize()
        try:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        except RuntimeError as exc:
            self.prof, self.why = None, f"torch.profiler did not start: {exc}"
            return
        torch.cuda.synchronize()
        self.host_origin = time.perf_counter()
        torch.cuda._sleep(1000)

    def stop(self, spans, start: float, end: float) -> Optional[dict]:
        """The summary of the window [start, end] (host clock), or None."""
        from torch.autograd import DeviceType

        if self.prof is None:
            return None
        self.prof.stop()
        kernels, origin = [], None
        # the raw events: building the profiler's FunctionEvents for some
        # 10^5 kernels a window takes minutes
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name, t0 = e.name(), e.start_ns() / 1e9
            if origin is None and MARKER in name:
                origin = t0
                continue
            kernels.append((name, t0, t0 + e.duration_ns() / 1e9))
        if origin is None or not kernels:
            self.why = "the profiler saw no device time"
            return None
        summary = summarize(kernels, spans.intervals, self.host_origin, origin,
                            end - self.host_origin, load_families())
        summary["window_s"] = end - start
        return summary
