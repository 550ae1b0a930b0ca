"""The metrics that read the program's own spans and counter
(ddpo_torch/utils/profiling.py, ddpo_torch/ops/conv.py): each reads a
number from a run whose window holds the spans, and None from one whose
window holds none, and from a program without the recorder or the counter
(an older tree, which the benchmark runs too)."""

import time
import types

import pytest

from h100_bench import run
from h100_bench.tests.conftest import ROOT  # noqa: F401  (puts the checkout on the path)

SPAN_METRICS = ["apply_host_ms.ddpo", "optimizer_step_ms.ddpo", "sampler_host_ms.ddpo"]


def _read(name, start):
    return run.load_module("metrics", name).read(types.SimpleNamespace(start=start))


def _record_window():
    """Two sampler steps, two trained timesteps and an optimizer step whose
    sync takes 20 ms of its 30; returns the window's start."""
    from ddpo_torch.utils.profiling import span

    start = time.perf_counter()
    with span("sampler.trajectories"):
        for _ in range(2):
            with span("sampler.step"):
                time.sleep(0.005)
    with span("train.inner_epoch"):
        for _ in range(2):
            with span("train.apply"):
                time.sleep(0.005)
        with span("train.optimizer"):
            time.sleep(0.01)
            with span("train.optimizer.sync"):
                time.sleep(0.02)
    return start


def test_span_metrics_read_the_windows_spans():
    start = _record_window()
    got = {name: _read(name, start) for name in SPAN_METRICS}
    assert 5 <= got["sampler_host_ms.ddpo"] < 50
    assert 5 <= got["apply_host_ms.ddpo"] < 50
    assert 10 <= got["optimizer_step_ms.ddpo"] < 20  # the 20 ms sync is not in it


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_read_none_without_spans(name, monkeypatch):
    from ddpo_torch.utils import profiling

    _record_window()
    assert _read(name, time.perf_counter()) is None  # spans, but none in the window
    monkeypatch.delattr(profiling, "spans")
    assert _read(name, 0.0) is None  # a program without the recorder


def test_tap_operand_hit_reads_the_counter(monkeypatch):
    from ddpo_torch.ops import conv

    monkeypatch.setattr(conv, "operand_cache", {"lookups": 4410, "misses": 2009})
    assert _read("tap_operand_hit.ddpo", 0.0) == pytest.approx(100 * 2401 / 4410)
    monkeypatch.setattr(conv, "operand_cache", {"lookups": 0, "misses": 0})
    assert _read("tap_operand_hit.ddpo", 0.0) is None
    monkeypatch.delattr(conv, "operand_cache")
    assert _read("tap_operand_hit.ddpo", 0.0) is None
