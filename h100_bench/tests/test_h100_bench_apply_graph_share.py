"""The metric that reads the trainer's CUDA-graph counter
(ddpo_torch/pipelines/policy_gradient.py ``train_graphs``): the share of
replays among the applies, and None where the program made no apply or
has no such counter (an older tree, which the benchmark runs too)."""

import types

import pytest

from h100_bench import run
from h100_bench.tests.conftest import ROOT  # noqa: F401  (puts the checkout on the path)


def _read(name, start):
    return run.load_module("metrics", name).read(types.SimpleNamespace(start=start))


def test_apply_graph_share_reads_the_counter(monkeypatch):
    from ddpo_torch.pipelines import policy_gradient

    monkeypatch.setattr(policy_gradient, "train_graphs",
                        {"captures": 1, "replays": 78, "eager": 1})
    assert _read("apply_graph_share.ddpo", 0.0) == pytest.approx(97.5)
    monkeypatch.setattr(policy_gradient, "train_graphs", {"captures": 0, "replays": 0, "eager": 0})
    assert _read("apply_graph_share.ddpo", 0.0) is None
    monkeypatch.delattr(policy_gradient, "train_graphs")
    assert _read("apply_graph_share.ddpo", 0.0) is None
