"""bench/sp_check.py's gates on hand-built tensors, and one two-rank run.

sp_check holds the sp mesh axis to two gates, for eps and for the
gradients: (a) at fp32, max|sharded - unsharded| <= 2^-12 of max|ref|;
(b) in bf16, against the unsharded fp32 result, the sharded run's error at
most 1.5 times the unsharded bf16 run's in its maximum and 1.1 times in its
RMS. The statistics and both gates are checked here on tensors whose errors
are known, each gate once passing and once failing; then sp_check runs as
two gloo ranks on the CPU at the tiny preset and must pass.
"""

import json
import math
import os
import sys

import pytest
import torch

from ddpo_torch.bench.sp_check import (
    FP32_BOUND,
    MAX_RATIO,
    RMS_RATIO,
    bf16_gate,
    error_stats,
    fp32_gate,
    largest_shares,
)
from ddpo_torch.parallel.launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_error_stats_over_a_tensor_and_pooled_over_a_dict():
    ref = torch.tensor([4.0, -2.0, 1.0, 0.0])
    got = ref + torch.tensor([0.5, 0.0, -0.5, 0.0])
    stats = error_stats(got, ref)
    assert stats["max"] == 0.5 / 4.0
    assert math.isclose(stats["rms"], math.sqrt(0.5 / 4) / 4.0, rel_tol=1e-12)
    # a dict pools every element: the largest |d| and |ref| over all, one RMS
    refs = {"a": torch.tensor([1.0, 1.0]), "b": torch.tensor([8.0, 0.0])}
    gots = {"a": torch.tensor([1.25, 1.0]), "b": torch.tensor([8.0, 0.75])}
    pooled = error_stats(gots, refs)
    assert pooled["max"] == 0.75 / 8.0
    assert math.isclose(pooled["rms"], math.sqrt((0.25**2 + 0.75**2) / 4) / 8.0, rel_tol=1e-12)
    # and b holds 0.75^2 / (0.25^2 + 0.75^2) of the squared error
    assert largest_shares(gots, refs) == [("b", 0.9), ("a", 0.1)]
    # bf16 inputs are compared in fp32
    assert error_stats(got.bfloat16(), ref.bfloat16())["max"] == 0.5 / 4.0


@pytest.mark.parametrize("rel,passes", [(FP32_BOUND / 2, True), (FP32_BOUND, True),
                                        (2 * FP32_BOUND, False)])
def test_fp32_gate(rel, passes):
    ref = torch.linspace(-1.0, 1.0, 101, dtype=torch.float64).float()
    got = ref.clone()
    got[7] += rel  # max|ref| = 1
    assert fp32_gate(error_stats(got, ref)) is passes


def test_bf16_gate_passes_an_equal_error_and_fails_each_ratio():
    ref = torch.ones(100)
    unsharded = error_stats(ref + 0.01 * torch.ones(100), ref)
    assert bf16_gate(unsharded, unsharded)
    # one element 1.6x the unsharded run's largest error: the RMS stays
    # within 1.1x, the maximum does not
    bad_max = ref + 0.01 * torch.ones(100)
    bad_max[3] = 1.0 + 0.016
    s = error_stats(bad_max, ref)
    assert s["rms"] <= RMS_RATIO * unsharded["rms"] and s["max"] > MAX_RATIO * unsharded["max"]
    assert not bf16_gate(s, unsharded)
    # every element 1.2x: the maximum stays within 1.5x, the RMS does not
    s = error_stats(ref + 0.012 * torch.ones(100), ref)
    assert s["max"] <= MAX_RATIO * unsharded["max"] and s["rms"] > RMS_RATIO * unsharded["rms"]
    assert not bf16_gate(s, unsharded)


def test_sp_check_two_gloo_ranks_on_the_tiny_preset(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "ddpo_torch.bench.sp_check", "--device", "cpu",
           "--preset", "tiny", "--resolution", "64"]
    results = launch(cmd, 2, timeout=240, env=env, cwd=str(tmp_path))
    reports = []
    for rc, out in results:
        assert rc == 0, out[-3000:]
        line = [l for l in out.splitlines() if l.startswith("SP_CHECK ")]
        reports.append(json.loads(line[-1][len("SP_CHECK "):]))
    for rep in reports:
        assert rep["ok"]
        for mode in ("spatial", "attention", "tp"):
            m = rep[mode]
            assert m["passed"] and m["finite"]
            for key in ("eps", "grads"):
                assert m["fp32"][key]["max"] <= FP32_BOUND
                assert bf16_gate(m["bf16_sharded"][key], rep["bf16_unsharded"][key])
    # both ranks compare the same eps and gradients
    assert reports[0]["spatial"]["fp32"] == reports[1]["spatial"]["fp32"]
    assert reports[0]["tp"]["fp32"] == reports[1]["tp"]["fp32"]

