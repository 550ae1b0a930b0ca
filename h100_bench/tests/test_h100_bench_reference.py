"""The plain reference against the port at the tiny preset for one epoch,
the faults a DDPO cell can have, planted under the timed path, and the
float8 control, each of which the cells' limits have to catch."""

import numpy as np
import pytest
import torch

from h100_bench import run, weights
from h100_bench.tests.conftest import tiny_cell


def measure(cell, seed=2**31 + 12345):
    run.set_environment()
    return run.measure(cell, seed, 0.1, False, "cpu")


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_reference_matches_port_for_one_epoch(lora):
    r, metrics, checks, correct, info = measure(tiny_cell(lora))
    assert correct, checks
    values = {name: value for name, value, _ in checks}
    assert values["init"] == values["reward"] == values["advantages"] == values["refresh"] == 0.0
    for name in ("text", "eps", "decode", "grad"):
        assert values[name] < 1e-3, (name, values[name])
    # adamw stores its first moment in bf16: 2^-9 of each element
    assert values["grad_diff"] < 5e-3, values["grad_diff"]
    assert set(metrics) == {"ddpo_epoch_s", "setup_s"}
    assert r.epochs >= 1 and r.record["opt_count"] == 1


def test_weights_are_equal_on_both_sides():
    from h100_bench.checks.ddpo import Reference
    from h100_bench.drivers.ddpo import build_stack

    cell = tiny_cell()
    port = build_stack(cell["model"], "cpu", seed=9)
    reference = Reference(cell["model"], cell["traffic"], 9, "cpu")
    for mine, theirs in zip(port, (reference.text, reference.vae, reference.unet)):
        a, b = dict(mine.named_parameters()), dict(theirs.named_parameters())
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    other = dict(build_stack(cell["model"], "cpu", seed=10)[2].named_parameters())
    assert not torch.equal(other["conv_in.weight"], dict(port[2].named_parameters())["conv_in.weight"])


def _unchanged_state(monkeypatch):
    from ddpo_torch.training import optim

    monkeypatch.setattr(optim.ClipAdamW, "step", lambda self, params, grads, state: None)


def _half_batch(monkeypatch):
    from ddpo_torch.training import policy_gradient as pg

    step = pg.train_step_fused

    def half(state, batch, *args, **kwargs):
        b = batch["advantages"].shape[0] // 2
        cut = {k: (v[:, :b] if k in pg.PER_T else v[:b]) for k, v in batch.items()}
        return step(state, cut, *args, **kwargs)

    monkeypatch.setattr(pg, "train_step_fused", half)


def _negated_gradient(monkeypatch):
    from ddpo_torch.training import optim

    step = optim.ClipAdamW.step

    def negated(self, params, grads, state):
        return step(self, params, {k: -g for k, g in grads.items()}, state)

    monkeypatch.setattr(optim.ClipAdamW, "step", negated)


def _altered_reward(monkeypatch):
    import ddpo_torch.native as native

    sizes = native.jpeg_sizes

    def altered(images, *args, **kwargs):
        out = sizes(images, *args, **kwargs)
        out[0] += 1
        return out

    monkeypatch.setattr(native, "jpeg_sizes", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _negated_gradient,
                                   _altered_reward],
                         ids=["state_unchanged", "half_batch", "gradient_negated",
                              "reward_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    """A run with the fault planted in the program, the card's look skipped,
    comes out not correct, failing the numbers the fault moves."""
    fault(monkeypatch)
    _, _, checks, correct, _ = measure(tiny_cell())
    assert not correct
    failed = {name for name, value, limit in checks if value > limit}
    expected = {_unchanged_state: {"grad", "grad_diff", "change"},
                _half_batch: {"grad", "grad_diff", "loss"}, _negated_gradient: {"grad_diff"},
                _altered_reward: {"reward", "advantages"}}[fault]
    assert expected & failed, checks


def test_float8_control_is_not_correct():
    """The reference in float8 in the program's place fails the cell's limits."""
    from h100_bench import control

    cell = tiny_cell()
    run.set_environment()
    lines = control.control(cell, [4], "cpu", sides=("fp8",))
    values = lines[0]["values"]
    assert any(values[k] > v for k, v in cell["limits"].items()), values


def test_sampled_steps_are_drawn_from_the_seed():
    from h100_bench.checks.ddpo import sampled_steps

    a = sampled_steps(2**33 + 1, 50, 6)
    assert a == sampled_steps(2**33 + 1, 50, 6) and len(a) == 6 and a[0] == 0 and a[-1] == 49
    assert a != sampled_steps(2**33 + 2, 50, 6)


def test_lora_adapters_from_the_seed():
    a = {"x.a": torch.empty(6, 2), "x.b": torch.empty(2, 3)}
    b = {k: torch.empty_like(v) for k, v in a.items()}
    weights.fill_lora_(a, 3)
    weights.fill_lora_(b, 3)
    assert torch.equal(a["x.a"], b["x.a"]) and not a["x.b"].any()
    assert float(a["x.a"].std()) == pytest.approx(0.5, rel=0.6)
    assert np.isfinite(a["x.a"].numpy()).all()


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on the card comes out correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run.set_environment()
    _, metrics, checks, correct, info = run.measure(run.load_cell("ddpo.sd14.b8"), 77, 1.0,
                                                    False, "cuda")
    assert correct, checks
    assert info["platform"] == "gpu" and metrics["ddpo_epoch_s"]["value"] > 0
