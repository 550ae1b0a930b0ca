"""The port's clip + adamw, schedules, stat tracker and rewards against
ddpo_tpu's, on the CPU.

Tolerances, each measured first:

  - optimizer (fp32 params, bf16 mu, fp32 nu after 3 steps, one of them
    clipped): params and nu rtol 1e-6, mu within one bf16 ulp;
  - schedules: rtol 1e-6 (float32 on both sides);
  - stat tracker and the dependency-free rewards: rtol 1e-12 (numpy on both
    sides); JPEG sizes exact (the same libjpeg through the same C++).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpo_torch.training import callbacks as t_callbacks
from ddpo_torch.training.optim import ClipAdamW, build_lr_schedule, build_optimizer
from ddpo_torch.training.stat_tracking import PerPromptStatTracker
from ddpo_tpu.training import callbacks as j_callbacks
from ddpo_tpu.training import optim as j_optim
from ddpo_tpu.training.stat_tracking import PerPromptStatTracker as JaxTracker


def _opt_args(**kw):
    base = dict(learning_rate=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=1e-2,
                max_grad_norm=1.0, lr_schedule="constant", lr_warmup_steps=0,
                lr_total_steps=None, optimizer="adamw")
    base.update(kw)
    return SimpleNamespace(**base)


def test_clip_adamw_matches_optax():
    """3 steps with identical gradients; the second is clipped (norm > 1)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grad_scales = [0.05, 10.0, 0.1]  # global norms about 0.3, 60 and 0.6
    grads = [{k: (rng.standard_normal(s) * g).astype(np.float32) for k, s in shapes.items()}
             for g in grad_scales]
    args = _opt_args(lr_warmup_steps=2)

    tx = j_optim.build_optimizer(args)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    for g in grads:
        updates, j_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
    adam = next(x for x in jax.tree_util.tree_leaves(
        j_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))

    opt = build_optimizer(args)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = opt.init(t_params)
    norms = [float(ClipAdamW.global_norm([torch.from_numpy(x) for x in g.values()])) for g in grads]
    assert norms[1] > 1.0 > max(norms[0], norms[2])
    for g in grads:
        opt.step(t_params, {k: torch.from_numpy(v) for k, v in g.items()}, t_state)
    assert t_state["count"] == int(adam.count) == 3
    for k in shapes:
        np.testing.assert_allclose(t_params[k].numpy(), np.asarray(j_params[k]), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(t_state["nu"][k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6)
        assert t_state["mu"][k].dtype == torch.bfloat16 and adam.mu[k].dtype == jnp.bfloat16
        mu_j = np.asarray(adam.mu[k].astype(jnp.float32))
        ulp = np.abs(mu_j) * 2.0**-7
        assert np.all(np.abs(t_state["mu"][k].float().numpy() - mu_j) <= ulp), k


@pytest.mark.parametrize("kw", [
    dict(lr_schedule="constant"),
    dict(lr_schedule="constant", lr_warmup_steps=5),
    dict(lr_schedule="linear", lr_warmup_steps=3, lr_total_steps=20),
    dict(lr_schedule="cosine", lr_total_steps=15),
    dict(lr_schedule="cosine", lr_warmup_steps=4, lr_total_steps=15),
])
def test_lr_schedules_match_optax(kw):
    args = _opt_args(**kw)
    j_sched, t_sched = j_optim.build_lr_schedule(args), build_lr_schedule(args)
    for count in range(25):
        np.testing.assert_allclose(t_sched(count), float(j_sched(count)), rtol=1e-6, atol=0)


def test_adafactor_is_not_ported():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_optimizer(_opt_args(optimizer="adafactor"))


def test_stat_tracker_matches_jax():
    rng = np.random.default_rng(9)
    j, t = JaxTracker(4, 3), PerPromptStatTracker(4, 3)
    for _ in range(4):
        prompts = rng.choice(["a cat", "a dog", "an owl"], size=6)
        rewards = rng.standard_normal(6)
        np.testing.assert_allclose(t.update(prompts, rewards), j.update(prompts, rewards),
                                   rtol=1e-12)
    assert t.state_dict() == j.state_dict()
    restored = PerPromptStatTracker(4, 3)
    restored.load_state_dict(t.state_dict())
    prompts, rewards = np.array(["a cat", "a dog"]), np.array([0.5, -0.25])
    np.testing.assert_allclose(restored.update(prompts, rewards), j.update(prompts, rewards),
                               rtol=1e-12)


@pytest.mark.parametrize("name", ["jpeg", "neg_jpeg", "arange", "mirror", "mirror_corr",
                                  "rotational_corr"])
def test_rewards_match_jax(name):
    rng = np.random.default_rng(11)
    images = rng.random((3, 32, 32, 3)).astype(np.float32)
    images[1] = images[1, :, ::-1]  # a more symmetric image
    prompts, metadata = ["a cat"] * 3, [{}] * 3
    t_out = t_callbacks.evaluate_callbacks(
        {name: t_callbacks.callback_fns[name]()}, images, prompts, metadata)[name]
    j_out = j_callbacks.evaluate_callbacks(
        {name: j_callbacks.callback_fns[name]()}, images, prompts, metadata)[name]
    np.testing.assert_allclose(np.asarray(t_out[0], np.float64), np.asarray(j_out[0], np.float64),
                               rtol=1e-12)
    assert t_out[1] == j_out[1] == {}


def test_unported_rewards_raise():
    for name in ("vae", "aesthetic", "consistency", "rotational", "thumbnail", "vqa",
                 "llava_vqa", "llava_bertscore"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            t_callbacks.callback_fns[name]()
    assert set(t_callbacks.callback_fns) == set(j_callbacks.callback_fns)
