"""The port's clip + adamw, schedules, stat tracker and rewards against
ddpo_tpu's, on the CPU.

Tolerances, each measured first:

  - optimizer (fp32 params, bf16 mu, fp32 nu after 3 steps, one of them
    clipped): params and nu rtol 1e-6, mu within one bf16 ulp;
  - adafactor (fp32, 5 steps, one clipped, a factored Dense kernel, a
    factored 3x3 conv kernel with Cin = Cout and unfactored biases, carried
    across with from_flax / to_flax): params and second moments rtol 1e-6;
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

from ddpo_torch.models.convert import flax_tree_to_state_dict, to_flax
from ddpo_torch.training import callbacks as t_callbacks
from ddpo_torch.training.optim import (
    ClipAdafactor,
    ClipAdamW,
    build_lr_schedule,
    build_optimizer,
    factored_axes,
)
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


class _Layers(torch.nn.Module):
    """The modules the adafactor tree's Flax names come from."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(256, 130)
        self.conv = torch.nn.Conv2d(128, 128, 3)


def test_adafactor_matches_optax():
    """5 steps of clip + adafactor on a Flax tree and on its from_flax copy:
    a (256, 130) Dense kernel and a 3x3 conv kernel with Cin = Cout = 128,
    both factored, and unfactored biases; the second step is clipped."""
    rng = np.random.default_rng(5)
    shapes = {"dense": {"kernel": (256, 130), "bias": (130,)},
              "conv": {"kernel": (3, 3, 128, 128), "bias": (128,)}}

    def tree(scale):
        return {m: {k: (rng.standard_normal(s) * scale).astype(np.float32)
                    for k, s in leaves.items()} for m, leaves in shapes.items()}

    params = tree(0.05)
    grads = [tree(g) for g in (1e-4, 0.5, 2e-4, 1e-3, 5e-5)]
    args = _opt_args(optimizer="adafactor", learning_rate=1e-2)

    tx = j_optim.build_optimizer(args)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = tx.init(j_params)
    for g in grads:
        updates, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
    factored = next(x for x in jax.tree_util.tree_leaves(
        j_state, is_leaf=lambda x: isinstance(x, optax._src.factorized.FactoredState))
        if isinstance(x, optax._src.factorized.FactoredState))

    opt = build_optimizer(args)
    assert isinstance(opt, ClipAdafactor)
    t_params = flax_tree_to_state_dict(params)
    t_state = opt.init(t_params)
    # the tie Cin = Cout: HWIO's O (the port's axis 0) ranks as the larger
    assert opt.axes == {"dense.weight": (0, 1), "dense.bias": None,
                        "conv.weight": (1, 0), "conv.bias": None}
    norms = [float(ClipAdamW.global_norm([torch.from_numpy(x) for m in g.values()
                                          for x in m.values()])) for g in grads]
    assert norms[1] > 1.0 > max(norms[:1] + norms[2:])
    for g in grads:
        opt.step(t_params, flax_tree_to_state_dict(g), t_state)
    assert t_state["count"] == int(factored.count) == 5
    out = to_flax(t_params, _Layers())
    for m, leaves in shapes.items():
        for k in leaves:
            np.testing.assert_allclose(out[m][k], np.asarray(j_params[m][k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{m}.{k}")
    # the second moments, in the port's axes: the dense row statistic is
    # Flax's (256,) over out; the conv's are (3, 3, 128) over Cout and Cin
    np.testing.assert_allclose(t_state["v_row"]["dense.weight"].numpy(),
                               np.asarray(factored.v_row["dense"]["kernel"]), rtol=1e-6)
    np.testing.assert_allclose(t_state["v_col"]["conv.weight"].permute(1, 2, 0).numpy(),
                               np.asarray(factored.v_col["conv"]["kernel"]), rtol=1e-6)
    np.testing.assert_allclose(t_state["v"]["conv.bias"].numpy(),
                               np.asarray(factored.v["conv"]["bias"]), rtol=1e-6)


@pytest.mark.parametrize("name, shape, axes", [
    ("x.weight", (130, 256), (0, 1)),      # Dense (in 256, out 130)
    ("x.weight", (256, 256), (1, 0)),      # square Dense: Flax's out is d0
    ("x.weight", (320, 640, 3, 3), (0, 1)),  # conv Cin 640 > Cout 320
    ("x.weight", (1280, 4, 3, 3), None),   # Cin below 128
    ("x.a", (320, 8), None),               # LoRA A: r = 8
    ("x.b", (128, 640), (0, 1)),           # Flax layout as it is
])
def test_factored_axes_follow_optax(name, shape, axes):
    from optax._src.factorized import _factored_dims

    assert factored_axes(name, shape) == axes
    flax_shape = shape[::-1] if len(shape) == 2 and name.endswith("weight") else (
        (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 else shape)
    dims = _factored_dims(flax_shape, True, 128)
    if axes is None:
        assert dims is None
    else:
        from ddpo_torch.training.optim import flax_axes

        to_port = flax_axes(name, shape)
        assert (to_port[dims[0]], to_port[dims[1]]) == axes


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
    # vqa without its model directory names the paths it tried
    # (tests/test_torch_vqa.py); the CLIP rewards without their weights
    # raise as JAX's do (tests/test_torch_rewards_clip.py)
    with pytest.raises(FileNotFoundError, match="blip2-opt-2.7b"):
        t_callbacks.callback_fns["vqa"]()
    for name in ("aesthetic", "consistency", "rotational", "thumbnail"):
        with pytest.raises(RuntimeError, match="unavailable"):
            t_callbacks.callback_fns[name]()
    # the vae reward is ported (tests/test_torch_rwr.py) and needs its model
    with pytest.raises(RuntimeError, match="pass vae="):
        t_callbacks.callback_fns["vae"]()
    assert set(t_callbacks.callback_fns) == set(j_callbacks.callback_fns)
