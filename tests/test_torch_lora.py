"""The port's LoRA (models/lora.py and --lora_rank in the DDPO driver)
against ddpo_tpu's, on the CPU at fp32 with the tiny preset.

The JAX tiny UNet's weights reach the port through ``from_flax`` and JAX's
adapter tree through ``lora_from_flax``; inputs come from a numpy seed.
Tolerances, each measured first:

  - the merged UNet's output: atol 1e-5 (measured at most 2.0e-6: fp32
    convs and matmuls in another summation order); the merged weights atol
    1e-7 (measured equal);
  - one fused PPO step with adamw at lr 1e-3: the updated adapters within
    atol 1e-5 (measured at most 6.2e-6: adam's first step divides each
    gradient by its own size, so a gradient near 0 turns fp32 noise into a
    step of up to the lr);
  - the driver: the first minibatch's approx_kl below 1e-6, as the full
    finetune's; a resumed run equals the uninterrupted one (rtol 1e-6 on
    rewards, 1e-5 on losses and on the exported UNet; measured equal).
"""

import functools
import json
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from ddpo_torch.core.scheduler import DDIMScheduler as TorchDDIM
from ddpo_torch.models.convert import from_flax, lora_from_flax
from ddpo_torch.models.lora import (
    DEFAULT_TARGETS,
    init_lora,
    merge_lora,
    n_lora_params,
    target_paths,
)
from ddpo_torch.pipelines.policy_gradient import make_train_apply, sampler_unet
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import AccumulatingTrainState, train_step_fused
from ddpo_torch.utils.serialization import build_models
from ddpo_tpu.models import lora as j_lora
from ddpo_tpu.training import optim as j_optim
from ddpo_tpu.training import policy_gradient as j_pg
from ddpo_tpu.utils.serialization import _tiny_stack, sd_scheduler

from test_torch_pipeline import COMMON, LOGDIR, _train_infos, workdir  # noqa: F401

RANK = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """The JAX UNet and params, the port's UNet with the same weights, and
    JAX's rank-2 adapters with a nonzero B, on both sides."""
    _, _, j_unet = _tiny_stack(jnp.float32)
    params = jax.jit(j_unet.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, 32)),
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    _, _, t_unet = build_models("tiny", "cpu")
    t_unet.load_state_dict(from_flax({"unet": params})["unet"])
    t_unet.requires_grad_(False)  # the frozen base
    rng = np.random.default_rng(0)
    tree = j_lora.init_lora(params, RANK, jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, tree)

    def nonzero_b(node):
        return {k: (dict(v, b=(rng.standard_normal(v["b"].shape) * 0.05).astype(np.float32))
                    if "a" in v else nonzero_b(v)) for k, v in node.items()}

    tree = nonzero_b(tree)
    return SimpleNamespace(j_unet=j_unet, params=params, t_unet=t_unet, tree=tree,
                           adapters=lora_from_flax(tree))


def _inputs(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 4, 8, 8)).astype(np.float32),
            np.array([901, 301][:batch], np.int32),
            rng.standard_normal((batch, 77, 32)).astype(np.float32))


def test_merge_at_init_is_the_base_bitwise(tiny):
    base = dict(tiny.t_unet.named_parameters())
    adapters = init_lora(tiny.t_unet, 4, torch.Generator().manual_seed(0))
    merged = merge_lora(base, adapters)
    assert merged.keys() == base.keys()
    for k, p in base.items():
        assert torch.equal(merged[k], p), k
    # A ~ N(0, 1) / rank in JAX's (in, r) orientation, B = 0 as (r, out)
    for path in target_paths(base):
        d_out, d_in = base[path + ".weight"].shape
        assert adapters[path + ".a"].shape == (d_in, 4)
        assert adapters[path + ".b"].shape == (4, d_out) and not adapters[path + ".b"].any()
    assert n_lora_params(adapters) == sum(4 * sum(base[p + ".weight"].shape)
                                          for p in target_paths(base))


def test_merge_touches_only_the_targets(tiny):
    base = dict(tiny.t_unet.named_parameters())
    adapters = {k: torch.ones_like(v) for k, v in
                init_lora(base, 4, torch.Generator().manual_seed(0)).items()}
    merged = merge_lora(base, adapters)
    changed = {k for k in base if not torch.equal(merged[k], base[k])}
    unchanged_are_shared = all(merged[k] is base[k] for k in base if k not in changed)
    assert unchanged_are_shared
    assert changed == {p + ".weight" for p in target_paths(base)}
    assert all(any(k.endswith(f".{t}.weight") for t in DEFAULT_TARGETS) for k in changed)
    # the same modules JAX's init_lora targets, keyed by the torch path
    assert set(tiny.adapters) == set(adapters)


def test_gradients_reach_a_and_b(tiny):
    base = dict(tiny.t_unet.named_parameters())
    x, t, ctx = (torch.from_numpy(v) for v in _inputs(1, batch=1))

    def grads(adapters):
        adapters = {k: v.clone().requires_grad_(True) for k, v in adapters.items()}
        out = functional_call(tiny.t_unet, merge_lora(base, adapters), (x, t, ctx))
        g = torch.autograd.grad(out.square().sum(), list(adapters.values()))
        return dict(zip(adapters, g))

    at_init = grads(init_lora(base, RANK, torch.Generator().manual_seed(2)))
    # with B = 0: dL/dB = A^T (...) is nonzero, dL/dA = (...) B^T is 0, as in JAX
    assert max(g.abs().max().item() for k, g in at_init.items() if k.endswith(".b")) > 0
    assert max(g.abs().max().item() for k, g in at_init.items() if k.endswith(".a")) == 0
    trained = grads(tiny.adapters)
    assert all(g.abs().max().item() > 0 for g in trained.values())


def test_merged_unet_matches_jax(tiny):
    x, t, ctx = _inputs(2)
    j_out = tiny.j_unet.apply({"params": j_lora.merge_lora(tiny.params, tiny.tree)}, x, t, ctx)
    base = dict(tiny.t_unet.named_parameters())
    with torch.no_grad():
        merged = merge_lora(base, tiny.adapters)
        out = functional_call(tiny.t_unet, merged, tuple(map(torch.from_numpy, (x, t, ctx))))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
    # the merged weights themselves, in torch's layout
    j_merged = from_flax({"unet": jax.tree_util.tree_map(
        np.asarray, j_lora.merge_lora(tiny.params, tiny.tree))})["unet"]
    for k, w in merged.items():
        np.testing.assert_allclose(w.numpy(), j_merged[k].numpy(), atol=1e-7, err_msg=k)


def test_train_step_fused_matches_jax(tiny):
    """One fused PPO update (3 timesteps, CFG as one 2B apply, remat, clip +
    adamw at the LoRA preset's lr 1e-3) of the same adapters on the same
    batch, with the same frozen base."""
    args = SimpleNamespace(learning_rate=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
                           weight_decay=1e-4, max_grad_norm=1.0, lr_schedule="constant",
                           lr_warmup_steps=0, lr_total_steps=None, optimizer="adamw")
    rng = np.random.default_rng(4)
    t_n, b = 3, 2
    batch = {
        "latents": rng.standard_normal((t_n, b, 4, 8, 8)).astype(np.float32),
        "next_latents": rng.standard_normal((t_n, b, 4, 8, 8)).astype(np.float32),
        "ts": np.array([[901, 601], [601, 301], [301, 901]], np.int32),
        "log_probs": rng.standard_normal((t_n, b)).astype(np.float32),
        "advantages": np.array([1.5, -0.7], np.float32),
        "prompt_embeds": rng.standard_normal((b, 77, 32)).astype(np.float32),
        "uncond_embeds": rng.standard_normal((b, 77, 32)).astype(np.float32),
    }
    kw = dict(train_cfg=True, guidance_scale=5.0, eta=1.0, clip_range=1e-2,
              do_opt_update=True, cfg_concat=True)

    j_sched = sd_scheduler()
    j_sched_state = j_sched.set_timesteps(j_sched.create_state(), 10)
    j_apply = jax.checkpoint(lambda p, x, t, c: tiny.j_unet.apply({"params": p}, x, t, c))
    j_state = j_pg.AccumulatingTrainState.create(
        apply_fn=lambda base, p, x, t, c: j_apply(j_lora.merge_lora(base, p), x, t, c),
        params=jax.tree_util.tree_map(jnp.asarray, tiny.tree), tx=j_optim.build_optimizer(args),
        accumulate=False)
    step = jax.jit(functools.partial(j_pg.train_step_fused, scheduler=j_sched, **kw))
    j_state, j_info = step(j_state, {k: jnp.asarray(v) for k, v in batch.items()},
                           scheduler_state=j_sched_state, frozen=tiny.params)

    t_sched = TorchDDIM()
    base = dict(tiny.t_unet.named_parameters())
    adapters = {k: v.clone().requires_grad_(True) for k, v in tiny.adapters.items()}
    state = AccumulatingTrainState(
        apply_fn=make_train_apply(tiny.t_unet, torch.float32, remat=True, base=base),
        params=adapters, tx=build_optimizer(args), accumulate=False)
    _, info = train_step_fused(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                               scheduler_state=t_sched.set_timesteps(t_sched.create_state(), 10),
                               scheduler=t_sched, **kw)
    np.testing.assert_allclose(info["loss"].item(), float(j_info["loss"]), atol=1e-6)
    assert info["clipfrac"].item() == float(j_info["clipfrac"])
    ref = lora_from_flax(jax.tree_util.tree_map(np.asarray, j_state.params))
    moved = 0.0
    for k, p in adapters.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
        moved = max(moved, (p.detach() - tiny.adapters[k]).abs().max().item())
    assert moved > 1e-4  # the step moved the adapters by about the lr


def test_sampler_unet_shares_the_frozen_base(tiny):
    """The sampler's UNet holds copies of the merged targets only; every
    other tensor is the base's own."""
    _, _, unet = build_models("tiny", "cpu")
    unet.load_state_dict(tiny.t_unet.state_dict())
    unet.requires_grad_(False)
    own = [p + ".weight" for p in target_paths(dict(unet.named_parameters()))]
    sampler = sampler_unet(unet, torch.float32, own)
    base = dict(unet.named_parameters())
    for name, p in sampler.named_parameters():
        assert (p is not base[name]) == (name in own), name
        assert torch.equal(p, base[name])
    assert sampler_unet(unet, torch.float32) is unet
    assert sampler_unet(unet, torch.bfloat16, own).conv_in.weight.dtype == torch.bfloat16


def test_lora_driver_on_policy_checkpoint_and_export(workdir):
    from ddpo_torch.pipelines import policy_gradient

    rewards = policy_gradient.main([
        "--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
        "--resolution", "32", "--sample_batch_size", "8", "--num_train_epochs", "1",
        "--lora_rank", str(RANK),
    ])
    assert rewards == [3.5]
    logdir = workdir.joinpath(*LOGDIR)
    info = _train_infos(logdir)["0_0_0.npy"]
    assert info["approx_kl"][0] < 1e-6  # on-policy until the first update
    state = torch.load(workdir / "bucket/logs/debug-animals/models/pg/checkpoints/0/state.pt",
                       weights_only=True)
    _, _, unet = build_models("tiny", "cpu")
    paths = target_paths(dict(unet.named_parameters()))
    adapters = state["state"]["params"]
    assert set(adapters) == {p + s for p in paths for s in (".a", ".b")}  # adapters only
    assert set(state["state"]["opt_state"]["nu"]) == set(adapters)
    assert all(v.dtype == torch.float32 for v in adapters.values())
    with open(logdir / "unet_0.pkl", "rb") as f:
        tree = pickle.load(f)
    exported = from_flax({"unet": tree})["unet"]
    assert set(exported) == {k for k, _ in unet.named_parameters()}  # the whole UNet


def test_lora_resume_matches_uninterrupted(workdir):
    import shutil

    from ddpo_torch.pipelines import policy_gradient

    flags = COMMON + ["--lora_rank", str(RANK), "--learning_rate", "1e-3"]
    logdir = workdir.joinpath(*LOGDIR)
    rewards_full = policy_gradient.main(flags + ["--num_train_epochs", "2"])
    infos_full = _train_infos(logdir)
    with open(logdir / "unet_1.pkl", "rb") as f:
        export_full = from_flax({"unet": pickle.load(f)})["unet"]

    shutil.rmtree(workdir / "logs")
    shutil.rmtree(workdir / "bucket")
    policy_gradient.main(flags + ["--num_train_epochs", "1"])
    rewards = policy_gradient.main(flags + ["--num_train_epochs", "2", "--resume", "True"])
    np.testing.assert_allclose(rewards, rewards_full, rtol=1e-6)
    infos = _train_infos(logdir)
    assert set(infos) == set(infos_full)
    for name, info in infos_full.items():
        np.testing.assert_allclose(infos[name]["loss"], info["loss"], rtol=1e-5, err_msg=name)
    with open(logdir / "unet_1.pkl", "rb") as f:
        export = from_flax({"unet": pickle.load(f)})["unet"]
    for k, w in export_full.items():
        np.testing.assert_allclose(export[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    curve = json.loads((logdir / "reward_curve.json").read_text())
    assert len(curve["mean"]) == 2


def test_lora_preset_resolves_the_measured_recipe():
    from ddpo_torch.pipelines.policy_gradient import Parser

    args = Parser().parse_args("pg", ["--dataset", "compressed-animals-lora"], setup=False)
    assert args.lora_rank == 8
    assert args.learning_rate == 1e-3
    assert args.optimizer == "adamw"
    assert args.prompt_fn == "imagenet_animals"
    assert args.filter_field == "jpeg"
