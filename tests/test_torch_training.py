"""The port's PPO loss and train steps against ddpo_tpu's, on the CPU at fp32.

The tiny UNet carries the same weights on both sides (``from_flax``); batches
come from a numpy seed; JAX gradients are mapped onto the port's keys and
layouts with ``from_flax``. Tolerances, each measured first:

  - loss, approx_kl: atol 1e-6 (measured at most 1.8e-7 and 1.1e-8);
    clipfrac exact;
  - gradients: atol 1e-4 * max|g| and rtol 1e-4 (measured at most 7.3e-6
    of max|g|: fp32 UNet differences, amplified by the guidance scale of 5);
  - the unfused loop against the fused step: rtol 1e-6 (the same sums in
    the same order; measured equal).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpo_torch.core.scheduler import DDIMScheduler as TorchDDIM
from ddpo_torch.models.convert import from_flax
from ddpo_torch.pipelines.policy_gradient import make_train_apply
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import (
    AccumulatingTrainState,
    ppo_loss,
    train_step,
    train_step_fused,
)
from ddpo_torch.utils.serialization import build_models
from ddpo_tpu.training.policy_gradient import _fused_grads
from ddpo_tpu.training.policy_gradient import ppo_loss as jax_ppo_loss
from ddpo_tpu.utils.serialization import _tiny_stack, sd_scheduler

B, STEPS, CLIP = 2, 10, 1e-2
TS = [901, 601, 301]  # grid points of the 10-step DDIM schedule


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tiny models gain nothing from more, and the
    suite runs several workers at once, where spinning OpenMP threads
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    _, _, j_unet = _tiny_stack(jnp.float32)
    params = jax.jit(j_unet.init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, 32)),
    )["params"]
    _, _, t_unet = build_models("tiny", "cpu")
    t_unet.load_state_dict(from_flax({"unet": jax.tree_util.tree_map(np.asarray, params)})["unet"])
    t_unet.requires_grad_(True)
    j_sched = sd_scheduler()
    j_state = j_sched.set_timesteps(j_sched.create_state(), STEPS)
    t_sched = TorchDDIM()
    t_state = t_sched.set_timesteps(t_sched.create_state(), STEPS)

    rng = np.random.default_rng(0)
    t_n = len(TS)
    batch = {
        "latents": rng.standard_normal((t_n, B, 4, 8, 8)).astype(np.float32),
        "ts": np.array([[t, TS[(i + 1) % t_n]] for i, t in enumerate(TS)], np.int32),
        "advantages": np.array([1.5, -0.7], np.float32),
        "prompt_embeds": rng.standard_normal((B, 77, 32)).astype(np.float32),
        "uncond_embeds": rng.standard_normal((B, 77, 32)).astype(np.float32),
    }
    # next_latents drawn from the policy itself, and old log-probs offset
    # from the current ones by 0.3x (inside) and 3x (outside) the clip range
    apply = make_train_apply(t_unet, torch.float32, remat=False)
    params_t = dict(t_unet.named_parameters())
    next_lat, old_lp = [], []
    with torch.no_grad():
        for i in range(t_n):
            x = torch.from_numpy(batch["latents"][i])
            ts = torch.from_numpy(batch["ts"][i])
            eps_u = apply(params_t, x, ts, torch.from_numpy(batch["uncond_embeds"]))
            eps_c = apply(params_t, x, ts, torch.from_numpy(batch["prompt_embeds"]))
            eps = eps_u + 5.0 * (eps_c - eps_u)
            noise = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
            nxt, lp = t_sched.step(t_state, eps, ts, x, noise=noise, eta=1.0)
            next_lat.append(nxt.numpy())
            old_lp.append(lp.numpy() + np.array([0.3, -3.0]) * CLIP * (1 if i % 2 else -1))
    batch["next_latents"] = np.stack(next_lat)
    batch["log_probs"] = np.stack(old_lp).astype(np.float32)
    return SimpleNamespace(j_unet=j_unet, params=params, t_unet=t_unet, j_sched=j_sched,
                           j_state=j_state, t_sched=t_sched, t_state=t_state, batch=batch)


def _slice(batch, i):
    out = {k: batch[k] for k in ("advantages", "prompt_embeds", "uncond_embeds")}
    out.update({k: batch[k][i] for k in ("latents", "next_latents", "ts", "log_probs")})
    return out


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_apply(s):
    return lambda p, x, t, c: s.j_unet.apply({"params": p}, x, t, c)


def _assert_grads_close(t_grads, j_grads):
    ref = from_flax({"unet": jax.tree_util.tree_map(np.asarray, j_grads)})["unet"]
    assert set(ref) == set(t_grads)
    scale = max(float(np.abs(r.numpy()).max()) for r in ref.values())
    for k, r in ref.items():
        np.testing.assert_allclose(t_grads[k].numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


CFG_CASES = [(True, True, True), (True, False, False), (False, False, True)]


@pytest.mark.parametrize("train_cfg,cfg_concat,remat", CFG_CASES)
def test_ppo_loss_matches_jax(setup, train_cfg, cfg_concat, remat):
    s = setup
    jb = {k: jnp.asarray(v) for k, v in _slice(s.batch, 0).items()}
    (j_loss, j_info), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b, st: jax_ppo_loss(p, _jax_apply(s), b, s.j_sched, st, train_cfg, 5.0,
                                      1.0, CLIP, cfg_concat),
        has_aux=True,
    ))(s.params, jb, s.j_state)
    params = dict(s.t_unet.named_parameters())
    apply = make_train_apply(s.t_unet, torch.float32, remat=remat)
    loss, info = ppo_loss(params, apply, _to_torch(_slice(s.batch, 0)), s.t_sched, s.t_state,
                          train_cfg, 5.0, 1.0, CLIP, cfg_concat)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-6)
    np.testing.assert_allclose(info["approx_kl"].item(), float(j_info["approx_kl"]), atol=1e-6)
    assert info["clipfrac"].item() == float(j_info["clipfrac"])
    if train_cfg:  # the old log-probs were made with CFG: both branches run
        assert 0.0 < info["clipfrac"].item() < 1.0
    _assert_grads_close(grads, j_grads)


class _Recorder:
    """A stand-in optimizer that records the gradients it is given."""

    def init(self, params):
        self.grads = []
        return {}

    def step(self, params, grads, state):
        self.grads.append({k: g.clone() for k, g in grads.items()})


@pytest.mark.parametrize("train_cfg,cfg_concat", [(True, True)])  # the bf16 default path
def test_train_step_fused_matches_jax(setup, train_cfg, cfg_concat):
    s = setup
    per_t = {k: jnp.asarray(s.batch[k]) for k in ("latents", "next_latents", "ts", "log_probs")}
    shared = {k: jnp.asarray(s.batch[k]) for k in ("advantages", "prompt_embeds", "uncond_embeds")}
    j_grads, j_info = jax.jit(
        lambda p, a, b, st: _fused_grads(p, _jax_apply(s), a, b, s.j_sched, st, train_cfg,
                                         5.0, 1.0, CLIP, cfg_concat)
    )(s.params, per_t, shared, s.j_state)
    params = dict(s.t_unet.named_parameters())
    rec = _Recorder()
    state = AccumulatingTrainState(
        apply_fn=make_train_apply(s.t_unet, torch.float32, remat=True), params=params,
        tx=rec, accumulate=False,
    )
    _, info = train_step_fused(state, _to_torch(s.batch), s.t_state, s.t_sched, train_cfg,
                               5.0, 1.0, CLIP, do_opt_update=True, cfg_concat=cfg_concat)
    assert state.step == 1 and len(rec.grads) == 1
    assert all(p.grad is None for p in params.values())
    for k in ("loss", "approx_kl"):
        np.testing.assert_allclose(info[k].item(), float(j_info[k]), atol=1e-6)
    np.testing.assert_allclose(info["clipfrac"].item(), float(j_info["clipfrac"]), atol=1e-7)
    _assert_grads_close(rec.grads[0], j_grads)


def test_unfused_accumulation_equals_fused_step(setup):
    """T train_step calls (update on the last) give the fused step's update."""
    s = setup
    args = SimpleNamespace(learning_rate=1e-4, beta1=0.9, beta2=0.999, epsilon=1e-8,
                           weight_decay=1e-4, max_grad_norm=1.0, lr_schedule="constant",
                           lr_warmup_steps=0, lr_total_steps=None, optimizer="adamw")
    results = []
    for fused in (True, False):
        _, _, unet = build_models("tiny", "cpu")
        unet.load_state_dict(s.t_unet.state_dict())
        params = dict(unet.requires_grad_(True).named_parameters())
        state = AccumulatingTrainState(
            apply_fn=make_train_apply(unet, torch.float32, remat=False), params=params,
            tx=build_optimizer(args), accumulate=not fused,
        )
        kw = dict(scheduler_state=s.t_state, scheduler=s.t_sched, train_cfg=True,
                  guidance_scale=5.0, eta=1.0, clip_range=CLIP, cfg_concat=True)
        if fused:
            train_step_fused(state, _to_torch(s.batch), do_opt_update=True, **kw)
        else:
            for i in range(len(TS)):
                train_step(state, _to_torch(_slice(s.batch, i)),
                           do_opt_update=i == len(TS) - 1, **kw)
        assert state.step == 1
        results.append({k: p.detach().clone() for k, p in params.items()})
    for k in results[0]:
        np.testing.assert_allclose(results[1][k].numpy(), results[0][k].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


# graph_refusal's cases: (case, what the case changes, the reason it gives)
GRAPH_GATE_CASES = [
    ("cpu", {}, "cpu"),
    ("fp32", {"compute_dtype": torch.float32}, "compute dtype"),
    ("no remat", {"remat": False}, "no remat"),
    ("lora", {"lora": True}, "lora"),
    ("spatial axis", {"spatial": True}, "spatial axis"),
    ("tp axis", {"tp": True}, "tp axis"),
    ("attention sharding", {"attention_sharding": True}, "attention sharding"),
    ("no grad", {"no_grad": True}, "no grad"),
    ("input grad", {"input_grad": True}, "inputs"),
    ("bf16 masters", {"masters": torch.bfloat16}, "masters"),
]


@pytest.mark.parametrize("case,change,reason", GRAPH_GATE_CASES,
                         ids=[c[0] for c in GRAPH_GATE_CASES])
def test_train_apply_graph_gate(case, change, reason):
    """Which calls of make_train_apply's apply would replay CUDA graphs
    (``graph_refusal`` None) and which run eagerly, and why: a remat'd full
    finetune in bf16 over fp32 masters, with no spatial, tp or attention
    axis, gives only "cpu" here (on the card it is None). Every call runs
    eagerly here and counts as such."""
    from ddpo_torch.models.lora import init_lora
    from ddpo_torch.ops.attention import set_attention_sharding
    from ddpo_torch.ops.spatial import Axis
    from ddpo_torch.pipelines import policy_gradient as pg

    _, _, unet = build_models("tiny", "cpu")
    unet.to(change.get("masters", torch.float32))
    if change.get("spatial"):
        unet.set_spatial(Axis("sp", 2, 0))
    if change.get("tp"):
        unet.set_tensor_parallel(Axis("tp", 2, 0))
    params = dict(unet.requires_grad_(True).named_parameters())
    base = None
    if change.get("lora"):
        base = dict(unet.requires_grad_(False).named_parameters())
        params = init_lora(base, 2, torch.Generator().manual_seed(0))
        for p in params.values():
            p.requires_grad_(True)
    compute = change.get("compute_dtype", torch.bfloat16)
    remat = change.get("remat", True)
    inputs = (torch.randn(2, 4, 8, 8, requires_grad=bool(change.get("input_grad"))),
              torch.tensor([901, 601]), torch.randn(2, 77, 32))
    axes = [m for m in unet.modules() if hasattr(m, "spatial") or hasattr(m, "tp")]
    if change.get("attention_sharding"):
        set_attention_sharding(SimpleNamespace(shape={"sp": 2}), seq_axis="sp")
    try:
        with torch.set_grad_enabled(not change.get("no_grad")):
            assert pg.graph_refusal(axes, params, compute, remat, base, inputs) == reason
            if change.get("spatial") or change.get("tp") or change.get("attention_sharding"):
                return  # their collectives need ranks to run
            before = dict(pg.train_graphs)
            make_train_apply(unet, compute, remat, base)(params, *inputs)
    finally:
        set_attention_sharding(None)
    assert pg.train_graphs == dict(before, eager=before["eager"] + 1)
