"""The port's resident inner epoch (``--resident_inner_loop``) against
ddpo_tpu's ``inner_epoch_resident``, on the CPU at fp32 with the tiny UNet.

JAX draws the epoch's permutations from ``jax.random``, which the port
cannot reproduce, so the tests inject JAX's (the split of the epoch key into
the row permutation and one timestep permutation a row) into the port's
``inner_epoch_resident(perm=, t_perms=)``. Both sides train with plain SGD
(optax.sgd and the same step written out here), so a parameter moves by
lr times its gradient and the comparison bounds the gradients' agreement
without adamw's sign amplification of near-zero gradients.

  - against JAX, accumulation 1 and 2: the per-minibatch infos (loss and
    approx_kl rtol 1e-4, clipfrac equal) and the parameters after the
    epoch (atol 1e-6: lr 1e-2 times gradients that agree within 1e-4);
  - against the port's per-timestep loop on the same permutations
    (``inner_epoch_per_timestep``: ``train_step`` on each timestep, the
    gradients summed in the state's buffer, the driver's non-fused loop),
    accumulation 2: the same parameters (atol 1e-6) and the per-minibatch
    means of its infos (rtol 1e-5);
  - batch 2 with accumulation 2 against batch 4 with accumulation 1, as
    tests/test_sampler_and_ppo.py holds JAX's: the same parameters
    (atol 1e-6);
  - the permutations drawn from one seeded generator are the same on every
    call and a permutation;
  - two gloo ranks (dp = 2), each holding half of the samples and
    training its rows of each global minibatch, against one process over
    the whole batch: the same parameters (atol 1e-6), bit-equal on both
    ranks;
  - the driver with ``--resident_inner_loop True`` on the tiny preset: the
    first minibatch on-policy (approx_kl < 1e-6) and the checkpoint.
"""

import functools
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpo_torch.core.scheduler import DDIMScheduler
from ddpo_torch.models.convert import from_flax, to_flax
from ddpo_torch.parallel.launch import launch
from ddpo_torch.pipelines.policy_gradient import make_train_apply
from ddpo_torch.training.policy_gradient import (
    AccumulatingTrainState,
    draw_permutations,
    inner_epoch_per_timestep,
    inner_epoch_resident,
)
from ddpo_torch.utils.serialization import build_models, init_weights_
from ddpo_tpu.training.policy_gradient import AccumulatingTrainState as JaxState
from ddpo_tpu.training.policy_gradient import inner_epoch_resident as j_inner_epoch_resident
from ddpo_tpu.utils.serialization import _tiny_stack, sd_scheduler

from test_torch_distributed import _host, worker_env

B, T, TRAIN_TS, STEPS = 4, 3, 2, 10
LR, CLIP, GUIDANCE = 1e-2, 1e-2, 5.0
COMMON = dict(num_train_ts=TRAIN_TS, train_cfg=True, guidance_scale=GUIDANCE, eta=1.0,
              clip_range=CLIP, cfg_concat=True)



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, for the module's fixtures too: the suite runs
    several workers at once, where spinning OpenMP threads oversubscribe
    the cores (a tiny epoch took 10x longer with eight threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class SGD:
    """p -= lr * g, optax.sgd's step."""

    def init(self, params):
        return {"count": 0}

    def step(self, params, grads, state):
        for k, p in params.items():
            p.add_(-LR * grads[k])
        state["count"] += 1


@torch.no_grad()
def _samples(unet):
    """B trajectories of T steps whose next latents come from the policy
    (the port's UNet and scheduler) and whose old log-probs sit inside and
    outside the clip range."""
    rng = np.random.default_rng(0)
    ddim, state = _sched()
    ts = state.timesteps[:T].to(torch.int32)
    out = {
        "latents": torch.from_numpy(rng.standard_normal((B, T, 4, 8, 8)).astype(np.float32)),
        "ts": ts.repeat(B, 1),
        "advantages": torch.tensor([1.5, -0.7, 0.4, -1.2]),
        "embeds": torch.from_numpy(rng.standard_normal((B, 77, 32)).astype(np.float32)),
        "uncond_embeds": torch.from_numpy(
            rng.standard_normal((1, 77, 32)).astype(np.float32)).repeat(B, 1, 1),
    }
    nxt, old = [], []
    for j in range(T):
        x, t = out["latents"][:, j], out["ts"][:, j]
        eps_u, eps_c = unet(torch.cat([x, x]), torch.cat([t, t]),
                            torch.cat([out["uncond_embeds"], out["embeds"]])).chunk(2)
        eps = eps_u + GUIDANCE * (eps_c - eps_u)
        noise = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
        mean, std = ddim.step_mean_std(state, eps, t, x, eta=1.0)
        n, lp = ddim.step(state, eps, t, x, prev_sample=mean + std * noise, eta=1.0)
        nxt.append(n)
        old.append(lp + torch.tensor([0.3, -3.0, -0.3, 3.0]) * CLIP * (1 if j % 2 else -1))
    out["next_latents"] = torch.stack(nxt, 1)
    out["log_probs"] = torch.stack(old, 1)
    return out


def _jax_permutations(rng, total_b, num_timesteps):
    """The permutations JAX's inner_epoch_resident draws from ``rng``."""
    perm_key, ts_key = jax.random.split(rng)
    perm = jax.random.permutation(perm_key, total_b)
    t_perms = jax.vmap(lambda k: jax.random.permutation(k, num_timesteps))(
        jax.random.split(ts_key, total_b))
    return np.asarray(perm), np.asarray(t_perms)


@pytest.fixture(scope="module")
def setup():
    _, _, unet = build_models("tiny", "cpu")
    init_weights_(unet, torch.Generator().manual_seed(3))
    samples = _samples(unet)
    params = to_flax(unet.state_dict(), unet)
    j_unet = _tiny_stack(jnp.float32)[2]
    sched = sd_scheduler()
    sched_state = sched.set_timesteps(sched.create_state(), STEPS)
    rng = jax.random.PRNGKey(11)
    ref = {}
    for bs, acc in ((2, 1), (2, 2)):
        state = JaxState.create(apply_fn=lambda p, x, t, c: j_unet.apply({"params": p}, x, t, c),
                                params=params, tx=optax.sgd(LR), accumulate=acc > 1)
        run = jax.jit(functools.partial(j_inner_epoch_resident, scheduler=sched,
                                        train_batch_size=bs, accumulation_steps=acc, **COMMON))
        new, infos = run(state, {k: jnp.asarray(v.numpy()) for k, v in samples.items()},
                         sched_state, rng)
        ref[bs, acc] = {"params": {k: v.numpy() for k, v in
                                   from_flax({"unet": _host(new.params)})["unet"].items()},
                        "infos": _host(infos)}
    perm, t_perms = _jax_permutations(rng, B, T)
    return SimpleNamespace(unet_sd={k: v.clone() for k, v in unet.state_dict().items()},
                           ref=ref, samples=samples,
                           perm=torch.from_numpy(np.array(perm)).long(),
                           t_perms=torch.from_numpy(np.array(t_perms)).long())


def _port_state(setup, acc):
    _, _, unet = build_models("tiny", "cpu")
    unet.load_state_dict(setup.unet_sd)
    params = dict(unet.requires_grad_(True).named_parameters())
    return AccumulatingTrainState(apply_fn=make_train_apply(unet, torch.float32, remat=False),
                                  params=params, tx=SGD(), accumulate=acc > 1)


def _sched():
    ddim = DDIMScheduler()
    return ddim, ddim.set_timesteps(ddim.create_state(), STEPS)


def _resident(setup, bs, acc, **kw):
    ddim, ddim_state = _sched()
    kw = kw or dict(perm=setup.perm, t_perms=setup.t_perms)
    return inner_epoch_resident(_port_state(setup, acc), setup.samples, ddim_state, ddim,
                                train_batch_size=bs, accumulation_steps=acc, **COMMON, **kw)


def _params(state):
    return {k: p.detach().numpy() for k, p in state.params.items()}


@pytest.mark.parametrize("acc", [1, 2])
def test_resident_epoch_matches_jax(setup, acc):
    state, infos = _resident(setup, 2, acc)
    ref = setup.ref[2, acc]
    assert state.step == B // 2 // acc and infos["loss"].shape == (B // 2,)
    for k in ("loss", "approx_kl"):
        np.testing.assert_allclose(infos[k].numpy(), ref["infos"][k], rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_array_equal(infos["clipfrac"].numpy(), ref["infos"]["clipfrac"])
    assert 0 < infos["clipfrac"].numpy().max()  # the batch reaches the clip
    got = _params(state)
    moved = 0.0
    for k, r in ref["params"].items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-6, err_msg=k)
        moved = max(moved, float(np.abs(r - setup.unet_sd[k].numpy()).max()))
    assert moved > 1e-4  # the epoch trained


def test_resident_matches_the_per_timestep_loop(setup):
    state, infos = _resident(setup, 2, 2)
    ddim, ddim_state = _sched()
    host, host_infos = inner_epoch_per_timestep(
        _port_state(setup, 2), setup.samples, ddim_state, ddim, train_batch_size=2,
        perm=setup.perm, t_perms=setup.t_perms, accumulation_steps=2, **COMMON)
    assert state.step == host.step == B // 2 // 2
    a, b = _params(state), _params(host)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
    for k, v in infos.items():
        per_batch = host_infos[k].reshape(B // 2, TRAIN_TS).mean(1)
        np.testing.assert_allclose(v.numpy(), per_batch.numpy(), rtol=1e-5, atol=1e-9, err_msg=k)


def test_resident_accumulation_matches_larger_batch(setup):
    acc, _ = _resident(setup, 2, 2)
    big, _ = _resident(setup, 4, 1)
    a, b = _params(acc), _params(big)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)


def test_drawn_permutations_repeat_with_the_seed():
    draws = [draw_permutations(6, 5, torch.Generator().manual_seed(4), "cpu") for _ in range(2)]
    (p0, t0), (p1, t1) = draws
    assert torch.equal(p0, p1) and torch.equal(t0, t1)
    assert sorted(p0.tolist()) == list(range(6))
    assert all(sorted(row) == list(range(5)) for row in t0.tolist())


# ------------------------- two ranks: dp = 2 ------------------------- #

DP2 = r'''
import contextlib, io
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from ddpo_torch.core.scheduler import DDIMScheduler
from ddpo_torch.parallel import MeshConfig, create_mesh, maybe_initialize_distributed
from ddpo_torch.parallel.collectives import GradientAllReduce
from ddpo_torch.pipelines import policy_gradient
from ddpo_torch.pipelines.policy_gradient import make_train_apply
from ddpo_torch.training.policy_gradient import AccumulatingTrainState, inner_epoch_resident
from ddpo_torch.utils.serialization import build_models, init_weights_

maybe_initialize_distributed()
rank = dist.get_rank()
mesh = create_mesh(MeshConfig(), torch.device("cpu"))
inputs = torch.load("inputs.pt", weights_only=False)


class SGD:
    def init(self, params):
        return {"count": 0}

    def step(self, params, grads, state):
        for k, p in params.items():
            p.add_(-inputs["lr"] * grads[k])


_, _, unet = build_models("tiny", "cpu")
unet.load_state_dict(inputs["unet"])
params = dict(unet.requires_grad_(True).named_parameters())
state = AccumulatingTrainState(apply_fn=make_train_apply(unet, torch.float32, remat=False),
                               params=params, tx=SGD(), accumulate=False,
                               grad_reduce=GradientAllReduce(None, "gloo"))
ddim = DDIMScheduler()
ddim_state = ddim.set_timesteps(ddim.create_state(), inputs["steps"])
# each rank's half of the samples, gathered back as the driver gathers them
mine = {k: v.chunk(2)[rank] for k, v in inputs["samples"].items()}
whole = {}
for k, v in mine.items():
    parts = [torch.empty_like(v) for _ in range(2)]
    dist.all_gather(parts, v.contiguous())
    whole[k] = torch.cat(parts)
state, infos = inner_epoch_resident(state, whole, ddim_state, ddim, train_batch_size=4,
                                    perm=inputs["perm"], t_perms=inputs["t_perms"],
                                    dp=(mesh.dp, mesh.dp_index), **inputs["common"])
out = {"params": {k: p.detach().clone() for k, p in params.items()}, "infos": infos,
       "gathered_equal": all(torch.equal(whole[k], inputs["samples"][k]) for k in whole)}
torch.save(out, f"dp2_{rank}.pt")
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def dp2(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resident_dp2")
    torch.save({"unet": setup.unet_sd, "samples": setup.samples, "perm": setup.perm,
                "t_perms": setup.t_perms, "lr": LR, "steps": STEPS, "common": COMMON},
               tmp / "inputs.pt")
    path = tmp / "worker.py"
    path.write_text(DP2)
    results = launch([sys.executable, str(path)], 2, timeout=240, env=worker_env(),
                     cwd=str(tmp))
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return [torch.load(tmp / f"dp2_{r}.pt", weights_only=False) for r in range(2)]


def test_dp2_ranks_equal_one_process_over_the_whole_batch(setup, dp2):
    whole, _ = _resident(setup, 4, 1)
    want = _params(whole)
    assert all(r["gathered_equal"] for r in dp2)
    for r in dp2:
        for k, w in want.items():
            np.testing.assert_allclose(r["params"][k].numpy(), w, rtol=0, atol=1e-6, err_msg=k)
    a, b = dp2[0]["params"], dp2[1]["params"]
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_driver_resident_epoch(tmp_path, monkeypatch):
    import importlib

    import ddpo_torch.config.base as base
    import ddpo_torch.config.user as user
    from ddpo_torch.pipelines import policy_gradient
    from ddpo_torch.utils.checkpoints import restore_train_state

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DDPO_BUCKET", "bucket")
    importlib.reload(user)
    importlib.reload(base)
    try:
        policy_gradient.main(["--dataset", "debug-animals", "--device", "cpu",
                              "--n_inference_steps", "2", "--resolution", "32",
                              "--sample_batch_size", "4", "--train_batch_size", "2",
                              "--num_train_epochs", "1", "--resident_inner_loop", "True"])
    finally:
        monkeypatch.undo()
        importlib.reload(user)
        importlib.reload(base)
    (found,) = tmp_path.glob("logs/**/train_info/0_0_0.npy")
    infos = np.load(found, allow_pickle=True).item()
    assert infos["loss"].shape == (2,) and infos["approx_kl"][0] < 1e-6
    (ckpt,) = tmp_path.glob("bucket/**/checkpoints")
    restored, step = restore_train_state(str(ckpt.parent))
    assert step == 0 and restored["host"]["train_generator"] is not None
