"""The port's data parallelism over torch.distributed, on the CPU with gloo.

The port of tests/test_multiprocess.py: pairs of worker processes started by
``ddpo_torch.parallel.launch`` (a free port from bind(("127.0.0.1", 0)),
each rank's own timeout, ``destroy_process_group`` at the end). Workers
import ddpo_torch only; this process does the JAX side.

  - the collectives: worker_sum, sharded_softmax against softmax_ref of the
    concatenation (atol 1e-7: fp32 exp over fp32 sums), the allgathers,
    all_processes_equal raising on a diverged tree, the broadcast of
    sync_state_across_devices, the seeds per rank (with --seed unset too),
    the backend chosen on the CPU, and a two-rank DDPO epoch whose ranks
    draw different sampler noise and report the same rewards;
  - one update against ddpo_tpu's on a dp = 2 mesh over two of conftest's
    virtual CPU devices: JAX's step takes the global batch of 4, each port
    rank its 2 rows. DDPO's ``train_step_fused`` plain (fp32 gradient
    mean) and with ``grad_reduce_dtype=bfloat16``; RWR's
    ``training/diffusion.py::train_step`` unweighted (ranks average) and
    weighted (ranks sum: averaging would halve every gradient, 50% off),
    without train-time CFG (test_torch_rwr.py holds the CFG forms in one
    process; one UNet apply halves JAX's compile here).
    Bounds: fp32 gradients max|d| <= 1e-5 of the leaf set's max|g|
    (measured 5.2e-6 DDPO, 3.1e-6 and 3.4e-6 RWR unweighted and weighted); bf16
    gradients per element 2^-7 |g| + 2^-8 of the leaf's max|g| (each side
    rounds its own fp32 local means; ``test_reduced_gradients_match_jax``);
    the params after one clip + adamw step within the bound that each
    side's own gradient allows (``test_updated_params_match_jax``: near-zero
    gradients make adamw's step a sign, so no bound relative to max|param|
    holds there). The ranks' results are bit-equal to each other.
"""

import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ddpo_torch.models.convert import from_flax
from ddpo_torch.parallel import softmax_ref
from ddpo_torch.parallel.launch import launch
from ddpo_tpu.core.scheduler import DDPMScheduler as JaxDDPM
from ddpo_tpu.models.tokenizer import HashTokenizer
from ddpo_tpu.training import diffusion as j_diffusion
from ddpo_tpu.training.optim import build_optimizer as jax_build_optimizer
from ddpo_tpu.training.policy_gradient import AccumulatingTrainState as JaxState
from ddpo_tpu.training.policy_gradient import train_step_fused as jax_train_step_fused
from ddpo_tpu.utils.serialization import _tiny_stack, sd_scheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, STEPS, CLIP, GUIDANCE = 4, 10, 1e-2, 5.0
TS = [901, 601, 301]
OPT = dict(learning_rate=1e-4, beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=1e-4,
           max_grad_norm=1.0, lr_schedule="constant", lr_warmup_steps=0,
           lr_total_steps=None, optimizer="adamw")


def worker_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", DDPO_BUCKET="bucket")
    return env


def run_pair(tmp_path, script: str, *args, timeout: float = 240):
    """Two ranks of ``script`` in ``tmp_path``; fails unless both exit 0."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    results = launch([sys.executable, str(path), *map(str, args)], 2, timeout=timeout,
                     env=worker_env(), cwd=str(tmp_path))
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return [out for _, out in results]


COLLECTIVES = r'''
import contextlib, io, json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from ddpo_torch.parallel import (all_gather_array, all_gather_strings, all_processes_equal,
    gradient_group, maybe_initialize_distributed, process_count, process_index,
    sharded_softmax, sync_state_across_devices, worker_sum)
from ddpo_torch.pipelines import policy_gradient
from ddpo_torch.utils.parser import Parser

maybe_initialize_distributed()
rank = process_index()
out = {"count": process_count(), "worker_sum": worker_sum(1 + rank),
       "worker_sum_array": worker_sum(np.arange(3) * (rank + 1)).tolist()}
x = torch.from_numpy(np.random.default_rng(rank).standard_normal(4).astype(np.float32))
out["softmax"] = sharded_softmax(x, temperature=2.0).tolist()
out["gather"] = all_gather_array(np.full((2, 3), rank)).tolist()
out["strings"] = all_gather_strings([f"r{rank}"] + ["x"] * rank)
out["equal_digest"] = all_processes_equal({"a": torch.ones(3), "b": np.arange(4)}, "same")
try:
    all_processes_equal({"a": torch.full((3,), float(rank))}, "diverged")
    out["diverged_raised"] = ""
except RuntimeError as e:
    out["diverged_raised"] = str(e)
state = {"w": torch.full((5,), float(rank)), "b": torch.arange(3.0) + 10 * rank}
sync_state_across_devices(state)
out["synced"] = {k: v.tolist() for k, v in state.items()}
out["backend"] = gradient_group(torch.device("cpu"))[1]
for seed in ("7", "None"):
    args = Parser().parse_args("pg", ["--dataset", "debug-animals", "--device", "cpu",
                                      "--seed", seed])
    out[f"seed_{seed}"] = [args.base_seed, args.seed]
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    out["rewards"] = policy_gradient.main([
        "--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
        "--resolution", "32", "--sample_batch_size", "2", "--train_batch_size", "1",
        "--num_train_epochs", "1"])
out["noise"] = [l.split("initial noise digest ")[1] for l in printed.getvalue().splitlines()
                if "initial noise digest" in l]
out["params_digest"] = [l for l in printed.getvalue().splitlines() if "params digest" in l]
with open(f"collectives_{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    run_pair(tmp, COLLECTIVES)
    return [json.loads((tmp / f"collectives_{r}.json").read_text()) for r in range(2)]


def test_worker_sum(collectives):
    for out in collectives:
        assert out["count"] == 2
        assert out["worker_sum"] == 3.0
        assert out["worker_sum_array"] == [0.0, 3.0, 6.0]


def test_sharded_softmax_is_softmax_of_the_concatenation(collectives):
    x = np.concatenate([np.random.default_rng(r).standard_normal(4).astype(np.float32)
                        for r in range(2)])
    ref = softmax_ref(x.astype(np.float64), temperature=2.0)
    got = np.concatenate([out["softmax"] for out in collectives])
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)
    assert abs(got.sum() - 1.0) < 1e-6


def test_allgathers(collectives):
    for out in collectives:
        assert out["gather"] == [[0] * 3, [0] * 3, [1] * 3, [1] * 3]
        assert out["strings"] == ["r0", "r1", "x"]


def test_all_processes_equal_raises_on_divergence(collectives):
    assert collectives[0]["equal_digest"] == collectives[1]["equal_digest"]
    for out in collectives:
        assert "diverged diverged across processes" in out["diverged_raised"]


def test_sync_state_broadcasts_rank0(collectives):
    for out in collectives:
        assert out["synced"] == {"w": [0.0] * 5, "b": [0.0, 1.0, 2.0]}


def test_seed_per_rank(collectives):
    for rank, out in enumerate(collectives):
        assert out["seed_7"] == [7, 7 + rank]
    drawn = collectives[0]["seed_None"][0]
    for rank, out in enumerate(collectives):
        assert out["seed_None"] == [drawn, drawn + rank]  # rank 0's draw, broadcast


def test_backend_on_the_cpu_is_gloo(collectives):
    assert [out["backend"] for out in collectives] == ["gloo", "gloo"]


def test_ddpo_epoch_noise_differs_rewards_agree(collectives):
    noise = [out["noise"] for out in collectives]
    assert len(noise[0]) == 1 and noise[0] != noise[1]
    assert collectives[0]["rewards"] == collectives[1]["rewards"]
    assert collectives[0]["params_digest"] == collectives[1]["params_digest"]
    assert len(collectives[0]["params_digest"]) == 1


# ------------------------------ one update vs JAX ------------------------------ #

UPDATE = r'''
import sys
from types import SimpleNamespace
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from ddpo_torch.core.scheduler import DDIMScheduler, DDPMScheduler
from ddpo_torch.parallel import GradientAllReduce, maybe_initialize_distributed, process_index
from ddpo_torch.pipelines.policy_gradient import make_train_apply
from ddpo_torch.training import diffusion
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import AccumulatingTrainState, train_step_fused
from ddpo_torch.utils.serialization import build_models

maybe_initialize_distributed()
rank = process_index()
inputs = torch.load("inputs.pt", weights_only=False)
rows = slice(2 * rank, 2 * rank + 2)
ddim, ddpm = DDIMScheduler(), DDPMScheduler()
ddim_state = ddim.set_timesteps(ddim.create_state(), 10)


class Recorder:
    """The port's optimizer, keeping the (reduced) gradients it is given."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def init(self, params):
        return self.tx.init(params)

    def step(self, params, grads, state):
        self.grads = {k: g.clone() for k, g in grads.items()}
        self.tx.step(params, grads, state)


def run(case, tx):
    text, _, unet = build_models("tiny", "cpu")
    unet.load_state_dict(inputs["unet"])
    text.load_state_dict(inputs["text"])
    params = dict(unet.requires_grad_(True).named_parameters())
    dtype = torch.bfloat16 if case == "ddpo_bf16" else None
    state = AccumulatingTrainState(
        apply_fn=make_train_apply(unet, torch.float32, remat=False), params=params, tx=tx,
        accumulate=False, grad_reduce=GradientAllReduce(None, "gloo", dtype))
    if case.startswith("ddpo"):
        b = inputs["ddpo"]
        local = {k: (v[:, rows] if k in ("latents", "next_latents", "ts", "log_probs")
                     else v[rows]) for k, v in b.items()}
        train_step_fused(state, local, ddim_state, ddim, True, 5.0, 1.0, 1e-2,
                         do_opt_update=True, cfg_concat=True)
    else:
        b = inputs["rwr"]
        draws = diffusion.Draws(*(d[rows] for d in b["draws"]))
        weights = b["weights"][rows] if case == "rwr_weighted" else None
        batch = {k: b[k][rows] for k in ("vae", "input_ids", "uncond_text")}
        diffusion.train_step(state, text, batch, ddpm.create_state(), ddpm, False, 5.0,
                             weights=weights, draws=draws)
    return {k: p.detach().clone() for k, p in params.items()}


out = {}
opt = SimpleNamespace(**inputs["opt"])
for case in ("ddpo", "ddpo_bf16", "rwr", "rwr_weighted"):
    rec = Recorder(build_optimizer(opt))
    out[case] = {"params": run(case, rec), "grads": rec.grads}
torch.save(out, f"update_{rank}.pt")
dist.destroy_process_group()
'''


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ddpo_batch(unet, params, sched, sched_state):
    """A global batch of 4 whose next_latents come from the policy and whose
    old log-probs sit inside and outside the clip range."""
    rng = np.random.default_rng(0)
    t_n = len(TS)
    batch = {
        "latents": rng.standard_normal((t_n, B, 4, 8, 8)).astype(np.float32),
        "ts": np.array([[t, TS[(i + 1) % t_n]] * 2 for i, t in enumerate(TS)], np.int32),
        "advantages": np.array([1.5, -0.7, 0.4, -1.2], np.float32),
        "prompt_embeds": rng.standard_normal((B, 77, 32)).astype(np.float32),
        "uncond_embeds": rng.standard_normal((B, 77, 32)).astype(np.float32),
    }
    apply = jax.jit(lambda p, x, t, c: unet.apply({"params": p}, x, t, c))
    nxt, old = [], []
    for i in range(t_n):
        x, ts = jnp.asarray(batch["latents"][i]), jnp.asarray(batch["ts"][i])
        eps_u = apply(params, x, ts, jnp.asarray(batch["uncond_embeds"]))
        eps_c = apply(params, x, ts, jnp.asarray(batch["prompt_embeds"]))
        eps = eps_u + GUIDANCE * (eps_c - eps_u)
        noise = jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))
        mean, std = sched.step_mean_std(sched_state, eps, ts, x, eta=1.0)
        n, lp = sched.step(sched_state, eps, ts, x, prev_sample=mean + std * noise, eta=1.0)
        nxt.append(np.asarray(n))
        old.append(np.asarray(lp) + np.array([0.3, -3.0, -0.3, 3.0]) * CLIP * (1 if i % 2 else -1))
    batch["next_latents"] = np.stack(nxt)
    batch["log_probs"] = np.stack(old).astype(np.float32)
    return batch


def _recording_tx():
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, state, params=None: (zeros(g), g))


def _adamw_step(params, grads, opt):
    """JAX's clip + adamw on the step's own (reduced) gradients: what its
    ``apply_gradients`` does with ``build_optimizer``."""
    tx = jax_build_optimizer(opt)

    def step(p, g):
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, updates)

    return _host(jax.jit(step)(params, grads))


@pytest.fixture(scope="module")
def update(tmp_path_factory):
    """JAX's global step on a dp = 2 mesh, and the two port ranks' step."""
    j_text, _, j_unet = _tiny_stack(jnp.float32)
    k_unet, k_text = jax.random.split(jax.random.PRNGKey(5))
    params = _host(jax.jit(j_unet.init)(k_unet, jnp.zeros((1, 4, 8, 8)),
                                        jnp.zeros((1,), jnp.int32),
                                        jnp.zeros((1, 77, 32)))["params"])
    text_params = _host(jax.jit(j_text.init)(k_text, jnp.zeros((1, 77), jnp.int32))["params"])
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1, 1), ("dp", "sp", "tp"))
    opt = SimpleNamespace(**OPT)

    # DDPO: train_step_fused over the global batch, batch axis on dp
    sched = sd_scheduler()
    sched_state = sched.set_timesteps(sched.create_state(), STEPS)
    ddpo = _ddpo_batch(j_unet, params, sched, sched_state)
    per_t = ("latents", "next_latents", "ts", "log_probs")
    placed = {k: jax.device_put(v, NamedSharding(mesh, P(None, "dp") if k in per_t else P("dp")))
              for k, v in ddpo.items()}
    apply = lambda p, x, t, c: j_unet.apply({"params": p}, x, t, c)  # noqa: E731

    def ddpo_step(tx, **kw):
        state = JaxState.create(apply_fn=apply, params=params, tx=tx, accumulate=False)
        step = jax.jit(lambda st, b, ss: jax_train_step_fused(
            st, b, ss, sched, True, GUIDANCE, 1.0, CLIP, do_opt_update=True, cfg_concat=True,
            **kw))
        return step(state, placed, sched_state)[0]

    ref = {}
    for case, kw in (("ddpo", {}),
                     ("ddpo_bf16", dict(grad_reduce_mesh=mesh, grad_reduce_dtype=jnp.bfloat16))):
        grads = _host(ddpo_step(_recording_tx(), **kw).opt_state)
        ref[case] = {"grads": grads, "params": _adamw_step(params, grads, opt)}

    # RWR: diffusion.train_step over the global batch, JAX's own draws
    rng = np.random.default_rng(5)
    tok = HashTokenizer()
    moments = rng.standard_normal((B, 8, 8, 8)).astype(np.float32)
    moments[..., 4:] = -2.0 + 0.5 * moments[..., 4:]
    prompts = ["a cat", "an otter on a rock", "a dog", "a heron"]
    rwr = {"vae": moments, "input_ids": tok(prompts), "uncond_text": tok([""] * B)}
    weights = softmax_ref(np.array([0.2, -1.0, 1.5, 0.3]), temperature=1.0).astype(np.float32)
    key = jax.random.PRNGKey(9)
    j_sched = JaxDDPM()
    text_apply = lambda p, ids: j_text.apply({"params": p}, ids)  # noqa: E731
    dp = NamedSharding(mesh, P("dp"))
    rwr_placed = {k: jax.device_put(v, dp) for k, v in rwr.items()}

    def rwr_step(tx, w):
        state = TrainState.create(apply_fn=apply, params=params, tx=tx)
        step = jax.jit(lambda st, b, r, ss, w: j_diffusion.train_step(
            st, text_apply, text_params, b, r, ss, j_sched, False, GUIDANCE, weights=w))
        return step(state, rwr_placed, key, j_sched.create_state(),
                    None if w is None else jax.device_put(w, dp))[0]

    for case, w in (("rwr", None), ("rwr_weighted", weights)):
        grads = _host(rwr_step(_recording_tx(), w).opt_state)
        ref[case] = {"grads": grads, "params": _adamw_step(params, grads, opt)}
    sample_rng, noise_rng, timestep_rng, _ = jax.random.split(key, 4)
    draws = (np.asarray(jax.random.normal(sample_rng, (B, 8, 8, 4))),
             np.asarray(jax.random.normal(noise_rng, (B, 4, 8, 8))),
             np.asarray(jax.random.randint(timestep_rng, (B,), 0, 1000)))

    tmp = tmp_path_factory.mktemp("update")
    state = from_flax({"unet": params, "text_encoder": text_params})
    torch.save({
        "unet": state["unet"], "text": state["text_encoder"], "opt": OPT,
        "ddpo": {k: torch.from_numpy(np.asarray(v)) for k, v in ddpo.items()},
        "rwr": {"vae": torch.from_numpy(moments),
                "input_ids": torch.from_numpy(np.asarray(rwr["input_ids"])),
                "uncond_text": torch.from_numpy(np.asarray(rwr["uncond_text"])),
                "weights": torch.from_numpy(weights),
                "draws": tuple(torch.from_numpy(np.array(d)) for d in draws)},
    }, tmp / "inputs.pt")
    run_pair(tmp, UPDATE)
    ranks = [torch.load(tmp / f"update_{r}.pt", weights_only=False) for r in range(2)]
    return SimpleNamespace(ref=ref, ranks=ranks, params=params)


def _port(tree):
    return {k: v.numpy() for k, v in tree.items()}


def _jax(tree):
    return {k: v.numpy() for k, v in from_flax({"unet": tree})["unet"].items()}


CASES = ["ddpo", "ddpo_bf16", "rwr", "rwr_weighted"]


@pytest.mark.parametrize("case", CASES)
def test_ranks_end_bit_equal(update, case):
    for what in ("grads", "params"):
        a, b = _port(update.ranks[0][case][what]), _port(update.ranks[1][case][what])
        assert all(np.array_equal(a[k], b[k]) for k in a), (case, what)


@pytest.mark.parametrize("case", CASES)
def test_reduced_gradients_match_jax(update, case):
    got, ref = _port(update.ranks[0][case]["grads"]), _jax(update.ref[case]["grads"])
    assert set(got) == set(ref)
    gmax = max(np.abs(r).max() for r in ref.values())
    assert gmax > 1e-6  # a real gradient flowed
    for k, r in ref.items():
        if case == "ddpo_bf16":
            # each side rounds its own fp32 local means to bf16: a rounding
            # may flip, one ulp of a local value (bounded by the leaf's
            # largest), and the sum's, two ulps of the element
            atol = 2.0 ** -8 * np.abs(r).max() + 1e-5 * gmax
            np.testing.assert_allclose(got[k], r, rtol=2.0 ** -7, atol=atol, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-5 * gmax, err_msg=k)


def _clip(grads, max_norm):
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in grads.values()))
    return {k: g * min(1.0, max_norm / norm) for k, g in grads.items()}


@pytest.mark.parametrize("case", CASES)
def test_updated_params_match_jax(update, case):
    """One clip + adamw step moves each element by lr * (u + wd * p), u =
    m/(sqrt(v) + eps) of the clipped gradient, m stored in bf16 (both
    packages). Given each side's own reduced gradient, the params may differ
    by lr * |u_port - u_jax| (u from the fp32 gradients), lr * 2^-7 (the
    bf16 first moment rounded on each side), and 2 ulps of the param."""
    got, ref = _port(update.ranks[0][case]["params"]), _jax(update.ref[case]["params"])
    before = _jax(update.params)
    gt = _clip(_port(update.ranks[0][case]["grads"]), OPT["max_grad_norm"])
    gj = _clip(_jax(update.ref[case]["grads"]), OPT["max_grad_norm"])
    lr, eps = OPT["learning_rate"], OPT["epsilon"]
    for k, p in before.items():
        u_t, u_j = gt[k] / (np.abs(gt[k]) + eps), gj[k] / (np.abs(gj[k]) + eps)
        bound = lr * (np.abs(u_t - u_j) + 2.0 ** -7) + 2 * np.spacing(np.abs(p))
        diff = np.abs(got[k] - ref[k])
        assert (diff <= bound).all(), (k, float((diff - bound).max()))
        assert not np.array_equal(got[k], p), k  # every param moved


def test_weighted_rwr_sums_over_ranks(update):
    """The weighted step's gradient is the ranks' sum: against JAX's global
    step, an average over ranks would be off by a factor 2 on every leaf."""
    got = _port(update.ranks[0]["rwr_weighted"]["grads"])
    ref = _jax(update.ref["rwr_weighted"]["grads"])
    num = sum(float(np.vdot(got[k], ref[k])) for k in ref)
    den = sum(float(np.vdot(ref[k], ref[k])) for k in ref)
    assert abs(num / den - 1.0) < 1e-4  # 0.5 if the ranks averaged
