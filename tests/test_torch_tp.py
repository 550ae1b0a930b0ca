"""The port's tp mesh axis against ddpo_tpu's, on the CPU at fp32.

Two UNets: the tiny preset (JAX's TINY: channels (32, 64), 2 heads, 4
transformer blocks) and the SD head geometry of tests/test_tp_full_geometry.py
(channels (320, 640), 8 heads, D = 40 / 80, 768-dim context, GEGLU, 8x8
latents, 7 transformer blocks). Biases are drawn nonzero, so a bias added
on every rank instead of once would show.

In one process:
  - the partition rules: for every UNet parameter the port's rule splits the
    same axis of the same global tensor as JAX's ``param_specs``;
  - the GEGLU: rank r holds rows hidden[r] and gate[r] of ff.net.0.proj
    and the matching input columns of ff.net.2, and joining the ranks'
    slices gives the whole state dict back bit for bit (tp 2 and 4);
  - a tp axis of size 1 leaves the UNet as it is;
  - the gathered state at tp = 2 (from the ranks below) resumes at tp = 1
    to the same parameters and optimizer state, bit for bit.

Two gloo ranks (dp = 1 x tp = 2), through ``ddpo_torch.parallel.launch``,
launched once:
  - the tiny forward against JAX's replicated ``unet_apply``, rtol 2e-4 and
    atol 2e-5 (tests/test_parallel.py:130's bounds), and the gathered
    gradients of mean(eps^2) within 1e-5 of max|g|; a deliberately
    contiguous GEGLU shard (JAX's global rule without GSPMD's reshard)
    fails the forward comparison, so the test sees that trap;
  - the collectives: 12 forward all-reduces (3 a block) and 12 backward
    ones at the tiny preset, 21 and 21 at the SD geometry (its PPO step);
  - at the SD geometry the forward at the same bounds, one PPO step's loss
    at rtol 1e-5 (tests/test_tp_full_geometry.py:83-133), its gathered
    gradients within 1e-5 of max|g|, and the gathered parameters after one
    clip + adamw and one clip + adafactor step within 1e-6 of optax's
    update from the same gradients (the optimizers' whole-tensor reductions
    over the group: the norm, adafactor's factored means and RMS);
  - a tp = 1 state loaded at tp = 2 and gathered back equals itself;
  - the driver with ``--mesh_tp 2``: the same seed, noise, rewards and
    gathered digest on both ranks, the tp collectives line; the test then
    resumes its checkpoint at tp = 1.

Four gloo ranks (dp = 2 x tp = 2), launched once:
  - one ``train_step_fused`` update against JAX's global step: the loss
    (the dp slices' mean) at rtol 1e-5; the reduced gradients (each rank's
    slices) are the slices of JAX's, within 1e-5 of max|g| (a reduce over
    the world would average different slices); the reduce runs over the
    two ranks of a dp group; the gathered parameters within 1e-6 of
    optax's clip + adamw on the same gradients, and bit-equal on every
    rank;
  - tp = 4 over the tiny UNet's 2 heads (JAX's fallback: the heads do not
    divide, q/k/v gathered): the forward against JAX's, rtol 2e-4 atol 2e-5;
  - the driver with ``--mesh_tp 2``: the tp ranks of a dp slice draw the
    same noise, the dp slices different noise.
"""

import contextlib
import importlib
import io
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddpo_torch.models.convert import flax_path_to_torch_key, from_flax, to_flax
from ddpo_torch.models.unet import UNet2DCondition, UNetConfig
from ddpo_torch.ops.spatial import Axis
from ddpo_torch.parallel import digest
from ddpo_torch.parallel.sharding import Shard, param_specs, shard_state_dict
from ddpo_torch.pipelines.policy_gradient import make_train_apply
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import AccumulatingTrainState
from ddpo_tpu.models import UNet2DCondition as JaxUNet
from ddpo_tpu.models import UNetConfig as JaxUNetConfig
from ddpo_tpu.parallel.sharding import param_specs as j_param_specs
from ddpo_tpu.training.optim import build_optimizer as jax_build_optimizer
from ddpo_tpu.training.policy_gradient import AccumulatingTrainState as JaxState
from ddpo_tpu.training.policy_gradient import train_step as j_train_step
from ddpo_tpu.training.policy_gradient import train_step_fused as j_train_step_fused
from ddpo_tpu.utils.serialization import sd_scheduler

from test_torch_distributed import (  # noqa: F401  (helpers, no tests)
    CLIP,
    GUIDANCE,
    OPT,
    STEPS,
    _ddpo_batch,
    _host,
    _recording_tx,
)
from test_torch_spatial import run_ranks

GEOMETRY = dict(sample_size=8, block_out_channels=(320, 640), layers_per_block=1,
                attention_heads=8, cross_attention_dim=768, down_block_has_attn=(True, True))
TINY = dict(sample_size=8, block_out_channels=(32, 64), layers_per_block=1, attention_heads=2,
            cross_attention_dim=32, down_block_has_attn=(True, False))
PPO_CLIP = 1e-2



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, for the module's fixtures too: the suite runs
    several workers at once, where spinning OpenMP threads oversubscribe
    the cores (a tiny epoch took 10x longer with eight threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _port_unet(config: dict, seed: int) -> UNet2DCondition:
    """A UNet of ``config`` with random weights (normal, scaled by the fan
    in), norm scales near 1 and every bias nonzero."""
    unet = UNet2DCondition(UNetConfig(**config))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() > 1:
                p.copy_(noise * p[0].numel() ** -0.5)
            else:
                p.copy_(0.05 * noise + (0.0 if name.endswith("bias") else 1.0))
    return unet


def _jax_apply(config: dict):
    model = JaxUNet(JaxUNetConfig(**config))
    return jax.jit(lambda p, x, t, c: model.apply({"params": p}, x, t, c))


def _jax_tree(tree):
    return {k: v.numpy() for k, v in from_flax({"unet": _host(tree)})["unet"].items()}


# ------------------------------ one process ------------------------------ #


@pytest.mark.parametrize("config", [TINY, GEOMETRY], ids=["tiny", "sd_geometry"])
def test_partition_rules_split_the_axis_jax_splits(config):
    model = JaxUNet(JaxUNetConfig(**config))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)),
                            jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, 7, config["cross_attention_dim"])))["params"]
    specs = j_param_specs(shapes)
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        axes = [i for i, a in enumerate(spec) if a == "tp"]
        # a Dense kernel is (in, out) in Flax and (out, in) in the port
        if axes and keys[-1] == "kernel":
            axes = [1 - axes[0]]
        want[flax_path_to_torch_key(keys)] = axes[0] if axes else None
    got = param_specs(dict(UNet2DCondition(UNetConfig(**config)).named_parameters()))
    assert set(got) == set(want)
    assert {k: (s.dim if s else None) for k, s in got.items()} == want
    assert sum(s is not None for s in got.values()) > 0
    geglu = [k for k, s in got.items() if s is not None and s.halves == 2]
    assert geglu and all("ff.net.0.proj" in k for k in geglu)


@pytest.mark.parametrize("tp", [2, 4])
def test_geglu_slices_and_the_round_trip(tp):
    unet = _port_unet(TINY, 1)
    sd = {k: v.detach() for k, v in unet.state_dict().items()}
    specs = param_specs(sd)
    parts = [shard_state_dict(sd, tp, r, specs) for r in range(tp)]
    name = "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight"
    hidden, gate = sd[name].chunk(2)
    for r, part in enumerate(parts):  # rank r: [hidden[r] | gate[r]], contiguous rows each
        h, g = part[name].chunk(2)
        assert torch.equal(h, hidden.chunk(tp)[r]) and torch.equal(g, gate.chunk(tp)[r])
        net2 = name.replace("net.0.proj", "net.2")
        assert torch.equal(part[net2], sd[net2].chunk(tp, 1)[r])
    joined = {k: t if specs[k] is None else specs[k].join([p[k] for p in parts])
              for k, t in sd.items()}
    assert all(torch.equal(joined[k], sd[k]) for k in sd)


def test_shard_drop_and_join():
    s = Shard(1, 2)
    assert s.drop(1) is None and s.drop(0) == Shard(0, 2) and s.drop(2) == Shard(1, 2)
    t = torch.arange(24.0).reshape(2, 12)
    assert torch.equal(s.join([s.local(t, 3, r) for r in range(3)]), t)
    with pytest.raises(ValueError, match="does not split"):
        Shard(0).local(torch.zeros(3), 2, 0)


def test_axis_of_size_one_leaves_the_unet_as_it_is():
    unet = _port_unet(TINY, 2)
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    t, c = torch.tensor([3, 500]), torch.randn(2, 7, 32)
    with torch.no_grad():
        want = unet(x, t, c)
        unet.set_tensor_parallel(Axis("tp", 1, 0))
        got = unet(x, t, c)
    assert torch.equal(got, want)
    assert all(torch.equal(v, before[k]) for k, v in unet.state_dict().items())
    assert all(getattr(m, "tp", None) is None for m in unet.modules())


# --------------------------- two ranks: dp 1 x tp 2 --------------------------- #

TP2 = r'''
import contextlib, copy, io
from types import SimpleNamespace
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from ddpo_torch.core.scheduler import DDIMScheduler
from ddpo_torch.models.unet import UNet2DCondition, UNetConfig
from ddpo_torch.ops.spatial import comm_counts, reset_comm
from ddpo_torch.parallel import (MeshConfig, create_mesh, digest, maybe_initialize_distributed,
                                 sharding)
from ddpo_torch.parallel.sharding import TensorParallel, param_specs
from ddpo_torch.pipelines import policy_gradient
from ddpo_torch.pipelines.policy_gradient import make_train_apply
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import AccumulatingTrainState, train_step

maybe_initialize_distributed()
rank = dist.get_rank()
mesh = create_mesh(MeshConfig(tp=2), torch.device("cpu"))
axis = mesh.axis("tp")
inputs = torch.load("inputs.pt", weights_only=False)
out = {"mesh": [mesh.dp, mesh.tp, mesh.dp_index, mesh.tp_index]}


def keep(tree):
    """The SD geometry's whole trees on rank 0 (copies), their digests on rank 1."""
    return copy.deepcopy(tree) if rank == 0 else digest(tree)


def sharded(config, sd):
    unet = UNet2DCondition(UNetConfig(**config))
    unet.load_state_dict(sd)
    layout = TensorParallel(axis, param_specs(dict(unet.named_parameters())))
    return unet.set_tensor_parallel(axis), layout


def forward_and_grads(tag, config, sd, grads=True):
    unet, layout = sharded(config, sd)
    reset_comm()
    with torch.no_grad():
        out[f"{tag}_fwd"] = unet(*inputs[f"{tag}_fwd"])
    out[f"{tag}_comm_fwd"] = comm_counts()
    if not grads:
        return
    params = dict(unet.named_parameters())
    reset_comm()
    loss = (unet(*inputs[f"{tag}_fwd"]) ** 2).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    out[f"{tag}_comm_grad"] = comm_counts()
    out[f"{tag}_grads"] = layout.gather(dict(zip(params, grads)))


forward_and_grads("tiny", inputs["tiny_config"], inputs["tiny"])
forward_and_grads("sd", inputs["sd_config"], inputs["sd"], grads=False)

# a contiguous GEGLU shard: JAX's global rule, without GSPMD's reshard
halves, sharding._HALVES = sharding._HALVES, r"^$"
wrong, _ = sharded(inputs["tiny_config"], inputs["tiny"])
sharding._HALVES = halves
with torch.no_grad():
    out["tiny_fwd_contiguous"] = wrong(*inputs["tiny_fwd"])


class Recorder:
    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def init(self, params):
        return self.tx.init(params)

    def moment_spec(self, *a):
        return self.tx.moment_spec(*a)

    def step(self, params, grads, state):
        self.grads = {k: g.clone() for k, g in grads.items()}
        self.tx.step(params, grads, state)


ddim = DDIMScheduler()
ddim_state = ddim.set_timesteps(ddim.create_state(), inputs["steps"])
for opt in ("adamw", "adafactor"):
    unet, layout = sharded(inputs["sd_config"], inputs["sd"])
    params = dict(unet.requires_grad_(True).named_parameters())
    rec = Recorder(build_optimizer(SimpleNamespace(**dict(inputs["opt"], optimizer=opt)),
                                   tp=layout))
    state = AccumulatingTrainState(make_train_apply(unet, torch.float32, remat=False), params,
                                   rec, accumulate=False, tp=layout)
    reset_comm()
    _, info = train_step(state, inputs["ppo"], ddim_state, ddim, False, 5.0, 1.0,
                         inputs["clip"], do_opt_update=True)
    out["sd_comm_grad"] = {k: v for k, v in comm_counts().items() if k != "tp_optim"}
    out[opt] = {"loss": float(info["loss"]), "grads": keep(layout.gather(rec.grads)),
                "params": keep(state.global_params()),
                "optim_calls": comm_counts().get("tp_optim", [0])[0]}
    if opt == "adafactor":
        whole = state.state_dict()
        if rank == 0:
            torch.save(whole, "tp2_state.pt")
        out["tp2_state"] = digest(whole)
        # the reverse: a tp = 1 state loaded here, gathered back
        state.load_state_dict(inputs["tp1_state"])
        out["tp1_round_trip"] = digest(state.state_dict())

argv = ["--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
        "--resolution", "32", "--sample_batch_size", "2", "--train_batch_size", "1",
        "--num_train_epochs", "1", "--mesh_tp", "2", "--seed", "5"]
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    out["rewards"] = policy_gradient.main(argv)
out["driver"] = printed.getvalue().splitlines()
torch.save(out, f"tp2_{rank}.pt")
dist.destroy_process_group()
'''

OPT_STEP = dict(OPT, learning_rate=1e-3)


def _sd_inputs(j_apply, params, sched, sched_state):
    """The SD-geometry forward inputs and a PPO batch of 4 whose next
    latents come from the policy and whose old log-probs sit inside and
    outside the clip range (train_cfg off, as test_tp_full_geometry)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 4, 8, 8)).astype(np.float32)
    t = np.array([601, 601, 301, 901], np.int32)
    c = rng.standard_normal((4, 77, 768)).astype(np.float32)
    eps = j_apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c))
    noise = jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))
    mean, std = sched.step_mean_std(sched_state, eps, jnp.asarray(t), jnp.asarray(x), eta=1.0)
    nxt, logp = sched.step(sched_state, eps, jnp.asarray(t), jnp.asarray(x),
                           prev_sample=mean + std * noise, eta=1.0)
    ppo = {"latents": x, "next_latents": np.asarray(nxt), "ts": t,
           "log_probs": (np.asarray(logp) + np.array([0.3, -3.0, -0.3, 3.0]) * PPO_CLIP
                         ).astype(np.float32),
           # one sign: the loss is about -1, not a difference of O(1)
           # terms near 0, so rtol 1e-5 reads the step, not fp32 cancellation
           "advantages": np.array([1.5, 0.7, 0.4, 1.2], np.float32),
           "prompt_embeds": c, "uncond_embeds": np.zeros_like(c)}
    fwd = (rng.standard_normal((4, 4, 8, 8)).astype(np.float32),
           np.array([10, 10, 500, 801], np.int32),
           rng.standard_normal((4, 77, 768)).astype(np.float32))
    return fwd, ppo


def _port_state(config, sd, opt):
    unet = UNet2DCondition(UNetConfig(**config))
    unet.load_state_dict(sd)
    params = dict(unet.requires_grad_(True).named_parameters())
    tx = build_optimizer(SimpleNamespace(**dict(OPT_STEP, optimizer=opt)))
    return AccumulatingTrainState(make_train_apply(unet, torch.float32, remat=False), params, tx,
                                  accumulate=False)


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tiny_unet, sd_unet = _port_unet(TINY, 3), _port_unet(GEOMETRY, 4)
    tiny_params = to_flax(tiny_unet.state_dict(), tiny_unet)
    sd_params = to_flax(sd_unet.state_dict(), sd_unet)
    tiny_apply, sd_apply = _jax_apply(TINY), _jax_apply(GEOMETRY)
    rs = np.random.RandomState(2)
    tiny_fwd = (rs.randn(4, 4, 8, 8).astype(np.float32), np.array([10, 10, 500, 801], np.int32),
                rs.randn(4, 7, 32).astype(np.float32))
    sched = sd_scheduler()
    sched_state = sched.set_timesteps(sched.create_state(), STEPS)
    sd_fwd, ppo = _sd_inputs(sd_apply, sd_params, sched, sched_state)

    def loss_grads(apply, params, fwd):
        loss = lambda p: jnp.mean(apply(p, *map(jnp.asarray, fwd)) ** 2)  # noqa: E731
        return _jax_tree(jax.grad(loss)(params))

    ref = {"tiny_fwd": np.asarray(tiny_apply(tiny_params, *tiny_fwd)),
           "sd_fwd": np.asarray(sd_apply(sd_params, *sd_fwd)),
           "tiny_grads": loss_grads(tiny_apply, tiny_params, tiny_fwd)}
    # one PPO step (JAX's train_step, its gradients recorded)
    model = JaxUNet(JaxUNetConfig(**GEOMETRY))
    state = JaxState.create(apply_fn=lambda p, x, t, c: model.apply({"params": p}, x, t, c),
                            params=sd_params, tx=_recording_tx(), accumulate=False)
    step = jax.jit(lambda st, b, ss: j_train_step(st, b, ss, sched, False, GUIDANCE, 1.0,
                                                  PPO_CLIP, do_opt_update=True))
    new, info = step(state, {k: jnp.asarray(v) for k, v in ppo.items()}, sched_state)
    ref["ppo_loss"], ref["ppo_grads"] = float(info["loss"]), _jax_tree(new.opt_state)

    # a whole (tp = 1) adafactor state for the ranks to load at tp = 2:
    # every parameter and statistic drawn, so each element is its own
    one = _port_state(GEOMETRY, sd_unet.state_dict(), "adafactor")
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in one.params.values():
            p.add_(1e-3 * torch.randn(p.shape, generator=gen))
        for moment in ("v", "v_row", "v_col"):
            for v in one.opt_state[moment].values():
                v.copy_(torch.rand(v.shape, generator=gen))
    one.opt_state["count"], one.step = 1, 1
    tp1_state = one.state_dict()

    tmp = tmp_path_factory.mktemp("tp2")
    torch.save({
        "tiny_config": TINY, "sd_config": GEOMETRY, "tiny": tiny_unet.state_dict(),
        "sd": sd_unet.state_dict(), "tiny_fwd": tuple(map(t, tiny_fwd)),
        "sd_fwd": tuple(map(t, sd_fwd)), "ppo": {k: t(v) for k, v in ppo.items()},
        "opt": OPT_STEP, "clip": PPO_CLIP, "steps": STEPS, "tp1_state": tp1_state,
    }, tmp / "inputs.pt")
    tp1_digest = digest(tp1_state)
    del tp1_state
    ranks = run_ranks(tmp, TP2, "tp2", 2)
    tp2_state = torch.load(tmp / "tp2_state.pt", weights_only=True)
    for f in ["inputs.pt", "tp2_state.pt", "tp2_0.pt", "tp2_1.pt"]:  # about 3 GB
        (tmp / f).unlink()
    return SimpleNamespace(ref=ref, ranks=ranks, tmp=tmp, sd_params=sd_params,
                           sd=sd_unet.state_dict(), tp1_digest=tp1_digest, tp2_state=tp2_state)


def _np(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


def test_tp2_mesh_layout(tp2):
    assert [r["mesh"] for r in tp2.ranks] == [[1, 2, 0, 0], [1, 2, 0, 1]]


@pytest.mark.parametrize("tag", ["tiny", "sd"])
def test_tp_forward_matches_jax(tp2, tag):
    for out in tp2.ranks:  # eps whole on each rank
        np.testing.assert_allclose(out[f"{tag}_fwd"].numpy(), tp2.ref[f"{tag}_fwd"],
                                   rtol=2e-4, atol=2e-5)


def test_contiguous_geglu_shard_fails_the_forward(tp2):
    got, want = tp2.ranks[0]["tiny_fwd_contiguous"].numpy(), tp2.ref["tiny_fwd"]
    assert not np.allclose(got, want, rtol=2e-4, atol=2e-5)


def test_tp_gathered_gradients_match_jax(tp2):
    """The tiny UNet's; the SD geometry's are the PPO step's, below."""
    ref = tp2.ref["tiny_grads"]
    gmax = max(np.abs(r).max() for r in ref.values())
    for out in tp2.ranks:
        got = _np(out["tiny_grads"])
        assert set(got) == set(ref)
        for k, r in ref.items():
            np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-5 * gmax, err_msg=k)


@pytest.mark.parametrize("tag,blocks", [("tiny", 4), ("sd", 7)])
def test_tp_collectives_three_a_block_each_way(tp2, tag, blocks):
    for out in tp2.ranks:
        assert {k: v[0] for k, v in out[f"{tag}_comm_fwd"].items()} == {"tp_reduce": 3 * blocks}
        assert {k: v[0] for k, v in out[f"{tag}_comm_grad"].items()} == {
            "tp_reduce": 3 * blocks, "tp_copy.bwd": 3 * blocks}


def test_tp_ppo_step_loss_and_gradients_match_jax(tp2):
    ref = tp2.ref["ppo_grads"]
    gmax = max(np.abs(r).max() for r in ref.values())
    assert gmax > 1e-6
    first, second = tp2.ranks
    for opt in ("adamw", "adafactor"):
        for out in tp2.ranks:
            np.testing.assert_allclose(out[opt]["loss"], tp2.ref["ppo_loss"], rtol=1e-5)
        got = _np(first[opt]["grads"])
        for k, r in ref.items():
            np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-5 * gmax, err_msg=k)
        assert digest(first[opt]["grads"]) == second[opt]["grads"]  # rank 1's, the same bits


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_tp_update_matches_optax_on_the_same_gradients(tp2, opt):
    """The gathered parameters after one step against optax's clip + adamw
    or adafactor applied to the same (gathered) gradients: what the tp
    group's norm, factored means and RMS must reproduce."""
    out = tp2.ranks[0][opt]
    grads = {k: v.numpy() for k, v in out["grads"].items()}
    with torch.device("meta"):  # to_flax reads the module types only
        unet = UNet2DCondition(UNetConfig(**GEOMETRY))
    tx = jax_build_optimizer(SimpleNamespace(**dict(OPT_STEP, optimizer=opt)))
    g_tree = to_flax({k: torch.from_numpy(v) for k, v in grads.items()}, unet)
    upd, _ = jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(g_tree, tp2.sd_params)
    want = _jax_tree(optax.apply_updates(tp2.sd_params, upd))
    got = _np(out["params"])
    moved = 0.0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
        moved = max(moved, float(np.abs(w - tp2.sd[k].numpy()).max()))
    assert moved > 1e-4
    assert tp2.ranks[1][opt]["params"] == digest(out["params"])


@pytest.mark.parametrize("opt,calls", [("adamw", 1), ("adafactor", 4)])
def test_tp_optimizer_reductions_are_batched(tp2, opt, calls):
    """The optimizer's all-reduces in one step over the SD geometry's
    leaves: the norm's, and in adafactor one for each pass of its
    whole-tensor means (g^2's rows and columns with the parameters' RMS,
    v_row's mean, the update's RMS)."""
    assert [out[opt]["optim_calls"] for out in tp2.ranks] == [calls, calls]


@pytest.mark.parametrize("cards,backend", [("abcd", "nccl"), ("aaaa", "gloo"), (None, "gloo")])
def test_tp_gradient_group_is_on_the_cards_when_they_differ(monkeypatch, cards, backend):
    """dp 2 x tp 2, rank 1: the gradients' mean over dp runs in a group of
    ranks 1 and 3 on NCCL when their cards differ, else in the gloo dp
    group; the host data's dp group is gloo either way."""
    from ddpo_torch.parallel import mesh as mesh_mod

    made = []

    def new_group(ranks, backend):
        made.append((tuple(ranks), backend))
        return len(made) - 1

    dist = mesh_mod.dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "new_group", new_group)
    monkeypatch.setattr(mesh_mod, "_card_keys",
                        lambda device: list(cards) if cards else [None] * 4)
    mesh = mesh_mod.create_mesh(mesh_mod.MeshConfig(tp=2))
    assert (mesh.dp, mesh.tp, mesh.dp_index, mesh.tp_index) == (2, 2, 0, 1)
    assert made[mesh.dp_group] == ((1, 3), "gloo")
    assert made[mesh.grad_group] == ((1, 3), backend) and mesh.grad_backend == backend
    assert (mesh.grad_group == mesh.dp_group) == (backend == "gloo")


def _assert_equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_equal_trees(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_tp2_state_resumes_at_tp1_and_the_reverse(tp2):
    saved = tp2.tp2_state
    assert all(out["tp2_state"] == digest(saved) for out in tp2.ranks)
    one = _port_state(GEOMETRY, tp2.sd, "adafactor")
    one.load_state_dict(saved)
    _assert_equal_trees(one.state_dict(), saved)
    assert saved["opt_state"]["v_row"] and saved["opt_state"]["v_col"]  # factored leaves
    for out in tp2.ranks:  # a tp = 1 state at tp = 2, gathered back
        assert out["tp1_round_trip"] == tp2.tp1_digest


def test_tp2_driver_ranks_agree_and_resume_at_tp1(tp2, monkeypatch):
    lines = [r["driver"] for r in tp2.ranks]

    def grep(pattern):
        return [[m.group(1) for m in map(re.compile(pattern).search, ls) if m] for ls in lines]

    noise = grep(r"initial noise digest (\w+)")
    digests = grep(r"epoch 0 params digest (\w+)")
    replicated = grep(r"epoch 0 replicated params digest (\w+)")
    per_call = grep(r"tp collectives a sampler UNet forward (\{.*?\}) \|")
    assert len(noise[0]) == 1 and noise[0] == noise[1]
    assert len(digests[0]) == 1 and digests[0] == digests[1]
    assert len(replicated[0]) == 1 and replicated[0] == replicated[1]
    assert tp2.ranks[0]["rewards"] == tp2.ranks[1]["rewards"]
    assert all(len(p) == 1 and '"tp_reduce": [12.0' in p[0] for p in per_call), per_call
    assert any("tp=2: the transformer blocks' Linears split" in ln for ln in lines[0])

    import ddpo_torch.config.base as base
    import ddpo_torch.config.user as user
    from ddpo_torch.pipelines import policy_gradient

    monkeypatch.chdir(tp2.tmp)
    monkeypatch.setenv("DDPO_BUCKET", "bucket")
    importlib.reload(user)
    importlib.reload(base)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            rewards = policy_gradient.main([
                "--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
                "--resolution", "32", "--sample_batch_size", "2", "--train_batch_size", "1",
                "--num_train_epochs", "2", "--seed", "5", "--resume", "True"])
    finally:
        monkeypatch.undo()
        importlib.reload(user)
        importlib.reload(base)
    assert "resumed from checkpoint at epoch 0" in printed.getvalue()
    assert len(rewards) == 2 and rewards[0] == tp2.ranks[0]["rewards"][0]


# --------------------------- four ranks: dp 2 x tp 2 --------------------------- #

TP4 = r'''
import contextlib, io
from types import SimpleNamespace
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from ddpo_torch.core.scheduler import DDIMScheduler
from ddpo_torch.models.unet import UNet2DCondition, UNetConfig
from ddpo_torch.ops.spatial import comm_counts, reset_comm
from ddpo_torch.parallel import MeshConfig, create_mesh, maybe_initialize_distributed
from ddpo_torch.parallel.sharding import TensorParallel, param_specs
from ddpo_torch.pipelines import policy_gradient
from ddpo_torch.pipelines.policy_gradient import make_train_apply
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import AccumulatingTrainState, train_step_fused

maybe_initialize_distributed()
rank = dist.get_rank()
inputs = torch.load("inputs.pt", weights_only=False)
mesh = create_mesh(MeshConfig(tp=2), torch.device("cpu"))
out = {"mesh": [mesh.dp, mesh.tp, mesh.dp_index, mesh.tp_index]}


def unet_of(axis):
    unet = UNet2DCondition(UNetConfig(**inputs["config"]))
    unet.load_state_dict(inputs["unet"])
    layout = TensorParallel(axis, param_specs(dict(unet.named_parameters())))
    return unet.set_tensor_parallel(axis), layout


class Recorder:
    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def init(self, params):
        return self.tx.init(params)

    def step(self, params, grads, state):
        self.grads = {k: g.clone() for k, g in grads.items()}
        self.tx.step(params, grads, state)


unet, layout = unet_of(mesh.axis("tp"))
params = dict(unet.requires_grad_(True).named_parameters())
rec = Recorder(build_optimizer(SimpleNamespace(**inputs["opt"]), tp=layout))
reduce = policy_gradient.gradient_reduce(mesh, False, None, "gloo")
state = AccumulatingTrainState(make_train_apply(unet, torch.float32, remat=False), params, rec,
                               accumulate=False, grad_reduce=reduce, tp=layout)
rows = slice(2 * mesh.dp_index, 2 * mesh.dp_index + 2)
b = inputs["ddpo"]
local = {k: (v[:, rows] if k in ("latents", "next_latents", "ts", "log_probs") else v[rows])
         for k, v in b.items()}
ddim = DDIMScheduler()
ddim_state = ddim.set_timesteps(ddim.create_state(), inputs["steps"])
_, info = train_step_fused(state, local, ddim_state, ddim, True, 5.0, 1.0, inputs["clip"],
                           do_opt_update=True, cfg_concat=True)
out["loss"] = float(info["loss"])  # this dp slice's rows'
out["reduce_world"], out["reduce_calls"] = reduce.world, len(reduce.calls)
out["local_grads"] = rec.grads
out["grads"] = layout.gather(rec.grads)
out["params"] = state.global_params()

# tp = 4 over 2 heads: JAX's fallback runs every head on every rank
mesh4 = create_mesh(MeshConfig(tp=4), torch.device("cpu"))
unet4, _ = unet_of(mesh4.axis("tp"))
reset_comm()
with torch.no_grad():
    out["fwd_tp4"] = unet4(*inputs["fwd"])
out["comm_tp4"] = comm_counts()

printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    out["rewards"] = policy_gradient.main([
        "--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
        "--resolution", "32", "--sample_batch_size", "2", "--train_batch_size", "1",
        "--num_train_epochs", "1", "--mesh_tp", "2", "--seed", "3"])
out["driver"] = printed.getvalue().splitlines()
torch.save(out, f"tp4_{rank}.pt")
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    unet = _port_unet(TINY, 5)
    params = to_flax(unet.state_dict(), unet)
    apply = _jax_apply(TINY)
    sched = sd_scheduler()
    sched_state = sched.set_timesteps(sched.create_state(), STEPS)
    model = JaxUNet(JaxUNetConfig(**TINY))
    ddpo = _ddpo_batch(model, params, sched, sched_state)
    # one sign: each dp slice's loss is about -1, not a cancellation near 0
    ddpo["advantages"] = np.abs(ddpo["advantages"])
    plain = lambda p, x, t, c: model.apply({"params": p}, x, t, c)  # noqa: E731
    state = JaxState.create(apply_fn=plain, params=params, tx=_recording_tx(), accumulate=False)
    step = jax.jit(lambda st, b, ss: j_train_step_fused(
        st, b, ss, sched, True, GUIDANCE, 1.0, CLIP, do_opt_update=True, cfg_concat=True))
    new, info = step(state, {k: jnp.asarray(v) for k, v in ddpo.items()}, sched_state)
    grads = _jax_tree(new.opt_state)
    rs = np.random.RandomState(4)
    fwd = (rs.randn(4, 4, 8, 8).astype(np.float32), np.array([10, 10, 500, 801], np.int32),
           rs.randn(4, 7, 32).astype(np.float32))
    ref = {"grads": grads, "fwd": np.asarray(apply(params, *fwd)), "loss": float(info["loss"])}
    tmp = tmp_path_factory.mktemp("tp4")
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    torch.save({"config": TINY, "unet": unet.state_dict(), "opt": OPT, "clip": CLIP,
                "steps": STEPS, "fwd": tuple(map(t, fwd)),
                "ddpo": {k: t(v) for k, v in ddpo.items()}}, tmp / "inputs.pt")
    return SimpleNamespace(ref=ref, ranks=run_ranks(tmp, TP4, "tp4", 4, timeout=600),
                           specs=param_specs(unet.state_dict()), params=params,
                           before=unet.state_dict())


def test_tp4_mesh_layout(tp4):
    assert [r["mesh"] for r in tp4.ranks] == [[2, 2, 0, 0], [2, 2, 0, 1], [2, 2, 1, 0],
                                              [2, 2, 1, 1]]


def test_tp4_reduce_runs_over_dp_groups_only(tp4):
    """Each rank's reduced gradients are its slices of JAX's global
    gradients: a reduce over the world would average rank 0's slice of
    to_q with rank 1's, which has the same shape."""
    ref = tp4.ref["grads"]
    gmax = max(np.abs(r).max() for r in ref.values())
    for out in tp4.ranks:
        assert out["reduce_world"] == 2 and out["reduce_calls"] == 1
        _, tp, _, index = out["mesh"]
        want = shard_state_dict({k: torch.from_numpy(v) for k, v in ref.items()}, tp, index,
                                tp4.specs)
        for k, w in want.items():
            np.testing.assert_allclose(out["local_grads"][k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5 * gmax, err_msg=k)


def test_tp4_ppo_loss_matches_jax(tp4):
    """JAX's loss is the global batch's mean; the two dp slices' means
    average to it (equal rows), and the tp ranks of a slice agree."""
    losses = [r["loss"] for r in tp4.ranks]
    assert losses[0] == losses[1] and losses[2] == losses[3]
    np.testing.assert_allclose((losses[0] + losses[2]) / 2, tp4.ref["loss"], rtol=1e-5)


def test_tp4_update_matches_optax_on_the_same_gradients(tp4):
    out = tp4.ranks[0]
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig(**TINY))
    tx = jax_build_optimizer(SimpleNamespace(**OPT))
    upd, _ = jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(to_flax(out["grads"], unet),
                                                               tp4.params)
    want = _jax_tree(optax.apply_updates(tp4.params, upd))
    got = _np(out["params"])
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
    assert any(not np.array_equal(got[k], tp4.before[k].numpy()) for k in got)


def test_tp4_ranks_end_bit_equal(tp4):
    first = tp4.ranks[0]
    for out in tp4.ranks[1:]:
        for what in ("grads", "params"):
            assert all(torch.equal(first[what][k], v) for k, v in out[what].items()), what


def test_tp4_heads_fallback_forward_matches_jax(tp4):
    for out in tp4.ranks:
        np.testing.assert_allclose(out["fwd_tp4"].numpy(), tp4.ref["fwd"], rtol=2e-4, atol=2e-5)
        calls = {k: v[0] for k, v in out["comm_tp4"].items()}
        assert calls == {"tp_reduce": 12, "tp_gather": 24}  # q, k and v of 8 attentions


def test_tp4_driver_noise_per_dp_slice(tp4):
    noise = [[ln.split("initial noise digest ")[1] for ln in r["driver"]
              if "initial noise digest" in ln] for r in tp4.ranks]
    assert noise[0] == noise[1] and noise[2] == noise[3] and noise[0] != noise[2]
    assert all(r["rewards"] == tp4.ranks[0]["rewards"] for r in tp4.ranks)
    digests = [[ln for ln in r["driver"] if "epoch 0 params digest" in ln] for r in tp4.ranks]
    assert len(digests[0]) == 1 and all(d == digests[0] for d in digests)
