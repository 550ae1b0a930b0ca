"""The port's sp mesh axis against ddpo_tpu's, on the CPU at fp32 with the
tiny preset (JAX's TINY UNet: 8x8 latents, channels (32, 64)).

In one process:
  - the halo route of the convs: a SAME conv of the full map equals the
    concatenation of each shard's conv of its hand-built halo'd rows, VALID
    over H (the library conv with padding (0, 1), and the kernels' SAME
    map with its first and last rows dropped); the stride-2 conv over the
    top halo row; atol 1e-5 (fp32 sums in another order);
  - ``validate_spatial_geometry``'s messages, equal to JAX's;
  - ``conv3x3_w8a8(padding=((0, 0), (1, 1)))`` on a halo'd shard against
    JAX's: the int8 codes equal, the output within 1e-5 relative L2 (as
    tests/test_torch_quant.py);
  - an axis of size 1 (zero halo rows, the convs VALID over H) leaves the
    UNet's output within 1e-5;
  - the manifest: the port's UNet, VAE and CLIP text tower, built on the
    meta device and mapped through models/convert.py's key map, equal the
    generator's manifest and assets/sd14_params.json path for path and
    shape for shape, and the totals are the published ones.

Through ``ddpo_torch.parallel.launch``, one module-scoped launch each:
  - two gloo ranks (dp = 1 x sp = 2) against JAX on a (1, 2, 1) mesh of
    conftest's virtual CPU devices: the spatial forward against
    ``make_spatial_unet_apply`` and against the unsharded UNet, atol and
    rtol 2e-5 (JAX's own bound, tests/test_parallel.py); the parameter
    gradients of mean(eps^2), summed over the sp ranks as the driver's
    reduce sums them, atol 3e-5 and rtol 3e-4 (a gather backward that sums
    would double them); the attention mode's forward and gradients (whole
    on each rank) against ``set_attention_sharding(seq_axis="sp")``; the
    sampler trajectory with JAX's noise injected, atol and rtol 1e-4; and
    the driver in both modes: the sp ranks draw the same seed and noise and
    end with the same rewards and parameters;
  - four gloo ranks (dp = 2 x sp = 2): one ``train_step_fused`` update in
    the spatial mode, in the attention mode, and with LoRA adapters in the
    spatial mode, against JAX's on a (2, 2, 1) mesh, under
    tests/test_torch_distributed.py's bounds (the reduced gradients within
    1e-5 of the leaf set's max|g|, the params within what each side's own
    gradient allows). A reduce that averaged the spatial mode's partial
    gradients over the world would halve them. The driver's dp slices draw
    different noise, the sp ranks of a slice the same.
"""

import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ddpo_torch.models import AutoencoderKL, CLIPTextModel, UNet2DCondition
from ddpo_torch.models import manifest as t_manifest
from ddpo_torch.models.convert import from_flax, lora_from_flax
from ddpo_torch.ops import conv as tconv
from ddpo_torch.ops.quant import conv3x3_w8a8, quantize_symmetric
from ddpo_torch.ops.spatial import Axis
from ddpo_torch.ops.spatial import validate_spatial_geometry as t_validate
from ddpo_torch.parallel.launch import launch
from ddpo_torch.utils.serialization import build_models
from ddpo_tpu.models import lora as j_lora
from ddpo_tpu.models.manifest import sd14_manifest as j_sd14_manifest
from ddpo_tpu.ops import set_attention_sharding as j_set_attention_sharding
from ddpo_tpu.ops.quant import conv3x3_w8a8 as j_conv3x3_w8a8
from ddpo_tpu.ops.quant import quantize_symmetric as j_quantize_symmetric
from ddpo_tpu.ops.spatial import validate_spatial_geometry as j_validate
from ddpo_tpu.parallel.spatial import make_spatial_unet_apply as j_spatial_apply
from ddpo_tpu.sampling.sampler import SamplerConfig as JaxSamplerConfig
from ddpo_tpu.sampling.sampler import sample_trajectories as j_sample_trajectories
from ddpo_tpu.training.policy_gradient import AccumulatingTrainState as JaxState
from ddpo_tpu.training.policy_gradient import train_step_fused as j_train_step_fused
from ddpo_tpu.utils.serialization import _tiny_stack, sd_scheduler

from test_torch_distributed import (  # noqa: F401  (helpers, no tests)
    CLIP,
    GUIDANCE,
    OPT,
    STEPS,
    _adamw_step,
    _clip,
    _ddpo_batch,
    _host,
    _recording_tx,
    worker_env,
)

SAMPLER_STEPS, SAMPLER_RES = 5, 64


# ------------------------------ one process ------------------------------ #


def _halo_shards(x: torch.Tensor, n: int, top_only: bool = False):
    """Hand-built halo'd shards of a full NCHW map: each shard's rows with
    its neighbours' boundary rows (zero rows at the global edges)."""
    full = F.pad(x, (0, 0, 1, 1))
    rows = x.shape[2] // n
    return [full[:, :, i * rows:(i + 1) * rows + (1 if top_only else 2)] for i in range(n)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("route", ["library", "kernel_plain"])
def test_same_conv_is_the_concatenation_of_halo_shards(n, route):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((2, 6, 8, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 6, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(7).astype(np.float32))
    want = F.conv2d(x, w, b, padding=1)
    if route == "library":
        parts = [tconv.library_conv(xh, w, b, padding=(0, 1)) for xh in _halo_shards(x, n)]
    else:  # the kernel's SAME map on the halo'd frame, first and last rows dropped
        parts = [tconv.conv3x3_reference(xh, w)[:, :, 1:-1] + b[:, None, None]
                 for xh in _halo_shards(x, n)]
    torch.testing.assert_close(torch.cat(parts, 2), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_strided_conv_is_the_concatenation_of_top_halo_shards(n):
    rng = np.random.default_rng(10 + n)
    x = torch.from_numpy(rng.standard_normal((2, 6, 16, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 6, 3, 3)).astype(np.float32))
    want = F.conv2d(x, w, None, stride=2, padding=1)
    parts = [tconv.library_conv(xh, w, None, stride=2, padding=(0, 1))
             for xh in _halo_shards(x, n, top_only=True)]
    torch.testing.assert_close(torch.cat(parts, 2), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("height,n,levels", [
    (64, 2, 3), (64, 8, 3), (8, 8, 1), (12, 8, 1), (48, 4, 3), (8, 2, 1), (4, 2, 1),
])
def test_validate_spatial_geometry_messages_equal_jax(height, n, levels):
    def outcome(fn):
        try:
            fn(height, "sp", n, levels=levels)
            return None
        except ValueError as e:
            return str(e)

    got, want = outcome(t_validate), outcome(j_validate)
    assert got == want
    if (height, n) in ((8, 8), (12, 8)):
        assert got is not None and got.startswith("spatial sharding")


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_w8a8_valid_rows_matches_jax(dtype, jdtype):
    """A halo'd shard (10 rows for 8) through both packages' int8 conv,
    VALID over H: equal codes, outputs within 1e-5 relative L2."""
    rng = np.random.default_rng(3)
    xh = rng.standard_normal((2, 16, 10, 8)).astype(np.float32)
    xh[:, :, 0] = 0.0  # shard 0: the global top pad row
    w = (rng.standard_normal((24, 16, 3, 3)) * 48 ** -0.5).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32) * 0.1
    pad = ((0, 0), (1, 1))
    tx, tw, tb = (torch.from_numpy(a).to(dtype) for a in (xh, w, b))
    got = conv3x3_w8a8(tx, tw, tb, padding=pad)
    jx = jnp.asarray(xh.transpose(0, 2, 3, 1)).astype(jdtype)
    want = j_conv3x3_w8a8(jx, jnp.asarray(w.transpose(2, 3, 1, 0)).astype(jdtype),
                          jnp.asarray(b).astype(jdtype), padding=pad)
    assert got.shape == (2, 24, 8, 8) and got.dtype == dtype
    q, _ = quantize_symmetric(tx, (1, 2, 3))  # the scale is the halo'd shard's
    jq, _ = j_quantize_symmetric(jx, (1, 2, 3))
    np.testing.assert_array_equal(q.numpy().transpose(0, 2, 3, 1), np.asarray(jq))
    a = got.float().numpy().astype(np.float64)
    r = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2).astype(np.float64)
    assert np.linalg.norm(a - r) / np.linalg.norm(r) <= 1e-5
    with pytest.raises(ValueError, match="padding"):
        conv3x3_w8a8(tx, tw, tb, padding=((0, 1), (1, 1)))


def test_axis_of_size_one_leaves_the_unet_as_it_is():
    from ddpo_torch.utils.serialization import init_weights_

    _, _, unet = build_models("tiny", "cpu")
    init_weights_(unet, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    args = (torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32)),
            torch.tensor([3, 600]),
            torch.from_numpy(rng.standard_normal((2, 7, 32)).astype(np.float32)))
    with torch.no_grad():
        want = unet(*args)
        got = unet.set_spatial(Axis("sp", 1, 0))(*args)
        unet.set_spatial(None)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_group_backends_follow_the_cards():
    """NCCL only for a group of several ranks on cards of their own; a
    one-rank group, ranks sharing a card and the CPU take gloo."""
    from ddpo_torch.parallel.mesh import _backend_for

    assert _backend_for(["a", "b"]) == "nccl"
    assert [_backend_for(k) for k in (["a"], ["a", "a"], [None, None], ["a", None])] == \
        ["gloo"] * 4


@pytest.fixture(scope="module")
def meta_models():
    with torch.device("meta"):
        return {"unet": UNet2DCondition(), "vae": AutoencoderKL(),
                "text_encoder": CLIPTextModel()}


@pytest.mark.parametrize("name", ["unet", "vae", "text_encoder"])
def test_port_state_dicts_match_the_manifest(meta_models, name):
    got = t_manifest.flax_manifest(meta_models[name])
    generated = t_manifest.sd14_manifest()[name]
    assert got == generated, sorted(set(got) ^ set(generated))[:8]
    assert generated == t_manifest.vendored_manifest()[name]
    assert generated == j_sd14_manifest()[name]  # the port's copy is JAX's generator


def test_manifest_totals_are_the_published_counts(meta_models):
    totals = {k: t_manifest.count_params(t_manifest.flax_manifest(m))
              for k, m in meta_models.items()}
    assert totals == {"unet": 859_520_964, "vae": 83_653_863, "text_encoder": 123_060_480}


# --------------------------- two ranks: dp 1 x sp 2 --------------------------- #

SP2 = r'''
import contextlib, io, json
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from ddpo_torch.core.scheduler import DDIMScheduler
from ddpo_torch.ops.attention import set_attention_sharding
from ddpo_torch.ops.spatial import comm_counts, reset_comm
from ddpo_torch.parallel import MeshConfig, create_mesh, maybe_initialize_distributed
from ddpo_torch.parallel.spatial import make_spatial_unet_apply
from ddpo_torch.pipelines import policy_gradient
from ddpo_torch.sampling import SamplerConfig, sample_trajectories
from ddpo_torch.utils.parser import Parser
from ddpo_torch.utils.serialization import build_models

maybe_initialize_distributed()
rank = dist.get_rank()
mesh = create_mesh(MeshConfig(sp=2), torch.device("cpu"))
inputs = torch.load("inputs.pt", weights_only=False)
_, _, unet = build_models("tiny", "cpu")
unet.load_state_dict(inputs["unet"])
params = dict(unet.named_parameters())
out = {"mesh": [mesh.dp, mesh.sp, mesh.dp_index, mesh.sp_index]}


def grads_of(apply, x, t, c):
    loss = (apply(x, t, c) ** 2).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return {k: g.clone() for k, g in zip(params, grads)}


set_attention_sharding(mesh, batch_axis="dp", seq_axis="sp")
with torch.no_grad():
    out["attention_fwd"] = unet(*inputs["fwd"])
out["attention_grads"] = grads_of(unet, *inputs["grad"])  # whole on each rank
set_attention_sharding(None)

apply = make_spatial_unet_apply(mesh, unet)
reset_comm()
with torch.no_grad():
    out["spatial_fwd"] = apply(*inputs["fwd"])
out["comm_fwd"] = comm_counts()
grads = grads_of(apply, *inputs["grad"])
for g in grads.values():  # each rank's rows' part: the sum over sp
    dist.all_reduce(g)
out["spatial_grads"] = grads
s = inputs["sampler"]
sched = DDIMScheduler()
traj = sample_trajectories(apply, sched, sched.create_state(), s["prompt"], s["uncond"],
                           SamplerConfig(num_inference_steps=s["steps"], height=s["res"],
                                         width=s["res"]),
                           init_latents=s["init"], noise=s["noise"])
out["traj"] = {k: traj[k] for k in ("latents", "next_latents", "log_probs")}
unet.set_spatial(None)

args = Parser().parse_args("pg", ["--dataset", "debug-animals", "--device", "cpu", "--seed", "7",
                                  "--mesh_sp", "2"])
out["seed"] = [args.base_seed, args.seed]
for mode in ("spatial", "attention"):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out[f"{mode}_rewards"] = policy_gradient.main([
            "--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
            "--resolution", "32", "--sample_batch_size", "2", "--train_batch_size", "1",
            "--num_train_epochs", "1", "--mesh_sp", "2", "--sp_mode", mode])
    lines = printed.getvalue().splitlines()
    out[f"{mode}_noise"] = [l.split("initial noise digest ")[1] for l in lines
                            if "initial noise digest" in l]
    out[f"{mode}_digest"] = [l for l in lines if "params digest" in l]
    out[f"{mode}_lines"] = [l for l in lines if "sp=2" in l or "sp collectives" in l]
torch.save(out, f"sp2_{rank}.pt")
dist.destroy_process_group()
'''


def run_ranks(tmp, script, tag, world, timeout=420):
    """``world`` ranks of ``script`` in ``tmp``; each saves {tag}_{rank}.pt."""
    path = tmp / "worker.py"
    path.write_text(script)
    results = launch([sys.executable, str(path)], world, timeout=timeout, env=worker_env(),
                     cwd=str(tmp))
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return [torch.load(tmp / f"{tag}_{r}.pt", weights_only=False) for r in range(world)]


def _tiny_params(seed=0):
    _, _, j_unet = _tiny_stack(jnp.float32)
    params = _host(jax.jit(j_unet.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 7, 32)))["params"])
    return j_unet, params


def _mesh(dp, sp):
    return Mesh(np.asarray(jax.devices()[:dp * sp]).reshape(dp, sp, 1), ("dp", "sp", "tp"))


@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    j_unet, params = _tiny_params()
    rs = np.random.RandomState(2)
    fwd = (rs.randn(4, 4, 8, 8).astype(np.float32), np.array([10, 10, 500, 801], np.int32),
           rs.randn(4, 7, 32).astype(np.float32))
    rs = np.random.RandomState(3)
    grad = (rs.randn(2, 4, 8, 8).astype(np.float32), np.array([3, 11], np.int32),
            rs.randn(2, 7, 32).astype(np.float32))
    mesh = _mesh(1, 2)
    apply = lambda p, x, t, c: j_unet.apply({"params": p}, x, t, c)  # noqa: E731
    apply_sp = j_spatial_apply(mesh, j_unet)
    loss = lambda fn: (lambda p: jnp.mean(fn(p, *map(jnp.asarray, grad)) ** 2))  # noqa: E731
    ref = {
        "unsharded_fwd": np.asarray(apply(params, *fwd)),
        "spatial_fwd": np.asarray(jax.jit(apply_sp)(params, *fwd)),
        "unsharded_grads": _host(jax.grad(loss(apply))(params)),
        "spatial_grads": _host(jax.jit(jax.grad(loss(apply_sp)))(params)),
    }
    j_set_attention_sharding(mesh, batch_axis="dp", seq_axis="sp")
    try:
        with mesh:
            ref["attention_fwd"] = np.asarray(jax.jit(apply)(params, *fwd))
            ref["attention_grads"] = _host(jax.jit(jax.grad(loss(apply)))(params))
    finally:
        j_set_attention_sharding(None)

    # the sampler: JAX's spatial apply at the GSPMD level, its noise replayed
    rng = np.random.default_rng(0)
    prompt, uncond = (rng.standard_normal((2, 7, 32)).astype(np.float32) for _ in range(2))
    init = rng.standard_normal((2, 4, SAMPLER_RES // 8, SAMPLER_RES // 8)).astype(np.float32)
    sched = sd_scheduler()
    key = jax.random.PRNGKey(7)
    cfg = JaxSamplerConfig(num_inference_steps=SAMPLER_STEPS, guidance_scale=5.0, eta=1.0,
                           height=SAMPLER_RES, width=SAMPLER_RES)
    traj = j_sample_trajectories(apply_sp, params, sched, sched.create_state(),
                                 jnp.asarray(prompt), jnp.asarray(uncond), key, cfg,
                                 init_latents=jnp.asarray(init))
    ref["traj"] = {k: np.asarray(traj[k]) for k in ("latents", "next_latents", "log_probs")}
    noise, carry = [], key
    for _ in range(SAMPLER_STEPS):
        carry, step_key = jax.random.split(carry)
        noise.append(np.asarray(jax.random.normal(step_key, init.shape, jnp.float32)))

    tmp = tmp_path_factory.mktemp("sp2")
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    torch.save({
        "unet": from_flax({"unet": params})["unet"],
        "fwd": tuple(map(t, fwd)), "grad": tuple(map(t, grad)),
        "sampler": {"prompt": t(prompt), "uncond": t(uncond), "init": t(init),
                    "noise": t(np.stack(noise)), "steps": SAMPLER_STEPS, "res": SAMPLER_RES},
    }, tmp / "inputs.pt")
    ranks = run_ranks(tmp, SP2, "sp2", 2)
    return SimpleNamespace(ref=ref, ranks=ranks)


def _port_tree(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


def _jax_tree(tree):
    return {k: v.numpy() for k, v in from_flax({"unet": tree})["unet"].items()}


def test_sp2_mesh_layout(sp2):
    assert [r["mesh"] for r in sp2.ranks] == [[1, 2, 0, 0], [1, 2, 0, 1]]


@pytest.mark.parametrize("against", ["spatial_fwd", "unsharded_fwd"])
def test_spatial_forward_matches_jax(sp2, against):
    for out in sp2.ranks:  # eps whole on each rank
        np.testing.assert_allclose(out["spatial_fwd"].numpy(), sp2.ref[against],
                                   atol=2e-5, rtol=2e-5)


def test_spatial_forward_collectives(sp2):
    """The tiny UNet's collectives a forward: 19 stride-1 convs, 1 stride-2
    conv, 21 GroupNorms, 4 self-attentions (down, mid, 2 up) and the output
    gather."""
    comm = sp2.ranks[0]["comm_fwd"]
    assert {k: v[0] for k, v in comm.items()} == {
        "halo": 19, "halo_top": 1, "psum": 21, "gather_kv": 4, "gather_out": 1}


@pytest.mark.parametrize("against", ["spatial_grads", "unsharded_grads"])
def test_spatial_gradients_match_jax(sp2, against):
    ref = _jax_tree(sp2.ref[against])
    for out in sp2.ranks:
        got = _port_tree(out["spatial_grads"])
        assert set(got) == set(ref)
        for k, r in ref.items():
            np.testing.assert_allclose(got[k], r, atol=3e-5, rtol=3e-4, err_msg=k)


def test_attention_mode_matches_jax(sp2):
    ref = _jax_tree(sp2.ref["attention_grads"])
    for out in sp2.ranks:
        np.testing.assert_allclose(out["attention_fwd"].numpy(), sp2.ref["attention_fwd"],
                                   atol=2e-5, rtol=2e-5)
        got = _port_tree(out["attention_grads"])
        for k, r in ref.items():
            np.testing.assert_allclose(got[k], r, atol=3e-5, rtol=3e-4, err_msg=k)


def test_spatial_sampler_matches_jax(sp2):
    for out in sp2.ranks:
        for k, r in sp2.ref["traj"].items():
            np.testing.assert_allclose(out["traj"][k].numpy(), r, atol=1e-4, rtol=1e-4,
                                       err_msg=k)


def test_sp_ranks_share_seed_noise_and_end_equal(sp2):
    r0, r1 = sp2.ranks
    assert r0["seed"] == r1["seed"] == [7, 7]  # seed = base_seed + dp_index
    for mode in ("spatial", "attention"):
        assert len(r0[f"{mode}_noise"]) == 1 and r0[f"{mode}_noise"] == r1[f"{mode}_noise"]
        assert r0[f"{mode}_rewards"] == r1[f"{mode}_rewards"]
        assert len(r0[f"{mode}_digest"]) == 1 and r0[f"{mode}_digest"] == r1[f"{mode}_digest"]
        assert any(f"sp=2 {mode}" in line for line in r0[f"{mode}_lines"]), r0[f"{mode}_lines"]


# --------------------------- four ranks: dp 2 x sp 2 --------------------------- #

SP4 = r'''
import contextlib, io
from types import SimpleNamespace
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from ddpo_torch.core.scheduler import DDIMScheduler
from ddpo_torch.ops.attention import set_attention_sharding
from ddpo_torch.parallel import MeshConfig, create_mesh, maybe_initialize_distributed
from ddpo_torch.pipelines import policy_gradient
from ddpo_torch.pipelines.policy_gradient import make_train_apply
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import AccumulatingTrainState, train_step_fused
from ddpo_torch.utils.serialization import build_models

maybe_initialize_distributed()
rank = dist.get_rank()
mesh = create_mesh(MeshConfig(sp=2), torch.device("cpu"))
inputs = torch.load("inputs.pt", weights_only=False)
rows = slice(2 * mesh.dp_index, 2 * mesh.dp_index + 2)
ddim = DDIMScheduler()
ddim_state = ddim.set_timesteps(ddim.create_state(), 10)
b = inputs["ddpo"]
local = {k: (v[:, rows] if k in ("latents", "next_latents", "ts", "log_probs") else v[rows])
         for k, v in b.items()}


class Recorder:
    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def init(self, params):
        return self.tx.init(params)

    def step(self, params, grads, state):
        self.grads = {k: g.clone() for k, g in grads.items()}
        self.tx.step(params, grads, state)


out = {"mesh": [mesh.dp, mesh.sp, mesh.dp_index, mesh.sp_index]}
for case in ("spatial", "attention", "lora"):
    _, _, unet = build_models("tiny", "cpu")
    unet.load_state_dict(inputs["unet"])
    axis = None if case == "attention" else mesh.axis("sp")
    base = None
    if case == "lora":
        base = dict(unet.requires_grad_(False).named_parameters())
        params = {k: v.clone().requires_grad_(True) for k, v in inputs["adapters"].items()}
    else:
        params = dict(unet.requires_grad_(True).named_parameters())
    if case == "attention":
        set_attention_sharding(mesh, batch_axis="dp", seq_axis="sp")
    rec = Recorder(build_optimizer(SimpleNamespace(**inputs["opt"])))
    state = AccumulatingTrainState(
        apply_fn=make_train_apply(unet, torch.float32, remat=False, base=base, spatial=axis),
        params=params, tx=rec, accumulate=False,
        grad_reduce=policy_gradient.gradient_reduce(mesh, axis is not None, None, "gloo"))
    train_step_fused(state, local, ddim_state, ddim, True, 5.0, 1.0, 1e-2,
                     do_opt_update=True, cfg_concat=True)
    set_attention_sharding(None)
    out[case] = {"grads": rec.grads, "params": {k: p.detach().clone() for k, p in params.items()}}

printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    out["rewards"] = policy_gradient.main([
        "--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
        "--resolution", "32", "--sample_batch_size", "2", "--train_batch_size", "1",
        "--num_train_epochs", "1", "--mesh_sp", "2", "--seed", "3"])
lines = printed.getvalue().splitlines()
out["noise"] = [l.split("initial noise digest ")[1] for l in lines if "initial noise digest" in l]
out["digest"] = [l for l in lines if "params digest" in l]
torch.save(out, f"sp4_{rank}.pt")
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def sp4(tmp_path_factory):
    j_unet, params = _tiny_params(5)
    mesh = _mesh(2, 2)
    sched = sd_scheduler()
    sched_state = sched.set_timesteps(sched.create_state(), STEPS)
    ddpo = _ddpo_batch(j_unet, params, sched, sched_state)
    per_t = ("latents", "next_latents", "ts", "log_probs")
    placed = {k: jax.device_put(v, NamedSharding(mesh, P(None, "dp") if k in per_t else P("dp")))
              for k, v in ddpo.items()}
    apply_sp = j_spatial_apply(mesh, j_unet)
    plain = lambda p, x, t, c: j_unet.apply({"params": p}, x, t, c)  # noqa: E731
    opt = SimpleNamespace(**OPT)

    lora = j_lora.init_lora(params, 2, jax.random.PRNGKey(1))
    lora = _host(jax.tree_util.tree_map(
        lambda a: a + 0.05 * np.random.default_rng(1).standard_normal(a.shape).astype(np.float32),
        lora))

    def step(apply, p, **kw):
        state = JaxState.create(apply_fn=apply, params=p, tx=_recording_tx(), accumulate=False)
        fn = jax.jit(lambda st, b, ss: j_train_step_fused(
            st, b, ss, sched, True, GUIDANCE, 1.0, CLIP, do_opt_update=True, cfg_concat=True,
            **kw))
        return _host(fn(state, placed, sched_state)[0].opt_state)

    ref = {}
    grads = step(apply_sp, params)
    ref["spatial"] = {"grads": _jax_tree(grads), "params": _jax_tree(_adamw_step(params, grads, opt)),
                      "before": _jax_tree(params)}
    j_set_attention_sharding(mesh, batch_axis="dp", seq_axis="sp")
    try:
        with mesh:
            grads = step(plain, params)
    finally:
        j_set_attention_sharding(None)
    ref["attention"] = {"grads": _jax_tree(grads),
                        "params": _jax_tree(_adamw_step(params, grads, opt)),
                        "before": _jax_tree(params)}
    lora_apply = lambda base, p, x, t, c: apply_sp(j_lora.merge_lora(base, p), x, t, c)  # noqa: E731
    grads = step(lora_apply, lora, frozen=params)
    ref["lora"] = {"grads": lora_from_flax(grads), "params": lora_from_flax(
        _adamw_step(lora, grads, opt)), "before": lora_from_flax(lora)}
    ref["lora"] = {k: {n: v.numpy() for n, v in tree.items()} for k, tree in ref["lora"].items()}

    tmp = tmp_path_factory.mktemp("sp4")
    torch.save({"unet": from_flax({"unet": params})["unet"], "opt": OPT,
                "adapters": lora_from_flax(lora),
                "ddpo": {k: torch.from_numpy(np.asarray(v)) for k, v in ddpo.items()}},
               tmp / "inputs.pt")
    return SimpleNamespace(ref=ref, ranks=run_ranks(tmp, SP4, "sp4", 4, timeout=600))


CASES = ["spatial", "attention", "lora"]


def test_sp4_mesh_layout(sp4):
    assert [r["mesh"] for r in sp4.ranks] == [[2, 2, 0, 0], [2, 2, 0, 1], [2, 2, 1, 0],
                                              [2, 2, 1, 1]]


@pytest.mark.parametrize("case", CASES)
def test_sp4_ranks_end_bit_equal(sp4, case):
    first = sp4.ranks[0][case]
    for out in sp4.ranks[1:]:
        for what in ("grads", "params"):
            a, b = _port_tree(first[what]), _port_tree(out[case][what])
            assert all(np.array_equal(a[k], b[k]) for k in a), (case, what)


@pytest.mark.parametrize("case", CASES)
def test_sp4_reduced_gradients_match_jax(sp4, case):
    got, ref = _port_tree(sp4.ranks[0][case]["grads"]), sp4.ref[case]["grads"]
    assert set(got) == set(ref)
    gmax = max(np.abs(r).max() for r in ref.values())
    assert gmax > 1e-6  # a real gradient flowed
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-5 * gmax, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_sp4_updated_params_match_jax(sp4, case):
    """tests/test_torch_distributed.py's bound: given each side's own reduced
    gradient, one clip + adamw step may differ by lr * |u_port - u_jax|,
    lr * 2^-7 (the bf16 first moment) and 2 ulps of the param."""
    got, ref = _port_tree(sp4.ranks[0][case]["params"]), sp4.ref[case]["params"]
    before = sp4.ref[case]["before"]
    gt = _clip(_port_tree(sp4.ranks[0][case]["grads"]), OPT["max_grad_norm"])
    gj = _clip(sp4.ref[case]["grads"], OPT["max_grad_norm"])
    lr, eps = OPT["learning_rate"], OPT["epsilon"]
    for k, p in before.items():
        u_t, u_j = gt[k] / (np.abs(gt[k]) + eps), gj[k] / (np.abs(gj[k]) + eps)
        bound = lr * (np.abs(u_t - u_j) + 2.0 ** -7) + 2 * np.spacing(np.abs(p))
        diff = np.abs(got[k] - ref[k])
        assert (diff <= bound).all(), (k, float((diff - bound).max()))
        assert not np.array_equal(got[k], p), k


def test_sp4_spatial_reduce_sums_over_sp(sp4):
    """The spatial mode's gradient is the sum over sp and the mean over dp:
    against JAX's global step, a mean over the world would halve it."""
    got = _port_tree(sp4.ranks[0]["spatial"]["grads"])
    ref = sp4.ref["spatial"]["grads"]
    num = sum(float(np.vdot(got[k], ref[k])) for k in ref)
    den = sum(float(np.vdot(ref[k], ref[k])) for k in ref)
    assert abs(num / den - 1.0) < 1e-4  # 0.5 if the reduce averaged over the world


def test_sp4_driver_noise_per_dp_slice(sp4):
    noise = [r["noise"] for r in sp4.ranks]
    assert noise[0] == noise[1] and noise[2] == noise[3] and noise[0] != noise[2]
    assert all(r["rewards"] == sp4.ranks[0]["rewards"] for r in sp4.ranks)
    digests = [r["digest"] for r in sp4.ranks]
    assert len(digests[0]) == 1 and all(d == digests[0] for d in digests)
