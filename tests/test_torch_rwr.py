"""The port's RWR stack against ddpo_tpu's, on the CPU at fp32 (tiny preset).

The JAX tiny stack is initialised from a seed and carried into the port by
``from_flax``; inputs come from a numpy seed. Tolerances:

  - the VAE encoder's moments and ``vae_fn``'s (N, h, w, 8) output: atol
    1e-4 (fp32 convs in another summation order, through every layer);
  - ``DiagonalGaussian.sample`` with injected noise and ``add_noise`` /
    ``get_velocity`` at random per-sample timesteps: atol 1e-6 (a few fp32
    operations on values of order 1);
  - ``train_step`` with JAX's own draws (``jax.random.split(rng, 4)``,
    reproduced here and injected into the port): the loss rtol 1e-5; the
    gradients per leaf atol 1e-4 * max|g| and rtol 1e-4 (as
    tests/test_torch_training.py holds the PPO step); the params after one
    adamw step (bound stated at ``_assert_adamw_step_close``);
  - the maskers' masks and cutoffs: equal; ``make_weights`` and
    ``softmax_ref``: atol 1e-12 (float64).
"""

import dataclasses
import pickle
from types import SimpleNamespace

import dill
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState

from ddpo_torch.core.scheduler import DDIMScheduler as TorchDDIM
from ddpo_torch.core.scheduler import DDPMScheduler as TorchDDPM
from ddpo_torch.models.convert import from_flax
from ddpo_torch.models.vae import DiagonalGaussian
from ddpo_torch.parallel.collectives import sharded_softmax, softmax_ref
from ddpo_torch.pipelines.policy_gradient import make_train_apply
from ddpo_torch.training import callbacks, diffusion
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import AccumulatingTrainState
from ddpo_torch.utils import images as t_images
from ddpo_torch.utils import maskers as t_maskers
from ddpo_torch.data import hdf5 as t_hdf5
from ddpo_torch.utils.serialization import build_models
from ddpo_tpu.core.scheduler import DDIMScheduler as JaxDDIM
from ddpo_tpu.core.scheduler import DDPMScheduler as JaxDDPM
from ddpo_tpu.data.hdf5 import _MultiFileReader as JaxMultiFileReader
from ddpo_tpu.models.tokenizer import HashTokenizer
from ddpo_tpu.models.vae import DiagonalGaussian as JaxDiagonalGaussian
from ddpo_tpu.parallel.collectives import softmax_ref as jax_softmax_ref
from ddpo_tpu.training import callbacks as j_callbacks
from ddpo_tpu.training import diffusion as j_diffusion
from ddpo_tpu.training.optim import build_optimizer as jax_build_optimizer
from ddpo_tpu.utils import images as j_images
from ddpo_tpu.utils import maskers as j_maskers
from ddpo_tpu.utils.serialization import _tiny_stack

OPT_ARGS = SimpleNamespace(learning_rate=1e-4, beta1=0.9, beta2=0.999, epsilon=1e-8,
                           weight_decay=1e-4, max_grad_norm=1.0, lr_schedule="constant",
                           lr_warmup_steps=0, lr_total_steps=None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """JAX modules and fp32 params, and the port's modules loaded from them."""
    j_text, j_vae, j_unet = _tiny_stack(jnp.float32)
    k_unet, k_vae, k_text = jax.random.split(jax.random.PRNGKey(11), 3)
    params = {
        "unet": jax.jit(j_unet.init)(k_unet, jnp.zeros((1, 4, 8, 8)),
                                     jnp.zeros((1,), jnp.int32),
                                     jnp.zeros((1, 77, 32)))["params"],
        "vae": jax.jit(j_vae.init)(k_vae, jnp.zeros((1, 3, 32, 32)),
                                   jax.random.PRNGKey(0))["params"],
        "text_encoder": jax.jit(j_text.init)(k_text, jnp.zeros((1, 77), jnp.int32))["params"],
    }
    params = jax.tree_util.tree_map(np.asarray, params)
    t_text, t_vae, t_unet = build_models("tiny", "cpu")
    state = from_flax(params)
    for module, name in ((t_unet, "unet"), (t_vae, "vae"), (t_text, "text_encoder")):
        module.load_state_dict(state[name], strict=True)
        module.eval()
    return SimpleNamespace(j_text=j_text, j_vae=j_vae, j_unet=j_unet, params=params,
                           t_text=t_text, t_vae=t_vae, t_unet=t_unet)


def test_encoder_moments_match_jax(tiny):
    x = np.random.default_rng(0).uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    ref = np.asarray(tiny.j_vae.apply({"params": tiny.params["vae"]}, x,
                                      method=tiny.j_vae.encode))
    with torch.no_grad():
        out = tiny.t_vae.encode(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, 8, 16, 16) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_vae_fn_matches_jax(tiny):
    images = np.random.default_rng(1).uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    ref, _ = j_callbacks.vae_fn(vae=tiny.j_vae, vae_params=tiny.params["vae"])(images, [], [])
    out, info = callbacks.callback_fns["vae"](vae=tiny.t_vae)(images, [], [])
    assert info == {} and out.shape == (3, 16, 16, 8) and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("dim", [-1, 1])
def test_diagonal_gaussian_sample_matches_jax(dim):
    rng = np.random.default_rng(2)
    moments = rng.standard_normal((2, 8, 4, 8)).astype(np.float32) * 3
    moments[..., -1] = 40.0  # logvars outside [-30, 20] are clipped on both sides
    moments[..., -2] = -45.0
    if dim == 1:
        moments = np.ascontiguousarray(np.moveaxis(moments, -1, 1))
    j_dist = JaxDiagonalGaussian(jnp.asarray(moments), axis=dim)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(j_dist.sample(key))
    noise = jax.random.normal(key, j_dist.mean.shape, dtype=j_dist.mean.dtype)
    dist = DiagonalGaussian(torch.from_numpy(moments), dim=dim)
    out = dist.sample(noise=torch.tensor(np.asarray(noise)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(dist.logvar.numpy(), np.asarray(j_dist.logvar), atol=0)
    assert torch.equal(dist.mode(), dist.mean)


@pytest.mark.parametrize("fn", ["ddim_add_noise", "ddpm_add_noise", "get_velocity"])
def test_forward_noising_matches_jax(fn):
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((6, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = rng.integers(0, 1000, 6)
    kind, _, name = fn.partition("_") if fn != "get_velocity" else ("ddim", "", fn)
    j_sched = {"ddim": JaxDDIM, "ddpm": JaxDDPM}[kind]()
    t_sched = {"ddim": TorchDDIM, "ddpm": TorchDDPM}[kind]()
    j_state, t_state = j_sched.create_state(), t_sched.create_state()
    # the schedules agree within test_torch_scheduler.py's bound (fp32
    # cumprods over 1000 betas, reduced in another order); the noising math
    # is held here on JAX's own alphas_cumprod
    np.testing.assert_allclose(t_state.alphas_cumprod.numpy(), np.asarray(j_state.alphas_cumprod),
                               rtol=1e-5, atol=1e-6)
    t_state = dataclasses.replace(
        t_state, alphas_cumprod=torch.tensor(np.asarray(j_state.alphas_cumprod)))
    ref = getattr(j_sched, name)(j_state, jnp.asarray(x0), jnp.asarray(noise),
                                 jnp.asarray(t, jnp.int32))
    out = getattr(t_sched, name)(t_state, torch.from_numpy(x0), torch.from_numpy(noise),
                                 torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def _recording_tx():
    """An optax transform whose state is the last gradient and whose update
    is zero: JAX's train_step then hands its exact gradients back."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, state, params=None: (zeros(g), g))


def _rwr_batch(seed=5, b=2):
    rng = np.random.default_rng(seed)
    tok = HashTokenizer()
    moments = rng.standard_normal((b, 8, 8, 8)).astype(np.float32)
    moments[..., 4:] = -2.0 + 0.5 * moments[..., 4:]  # logvars of a sharp posterior
    return {"vae": moments, "input_ids": tok(["a cat", "an otter on a rock"][:b]),
            "uncond_text": tok([""] * b)}


def _clip(grads, max_norm):
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in grads.values()))
    return {k: g * min(1.0, max_norm / norm) for k, g in grads.items()}


def _assert_adamw_step_close(t_after, j_after, before, t_grads, j_grads, args):
    """The first clip + adamw step moves each element by lr * (u + wd * p)
    with u = g/(|g| + eps), g the clipped gradient (one step's bias-corrected
    moments are g and g^2). Given each side's own gradient, the two sides'
    params may differ by lr * |u(g_port) - u(g_jax)|, plus the fp32 rounding
    of the step: 2 ulp of the param and 1e-6 * lr. The gradients themselves
    are held to their bound above."""
    lr, eps = args.learning_rate, args.epsilon
    gt, gj = _clip(t_grads, args.max_grad_norm), _clip(j_grads, args.max_grad_norm)
    for k, p in before.items():
        u_t = gt[k] / (np.abs(gt[k]) + eps)
        u_j = gj[k] / (np.abs(gj[k]) + eps)
        bound = lr * np.abs(u_t - u_j) + 2 * np.spacing(np.abs(p).astype(np.float32)) + 1e-6 * lr
        diff = np.abs(t_after[k] - j_after[k])
        assert (diff <= bound).all(), (k, float((diff - bound).max()))
        assert not np.array_equal(t_after[k], p), k  # every param moved


TRAIN_CASES = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("train_cfg,cfg_concat", TRAIN_CASES)
def test_train_step_matches_jax(tiny, train_cfg, cfg_concat, weighted):
    batch = _rwr_batch()
    weights = np.array([0.3, 0.7], np.float32) if weighted else None
    rng = jax.random.PRNGKey(9)
    j_sched = JaxDDPM()
    text_apply = lambda p, ids: tiny.j_text.apply({"params": p}, ids)  # noqa: E731
    state = TrainState.create(apply_fn=lambda p, x, t, c: tiny.j_unet.apply({"params": p}, x, t, c),
                              params=tiny.params["unet"], tx=_recording_tx())
    step = jax.jit(lambda st, b, r, ss, w: j_diffusion.train_step(
        st, text_apply, tiny.params["text_encoder"], b, r, ss, j_sched, train_cfg, 5.0,
        weights=w, cfg_concat=cfg_concat))
    new_state, j_loss, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
                                j_sched.create_state(),
                                None if weights is None else jnp.asarray(weights))
    j_grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state)
    # JAX's draws, in train_step's order
    sample_rng, noise_rng, timestep_rng, _ = jax.random.split(rng, 4)
    b, h, w, c = batch["vae"].shape
    draws = diffusion.Draws(
        posterior=torch.from_numpy(np.asarray(jax.random.normal(sample_rng, (b, h, w, c // 2)))),
        noise=torch.from_numpy(np.asarray(jax.random.normal(noise_rng, (b, c // 2, h, w)))),
        timesteps=torch.from_numpy(np.asarray(jax.random.randint(timestep_rng, (b,), 0, 1000))),
    )

    _, _, unet = build_models("tiny", "cpu")
    unet.load_state_dict(tiny.t_unet.state_dict())
    params = dict(unet.requires_grad_(True).named_parameters())
    before = {k: p.detach().numpy().copy() for k, p in params.items()}
    t_state = AccumulatingTrainState(
        apply_fn=make_train_apply(unet, torch.float32, remat=True), params=params,
        tx=build_optimizer(OPT_ARGS), accumulate=False)
    t_sched = TorchDDPM()
    loss = diffusion.train_step(
        t_state, tiny.t_text, {k: torch.from_numpy(v) for k, v in batch.items()},
        t_sched.create_state(), t_sched, train_cfg, 5.0,
        weights=None if weights is None else torch.from_numpy(weights),
        cfg_concat=cfg_concat, draws=draws)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert t_state.step == 1

    ref = from_flax({"unet": j_grads})["unet"]
    t_grads = {k: p.grad.numpy() for k, p in params.items()}
    scale = max(float(np.abs(r.numpy()).max()) for r in ref.values())
    for k, r in ref.items():
        np.testing.assert_allclose(t_grads[k], r.numpy(), rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=k)

    # JAX's clip + adamw on its own gradients, against the port's step
    tx = jax_build_optimizer(OPT_ARGS)
    j_params = tiny.params["unet"]
    updates, _ = tx.update(new_state.opt_state, tx.init(j_params), j_params)
    j_after = from_flax({"unet": jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(j_params, updates))})["unet"]
    _assert_adamw_step_close({k: p.detach().numpy() for k, p in params.items()},
                             {k: v.numpy() for k, v in j_after.items()}, before, t_grads,
                             {k: r.numpy() for k, r in ref.items()}, OPT_ARGS)


def test_draw_follows_jax_order_and_shapes():
    moments = torch.zeros((3, 4, 5, 8))
    draws = diffusion.draw(moments, 1000, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(draws.posterior, torch.randn((3, 4, 5, 4), generator=gen))
    assert torch.equal(draws.noise, torch.randn((3, 4, 4, 5), generator=gen))
    assert torch.equal(draws.timesteps, torch.randint(0, 1000, (3,), generator=gen))


@pytest.mark.parametrize("mode,param", [("percentile", 90), ("streaming_percentile", 50),
                                        ("threshold", 0.2)])
def test_maskers_match_jax(mode, param):
    rng = np.random.default_rng(6)
    ours, theirs = t_maskers.make_masker(mode, param), j_maskers.make_masker(mode, param)
    avg, j_avg = t_maskers.StreamingAverage(), j_maskers.StreamingAverage()
    for shape in [(8,), (8, 1), (5,)]:
        xs = rng.standard_normal(shape)
        np.testing.assert_array_equal(ours(xs), theirs(xs))
        assert ours.p == theirs.p and repr(ours) == repr(theirs)
        avg(float(xs.mean()))
        j_avg(float(xs.mean()))
    assert avg.avg == j_avg.avg


class _JaxReader(JaxMultiFileReader):
    """JAX's ``make_weights`` over in-memory fields."""

    def __init__(self, fields):
        self.fields_ = fields
        self._total_size = len(next(iter(fields.values())))

    def get(self, idx, field="images"):
        return self.fields_[field][idx]


@pytest.mark.parametrize("by_prompt", [False, True])
def test_make_weights_matches_jax(by_prompt):
    rng = np.random.default_rng(7)
    labels = rng.standard_normal((12, 1)) * 10
    prompts = np.array([b"a cat", b"a dog", b"an otter"] * 4)
    j_reader = _JaxReader({"jpeg": labels, "inference_prompts": prompts})
    j_reader.make_weights("jpeg", 1 / 5.0, by_prompt)
    ours = t_hdf5.make_weights(labels.squeeze(), 1 / 5.0, prompts if by_prompt else None)
    np.testing.assert_allclose(ours, j_reader.weights, atol=1e-12, rtol=0)
    np.testing.assert_allclose(ours.mean(), 1.0, atol=1e-12)


def test_softmax_ref_matches_jax():
    x = np.random.default_rng(8).standard_normal(16) * 30
    for temperature in (1.0, 0.2, 5.0):
        ref = jax_softmax_ref(x, temperature)
        np.testing.assert_allclose(softmax_ref(x, temperature), ref, atol=1e-12, rtol=0)
        np.testing.assert_allclose(sharded_softmax(torch.from_numpy(x), temperature).numpy(),
                                   ref, atol=1e-12, rtol=0)


def test_generic_codec_reads_dill_and_is_read_by_dill():
    prompts = [["a cat", "cat"], ["an otter"]]
    assert pickle.loads(dill.dumps(prompts)) == prompts
    assert dill.loads(pickle.dumps(prompts)) == prompts
    assert t_images.decode_generic(j_images.encode_generic(prompts)) == prompts
    assert j_images.decode_generic(t_images.encode_generic(prompts)) == prompts
    # a codec table the JAX package wrote names its functions: the port reads
    # it as its own, without importing ddpo_tpu's
    table = j_images.encode_generic({"images": j_images.decode_jpeg, "vae": None,
                                     "training_prompts": j_images.decode_generic})
    assert t_images.decode_generic(table) == {
        "images": t_images.decode_jpeg, "vae": None,
        "training_prompts": t_images.decode_generic}
    image = np.random.default_rng(9).uniform(0, 1, (16, 16, 3)).astype(np.float32)
    jpeg = t_images.encode_jpeg(image)
    np.testing.assert_array_equal(jpeg, j_images.encode_jpeg(image))
    np.testing.assert_array_equal(t_images.decode_jpeg(jpeg), j_images.decode_jpeg(jpeg))


def test_step_and_reward_feed_contiguous_nchw(tiny):
    """The kernels take contiguous NCHW maps only (a CUDA tensor in another
    layout raises): the step's latents and the reward's images are made
    contiguous after their transposes from channel-last."""
    seen = []
    hook = tiny.t_vae.encoder.conv_in.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].is_contiguous()))
    try:
        images = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
        callbacks.callback_fns["vae"](vae=tiny.t_vae)(images, [], [])
    finally:
        hook.remove()
    batch = {k: torch.from_numpy(v) for k, v in _rwr_batch().items()}
    params = dict(tiny.t_unet.named_parameters())

    def apply(p, x, t, c):
        seen.append(x.is_contiguous())
        return torch.zeros_like(x, requires_grad=True)

    state = SimpleNamespace(params=params, apply_fn=apply,
                            apply_gradients=lambda grads: None)
    sched = TorchDDPM()
    diffusion.train_step(state, tiny.t_text, batch, sched.create_state(), sched, False, 5.0,
                         generator=torch.Generator().manual_seed(0))
    assert seen == [True, True]
