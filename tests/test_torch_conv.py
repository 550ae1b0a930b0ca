"""The port's direct 3x3 conv, its switch and the conv probes against
ddpo_tpu's, on the CPU.

The same numpy inputs (fp32, from a seed) go through both packages. JAX's
Pallas kernels run in interpret mode: ``conv3x3_direct(..., interpret=True)``
directly; inside its models through a monkeypatched
``ddpo_tpu.ops.conv.conv3x3_direct`` (``conv3x3`` passes ``interpret=False``
itself); the probes of bench_conv_probe.py, cut to a small shape, through a
monkeypatched ``pallas_call``, with their bf16 output type read as fp32. On
the CPU the port's wrappers run the kernels' plain versions. Tolerances:
1e-5 for one conv or probe (fp32 sums in another order); a tiny-preset UNet
forward 1e-4 and a 2-step rollout 2e-4 on the latents and 1e-5 on the
log-probs, the bounds of tests/test_torch_models.py and
tests/test_torch_sampler.py. The CUDA kernel is held against the plain
versions on the card by tests/test_torch_kernels.py.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from torch.utils.checkpoint import checkpoint

import ddpo_tpu.ops.conv as jconv
from ddpo_torch.bench import conv_probe
from ddpo_torch.core.scheduler import DDIMScheduler as TorchDDIM
from ddpo_torch.models.convert import from_flax
from ddpo_torch.ops import _build
from ddpo_torch.ops import conv as tconv
from ddpo_torch.sampling import SamplerConfig as TorchSamplerConfig
from ddpo_torch.sampling import sample_trajectories
from ddpo_torch.utils.serialization import build_models
from ddpo_tpu.sampling.sampler import SamplerConfig as JaxSamplerConfig
from ddpo_tpu.sampling.sampler import sample_trajectories as jax_sample_trajectories
from ddpo_tpu.utils.serialization import _tiny_stack, sd_scheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
JAX_DIRECT = jconv.conv3x3_direct


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _conv_inputs(b, h, w, cin, cout, seed):
    """NHWC x, HWIO weight, bias and an NHWC cotangent, fp32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, cin)).astype(np.float32),
            (rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5).astype(np.float32),
            rng.standard_normal(cout).astype(np.float32),
            rng.standard_normal((b, h, w, cout)).astype(np.float32))


@pytest.fixture
def switch_on(monkeypatch):
    """Both packages' conv switch on; JAX's kernel in interpret mode. Yields
    the calls of each package's direct conv (the port's plain version on
    the CPU), so a test can show that its models went through them."""
    calls = {"jax": 0, "torch": 0}

    def jax_direct(*args, **kwargs):
        calls["jax"] += 1
        return JAX_DIRECT(*args, interpret=True, **kwargs)

    def torch_direct(*args):
        calls["torch"] += 1
        return reference(*args)

    reference = tconv.conv3x3_reference
    monkeypatch.setattr(jconv, "conv3x3_direct", jax_direct)
    monkeypatch.setattr(tconv, "conv3x3_reference", torch_direct)
    jconv.set_conv_kernel_enabled(True)
    tconv.set_conv_kernel_enabled(True)
    yield calls
    jconv.set_conv_kernel_enabled(None)
    tconv.set_conv_kernel_enabled(None)


CONV_CASES = [(2, 8, 8, 16, 32), (1, 5, 7, 4, 8)]  # (B, H, W, Cin, Cout); a ragged map


@pytest.mark.parametrize("b,h,w,cin,cout", CONV_CASES)
def test_conv3x3_switch_on_matches_jax_direct(switch_on, b, h, w, cin, cout):
    """Forward against conv3x3_direct with K folded and with 9 taps, bias
    added after the product as JAX adds it."""
    x, wt, bias, _ = _conv_inputs(b, h, w, cin, cout, seed=cin)
    out = tconv.conv3x3(_nchw(x), torch.from_numpy(wt).permute(3, 2, 0, 1),
                        torch.from_numpy(bias))
    for kfold in (True, False):
        ref = JAX_DIRECT(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                         interpret=True, kfold=kfold)
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,h,w,cin,cout", CONV_CASES)
def test_conv3x3_switch_on_gradients_match_jax_vjp(switch_on, b, h, w, cin, cout):
    """d/dx, d/dw and d/dbias of <cot, conv3x3(x, w) + bias> against JAX's
    conv3x3 with the switch on: _conv3x3_pallas_op's VJP (the XLA conv's)."""
    x, wt, bias, cot = _conv_inputs(b, h, w, cin, cout, seed=cin + 1)
    j_grads = jax.grad(lambda x_, w_, b_: jnp.sum(jnp.asarray(cot) * jconv.conv3x3(x_, w_, b_)),
                       argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias))
    leaves = [_nchw(x).requires_grad_(), torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous()
              .requires_grad_(), torch.from_numpy(bias).requires_grad_()]
    tconv.conv3x3(*leaves).backward(_nchw(cot))
    np.testing.assert_allclose(_nhwc(leaves[0].grad), np.asarray(j_grads[0]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(leaves[1].grad.permute(2, 3, 1, 0).numpy(), np.asarray(j_grads[1]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(leaves[2].grad.numpy(), np.asarray(j_grads[2]), rtol=TOL, atol=TOL)
    assert switch_on["jax"] >= 1 and switch_on["torch"] == 1


def test_conv3x3_switch_semantics_on_the_cpu(monkeypatch):
    """None (auto) and False are F.conv2d exactly; True is the plain 9-tap
    version plus the bias, differentiable under a non-reentrant checkpoint
    (remat), and nothing loads the kernel library or counts a launch."""
    def refuse():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", refuse)
    before = _build.launch_counts()
    x, wt, bias, cot = (torch.from_numpy(a) for a in _conv_inputs(2, 6, 6, 8, 16, seed=3))
    x, cot, weight = x.permute(0, 3, 1, 2), cot.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
    library = F.conv2d(x, weight, bias, padding=1)
    try:
        for value in (None, False):
            tconv.set_conv_kernel_enabled(value)
            assert torch.equal(tconv.conv3x3(x, weight, bias), library)
        tconv.set_conv_kernel_enabled(True)
        on = tconv.conv3x3(x, weight, bias)
        assert torch.equal(on, tconv.conv3x3_reference(x, weight) + bias[:, None, None])
        torch.testing.assert_close(on, library, rtol=TOL, atol=TOL)
        grads = []
        for remat in (False, True):
            leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
            out = (checkpoint(tconv.conv3x3, *leaves, use_reentrant=False) if remat
                   else tconv.conv3x3(*leaves))
            out.backward(cot)
            grads.append([t.grad for t in leaves])
        for a, r in zip(*grads):
            assert torch.equal(a, r)
    finally:
        tconv.set_conv_kernel_enabled(None)
    assert _build.launch_counts() == before


@pytest.fixture
def probe_module(monkeypatch):
    """bench_conv_probe at (B2, 8x8, 16 -> 32), its Pallas calls in
    interpret mode, its bf16 output type read as fp32."""
    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "bench_conv_probe", os.path.join(REPO, "bench_conv_probe.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    # importing it points the compilation cache at its own directory
    jax.config.update("jax_compilation_cache_dir", cache_dir)

    class Float32Numpy:
        def __getattr__(self, name):
            return jnp.float32 if name == "bfloat16" else getattr(jnp, name)

    for name, value in (("B", 2), ("H", 8), ("W", 8), ("CIN", 16), ("COUT", 32),
                        ("jnp", Float32Numpy())):
        monkeypatch.setattr(module, name, value)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    return module


def test_conv_probes_match_jax(probe_module):
    m = probe_module
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m.B, m.H, m.W, m.CIN)).astype(np.float32)
    w9 = (rng.standard_normal((9, m.CIN, m.COUT)) * 0.1).astype(np.float32)
    # the windows of JAX's main2: H padded, then the dx = -1 / +1 shifts
    xh = jnp.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)))
    xl = jnp.pad(xh, ((0, 0), (0, 0), (1, 0), (0, 0)))[:, :, :m.W, :]
    xr = jnp.pad(xh, ((0, 0), (0, 0), (0, 1), (0, 0)))[:, :, 1:, :]
    w3, w2 = w9.reshape(3, 3 * m.CIN, m.COUT), w9.reshape(9 * m.CIN, m.COUT)
    refs = {"p1": m.p1(jnp.asarray(x), w9), "p2": m.p2(xh, w9), "p6": m.p6(xl, xh, xr, w3),
            "p7": m.p7(xl, xh, xr, w2)}
    weights = {"p1": w9, "p2": w9, "p6": w3, "p7": w2}
    xt = _nchw(x)
    for name, ref in refs.items():
        assert ref.dtype == jnp.float32
        out = getattr(conv_probe, name)(xt, torch.from_numpy(weights[name]))
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def tiny_unets():
    """JAX's tiny UNet with params from a seed, and the port's loaded
    with them through from_flax."""
    _, _, j_unet = _tiny_stack(jnp.float32)
    params = jax.jit(j_unet.init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, 32)),
    )["params"]
    _, _, t_unet = build_models("tiny", "cpu")
    t_unet.load_state_dict(from_flax({"unet": jax.tree_util.tree_map(np.asarray, params)})["unet"])
    return j_unet, params, t_unet.eval()


def test_tiny_unet_with_the_switch_on_matches_jax(switch_on, tiny_unets):
    j_unet, params, t_unet = tiny_unets
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([999, 21], dtype=np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    ref = np.asarray(j_unet.apply({"params": params}, x, t, ctx))
    with torch.no_grad():
        out = t_unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    # conv_in, 8 resnets x 2, 1 upsampler, conv_out in each package
    assert switch_on == {"jax": 19, "torch": 19}


def test_rollout_with_the_switch_on_matches_jax(switch_on, tiny_unets):
    """2 DDIM steps at 64 px with CFG, JAX's noise injected into the port."""
    j_unet, params, t_unet = tiny_unets
    steps, batch, res = 2, 2, 64
    rng = np.random.default_rng(2)
    prompt = rng.standard_normal((batch, 77, 32)).astype(np.float32)
    uncond = rng.standard_normal((batch, 77, 32)).astype(np.float32)
    init = rng.standard_normal((batch, 4, res // 8, res // 8)).astype(np.float32)
    j_sched = sd_scheduler()
    key = jax.random.PRNGKey(13)
    j_traj = jax.jit(
        lambda p, pe, ue, k, init: jax_sample_trajectories(
            lambda pp, x, t, c: j_unet.apply({"params": pp}, x, t, c),
            p, j_sched, j_sched.create_state(), pe, ue, k,
            JaxSamplerConfig(num_inference_steps=steps, height=res, width=res),
            init_latents=init,
        )
    )(params, prompt, uncond, key, init)
    noise, carry = [], key  # the scan splits its key once a step
    for _ in range(steps):
        carry, step_key = jax.random.split(carry)
        noise.append(np.asarray(jax.random.normal(step_key, init.shape, jnp.float32)))
    t_sched = TorchDDIM()
    t_traj = sample_trajectories(
        t_unet, t_sched, t_sched.create_state(), torch.from_numpy(prompt),
        torch.from_numpy(uncond), TorchSamplerConfig(num_inference_steps=steps, height=res,
                                                     width=res),
        init_latents=torch.from_numpy(init), noise=torch.from_numpy(np.stack(noise)))
    for k in ("latents", "next_latents", "final_latents"):
        np.testing.assert_allclose(t_traj[k].numpy(), np.asarray(j_traj[k]), atol=2e-4)
    np.testing.assert_allclose(t_traj["log_probs"].numpy(), np.asarray(j_traj["log_probs"]),
                               atol=1e-5)
    # the port runs the 19 convs once per step (CFG as one 2B call); JAX
    # traces them at least once
    assert switch_on["jax"] >= 19 and switch_on["torch"] == 19 * steps


@pytest.mark.parametrize("cin,cout", [(4, 320), (320, 4), (96, 40), (3, 5)])
def test_weight_kn_is_jax_kfold_layout(cin, cout):
    """The tap-GEMM's weight operand from an OIHW weight is JAX's HWIO weight
    reshaped to (9 * Cin, Cout), the K order (dy, dx, cin) of its kfold,
    transposed to output-major rows and padded with zeros to (padded(Cout),
    9 * padded(Cin)); on the CPU ``tap_weight`` is the plain version the
    card's layout kernel repeats, and a (9, Cin, Cout)-ordered weight (the
    probes') gives the same operand."""
    wt = np.random.default_rng(cin + cout).standard_normal((3, 3, cin, cout)).astype(np.float32)
    oihw = torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous()
    w_nk = tconv.tap_weight(oihw)
    cin_p, cout_p = tconv.padded(cin), tconv.padded(cout)
    assert cin_p % 8 == 0 and cout_p % 8 == 0 and cin_p - cin < 8 and cout_p - cout < 8
    assert w_nk.shape == (cout_p, 9 * cin_p) and w_nk.is_contiguous()
    taps = w_nk.numpy().reshape(cout_p, 9, cin_p)
    kfold = taps[:cout, :, :cin].reshape(cout, 9 * cin).T
    np.testing.assert_array_equal(kfold, np.asarray(jnp.asarray(wt).reshape(9 * cin, cout)))
    assert not taps[cout:].any() and not taps[:, :, cin:].any()
    np.testing.assert_array_equal(tconv.tap_weight_kn(torch.from_numpy(wt).reshape(9, cin, cout)),
                                  w_nk.numpy())


def test_layout_cache_follows_the_weight():
    """A layout kept per weight is made once while the weight lives
    unchanged, again after an in-place write, apart for another tensor, and
    dropped when the weight dies."""
    store, made = {}, []

    def layout(w):
        return tconv.cached_per_version(store, w, lambda: made.append(w.clone()) or made[-1])

    w = torch.randn(4, 3, 3, 3)
    first = layout(w)
    assert layout(w) is first and len(made) == 1
    w.mul_(2)
    second = layout(w)
    assert second is not first and torch.equal(second, w) and len(made) == 2
    other = w.clone()
    assert layout(other) is not second and len(store) == 2
    del w, other
    assert store == {}


@pytest.mark.parametrize("n", [1, 6])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_per_image_matches_one_call(n, stride):
    """The library conv one image a call (inside batch_invariant() on the
    card) gives the one-call conv's values, and its backward (one call over
    the whole batch) the same input, weight and bias gradients (fp32, atol
    1e-5: another summation order at most)."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, 8, 9, 9)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 8, 3, 3)).astype(np.float32) * 0.2)
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    ins = [[t.clone().requires_grad_(True) for t in (x, w, b)] for _ in range(2)]
    out = tconv.ConvPerImage.apply(*ins[0], stride, 1)
    ref = F.conv2d(*ins[1], stride=stride, padding=1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-5)
    g = torch.from_numpy(rng.standard_normal(tuple(ref.shape)).astype(np.float32))
    out.backward(g)
    ref.backward(g)
    for a, r in zip(ins[0], ins[1]):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n, piece", [(1, 4), (4, 4), (6, 4), (16, 4), (3, 1)])
def test_in_pieces_pads_and_drops(n, piece):
    """invariance.in_pieces calls fn with exactly ``piece`` rows each time and
    returns fn's rows in order, the padding's dropped."""
    from ddpo_torch.ops import invariance

    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    y = -x
    sizes = []

    def fn(a, b):
        sizes.append(a.shape[0])
        return a * 2 + b

    out = invariance.in_pieces(fn, [x, y], piece)
    assert torch.equal(out, x * 2 + y)
    assert set(sizes) == {piece} and len(sizes) == -(-n // piece)


def test_batch_invariant_changes_nothing_on_the_cpu():
    """On CPU tensors the mode keeps the library conv and the plain
    attention as they are (the kernel runs only on the card)."""
    from ddpo_torch.ops import attention, invariance

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 4, 8, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 4, 3, 3)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((6, 16, 2, 8)).astype(np.float32))
    before = _build.launch_counts()
    with invariance.batch_invariant():
        assert invariance.enabled()
        conv_out = tconv.conv3x3(x, w)
        att_out = attention(q, q, q)
    assert not invariance.enabled()
    assert _build.launch_counts() == before
    assert torch.equal(conv_out, F.conv2d(x, w, padding=1))
    assert torch.equal(att_out, attention(q, q, q))
