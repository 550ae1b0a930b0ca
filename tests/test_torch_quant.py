"""The port's W8A8 int8 conv (ops/quant.py) and the quantized UNet against
ddpo_tpu's, at fp32 and bf16 on the CPU.

The same numpy inputs go through both packages (NCHW/OIHW in the port,
NHWC/HWIO in JAX). On the CPU the port's op runs the s8 kernel's plain
version, which sums the codes exactly; tests/test_torch_kernels.py holds
the CUDA kernel against it bit for bit on the card. Bounds:
- ``quantize_symmetric``: codes equal to JAX's, scales within 1 ulp;
- ``conv3x3_w8a8``: 1e-5 relative L2 against JAX's (measured 0: the same
  codes, exact sums, the same epilogue), fp32 and bf16;
- the quantized tiny UNet against JAX's ``unet.clone(quant=True)``: 1e-3
  relative L2 (an fp32 ulp upstream can flip one activation's rounding to
  another code; measured 4.8e-7), well under the quant-vs-float gap, 2.1e-2
  here, which JAX bounds at 0.15.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddpo_torch.models.convert import from_flax
from ddpo_torch.models.layers import Conv3x3
from ddpo_torch.ops import _build
from ddpo_torch.ops import conv as tconv
from ddpo_torch.ops import invariance
from ddpo_torch.ops.quant import (
    activation_scale,
    conv3x3_w8a8,
    conv3x3_w8a8_reference,
    quantize_symmetric,
    quantize_with_scale,
    tap_gemm_s8,
    tap_gemm_s8_plain,
    tap_gemm_s8_reference,
    weight_codes,
)
from ddpo_torch.utils.serialization import build_models
from ddpo_tpu.ops.quant import conv3x3_w8a8 as jax_conv3x3_w8a8
from ddpo_tpu.ops.quant import quantize_symmetric as jax_quantize_symmetric
from ddpo_tpu.utils.serialization import _tiny_stack

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _inputs(b, cin, cout, h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cin, h, w)).astype(np.float32),
            (rng.standard_normal((cout, cin, 3, 3)) * (9 * cin) ** -0.5).astype(np.float32),
            rng.standard_normal(cout).astype(np.float32) * 0.1)


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
@pytest.mark.parametrize("shape,dims,jdims", [
    ((3, 16, 8, 8), (1, 2, 3), (1, 2, 3)),  # activations: per sample
    ((24, 16, 3, 3), (1, 2, 3), (0, 1, 2)),  # weights: per output channel
])
def test_quantize_symmetric_matches_jax(dtype, jdtype, shape, dims, jdims):
    """Codes equal, scales within 1 ulp; JAX's layout is NHWC or HWIO."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 3
    perm = (0, 2, 3, 1) if jdims == (1, 2, 3) else (2, 3, 1, 0)
    q, scale = quantize_symmetric(torch.from_numpy(x).to(dtype), dims)
    jq, jscale = jax_quantize_symmetric(jnp.asarray(x.transpose(perm)).astype(jdtype), jdims)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().transpose(perm), np.asarray(jq))
    s, js = scale.numpy().ravel(), np.asarray(jscale).ravel()
    assert np.all(np.abs(s - js) <= np.spacing(js))
    assert int(q.abs().max()) == 127  # the largest |value| of each slice hits 127


def test_quantize_symmetric_roundtrip_and_zero_input():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 16, 8, 8)).astype(np.float32))
    q, scale = quantize_symmetric(x, (1, 2, 3))
    assert scale.shape == (4, 1, 1, 1)
    assert torch.all((q.float() * scale - x).abs() <= scale / 2 + 1e-7)
    q0, s0 = quantize_symmetric(torch.zeros(2, 4, 4, 8), (1, 2, 3))
    assert torch.all(q0 == 0) and torch.all(s0 > 0) and torch.isfinite(s0).all()


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
@pytest.mark.parametrize("bias", [True, False])
def test_conv3x3_w8a8_matches_jax(dtype, jdtype, bias):
    x, w, b = _inputs(2, 64, 48, 16, 16, seed=2)
    out = conv3x3_w8a8(torch.from_numpy(x).to(dtype), torch.from_numpy(w),
                       torch.from_numpy(b) if bias else None)
    jout = jax_conv3x3_w8a8(jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdtype),
                            jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b) if bias else None)
    assert out.dtype == dtype and out.shape == (2, 48, 16, 16)
    assert _rel_l2(out.float().numpy(), np.asarray(jout.astype(jnp.float32)).transpose(0, 3, 1, 2)) <= 1e-5


def test_conv3x3_w8a8_close_to_float_conv():
    """JAX's bound: the int8 conv within 2% relative L2 of the fp32 conv."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(2, 64, 64, 16, 16, seed=3))
    err = _rel_l2(conv3x3_w8a8(x, w, b).numpy(), F.conv2d(x, w, b, padding=1).numpy())
    assert 0 < err < 0.02, err


def test_plain_version_sums_exactly():
    """The int32 sums of the codes: float64 against an int64 loop over taps."""
    rng = np.random.default_rng(4)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 40, 5, 7), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (6, 9 * 40), dtype=np.int8))
    ones = torch.ones(2), torch.ones(6)
    got = tap_gemm_s8_reference(xq, wq, *ones, None, torch.float32)
    xp = F.pad(xq.long(), (1, 1, 1, 1))
    want = sum(torch.einsum("bchw,oc->bohw", xp[:, :, dy:dy + 5, dx:dx + 7],
                            wq.long().view(6, 3, 3, 40)[:, dy, dx])
               for dy in range(3) for dx in range(3))
    assert torch.equal(got, want.float())


def test_kernel_wrapper_refuses_rather_than_falls_back():
    """The s8 kernel's wrapper takes CUDA tensors only: a CPU tensor, an x
    that is not float, a weight that is not int8 codes or mis-shaped scales
    raise, and nothing launches."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 16, 4, 4)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (8, 9 * 16), dtype=np.int8))
    sx, sw = torch.ones(2), torch.ones(8)
    before = _build.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        tap_gemm_s8(x, wq, sx, sw, None, torch.float32)
    with pytest.raises(TypeError, match="float"):
        tap_gemm_s8(x.to(torch.int8), wq, sx, sw, None, torch.float32)
    with pytest.raises(TypeError, match="int8"):
        tap_gemm_s8(x, wq.float(), sx, sw, None, torch.float32)
    with pytest.raises(ValueError, match="sw"):
        tap_gemm_s8(x, wq, sx, torch.ones(7), None, torch.float32)
    with pytest.raises(ValueError, match="9"):
        tap_gemm_s8(x, wq[:, :-1], sx, sw, None, torch.float32)
    assert _build.launch_counts() == before


def _edge_images(dtype, seed):
    """Three images: random, all zeros, and one whose largest |value|
    occurs at both +absmax and -absmax, with values at half-code steps."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 16, 6, 5)).astype(np.float32) * 3
    x[1] = 0.0
    x[2] = np.clip(x[2], -3.5, 3.5)
    x[2, 0, 0, 0], x[2, 1, 2, 3] = 4.0, -4.0
    x[2, 2, 1] = np.arange(5, dtype=np.float32) * 4.0 / 127 * 0.5 + 4.0 / 127 * 0.5
    return torch.from_numpy(x).to(dtype), x


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_activation_scale_is_quantize_symmetric(dtype, jdtype):
    """The fused path's quantize: one reduction (the infinity norm) for the scale, then
    quantize_with_scale's fp32 round half to even and clamp, gives
    quantize_symmetric's scale and codes and JAX's codes, on an all-zero
    image and on values at +-absmax too."""
    x, xn = _edge_images(dtype, 9)
    sx = activation_scale(x)
    q, scale = quantize_symmetric(x, (1, 2, 3))
    assert sx.dtype == torch.float32 and sx.shape == (3,)
    assert torch.equal(sx, scale.reshape(-1))
    codes = quantize_with_scale(x, sx)
    assert codes.dtype == torch.int8 and torch.equal(codes, q)
    jq, _ = jax_quantize_symmetric(jnp.asarray(xn.transpose(0, 2, 3, 1)).astype(jdtype), (1, 2, 3))
    np.testing.assert_array_equal(codes.numpy().transpose(0, 2, 3, 1), np.asarray(jq))
    assert not codes[1].any() and codes[2].max() == 127 and codes[2].min() == -127


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_fused_plain_path_matches_jax_codes(dtype, jdtype):
    """tap_gemm_s8_plain (the kernel's signature: float x and its scale)
    equals the codes' plain product, and the op built on it equals JAX's
    conv3x3_w8a8 on the edge images."""
    x, xn = _edge_images(dtype, 10)
    w = (np.random.default_rng(11).standard_normal((8, 16, 3, 3)) / 12).astype(np.float32)
    wq, sw = weight_codes(torch.from_numpy(w))
    sx = activation_scale(x)
    got = tap_gemm_s8_plain(x, wq, sx, sw, None, dtype)
    assert torch.equal(got, tap_gemm_s8_reference(quantize_symmetric(x, (1, 2, 3))[0], wq, sx, sw,
                                                  None, dtype))
    jout = jax_conv3x3_w8a8(jnp.asarray(xn.transpose(0, 2, 3, 1)).astype(jdtype),
                            jnp.asarray(w.transpose(2, 3, 1, 0)))
    assert _rel_l2(conv3x3_w8a8(x, torch.from_numpy(w)).float().numpy(),
                   np.asarray(jout.astype(jnp.float32)).transpose(0, 3, 1, 2)) <= 1e-5


def test_dispatch_precedence_over_switch_and_invariance():
    """conv3x3(quant=True) runs the int8 conv whatever the direct-conv
    switch and batch_invariant() say, as JAX's quant takes precedence over
    its conv override; on the CPU no kernel launches."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(2, 32, 32, 8, 8, seed=5))
    want = conv3x3_w8a8_reference(x, w, b)
    before = _build.launch_counts()
    try:
        for switch in (None, True, False):
            tconv.set_conv_kernel_enabled(switch)
            assert torch.equal(tconv.conv3x3(x, w, b, quant=True), want)
            with invariance.batch_invariant():
                assert torch.equal(tconv.conv3x3(x, w, b, quant=True), want)
            assert not torch.equal(tconv.conv3x3(x, w, b), want)
    finally:
        tconv.set_conv_kernel_enabled(None)
    assert _build.launch_counts() == before


def test_backward_raises():
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, 4, 8, 8, 8, seed=6))
    w.requires_grad_(True)
    out = conv3x3_w8a8(x, w, b)
    with pytest.raises(NotImplementedError, match="inference-only"):
        out.sum().backward()
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="inference-only"):
        torch.autograd.grad(conv3x3_w8a8(x, w.detach()).sum(), x)


def test_weight_codes_follow_the_weight():
    """Codes are computed once while the weight lives unchanged, and again
    after an in-place update."""
    conv = Conv3x3(8, 4)
    first = weight_codes(conv.weight)
    assert weight_codes(conv.weight)[0] is first[0]
    with torch.no_grad():
        conv.weight.mul_(-1)
    codes, scales = weight_codes(conv.weight)
    assert torch.equal(codes, -first[0]) and torch.equal(scales, first[1])
    wq, sw = quantize_symmetric(conv.weight.detach(), (1, 2, 3))
    assert torch.equal(codes, wq.permute(0, 2, 3, 1).reshape(4, -1))


@pytest.fixture(scope="module")
def tiny_unets():
    _, _, j_unet = _tiny_stack(jnp.float32)
    latents = jnp.zeros((1, 4, 8, 8))
    params = jax.jit(j_unet.init)(jax.random.PRNGKey(0), latents, jnp.zeros((1,), jnp.int32),
                                  jnp.zeros((1, 77, 32)))["params"]
    _, _, t_unet = build_models("tiny", "cpu")
    t_unet.load_state_dict(from_flax({"unet": jax.tree_util.tree_map(np.asarray, params)})["unet"])
    t_unet.eval()
    return j_unet, params, t_unet


def test_quant_unet_matches_jax(tiny_unets):
    j_unet, params, t_unet = tiny_unets
    rng = np.random.default_rng(7)
    latents = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([5, 9], np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    j_float = np.asarray(j_unet.apply({"params": params}, latents, t, ctx))
    j_quant = np.asarray(j_unet.clone(quant=True).apply({"params": params}, latents, t, ctx))
    args = (torch.from_numpy(latents), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        t_quant = t_unet.set_quant(True)(*args).numpy()
        t_float = t_unet.set_quant(False)(*args).numpy()
    assert np.isfinite(t_quant).all()
    assert _rel_l2(t_quant, j_quant) <= 1e-3
    gap = _rel_l2(t_quant, t_float)
    assert 0 < gap < 0.15 and _rel_l2(j_quant, j_float) < 0.15
    assert _rel_l2(t_float, j_float) <= 1e-4  # the float path is untouched


def test_quant_sites_and_parameters_unchanged(tiny_unets):
    """set_quant marks exactly JAX's sites (each resnet's conv1 and conv2,
    each upsampler's conv) and changes no parameter."""
    _, _, t_unet = tiny_unets
    before = {k: v.clone() for k, v in t_unet.state_dict().items()}
    t_unet.set_quant(True)
    try:
        quant = {name for name, m in t_unet.named_modules() if isinstance(m, Conv3x3) and m.quant}
        want = {name for name, m in t_unet.named_modules()
                if isinstance(m, Conv3x3) and (".resnets." in name or ".upsamplers." in name)}
        assert quant == want and "conv_in" not in quant and "conv_out" not in quant
        after = t_unet.state_dict()
        assert list(after) == list(before)
        assert all(torch.equal(after[k], before[k]) for k in before)
    finally:
        t_unet.set_quant(False)
    assert not any(m.quant for m in t_unet.modules() if isinstance(m, Conv3x3))
