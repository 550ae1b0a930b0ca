"""Each CUDA kernel against its plain PyTorch version, on the card.

Every test here carries the ``cuda`` marker and skips (inside the test, via
the ``cuda`` fixture) when torch.cuda.is_available() is false. The module
imports neither jax nor ddpo_tpu, so it also runs on a machine without
them; tests/conftest.py imports jax, hence on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

TF32 is switched off in the fixture so that fp32 plain versions are exact
fp32.
"""

import numpy as np
import pytest
import torch

from ddpo_torch.ops import _build
from ddpo_torch.ops.attention import (
    attention,
    attention_lse_reference,
    attention_reference,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
    flash_uses_tma,
)
from ddpo_torch.bench import conv_probe
from ddpo_torch.ops.conv import (
    conv3x3,
    conv3x3_direct,
    conv3x3_reference,
    set_conv_kernel_enabled,
    tap_weight,
    tap_weight_kn,
    tap_weight_reference,
)
from ddpo_torch.ops.quant import (
    VALID_ROWS,
    activation_scale,
    conv3x3_w8a8,
    conv3x3_w8a8_reference,
    quantize_symmetric,
    tap_gemm_s8,
    tap_gemm_s8_plain,
    weight_codes,
)
from ddpo_torch.ops.groupnorm import (
    gn_silu_plan,
    gn_stats_cluster_size,
    group_norm,
    group_norm_silu,
    group_norm_silu_reference,
    group_stats,
    group_stats_reference,
)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _qkv(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, sq, h, d)).astype(np.float32),
        rng.standard_normal((b, sk, h, d)).astype(np.float32),
        rng.standard_normal((b, sk, h, d)).astype(np.float32),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 1024, 1024, 8, 40), (2, 256, 256, 8, 160),
                                         (1, 300, 700, 4, 80)])
def test_flash_kernel_matches_plain(cuda, dtype, b, sq, sk, h, d):
    """Bounds: fp32 out 1e-4; bf16 out 1e-2 (its bf16 rounding); lse 1e-4."""
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(b, sq, sk, h, d))
    before = _build.launch_counts()["flash_fwd"]
    out, lse = flash_attention_fwd(q, k, v)
    assert _build.launch_counts()["flash_fwd"] == before + 1
    ref = attention_reference(q.float(), k.float(), v.float())
    bound = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref).abs().max().item() <= bound
    assert (lse - attention_lse_reference(q.float(), k.float())).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,g", [((8, 320, 64, 64), 32), ((2, 128, 256, 256), 32),
                                     ((2, 48, 17, 17), 16)])
def test_gn_stats_kernel_matches_plain(cuda, dtype, shape, g):
    """Bound: error relative to sum|x| (sum x^2) at most 1e-5, float64 truth;
    two calls on one input agree bit for bit (fixed reduction order)."""
    x = (torch.randn(shape, device=cuda) + 0.3).to(dtype)
    sums, sq = group_stats(x, g)
    sums2, sq2 = group_stats(x, g)
    assert torch.equal(sums, sums2) and torch.equal(sq, sq2)
    x64 = x.double().reshape(shape[0], g, -1)
    assert ((sums.double() - x64.sum(-1)).abs() / x64.abs().sum(-1)).max().item() <= 1e-5
    assert ((sq.double() - (x64 * x64).sum(-1)).abs() / (x64 * x64).sum(-1)).max().item() <= 1e-5
    ref_s, ref_sq = group_stats_reference(x, g)
    torch.testing.assert_close(sums, ref_s, rtol=1e-5, atol=1e-2)
    torch.testing.assert_close(sq, ref_sq, rtol=1e-5, atol=1e-2)


@pytest.mark.cuda
def test_dispatch_on_cuda(cuda):
    """The gate: long self-attention launches the kernel, 77-token
    cross-attention and D > 256 take the plain path; GroupNorm always
    launches the statistics kernel."""
    count = lambda: _build.launch_counts()["flash_fwd"]
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _qkv(2, 256, 256, 2, 40))
    before = count()
    attention(q, k, v)
    assert count() == before + 1
    ctx = torch.randn(2, 77, 2, 40, device=cuda, dtype=torch.bfloat16)
    attention(q, ctx, ctx)
    wide = torch.randn(1, 256, 1, 512, device=cuda, dtype=torch.bfloat16)
    attention(wide, wide, wide)
    assert count() == before + 1
    gn_before = _build.launch_counts()["gn_stats"]
    x = torch.randn(2, 64, 8, 8, device=cuda)
    out = group_norm(x, torch.ones(64, device=cuda), torch.zeros(64, device=cuda))
    assert _build.launch_counts()["gn_stats"] == gn_before + 1
    ref = group_norm(x.cpu(), torch.ones(64), torch.zeros(64))
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,h,d", [(4, 1024, 1024, 8, 40), (2, 1024, 1024, 8, 80),
                                         (4, 256, 256, 8, 160), (2, 300, 700, 8, 80),
                                         (2, 700, 300, 4, 112), (2, 300, 300, 2, 256),
                                         (1, 200, 130, 3, 16), (2, 200, 130, 3, 8),
                                         (2, 130, 200, 3, 20)])
def test_flash_backward_kernels_match_plain(cuda, dtype, b, sq, sk, h, d):
    """dq, dk, dv against the plain fp32 backward on the same inputs; bf16
    runs on the tensor cores at D = 8 to 256 (20 takes element-wise
    staging; 112 and up split dK and dV into column groups) and at ragged
    Sq != Sk both ways. Bounds: fp32 1e-4; bf16 1e-2 * max(1, max|ref|),
    the rounding of P and dS and of the bf16 outputs (half an ulp is 2^-9
    of the value). Two calls give the same bits, and so does image 0 alone
    against its slice of the batch (each output element has one owner; no
    atomics)."""
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(b, sq, sk, h, d, seed=2))
    do = torch.randn(q.shape, device=cuda).to(dtype)
    out, lse = flash_attention_fwd(q, k, v)
    before = _build.launch_counts()
    grads = flash_attention_bwd(q, k, v, out, lse, do)
    after = _build.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    again = flash_attention_bwd(q, k, v, out, lse, do)
    alone = flash_attention_bwd(q[:1], k[:1], v[:1], out[:1], lse[:1], do[:1])
    refs = flash_attention_bwd_reference(q, k, v, out, lse, do)
    for name, g, g2, g1, ref, x in zip("qkv", grads, again, alone, refs, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert torch.equal(g, g2) and torch.equal(g1, g[:1]), name
        bound = 1e-4 if dtype == torch.float32 else 1e-2 * max(1.0, ref.abs().max().item())
        assert (g.float() - ref).abs().max().item() <= bound, name


@pytest.mark.cuda
def test_autograd_through_attention_on_cuda(cuda):
    """Under autograd the gate goes through FlashAttention: bf16 runs the
    forward and both backward kernels; fp32 runs the forward kernel and
    differentiates the plain version (JAX's _use_pallas_bwd). The fp32
    gradient matches autograd through attention_reference within 1e-4."""
    for dtype, want_bwd in ((torch.bfloat16, 1), (torch.float32, 0)):
        q, k, v = (torch.from_numpy(x).to(cuda, dtype).requires_grad_()
                   for x in _qkv(2, 256, 256, 2, 40, seed=3))
        before = _build.launch_counts()
        out = attention(q, k, v)
        out.float().square().sum().backward()
        after = _build.launch_counts()
        assert after["flash_fwd"] == before["flash_fwd"] + 1
        assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + want_bwd
        assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + want_bwd
        assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
        if dtype == torch.float32:
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            attention_reference(*leaves).square().sum().backward()
            for t, r in zip((q, k, v), leaves):
                assert (t.grad - r.grad).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_paths_refuse_what_they_cannot_do(cuda):
    q = torch.randn(1, 256, 2, 40, device=cuda)
    with pytest.raises(TypeError):
        flash_attention_fwd(*(torch.randn(1, 256, 2, 40, device=cuda, dtype=torch.float16),) * 3)
    out, lse = flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, out, lse[:, :, :128], q)
    with pytest.raises(ValueError):
        group_stats(torch.randn(2, 64, 8, 8, device=cuda).transpose(2, 3), 32)


def _bound(dtype, ref):
    """bf16: 1e-2 * max(1, max|ref|), the rounding of the bf16 outputs;
    fp32: 1e-4 * max(1, max|ref|), the summation order."""
    return (1e-2 if dtype == torch.bfloat16 else 1e-4) * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8, 320, 64, 64), (2, 960, 64, 64), (2, 128, 256, 256),
                                   (2, 64, 17, 17), (1, 2560, 8, 8)])
def test_gn_silu_kernel_matches_plain(cuda, dtype, shape):
    """Against the fp32 plain version on the same inputs; two calls give
    the same bits; each call launches the kernel once."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(shape, generator=gen, device=cuda) + 0.3).to(dtype)
    scale = torch.randn(shape[1], generator=gen, device=cuda).to(dtype)
    bias = torch.randn(shape[1], generator=gen, device=cuda).to(dtype)
    before = _build.launch_counts()["gn_silu"]
    out = group_norm_silu(x, scale, bias, use_kernel=True)
    again = group_norm_silu(x, scale, bias, use_kernel=True)
    assert _build.launch_counts()["gn_silu"] == before + 2
    assert out.dtype == dtype and out.shape == x.shape and torch.equal(out, again)
    ref = group_norm_silu_reference(x.float(), scale.float(), bias.float())
    assert (out.float() - ref).abs().max().item() <= _bound(dtype, ref)


@pytest.mark.cuda
def test_gn_silu_dispatch_on_cuda(cuda):
    """use_kernel None is group_norm(silu=True); channels that do not split
    into the groups take group_norm with its gcd clamp, not the kernel."""
    x = torch.randn(2, 48, 8, 8, device=cuda)
    ones, zeros = torch.ones(48, device=cuda), torch.zeros(48, device=cuda)
    before = _build.launch_counts()["gn_silu"]
    clamped = group_norm_silu(x, ones, zeros, use_kernel=True)
    default = group_norm_silu(x[:, :32].contiguous(), ones[:32], zeros[:32])
    assert _build.launch_counts()["gn_silu"] == before
    assert torch.equal(clamped, group_norm(x, ones, zeros, silu=True))
    assert torch.equal(default, group_norm(x[:, :32].contiguous(), ones[:32], zeros[:32],
                                           silu=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,cin,cout,h,w", [(8, 320, 320, 64, 64), (8, 4, 320, 64, 64),
                                            (8, 320, 4, 64, 64), (8, 2560, 1280, 8, 8),
                                            (2, 96, 40, 13, 17), (1, 3, 5, 1, 1)])
def test_conv3x3_kernel_matches_plain(cuda, dtype, b, cin, cout, h, w):
    """The 9-tap plain version in fp32 on the same inputs; two calls give
    the same bits; conv_in's K = 36, conv_out's Cout = 4, the 8x8 bottom,
    odd and 1x1 maps are masked in the kernel."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((b, cin, h, w), generator=gen, device=cuda).to(dtype)
    weight = (torch.randn((cout, cin, 3, 3), generator=gen, device=cuda)
              * (9 * cin) ** -0.5).to(dtype)
    before = _build.launch_counts()["conv3x3"]
    out = conv3x3_direct(x, weight)
    again = conv3x3_direct(x, weight)
    assert _build.launch_counts()["conv3x3"] == before + 2
    assert out.dtype == dtype and out.shape == (b, cout, h, w) and torch.equal(out, again)
    ref = conv3x3_reference(x.float(), weight.float())
    assert (out.float() - ref).abs().max().item() <= _bound(dtype, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,cin,cout,h,w,bias", [
    (8, 320, 320, 64, 64, True), (8, 640, 640, 32, 32, False), (8, 1920, 1280, 16, 16, True),
    (8, 2560, 1280, 8, 8, True), (2, 40, 24, 13, 17, True), (1, 3, 5, 1, 1, False)])
def test_conv3x3_s8_kernel_matches_plain(cuda, dtype, b, cin, cout, h, w, bias):
    """The s8 tap-GEMM, which makes the codes while it stages x, against its
    plain version (the codes in torch, then their exact sums) on the same x
    and scale, bit for bit (integer sums are exact; the epilogue rounds as
    the plain version does); two calls and image 0 alone give the same bits;
    Cin not a multiple of 16 (the codes padded at the call), ragged maps and
    channels are masked in the kernel."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((b, cin, h, w), generator=gen, device=cuda).to(dtype)
    weight = (torch.randn((cout, cin, 3, 3), generator=gen, device=cuda)
              * (9 * cin) ** -0.5).to(dtype)
    bvec = torch.randn(cout, generator=gen, device=cuda) if bias else None
    sx = activation_scale(x)
    assert torch.equal(sx, quantize_symmetric(x, (1, 2, 3))[1].reshape(-1))
    wq, sw = weight_codes(weight)
    before = _build.launch_counts()["conv3x3_s8"]
    out = tap_gemm_s8(x, wq, sx, sw, bvec, dtype)
    again = tap_gemm_s8(x, wq, sx, sw, bvec, dtype)
    alone = tap_gemm_s8(x[:1].contiguous(), wq, sx[:1].contiguous(), sw, bvec, dtype)
    assert _build.launch_counts()["conv3x3_s8"] == before + 3
    ref = tap_gemm_s8_plain(x, wq, sx, sw, bvec, dtype)
    assert out.dtype == dtype and out.shape == (b, cout, h, w)
    assert torch.equal(out, ref) and torch.equal(out, again) and torch.equal(alone, out[:1])
    # the op end to end: the kernel path equals the plain one on the same x
    assert torch.equal(conv3x3_w8a8(x, weight, bvec), conv3x3_w8a8_reference(x, weight, bvec))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
def test_conv3x3_s8_bottom_and_edge_values(cuda, b, xdtype):
    """The 8x8 bottom (2560 -> 1280) at batch 1, 8 and 16, bf16 and fp32 x,
    with an all-zero image and values at +-absmax: the fused codes equal the
    plain ones bit for bit, and image 0 alone gives its slice."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn((b, 2560, 8, 8), generator=gen, device=cuda).to(xdtype)
    x[0, 3, 2, 1] = -x[0].abs().max()
    if b > 1:
        x[1] = 0
    weight = (torch.randn((1280, 2560, 3, 3), generator=gen, device=cuda) * 0.005).to(xdtype)
    wq, sw = weight_codes(weight)
    sx = activation_scale(x)
    out = tap_gemm_s8(x, wq, sx, sw, None, torch.bfloat16)
    assert torch.equal(out, tap_gemm_s8_plain(x, wq, sx, sw, None, torch.bfloat16))
    assert torch.equal(tap_gemm_s8(x[:1].contiguous(), wq, sx[:1].contiguous(), sw, None,
                                   torch.bfloat16), out[:1])


@pytest.mark.cuda
def test_halo_frame_bits(cuda):
    """The sp path's halo'd frame: the SAME map on a (4, 320, 34, 64) shard
    with its first and last rows dropped gives the unsharded map's rows bit
    for bit (bf16 tap-GEMM), and the s8 kernel there equals
    conv3x3_w8a8(padding=VALID_ROWS)'s plain version."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn((4, 320, 64, 64), generator=gen, device=cuda).to(torch.bfloat16)
    weight = (torch.randn((320, 320, 3, 3), generator=gen, device=cuda) * 0.02).to(torch.bfloat16)
    bias = torch.randn(320, generator=gen, device=cuda)
    xh = torch.nn.functional.pad(x, (0, 0, 1, 1))[:, :, :34].contiguous()
    assert torch.equal(conv3x3_direct(xh, weight)[:, :, 1:-1], conv3x3_direct(x, weight)[:, :, :32])
    assert torch.equal(conv3x3_w8a8(xh, weight, bias, padding=VALID_ROWS),
                       conv3x3_w8a8_reference(xh, weight, bias, padding=VALID_ROWS))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p1", "p2", "p6", "p7"])
def test_conv_probes_match_plain(cuda, name):
    """Each probe at a cut-down shape of JAX's (B 2, 32x32, 320 -> 320, bf16)
    against its plain version in fp32."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((2, 320, 32, 32), generator=gen, device=cuda).to(torch.bfloat16)
    w9 = (torch.randn((9, 320, 320), generator=gen, device=cuda) * 0.02).to(torch.bfloat16)
    w = {"p1": w9, "p2": w9, "p6": w9.reshape(3, 960, 320), "p7": w9.reshape(2880, 320)}[name]
    before = _build.launch_counts()[f"conv_probe_{name}"]
    out = getattr(conv_probe, name)(x, w)
    assert _build.launch_counts()[f"conv_probe_{name}"] == before + 1
    ref = getattr(conv_probe, f"{name}_reference")(x.float(), w.float())
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert (out.float() - ref).abs().max().item() <= _bound(torch.bfloat16, ref)
    # every tap map is batch invariant: image 0 alone gives its slice
    assert torch.equal(getattr(conv_probe, name)(x[:1].contiguous(), w), out[:1])


@pytest.mark.cuda
def test_conv3x3_switch_and_autograd_on_cuda(cuda):
    """Switch off: F.conv2d. Switch on: the kernel (bias added after the
    product is rounded), and under autograd the library conv's gradients,
    also under a non-reentrant checkpoint."""
    from torch.utils.checkpoint import checkpoint

    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((2, 64, 16, 16), generator=gen, device=cuda)
    weight = torch.randn((32, 64, 3, 3), generator=gen, device=cuda) * 0.05
    bias = torch.randn(32, generator=gen, device=cuda)
    g = torch.randn((2, 32, 16, 16), generator=gen, device=cuda)
    before = _build.launch_counts()["conv3x3"]
    try:
        set_conv_kernel_enabled(None)
        off = conv3x3(x, weight, bias)
        assert _build.launch_counts()["conv3x3"] == before
        set_conv_kernel_enabled(True)
        on = conv3x3(x, weight, bias)
        assert _build.launch_counts()["conv3x3"] == before + 1
        assert torch.equal(on, conv3x3_direct(x, weight) + bias[:, None, None])
        assert (on - off).abs().max().item() <= 1e-4
        leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
        checkpoint(conv3x3, *leaves, use_reentrant=False).backward(g)
        plain = [t.clone().requires_grad_() for t in (x, weight, bias)]
        torch.nn.functional.conv2d(*plain, padding=1).backward(g)
        for a, r in zip(leaves, plain):
            assert (a.grad - r.grad).abs().max().item() <= 1e-4
    finally:
        set_conv_kernel_enabled(None)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 1024, 1024, 8, 40), (2, 1024, 1024, 8, 80),
                                         (2, 256, 256, 8, 160), (2, 300, 300, 2, 256),
                                         (2, 200, 130, 3, 8), (2, 300, 700, 8, 80)])
def test_flash_bf16_tensor_core_kernel(cuda, b, sq, sk, h, d):
    """The bf16 forward on the tensor cores at D = 40/80/160/256, at D = 8
    (padded to 16 in shared memory) and at ragged Sq != Sk, against the fp32
    plain version (out 1e-2, lse 1e-4); two calls give the same bits, and so
    does image 0 alone against its slice of the batch."""
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in _qkv(b, sq, sk, h, d, seed=8))
    out, lse = flash_attention_fwd(q, k, v)
    out2, lse2 = flash_attention_fwd(q, k, v)
    out1, lse1 = flash_attention_fwd(q[:1], k[:1], v[:1])
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(out1, out[:1]) and torch.equal(lse1, lse[:1])
    ref = attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= 1e-2
    assert (lse - attention_lse_reference(q.float(), k.float())).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,cout,h,w", [(2, 4, 320, 64, 64), (2, 320, 4, 64, 64),
                                            (1, 1280, 1280, 8, 8), (16, 1280, 1280, 8, 8),
                                            (2, 96, 40, 13, 17), (4, 8, 16, 1, 1),
                                            (8, 2560, 1280, 8, 8)])
def test_conv3x3_bf16_tensor_core_kernel(cuda, b, cin, cout, h, w):
    """The bf16 tap-GEMM on the tensor cores at conv_in's Cin = 4, conv_out's
    Cout = 4, the 8x8 bottom at batch 1, 16 and 8 (Cin = 2560), an odd and
    a 1x1 map, against the fp32 plain version; two calls give the same bits,
    and so does image 0 alone against its slice of the batch."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((b, cin, h, w), generator=gen, device=cuda).to(torch.bfloat16)
    weight = (torch.randn((cout, cin, 3, 3), generator=gen, device=cuda)
              * (9 * cin) ** -0.5).to(torch.bfloat16)
    out = conv3x3_direct(x, weight)
    assert torch.equal(out, conv3x3_direct(x, weight))
    assert torch.equal(conv3x3_direct(x[:1], weight), out[:1])
    ref = conv3x3_reference(x.float(), weight.float())
    assert (out.float() - ref).abs().max().item() <= _bound(torch.bfloat16, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 1024, 1024, 8, 40), (2, 300, 700, 8, 80)])
def test_flash_backward_on_tensor_core_forward(cuda, b, sq, sk, h, d):
    """The backward kernels fed the bf16 forward's out and lse, against the
    plain fp32 backward (autograd through attention_reference on the same
    bf16 values): 1e-2 * max(1, max|ref|)."""
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in _qkv(b, sq, sk, h, d, seed=10))
    do = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v)
    grads = flash_attention_bwd(q, k, v, out, lse, do)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    refs = torch.autograd.grad(attention_reference(*leaves), leaves, do.float())
    for name, g, ref in zip("qkv", grads, refs):
        assert (g.float() - ref).abs().max().item() <= 1e-2 * max(1.0, ref.abs().max().item()), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cout,cin", [(1280, 2560), (4, 320), (3, 128), (40, 96)])
def test_conv_weight_layout_kernel(cuda, dtype, cout, cin):
    """The layout kernel gives the plain (padded(Cout), 9 * padded(Cin))
    layout bit for bit, from an OIHW weight and from the probes' (9, Cin,
    Cout) order, one counted launch each; the operand made from it (at fp32
    its tf32 split) is kept while the weight is unchanged and made again
    after an in-place write."""
    from ddpo_torch.ops.conv import tap_operand, tf32_split_reference

    def operand_reference(w):
        laid = tap_weight_reference(w.cpu())
        return tf32_split_reference(laid) if dtype == torch.float32 else laid

    weight = torch.randn((cout, cin, 3, 3), device=cuda).to(dtype)
    before = _build.launch_counts()["tap_layout"]
    w_nk = tap_weight(weight)
    assert w_nk.dtype == dtype and torch.equal(w_nk.cpu(), tap_weight_reference(weight.cpu()))
    w9 = weight.permute(2, 3, 1, 0).reshape(9, cin, cout).contiguous()
    assert torch.equal(tap_weight_kn(w9), w_nk)
    assert _build.launch_counts()["tap_layout"] == before + 2
    operand = tap_operand(weight)
    assert torch.equal(operand.cpu(), operand_reference(weight))
    assert tap_operand(weight) is operand
    weight.mul_(2)
    again = tap_operand(weight)
    assert again is not operand and torch.equal(again.cpu(), operand_reference(weight))


@pytest.mark.cuda
def test_flash_backward_bf16_on_fused_qkv_views(cuda):
    """q, k, v as non-contiguous views of one (B, S, 3, H, D) tensor: the
    kernels read them through their strides and give the bits of the
    contiguous copies."""
    rng = np.random.default_rng(13)
    qkv = torch.from_numpy(rng.standard_normal((2, 1024, 3, 8, 40)).astype(np.float32))
    q, k, v = qkv.to(cuda, torch.bfloat16).unbind(2)
    do = torch.from_numpy(rng.standard_normal((2, 1024, 8, 40)).astype(np.float32))
    do = do.to(cuda, torch.bfloat16)
    assert not q.is_contiguous()
    out, lse = flash_attention_fwd(q, k, v)
    grads = flash_attention_bwd(q, k, v, out, lse, do)
    copies = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), out, lse, do)
    refs = flash_attention_bwd_reference(q, k, v, out, lse, do)
    for name, g, c, ref in zip("qkv", grads, copies, refs):
        assert torch.equal(g, c), name
        assert (g.float() - ref).abs().max().item() <= _bound(torch.bfloat16, ref), name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 20, 40, 80, 96, 160, 192, 256])
@pytest.mark.parametrize("sq,sk", [(300, 257), (257, 700), (700, 300)])
def test_flash_bf16_kernels_match_plain_and_their_slices(cuda, sq, sk, d):
    """The three wgmma kernels, the bf16 forward, dQ and dK/dV, at D = 8 to
    256 (the forward's 128-key tiles up to D = 80 and 64-key ones above, one
    consumer warpgroup above D = 160; dQ in one or two column groups, dK/dV
    in one to four; D = 20 staged by plain loads), with one key in the last
    tile (Sk = 257) and Sq != Sk both ways: out 1e-2 and lse 1e-4 against the
    fp32 plain version, the gradients 1e-2 * max(1, max|ref|) against the
    plain backward. The first 1, 8 and 16 images of a 16-image call each
    give the bits of their slice of it."""
    h = 2
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in _qkv(16, sq, sk, h, d, seed=d + sq))
    do = torch.from_numpy(_qkv(16, sq, sq, h, d, seed=d)[0]).to(cuda, torch.bfloat16)
    assert flash_uses_tma(q) == (d % 8 == 0)
    out, lse = flash_attention_fwd(q, k, v)
    grads = flash_attention_bwd(q, k, v, out, lse, do)
    ref = attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= 1e-2
    assert (lse - attention_lse_reference(q.float(), k.float())).abs().max().item() <= 1e-4
    refs = flash_attention_bwd_reference(q, k, v, out, lse, do)
    for name, g, r in zip("qkv", grads, refs):
        assert (g.float() - r).abs().max().item() <= 1e-2 * max(1.0, r.abs().max().item()), name
    for b in (1, 8, 16):
        out_b, lse_b = flash_attention_fwd(q[:b], k[:b], v[:b])
        assert torch.equal(out_b, out[:b]) and torch.equal(lse_b, lse[:b]), b
        grads_b = flash_attention_bwd(q[:b], k[:b], v[:b], out[:b], lse[:b], do[:b])
        for name, g_b, g in zip("qkv", grads_b, grads):
            assert torch.equal(g_b, g[:b]), (name, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [20, 40, 80, 160])
@pytest.mark.parametrize("layout", ["fused_qkv", "odd_offset"])
def test_flash_dkv_producer_paths_give_the_same_bits(cuda, layout, d):
    """q, k, v as views of one (B, S, 3, H, D) tensor, and the same at an
    odd element offset, which TMA cannot take: the producers of the
    forward, dQ and dK/dV kernels stage them by plain loads, and each kernel
    gives the bits of the same call on contiguous copies (only the
    producer's path depends on alignment)."""
    rng = np.random.default_rng(d)
    b, s, h = 2, 300, 2
    flat = torch.from_numpy(rng.standard_normal(b * s * 3 * h * d + 1).astype(np.float32))
    flat = flat.to(cuda, torch.bfloat16)
    qkv = (flat[:-1] if layout == "fused_qkv" else flat[1:]).view(b, s, 3, h, d)
    q, k, v = qkv.unbind(2)
    do = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    do = do.to(cuda, torch.bfloat16)
    assert not q.is_contiguous()
    assert flash_uses_tma(q) == (layout == "fused_qkv" and d % 8 == 0)
    copies = [t.contiguous() for t in (q, k, v)]
    out, lse = flash_attention_fwd(q, k, v)
    out_c, lse_c = flash_attention_fwd(*copies)
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
    grads = flash_attention_bwd(q, k, v, out, lse, do)
    grads_c = flash_attention_bwd(*copies, out_c, lse_c, do)
    for name, g, g_c in zip("qkv", grads, grads_c):
        assert torch.equal(g, g_c), name


@pytest.mark.cuda
def test_flash_backward_bf16_refuses_rather_than_falls_back(cuda):
    """A bf16 CUDA call the kernels cannot take raises and launches nothing:
    D = 272 at the launch wrappers of the forward and both backward kernels,
    past the gate that flash_attention_fwd and flash_attention_bwd check
    first."""
    q = torch.randn(1, 256, 1, 272, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 256, device=cuda)
    before = _build.launch_counts()
    with pytest.raises(RuntimeError):
        flash_fwd(q, q, q, 272**-0.5)
    with pytest.raises(RuntimeError):
        flash_bwd_dq(q, q, q, q, lse, lse, 272**-0.5)
    with pytest.raises(RuntimeError):
        flash_bwd_dkv(q, q, q, q, lse, lse, 272**-0.5)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, q, lse, q)
    assert _build.launch_counts() == before


def _misaligned(x):
    """x's values in a contiguous tensor whose data starts one element past a
    16-byte boundary: the GroupNorm kernels' scalar-load path."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 and y.is_contiguous()
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,k", [
    ((8, 1280, 8, 8), torch.bfloat16, 1), ((8, 320, 64, 64), torch.bfloat16, 1),
    ((2, 640, 64, 64), torch.bfloat16, 2), ((2, 128, 512, 512), torch.bfloat16, 2),
    ((8, 1280, 8, 8), torch.float32, 1), ((8, 320, 64, 64), torch.float32, 2),
    ((2, 128, 512, 512), torch.float32, 2)])
def test_gn_stats_cluster_sizes_bit_equal(cuda, shape, dtype, k):
    """One launch a call with k blocks a run (k = 1, from one to three
    chunks; k = 2, the largest, from four chunks to the VAE's 1M elements);
    the sums and sums of squares are the two rows of one tensor; two calls,
    image 0 alone against its slice, and an unaligned copy of the map
    (scalar loads, the same element -> thread map) give the same bits; error
    relative to sum|x| (sum x^2) at most 1e-5 against float64."""
    g = 32
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(shape, generator=gen, device=cuda) + 0.3).to(dtype)
    assert gn_stats_cluster_size(x.numel() // (shape[0] * g), dtype) == k
    before = _build.launch_counts()["gn_stats"]
    sums, sq = group_stats(x, g)
    assert _build.launch_counts()["gn_stats"] == before + 1
    assert sums.shape == sq.shape == (shape[0], g)
    assert sq.data_ptr() == sums.data_ptr() + 4 * sums.numel()
    for s2, q2 in (group_stats(x, g), group_stats(_misaligned(x), g)):
        assert torch.equal(sums, s2) and torch.equal(sq, q2)
    s1, q1 = group_stats(x[:1], g)
    assert torch.equal(s1, sums[:1]) and torch.equal(q1, sq[:1])
    x64 = x.double().reshape(shape[0], g, -1)
    assert ((sums.double() - x64.sum(-1)).abs() / x64.abs().sum(-1)).max().item() <= 1e-5
    assert ((sq.double() - (x64 * x64).sum(-1)).abs() / (x64 * x64).sum(-1)).max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,affine,plans", [
    ((8, 320, 64, 64), torch.bfloat16, torch.bfloat16, [(1, "cached")]),
    ((8, 320, 64, 64), torch.float32, torch.float32, [(2, "cached")]),
    ((2, 960, 64, 64), torch.bfloat16, torch.float32, [(4, "cached")]),
    ((1, 512, 128, 128), torch.bfloat16, torch.bfloat16, [(8, "cached")]),
    ((1, 256, 256, 256), torch.bfloat16, torch.bfloat16, [(16, "cached"), (8, "streamed")]),
    ((1, 128, 512, 512), torch.bfloat16, torch.bfloat16, [(8, "streamed")]),
    ((2, 64, 17, 17), torch.bfloat16, torch.bfloat16, [(1, "scalar")])])
def test_gn_silu_cluster_plans_bit_equal(cuda, shape, dtype, affine, plans):
    """Each way through the fused kernel (shared-memory cache with k = 1, 2,
    4, 8 and 16 where the card runs 16-block clusters, two reads with k = 8,
    scalar loads) against the fp32 plain version, scale and bias read in
    their own dtype; two calls, and image 0 alone against its slice, give
    the same bits; so do two calls on an unaligned copy of the map."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = (torch.randn(shape, generator=gen, device=cuda) + 0.3).to(dtype)
    scale = torch.randn(shape[1], generator=gen, device=cuda).to(affine)
    bias = torch.randn(shape[1], generator=gen, device=cuda).to(affine)
    hw = shape[2] * shape[3]
    assert gn_silu_plan(shape[1] // 32, hw, dtype) in plans
    before = _build.launch_counts()["gn_silu"]
    out = group_norm_silu(x, scale, bias, use_kernel=True)
    assert _build.launch_counts()["gn_silu"] == before + 1
    ref = group_norm_silu_reference(x.float(), scale.float(), bias.float())
    assert out.dtype == dtype and (out.float() - ref).abs().max().item() <= _bound(dtype, ref)
    assert torch.equal(out, group_norm_silu(x, scale, bias, use_kernel=True))
    assert torch.equal(group_norm_silu(x[:1], scale, bias, use_kernel=True), out[:1])
    odd = _misaligned(x)
    odd_out = group_norm_silu(odd, scale, bias, use_kernel=True)
    assert (odd_out.float() - ref).abs().max().item() <= _bound(dtype, ref)
    assert torch.equal(odd_out, group_norm_silu(odd, scale, bias, use_kernel=True))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,stride", [((16, 320, 64, 64), 1), ((16, 1280, 8, 8), 1),
                                          ((16, 640, 32, 32), 2), ((16, 4, 64, 64), 1)])
def test_convs_are_batch_invariant_inside_the_mode(cuda, shape, stride):
    """Inside batch_invariant() a 3x3 conv (the tap-GEMM at stride 1, cuDNN
    one image a call at stride 2) gives an image the same bits at N = 16
    as in the trainer's N = 4 call ([uncond; cond] rows of two samples, in
    that order), and alone, in bf16."""
    from ddpo_torch.ops.conv import conv3x3, library_conv
    from ddpo_torch.ops.invariance import batch_invariant

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((320, shape[1], 3, 3), generator=gen, device=cuda) * 0.05).to(torch.bfloat16)
    b = torch.randn((320,), generator=gen, device=cuda).to(torch.bfloat16)
    rows = torch.tensor([5, 2, 13, 10], device=cuda)

    def conv(t):
        return conv3x3(t, w, b) if stride == 1 else library_conv(t, w, b, stride=2)

    with batch_invariant():
        full = conv(x)
        assert torch.equal(full[rows], conv(x[rows]))
        assert torch.equal(full[:1], conv(x[:1]))


@pytest.mark.cuda
@pytest.mark.parametrize("conv_switch", [None, True])
def test_vae_encoder_on_kernels_matches_plain(cuda, monkeypatch, conv_switch):
    """The SD-1.4 VAE encoder at fp32 on its kernels against the same module
    on the plain versions (group_stats_reference and, with the conv switch
    on, conv3x3_reference): one gn_stats launch per GroupNorm (22) and one
    conv3x3 per ResnetBlock conv (20) with the switch on, conv_in, conv_out
    and the stride-2 convs on cuDNN; moments within 1e-4 of max|moments|
    (fp32 sums in another order through 34 layers)."""
    from ddpo_torch.models import AutoencoderKL
    from ddpo_torch.models.layers import Conv3x3, GroupNorm
    from ddpo_torch.ops import conv as conv_ops
    from ddpo_torch.ops import groupnorm as gn_ops
    from ddpo_torch.utils.serialization import init_weights_

    with torch.device("meta"):
        vae = AutoencoderKL()
    vae = vae.to_empty(device=cuda).eval()
    init_weights_(vae, torch.Generator(device=cuda).manual_seed(0))
    n_gn = sum(isinstance(m, GroupNorm) for m in vae.encoder.modules())
    n_conv = sum(isinstance(m, Conv3x3) for m in vae.encoder.modules())
    assert (n_gn, n_conv) == (22, 20)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand((2, 3, 128, 128), generator=gen, device=cuda) * 2 - 1
    try:
        set_conv_kernel_enabled(conv_switch)
        before = _build.launch_counts()
        with torch.no_grad():
            out = vae.encode(x)
        after = _build.launch_counts()
        assert after["gn_stats"] - before["gn_stats"] == n_gn
        assert after["conv3x3"] - before["conv3x3"] == (n_conv if conv_switch else 0)
        monkeypatch.setattr(gn_ops, "group_stats",
                            lambda t, g: gn_ops.group_stats_reference(t, g))
        monkeypatch.setattr(conv_ops, "conv3x3_direct", conv_ops.conv3x3_reference)
        with torch.no_grad():
            ref = vae.encode(x)
        assert _build.launch_counts() == after
    finally:
        set_conv_kernel_enabled(None)
    assert out.shape == (2, 8, 16, 16) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def _attention64(q, k, v):
    """(out, lse) of the same values in fp64."""
    q, k, v = (t.double() for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return (torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v),
            torch.logsumexp(logits, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 20, 40, 80, 96, 160, 192, 256])
@pytest.mark.parametrize("sq,sk", [(300, 257), (257, 700), (700, 300)])
def test_flash_fp32_tensor_core_kernel(cuda, sq, sk, d):
    """The fp32 forward (3xTF32 on wgmma, csrc/flash_fwd_tf32.cu) at every
    tile shape it takes (D padded to 8: one or two consumer warpgroups, 64-
    or 32-key tiles, ragged last tiles): within 1e-4 of the fp32 plain
    version, its error against fp64 at most 4 times the plain version's,
    two calls and image 0 alone bit-equal to the batch."""
    q, k, v = (torch.from_numpy(x).to(cuda) for x in _qkv(3, sq, sk, 2, d, seed=d))
    out, lse = flash_attention_fwd(q, k, v)
    again, lse2 = flash_attention_fwd(q, k, v)
    ref, ref_lse = attention_reference(q, k, v), attention_lse_reference(q, k)
    out64, lse64 = _attention64(q, k, v)
    assert (out - ref).abs().max().item() <= 1e-4 and (lse - ref_lse).abs().max().item() <= 1e-4
    assert (out.double() - out64).abs().max() <= 4 * (ref.double() - out64).abs().max()
    assert (lse.double() - lse64).abs().max() <= 4 * (ref_lse.double() - lse64).abs().max()
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    out1, lse1 = flash_attention_fwd(q[:1], k[:1], v[:1])
    assert torch.equal(out1, out[:1]) and torch.equal(lse1, lse[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [20, 40, 80, 160])
@pytest.mark.parametrize("layout", ["fused_qkv", "odd_offset"])
def test_flash_fp32_producer_paths_give_the_same_bits(cuda, layout, d):
    """fp32 q, k, v as views of one (B, S, 3, H, D) tensor, and at an odd
    element offset, which TMA cannot take (Q and K then come by plain
    loads): the same bits as the call on contiguous copies."""
    rng = np.random.default_rng(d)
    b, s, h = 2, 300, 2
    flat = torch.from_numpy(rng.standard_normal(b * s * 3 * h * d + 1).astype(np.float32))
    flat = flat.to(cuda)
    qkv = (flat[:-1] if layout == "fused_qkv" else flat[1:]).view(b, s, 3, h, d)
    q, k, v = qkv.unbind(2)
    assert flash_uses_tma(q) == (layout == "fused_qkv" and d % 4 == 0)
    out, lse = flash_attention_fwd(q, k, v)
    out_c, lse_c = flash_attention_fwd(*(t.contiguous() for t in (q, k, v)))
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,cout,h,w", [(2, 4, 320, 64, 64), (2, 320, 4, 64, 64),
                                            (2, 320, 320, 13, 17), (3, 96, 24, 3, 5),
                                            (2, 2560, 1280, 8, 8), (2, 128, 128, 32, 32)])
def test_conv3x3_fp32_tensor_core_kernel(cuda, b, cin, cout, h, w):
    """The fp32 tap-GEMM (3xTF32 on wgmma): conv_in's K = 36, conv_out's
    Cout = 4 (N = 8), W not a multiple of 8, maps smaller than a tile, N =
    32 and 64, the UNet's deepest Cin = 2560 (720 taps summed): within 1e-4
    max(1, max|ref|) of the plain version, its error against fp64 at most 4
    times the plain version's, image 0 alone bit-equal to the batch."""
    gen = torch.Generator(device=cuda).manual_seed(cin + cout)
    x = torch.randn((b, cin, h, w), generator=gen, device=cuda)
    weight = torch.randn((cout, cin, 3, 3), generator=gen, device=cuda) * (9 * cin) ** -0.5
    out = conv3x3_direct(x, weight)
    ref = conv3x3_reference(x, weight)
    ref64 = torch.nn.functional.conv2d(x.double(), weight.double(), padding=1)
    assert (out - ref).abs().max().item() <= _bound(torch.float32, ref)
    assert (out.double() - ref64).abs().max() <= 4 * (ref.double() - ref64).abs().max()
    assert torch.equal(conv3x3_direct(x[:1], weight), out[:1])


@pytest.mark.cuda
def test_conv3x3_fp32_halo_frame_bits(cuda):
    """The sp path's halo'd frame at fp32: the SAME map on a (4, 320, 34,
    64) shard with its first and last rows dropped gives the unsharded
    map's rows bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn((4, 320, 64, 64), generator=gen, device=cuda)
    weight = torch.randn((320, 320, 3, 3), generator=gen, device=cuda) * 0.02
    xh = torch.nn.functional.pad(x, (0, 0, 1, 1))[:, :, :34].contiguous()
    assert torch.equal(conv3x3_direct(xh, weight)[:, :, 1:-1], conv3x3_direct(x, weight)[:, :, :32])


@pytest.mark.cuda
def test_tf32_split_kernel_matches_plain(cuda):
    """The weight's split kernel gives tf32_split_reference's hi and lo
    bit for bit; the fp32 operand is the layout's split, made once per
    weight version, without the layout kept beside it."""
    from ddpo_torch.ops import conv as conv_ops

    w = torch.randn((40, 9 * 96), device=cuda) * 3
    assert torch.equal(conv_ops._tf32_split(w).cpu(), conv_ops.tf32_split_reference(w.cpu()))
    weight = torch.randn((40, 96, 3, 3), device=cuda)
    before = _build.launch_counts()
    operand = conv_ops.tap_operand(weight)
    after = _build.launch_counts()
    assert (after["tap_layout"] - before["tap_layout"], after["tf32_split"]
            - before["tf32_split"]) == (1, 1)
    assert torch.equal(operand.cpu(), conv_ops.tf32_split_reference(tap_weight_reference(weight.cpu())))
    assert conv_ops.tap_operand(weight) is operand and id(weight) not in conv_ops._TAP_WEIGHTS
    weight.mul_(2)
    assert conv_ops.tap_operand(weight) is not operand
