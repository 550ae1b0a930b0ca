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
)
from ddpo_torch.bench import conv_probe
from ddpo_torch.ops.conv import (
    conv3x3,
    conv3x3_direct,
    conv3x3_reference,
    set_conv_kernel_enabled,
    weight_kn,
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
    """The transpose kernel gives the CPU permute's (9 * Cin, Cout) bit for bit."""
    weight = torch.randn((cout, cin, 3, 3), device=cuda).to(dtype)
    w_kn = weight_kn(weight)
    assert w_kn.shape == (9 * cin, cout) and w_kn.dtype == dtype
    assert torch.equal(w_kn.cpu(), weight_kn(weight.cpu()))


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
def test_flash_backward_bf16_refuses_rather_than_falls_back(cuda):
    """A bf16 CUDA call the kernels cannot take raises and launches nothing:
    D = 272 at the launch wrappers, past the gate that flash_attention_bwd
    checks first."""
    q = torch.randn(1, 256, 1, 272, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 256, device=cuda)
    before = _build.launch_counts()
    with pytest.raises(RuntimeError):
        flash_bwd_dq(q, q, q, q, lse, lse, 272**-0.5)
    with pytest.raises(RuntimeError):
        flash_bwd_dkv(q, q, q, q, lse, lse, 272**-0.5)
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
