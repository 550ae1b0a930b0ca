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
)
from ddpo_torch.ops.groupnorm import group_norm, group_stats, group_stats_reference


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
@pytest.mark.parametrize("b,sq,sk,h,d", [(4, 1024, 1024, 8, 40), (4, 256, 256, 8, 160),
                                         (2, 300, 700, 8, 80), (2, 300, 300, 2, 256),
                                         (1, 200, 130, 3, 16)])
def test_flash_backward_kernels_match_plain(cuda, dtype, b, sq, sk, h, d):
    """dq, dk, dv against the plain fp32 backward on the same inputs. Bounds:
    fp32 1e-4; bf16 1e-2 * max(1, max|ref|), the rounding of the bf16
    outputs (half an ulp is 2^-9 of the value). Two calls give the same
    bits (each output element has one owner; no atomics)."""
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in _qkv(b, sq, sk, h, d, seed=2))
    do = torch.randn(q.shape, device=cuda).to(dtype)
    out, lse = flash_attention_fwd(q, k, v)
    before = _build.launch_counts()
    grads = flash_attention_bwd(q, k, v, out, lse, do)
    after = _build.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    again = flash_attention_bwd(q, k, v, out, lse, do)
    refs = flash_attention_bwd_reference(q, k, v, out, lse, do)
    for name, g, g2, ref, x in zip("qkv", grads, again, refs, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert torch.equal(g, g2), name
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
