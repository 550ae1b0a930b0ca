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
def test_kernel_paths_refuse_what_they_cannot_do(cuda):
    q = torch.randn(1, 256, 2, 40, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(TypeError):
        flash_attention_fwd(*(torch.randn(1, 256, 2, 40, device=cuda, dtype=torch.float16),) * 3)
    with pytest.raises(ValueError):
        group_stats(torch.randn(2, 64, 8, 8, device=cuda).transpose(2, 3), 32)
