"""The port's attention and GroupNorm ops against ddpo_tpu's, on the CPU.

CPU parity (fp32): inputs from a numpy seed go through both packages; the
JAX side runs its Pallas kernels in interpret mode, as tests/test_ops.py
does. Tolerances: attention outputs atol 2e-5 and logsumexp atol 2e-5
(fp32 softmax, different summation orders); GroupNorm atol 1e-5 and the
group sums rtol 1e-5. The kernels themselves are held against these plain
versions on the card by tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
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
from ddpo_torch.ops.groupnorm import group_norm, group_stats
from ddpo_tpu.ops.attention import _flash_forward, flash_attention
from ddpo_tpu.ops.groupnorm import _group_stats
from ddpo_tpu.ops.groupnorm import group_norm as jax_group_norm


def _qkv(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, sq, h, d)).astype(np.float32),
        rng.standard_normal((b, sk, h, d)).astype(np.float32),
        rng.standard_normal((b, sk, h, d)).astype(np.float32),
    )


ATTN_CASES = [
    (2, 200, 200, 2, 40),  # ragged self-attention (not a multiple of 128)
    (1, 300, 300, 2, 80),
    (1, 200, 300, 2, 40),  # Sq != Sk
]


@pytest.mark.parametrize("b,sq,sk,h,d", ATTN_CASES)
def test_attention_reference_matches_jax_flash(b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    j_out = np.asarray(flash_attention(jq, jk, jv, None, 128, 128, True))
    _, j_lse = _flash_forward(jq, jk, jv, d**-0.5, 128, 128, True, with_lse=True)
    j_lse = np.asarray(j_lse)[:, :, :sq, 0]  # folded (B, H, Sq_pad, 1) layout

    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(attention_reference(tq, tk, tv).numpy(), j_out, atol=2e-5)
    np.testing.assert_allclose(attention_lse_reference(tq, tk).numpy(), j_lse, atol=2e-5)
    # the kernel wrapper on a CPU tensor is the plain version
    out, lse = flash_attention_fwd(tq, tk, tv)
    np.testing.assert_allclose(out.numpy(), j_out, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=2e-5)


def test_cpu_dispatch_never_touches_the_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", refuse)
    before = _build.launch_counts()
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 256, 256, 2, 40))
    out = attention(q, k, v)  # meets the flash gate's shape test
    np.testing.assert_allclose(out.numpy(), attention_reference(q, k, v).numpy(), atol=0)
    x = torch.randn(2, 64, 8, 8)
    group_norm(x, torch.ones(64), torch.zeros(64))
    group_stats(x, 32)
    assert _build.launch_counts() == before


@pytest.mark.parametrize("c", [64, 48, 20])  # 48 -> 16 groups, 20 -> 4 (gcd clamp)
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_matches_jax(c, silu):
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((2, 8, 8, c)) * 2 + 0.5).astype(np.float32)  # NHWC
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    ref = np.asarray(jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), silu=silu))
    out = group_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
        torch.from_numpy(scale), torch.from_numpy(bias), silu=silu,
    )
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("c,g", [(256, 32), (48, 16)])
def test_group_stats_matches_jax_kernel(c, g):
    rng = np.random.default_rng(c)
    xf = (rng.standard_normal((2, 64, c)) + 0.3).astype(np.float32)  # (n, s, c)
    j_sums, j_sq = _group_stats(jnp.asarray(xf), g, interpret=True)
    x = torch.from_numpy(xf).permute(0, 2, 1).contiguous()  # (n, c, s) NCHW
    sums, sq = group_stats(x, g)
    np.testing.assert_allclose(sums.numpy(), np.asarray(j_sums), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sq.numpy(), np.asarray(j_sq), rtol=1e-5, atol=1e-4)
