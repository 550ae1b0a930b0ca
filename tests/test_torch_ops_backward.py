"""The port's attention and GroupNorm backward against ddpo_tpu's, on the CPU.

fp32, inputs and cotangents from a numpy seed. The JAX side runs its Pallas
backward kernels in interpret mode (``_flash_backward(..., interpret=True)``),
as tests/test_ops.py does, and its XLA VJP. Tolerances:

  - flash backward: atol 2e-4 and rtol 2e-4, the bound tests/test_ops.py
    holds JAX's own Pallas backward to against the XLA VJP (measured here:
    at most 7.2e-7 against interpret-mode Pallas and 6.6e-7 against the VJP);
  - ``FlashAttention``'s gradient against autograd through
    ``attention_reference``: exact at fp32 (the fp32 branch is that
    autograd), atol 1e-2 in bf16 (bf16 rounding of dq, dk, dv; measured
    2.0e-3);
  - GroupNorm gradients: atol 1e-5 and rtol 1e-5 (measured at most 7.6e-6,
    in the scale and bias gradients, which sum over every pixel).

The kernels themselves are held against these plain versions on the card by
tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from ddpo_torch.ops.attention import (
    FlashAttention,
    attention_reference,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
)
from ddpo_torch.ops.groupnorm import GroupStats, group_norm, group_stats
from ddpo_tpu.ops.attention import _flash_backward, _flash_forward, xla_attention
from ddpo_tpu.ops.groupnorm import group_norm as jax_group_norm

# tests/test_ops.py's backward shapes: SD's D=40 with several kv blocks,
# ragged on both sides, and Sq != Sk
BWD_CASES = [(2, 256, 256, 2, 40), (1, 200, 130, 3, 16), (2, 128, 384, 1, 64)]


def _inputs(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d))
    )


@pytest.mark.parametrize("b,sq,sk,h,d", BWD_CASES)
def test_flash_backward_matches_jax(b, sq, sk, h, d):
    q, k, v, g = _inputs(b, sq, sk, h, d)
    scale = d**-0.5
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    j_out, j_lse = _flash_forward(jq, jk, jv, scale, 128, 128, True, with_lse=True)
    pallas = _flash_backward(jq, jk, jv, j_out, j_lse, jg, scale, 128, 128, True)
    _, vjp = jax.vjp(lambda a, b_, c: xla_attention(a, b_, c, scale), jq, jk, jv)
    xla = vjp(jg)

    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = flash_attention_fwd(tq, tk, tv)
    port = flash_attention_bwd(tq, tk, tv, out, lse, tg)  # the plain version on a CPU tensor
    twin = flash_attention_bwd_reference(tq, tk, tv, out, lse, tg)
    for name, a, ref_p, ref_x, tw in zip("qkv", port, pallas, xla, twin):
        assert a.dtype == torch.float32 and a.shape == tw.shape
        np.testing.assert_array_equal(a.numpy(), tw.numpy())
        np.testing.assert_allclose(a.numpy(), np.asarray(ref_p), atol=2e-4, rtol=2e-4,
                                   err_msg=f"d{name} vs interpret-mode Pallas")
        np.testing.assert_allclose(a.numpy(), np.asarray(ref_x), atol=2e-4, rtol=2e-4,
                                   err_msg=f"d{name} vs the XLA VJP")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 0.0), (torch.bfloat16, 1e-2)])
def test_flash_attention_function_gradient(dtype, atol):
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, 200, 200, 3, 16, seed=1))
    leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    out = FlashAttention.apply(*leaves, 16**-0.5)
    grads = torch.autograd.grad(out, leaves, g.to(dtype))

    ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
    ref = attention_reference(*ref_leaves)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g.to(dtype).float())
    for a, r in zip(grads, ref_grads):
        assert a.dtype == dtype
        np.testing.assert_allclose(a.float().numpy(), r.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_function_under_remat(dtype):
    """Inside a non-reentrant torch.utils.checkpoint (the trainer's remat),
    the backward reads its saved tensors once and gives the same gradient
    as without remat, bit for bit."""
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in _inputs(1, 256, 256, 2, 16, seed=4))
    grads = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        if remat:
            out = torch.utils.checkpoint.checkpoint(FlashAttention.apply, *leaves, 0.25,
                                                    use_reentrant=False)
        else:
            out = FlashAttention.apply(*leaves, 0.25)
        grads.append(torch.autograd.grad(out, leaves, g))
    for a, r in zip(*grads):
        assert torch.equal(a, r)


@pytest.mark.parametrize("c", [64, 48])  # 48 -> 16 groups (gcd clamp)
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_backward_matches_jax(c, silu):
    rng = np.random.default_rng(c + silu)
    x = (rng.standard_normal((2, 8, 8, c)) * 2 + 0.5).astype(np.float32)  # NHWC
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def loss(x_, s_, b_):
        return jnp.sum(jax_group_norm(x_, s_, b_, silu=silu) * cot)

    j_grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                               jnp.asarray(bias))

    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    ts, tb = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    out = group_norm(tx, ts, tb, silu=silu)
    t_grads = torch.autograd.grad(out, (tx, ts, tb), torch.from_numpy(cot).permute(0, 3, 1, 2))
    np.testing.assert_allclose(t_grads[0].permute(0, 2, 3, 1).numpy(), np.asarray(j_grads[0]),
                               atol=1e-5, rtol=1e-5)
    for a, r in zip(t_grads[1:], j_grads[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)


def test_group_stats_backward_is_the_analytic_formula():
    """gx = g_sums + 2 x g_sq per group, the same as autograd through the sums."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 48, 5, 5)).astype(np.float32))
    gs, gq = (torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32)) for _ in range(2))
    xa = x.clone().requires_grad_()
    sums, sq = GroupStats.apply(xa, 16)
    (gx,) = torch.autograd.grad((sums * gs).sum() + (sq * gq).sum(), xa)
    xr = x.clone().requires_grad_()
    xf = xr.reshape(2, 16, -1)
    (ref,) = torch.autograd.grad((xf.sum(-1) * gs).sum() + ((xf * xf).sum(-1) * gq).sum(), xr)
    np.testing.assert_allclose(gx.numpy(), ref.numpy(), atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(sums.detach().numpy(), group_stats(x, 16)[0].numpy())
