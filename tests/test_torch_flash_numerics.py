"""The bf16 flash forward's arithmetic, emulated in torch, against JAX's kernel.

csrc/flash_fwd.cu runs bf16 attention on the tensor cores: scores in fp32
from bf16 Q and K, an online softmax over key tiles (128 keys up to D = 80,
64 above: ``key_tile``) in base 2, P rounded
to bf16 before the P V product (fp32 sums), the row sum l over the fp32 P,
and out = O / l at the end. ``emulate_mma_forward`` repeats that on the CPU,
so the rounding choice is pinned here before the card sees it: against
ddpo_tpu's ``_flash_forward`` (its Pallas kernel in interpret mode, which
keeps P in fp32) on the same bf16 inputs, made from a numpy seed. Bounds are
the card's for bf16: out 1e-2, lse 1e-4.

csrc/flash_bwd.cu runs the bf16 backward on the tensor cores the same way:
S and dP in fp32 from bf16 inputs, P recomputed from the forward's lse in
base 2, P (for dV) and dS (for dQ and dK) rounded to bf16 before their
products, fp32 sums, the scale applied at the end; dQ sums its 64-key tiles
in key order. ``emulate_mma_backward`` repeats that and is held against ddpo_tpu's ``_flash_backward`` (its Pallas
kernels in interpret mode, fp32 inside) and against the fp32 plain backward
on the same bf16 inputs, within the card's bound 1e-2 * max(1, max|ref|).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpo_torch.ops.attention import (
    _delta,
    attention_lse_reference,
    attention_reference,
    flash_attention_bwd_reference,
)
from ddpo_tpu.ops.attention import _flash_backward, _flash_forward

DQ_KEY_TILE = 64  # keys per K/V tile of the dQ kernel in csrc/flash_bwd.cu


def key_tile(d: int) -> int:
    """Keys per K/V tile of the bf16 forward in csrc/flash_fwd.cu: 128 up to
    D = 80, 64 above (D padded to a multiple of 16)."""
    return 128 if (d + 15) // 16 <= 5 else 64


def emulate_mma_forward(q, k, v, scale):
    """(out (B, Sq, H, D) bf16, lse (B, H, Sq) fp32) as the bf16 kernel computes them."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    scores = qf @ kf.transpose(-1, -2)  # fp32 products of bf16 values
    b, h, sq, _ = qf.shape
    m = torch.full((b, h, sq), -math.inf)
    l = torch.zeros((b, h, sq))
    o = torch.zeros_like(qf)
    tile = key_tile(qf.shape[-1])
    for k0 in range(0, kf.shape[2], tile):
        s = scores[..., k0:k0 + tile]
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + p.bfloat16().float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    out = (o / l[..., None]).transpose(1, 2).bfloat16()
    return out, (m + torch.log2(l)) * math.log(2.0)


def _bf16_qkv(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
            for s in shapes]


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (1, 200, 200, 2, 40),   # D = 40: the kernel pads it to 48 in shared memory
    (1, 130, 300, 2, 40),   # ragged Sk: the last tile is masked
    (2, 64, 100, 1, 80),
    (1, 96, 257, 2, 16),    # one key in the last tile
    (1, 100, 300, 1, 80),   # three 128-key tiles, the last masked
    (1, 80, 260, 2, 40),    # Sk across two 128-key boundaries, 4 keys in the last tile
    (1, 70, 129, 2, 96),    # one key in the last tile
    (1, 70, 129, 2, 160),   # the UNet's widest D
    (1, 60, 200, 1, 256),   # the widest D the gate admits
])
def test_emulated_bf16_kernel_matches_jax_flash(b, sq, sk, h, d):
    q, k, v = _bf16_qkv(b, sq, sk, h, d, seed=sq + sk + d)
    scale = d ** -0.5
    out, lse = emulate_mma_forward(q, k, v, scale)

    # bf16 -> fp32 -> bf16 is exact, so JAX sees the same values
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    j_out, j_lse = _flash_forward(jq, jk, jv, scale, 128, 128, True, with_lse=True)
    j_out = np.asarray(j_out.astype(jnp.float32))
    j_lse = np.asarray(j_lse)[:, :, :sq, 0]  # folded (B, H, Sq_pad, 1) layout

    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert np.abs(out.float().numpy() - j_out).max() <= 1e-2
    assert np.abs(lse.numpy() - j_lse).max() <= 1e-4
    # and the card's own yardstick: the fp32 plain version on the same values
    ref = attention_reference(q.float(), k.float(), v.float(), scale)
    assert (out.float() - ref).abs().max().item() <= 1e-2
    ref_lse = attention_lse_reference(q.float(), k.float(), scale)
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def test_emulated_bf16_kernel_is_batch_invariant():
    """Rows are independent: image 0 alone gives the bits of its slice."""
    q, k, v = _bf16_qkv(3, 100, 150, 2, 40, seed=7)
    out, lse = emulate_mma_forward(q, k, v, 40 ** -0.5)
    out1, lse1 = emulate_mma_forward(q[:1], k[:1], v[:1], 40 ** -0.5)
    assert torch.equal(out1, out[:1]) and torch.equal(lse1, lse[:1])


@pytest.mark.parametrize("d", [80, 160])
def test_emulated_bf16_kernel_is_batch_invariant_at_wider_heads(d):
    """Image 0 alone gives the bits of its slice at the UNet's D = 80 and
    160, over five tiles."""
    q, k, v = _bf16_qkv(4, 90, 300, 1, d, seed=d)
    out, lse = emulate_mma_forward(q, k, v, d ** -0.5)
    out1, lse1 = emulate_mma_forward(q[:1], k[:1], v[:1], d ** -0.5)
    assert torch.equal(out1, out[:1]) and torch.equal(lse1, lse[:1])


def emulate_mma_backward(q, k, v, out, lse, do, scale):
    """(dq, dk, dv) bf16 as the bf16 backward kernels compute them; lse is
    the forward's (B, H, Sq) natural-log row logsumexp."""
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, do))  # (B, H, S, D)
    log2e = math.log2(math.e)
    scale_log2 = torch.tensor(scale * log2e, dtype=torch.float32)
    s = qf @ kf.transpose(-1, -2)  # fp32 products of bf16 values
    p = torch.exp2(s * scale_log2 - (lse * log2e)[..., None])
    ds = p * (gf @ vf.transpose(-1, -2) - _delta(out, do)[..., None])
    ds, p = ds.bfloat16().float(), p.bfloat16().float()  # the A operands
    dq = torch.zeros_like(qf)
    for k0 in range(0, kf.shape[2], DQ_KEY_TILE):  # dQ's key tiles in order
        dq = dq + ds[..., k0:k0 + DQ_KEY_TILE] @ kf[:, :, k0:k0 + DQ_KEY_TILE]
    dq = dq * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p.transpose(-1, -2) @ gf
    return tuple(t.transpose(1, 2).bfloat16() for t in (dq, dk, dv))


def _jax_forward(q, k, v, scale):
    """JAX's bf16 flash forward on the same values -> (jax arrays, out, lse)."""
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    j_out, j_lse = _flash_forward(jq, jk, jv, scale, 128, 128, True, with_lse=True)
    out = torch.from_numpy(np.array(j_out.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(np.array(j_lse[:, :, :q.shape[1], 0]))
    return (jq, jk, jv, j_out, j_lse), out, lse


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (1, 200, 200, 2, 40),   # D = 40: the kernels pad it to 48 in shared memory
    (1, 130, 300, 2, 40),   # ragged Sq and Sk, Sq < Sk
    (2, 300, 130, 1, 40),   # ragged Sq and Sk, Sq > Sk
    (2, 64, 100, 1, 80),
    (1, 96, 257, 2, 16),    # one key in the last tile
    (1, 80, 96, 1, 160),    # dK and dV in three column groups on the card
    (1, 70, 90, 1, 256),    # four column groups, one consumer warpgroup a block
])
def test_emulated_bf16_backward_matches_jax_flash(b, sq, sk, h, d):
    q, k, v, do = _bf16_qkv(b, sq, sk, h, d, seed=sq + sk + d) + _bf16_qkv(b, sq, sq, h, d, 1)[:1]
    scale = d ** -0.5
    jax_in, out, lse = _jax_forward(q, k, v, scale)
    grads = emulate_mma_backward(q, k, v, out, lse, do, scale)

    jg = jnp.asarray(do.float().numpy()).astype(jnp.bfloat16)
    pallas = _flash_backward(*jax_in, jg, scale, 128, 128, True)
    refs = flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
    for name, g, x, jref, ref in zip("qkv", grads, (q, k, v), pallas, refs):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape, name
        jref = np.asarray(jref.astype(jnp.float32))
        bound = 1e-2 * max(1.0, np.abs(jref).max())
        assert np.abs(g.float().numpy() - jref).max() <= bound, f"d{name} vs JAX"
        bound = 1e-2 * max(1.0, ref.abs().max().item())
        assert (g.float() - ref).abs().max().item() <= bound, f"d{name} vs the plain backward"


def test_emulated_bf16_backward_is_batch_invariant():
    """Rows and keys are independent: image 0 alone gives the bits of its slice."""
    q, k, v, do = _bf16_qkv(3, 100, 150, 2, 40, seed=9) + _bf16_qkv(3, 100, 100, 2, 40, 10)[:1]
    scale = 40 ** -0.5
    out = attention_reference(q, k, v, scale)
    lse = attention_lse_reference(q, k, scale)
    grads = emulate_mma_backward(q, k, v, out, lse, do, scale)
    alone = emulate_mma_backward(q[:1], k[:1], v[:1], out[:1], lse[:1], do[:1], scale)
    for g, g1 in zip(grads, alone):
        assert torch.equal(g1, g[:1])
