"""The fp32 kernels' 3xTF32 arithmetic, emulated in torch, against fp64 and
JAX.

csrc/flash_fwd_tf32.cu and the fp32 tap-GEMM of csrc/conv3x3.cu run fp32
products on the tensor cores in tf32: each operand x is split as hi =
tf32(x), lo = tf32(x - hi) (10 mantissa bits each, round to nearest, ties
away from zero: ``cvt.rna.tf32.f32``), and a * b is taken as lo_a hi_b +
hi_a lo_b + hi_a hi_b, three products that are exact in fp32, added into
fp32 accumulators a k8 step (8 values of the sum) at a time, the two small
products first. The tensor cores round each step into the accumulator
toward zero, so the kernels start a fresh sum for each 32 columns of D in S
= Q K^T, each key tile's P V and each tap of the conv, and add those in
fp32 registers, rounded to nearest (the conv's with Kahan's compensation).
This file repeats that in plain torch on the CPU, with the accumulators
rounding to nearest (``rz=False``) or toward zero (``rz=True``, the
card's), so the scheme is pinned before the card sees it:

  - its error against the fp64 result is at most 4 times the fp32 plain
    version's own (attention_reference, conv3x3_reference), at the UNet's
    head widths D = 40 / 80 / 160 and on a tiny conv;
  - it agrees with ddpo_tpu's Pallas flash kernel (``_flash_forward`` in
    interpret mode) and JAX's conv reference (``conv3x3_xla``) within the
    card's fp32 bounds (1e-4 on out and lse; 1e-4 * max(1, max|ref|) for
    the conv);
  - one long chain in a truncating accumulator, the P V of all keys summed
    in place, breaks the 4x bound: why the sums are cut short.

The flash emulation follows the kernel's tiles (keys a tile: 64 up to D =
64, 32 above) and its base-2 online softmax; the permutation of keys inside
a k8 step does not change the sum. The port's split
(``ops.conv.tf32_split_reference``, the plain version of the weight's split
kernel) is held to the emulation's rounding bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddpo_torch.ops.attention import attention_lse_reference, attention_reference
from ddpo_torch.ops.conv import conv3x3_reference, tf32_split_reference
from ddpo_tpu.ops.attention import _flash_forward
from ddpo_tpu.ops.conv import conv3x3_xla


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> nearest tf32, ties away from zero, on the bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def to_fp32(x: torch.Tensor, rz: bool) -> torch.Tensor:
    """fp64 values rounded to fp32: to nearest, or toward zero."""
    r = x.float()
    if rz:
        r = torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def mm3(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor, rz: bool) -> torch.Tensor:
    """acc + a @ b as a tensor-core chain sums it: over k8 steps in order,
    each step lo_a hi_b, then hi_a lo_b, then hi_a hi_b, each the exact sum
    of its 8 products (exact for tf32 operands) added into the fp32 acc."""
    (ah, al), (bh, bl) = split(a), split(b)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = to_fp32(acc.double() + x[..., ks].double() @ y[..., ks, :].double(), rz)
    return acc


def attention64(q, k, v, scale):
    """(out, lse) in fp64: the exact result the errors are taken against."""
    q, k, v = (t.double() for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
    return out, torch.logsumexp(logits, -1)


def key_tile(d: int) -> int:
    """Keys a K or V tile of the fp32 forward: 64 up to D = 64, 32 above."""
    return 64 if (d + 7) // 8 <= 8 else 32


def emulate_tf32_forward(q, k, v, scale, rz=False, short_chains=True):
    """(out (B, Sq, H, D), lse (B, H, Sq)) as the fp32 kernel computes them;
    ``short_chains=False`` sums S over all of D and O over all keys in one
    accumulator each instead."""
    qf, kf, vf = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    b, h, sq, d = qf.shape
    m = torch.full((b, h, sq), -math.inf)
    l = torch.zeros((b, h, sq))
    o = torch.zeros_like(qf)
    group = 32 if short_chains else d
    tile = key_tile(d)
    for k0 in range(0, kf.shape[2], tile):
        kt, vt = kf[:, :, k0:k0 + tile].transpose(-1, -2), vf[:, :, k0:k0 + tile]
        s = None
        for g0 in range(0, d, group):  # a fresh sum each 32 columns of D
            part = mm3(qf[..., g0:g0 + group], kt[..., g0:g0 + group, :],
                       torch.zeros((b, h, sq, kt.shape[-1])), rz)
            s = part if s is None else s + part
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * corr + p.sum(-1)
        if short_chains:  # O = O corr + (the tile's fresh P V), rounded once
            o = (o.double() * corr.double()[..., None]
                 + mm3(p, vt, torch.zeros_like(o), rz).double()).float()
        else:
            o = mm3(p, vt, o * corr[..., None], rz)
        m = m_new
    return (o * (1.0 / l)[..., None]).transpose(1, 2), (m + torch.log2(l)) * math.log(2.0)


def emulate_tf32_conv(x, weight, rz=False):
    """The fp32 tap-GEMM: out (N, Cout, H, W), over chunks of 32 input
    channels, then the 9 taps, each tap a fresh sum of its k8 steps added
    into the fp32 total with Kahan's compensation."""
    n, cin, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    tot = torch.zeros((n, h, w, weight.shape[0]))
    comp = torch.zeros_like(tot)
    for c0 in range(0, cin, 32):
        for dy in range(3):
            for dx in range(3):
                a = xp[:, c0:c0 + 32, dy:dy + h, dx:dx + w].permute(0, 2, 3, 1)
                y = mm3(a, weight[:, c0:c0 + 32, dy, dx].t(), torch.zeros_like(tot), rz) - comp
                t = tot + y
                comp, tot = (t - tot) - y, t
    return tot.permute(0, 3, 1, 2)


def test_split_rounds_to_nearest_ties_away():
    """tf32 keeps 10 mantissa bits: 1 + 2^-11 (a tie) rounds up, away from
    zero on either sign; 1 + 2^-12 rounds down; hi + lo carries the value to
    within 2^-22 of it; the port's split is the same, bit for bit."""
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11), one + 2.0 ** -12, 3.0, 0.0])
    assert tf32(x).tolist() == [one + 2.0 ** -10, -(one + 2.0 ** -10), one, 3.0, 0.0]
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(r)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi.double() + lo.double() - r.double()).abs() <= 2.0 ** -22 * r.double().abs()).all()
    assert torch.equal(tf32_split_reference(r), torch.cat([hi, lo]))


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))]


@pytest.mark.parametrize("rz", [False, True])
@pytest.mark.parametrize("b,sq,sk,h,d", [
    (1, 96, 200, 2, 40),    # four 64-key tiles, the last ragged
    (1, 80, 130, 2, 80),    # five 32-key tiles, the last ragged
    (1, 70, 100, 1, 160),   # the UNet's widest D
])
def test_emulated_tf32_forward_error_and_jax(b, sq, sk, h, d, rz):
    q, k, v = _qkv(b, sq, sk, h, d, seed=sq + sk + d)
    scale = d ** -0.5
    out, lse = emulate_tf32_forward(q, k, v, scale, rz)

    ref64, lse64 = attention64(q, k, v, scale)
    plain = attention_reference(q, k, v, scale)
    plain_lse = attention_lse_reference(q, k, scale)
    err = (out.double() - ref64).abs().max().item()
    plain_err = (plain.double() - ref64).abs().max().item()
    err_lse = (lse.double() - lse64).abs().max().item()
    plain_err_lse = (plain_lse.double() - lse64).abs().max().item()
    assert err <= 4 * plain_err, (err, plain_err)
    assert err_lse <= 4 * plain_err_lse, (err_lse, plain_err_lse)

    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    j_out, j_lse = _flash_forward(jq, jk, jv, scale, 128, 128, True, with_lse=True)
    j_lse = np.asarray(j_lse)[:, :, :sq, 0]  # folded (B, H, Sq_pad, 1) layout
    assert np.abs(out.numpy() - np.asarray(j_out)).max() <= 1e-4
    assert np.abs(lse.numpy() - j_lse).max() <= 1e-4


def test_one_long_truncating_chain_breaks_the_bound():
    """The P V of 1024 keys summed in place in a truncating accumulator
    drifts past 4 times the fp32 plain version's error; the kernel's fresh
    sums a key tile stay within it, on the same values."""
    q, k, v = _qkv(1, 64, 1024, 2, 40, seed=11)
    scale = 40 ** -0.5
    ref64, _ = attention64(q, k, v, scale)
    plain_err = (attention_reference(q, k, v, scale).double() - ref64).abs().max().item()
    errs = [(emulate_tf32_forward(q, k, v, scale, True, short)[0].double() - ref64).abs().max().item()
            for short in (False, True)]
    assert errs[0] > 4 * plain_err and errs[1] <= 4 * plain_err, (errs, plain_err)


@pytest.mark.parametrize("rz", [False, True])
@pytest.mark.parametrize("n,cin,h,w,cout", [(2, 40, 8, 8, 24), (1, 4, 6, 5, 16)])
def test_emulated_tf32_conv_error_and_jax(n, cin, h, w, cout, rz):
    """A tiny conv (two chunks of 32 channels, the second ragged) and a
    conv_in-like Cin = 4 on a ragged map."""
    rng = np.random.default_rng(cin + cout)
    x = torch.from_numpy(rng.standard_normal((n, cin, h, w)).astype(np.float32))
    weight = torch.from_numpy(
        (rng.standard_normal((cout, cin, 3, 3)) * (9 * cin) ** -0.5).astype(np.float32))
    out = emulate_tf32_conv(x, weight, rz)

    ref64 = F.conv2d(x.double(), weight.double(), padding=1)
    plain = conv3x3_reference(x, weight)
    err = (out.double() - ref64).abs().max().item()
    plain_err = (plain.double() - ref64).abs().max().item()
    assert err <= 4 * plain_err, (err, plain_err)

    j_out = conv3x3_xla(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                        jnp.asarray(weight.permute(2, 3, 1, 0).numpy()))
    j_out = torch.from_numpy(np.array(j_out)).permute(0, 3, 1, 2)
    peak = j_out.abs().max().item()
    assert (out - j_out).abs().max().item() <= 1e-4 * max(1.0, peak)
