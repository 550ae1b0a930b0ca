"""The GroupNorm kernels' arithmetic, emulated on the CPU.

csrc/gn_stats.cu and csrc/gn_silu.cu cannot run here, so their partition
and addition order is replayed in fp32 with numpy: the cluster size from
the run length, the chunks (gn_stats) or slices (gn_silu) each rank owns,
each thread's chain of additions (fmaf for the squares), the warp's shuffle
butterfly, the block's warp order and the cluster's rank order. The sums are
held against float64 and against ddpo_tpu's ``_group_stats`` (its Pallas
kernel in interpret mode) under chip_smoke.py phase 3's bound: error at most
1e-5 of sum|x| (sums) and of sum x^2 (sums of squares). The run lengths are
the UNet's at 512 px and the VAE decoder's, with n = 1-2; inputs are fp32,
or fp32 values rounded to bf16 (the kernels read bf16 exactly into fp32).

Also on the CPU: ``group_stats`` returns the two rows of one tensor, and
``group_norm`` without autograd gives the bits of its autograd path. The
kernels themselves are held against these on the card by
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpo_torch.ops.groupnorm import (
    group_norm,
    group_norm_silu_reference,
    group_stats,
    group_stats_reference,
)
from ddpo_tpu.ops.groupnorm import _group_stats
from ddpo_tpu.ops.groupnorm import group_norm_silu as jax_group_norm_silu

F32 = np.float32

# gn_stats.cu
STATS_THREADS, STATS_UNROLL, STATS_MAX_CLUSTER = 256, 8, 2
# gn_silu.cu
SILU_THREADS = 512
SILU_MAX_SLICE = 7 * 2 * SILU_THREADS  # vectors: 112 KB


def _ceil_div(a, b):
    return -(-a // b)


def _fma(a, b, c):
    """fmaf in fp32: the exact a * b + c rounded once (a float64 product of
    two fp32 values is exact)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(F32)


def _block_sum(per_thread):
    """(..., threads) per-thread values -> (...) block totals: the shuffle
    butterfly in each warp (every lane ends with the same bits; lane 0 is
    kept), then thread 0 adds the warps in order."""
    *lead, threads = per_thread.shape
    v = per_thread.reshape(*lead, threads // 32, 32)
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ off]).astype(F32)
    total = np.zeros(lead, F32)
    for w in range(threads // 32):
        total = (total + v[..., w, 0]).astype(F32)
    return total


def _rank_sum(per_rank):
    """(..., k) -> (...): the k pairs added in rank order from 0."""
    total = np.zeros(per_rank.shape[:-1], F32)
    for r in range(per_rank.shape[-1]):
        total = (total + per_rank[..., r]).astype(F32)
    return total


def stats_cluster_size(run_len, vec):
    chunk = STATS_THREADS * STATS_UNROLL * vec
    nchunks = _ceil_div(run_len, chunk)
    k = 1
    while k < STATS_MAX_CLUSTER and 4 * k <= nchunks:
        k *= 2
    return k


def emulate_gn_stats(runs, vec):
    """gn_stats.cu on (R, L) fp32 runs with V = vec elements a 16-byte load."""
    n_runs, run_len = runs.shape
    k = stats_cluster_size(run_len, vec)
    chunk = STATS_THREADS * STATS_UNROLL * vec
    nchunks = _ceil_div(run_len, chunk)
    padded = np.zeros((n_runs, nchunks * chunk), F32)
    padded[:, :run_len] = runs
    # chunk c, slot u, thread t, element e: run element ((c U + u) T + t) V + e
    blocks = padded.reshape(n_runs, nchunks, STATS_UNROLL, STATS_THREADS, vec)
    s = np.zeros((n_runs, k, STATS_UNROLL, STATS_THREADS), F32)
    ss = np.zeros_like(s)
    for r in range(k):
        for c in range(r, nchunks, k):
            for e in range(vec):
                v = blocks[:, c, :, :, e]
                s[:, r] = (s[:, r] + v).astype(F32)
                ss[:, r] = _fma(v, v, ss[:, r])
    ts, tss = s[:, :, 0], ss[:, :, 0]
    for u in range(1, STATS_UNROLL):
        ts = (ts + s[:, :, u]).astype(F32)
        tss = (tss + ss[:, :, u]).astype(F32)
    return _rank_sum(_block_sum(ts)), _rank_sum(_block_sum(tss)), k


def _slice_for(nvec, k):
    return _ceil_div(_ceil_div(nvec, k), SILU_THREADS) * SILU_THREADS


def silu_plan(run_len, hw, vec, cluster16=True):
    """gn_silu.cu's make_plan for an aligned map: (k, mode, slice, V)."""
    if hw % vec:
        k = 1
        while k < 8 and _slice_for(run_len, k) * (16 // vec) > SILU_MAX_SLICE * 16:
            k *= 2
        return k, "scalar", _slice_for(run_len, k), 1
    nvec = run_len // vec
    for k in (1, 2, 4, 8, 16):
        if k == 16 and not cluster16:
            break
        if _slice_for(nvec, k) <= SILU_MAX_SLICE:
            return k, "cached", _slice_for(nvec, k), vec
    return 8, "streamed", _slice_for(nvec, 8), vec


def emulate_gn_silu_stats(runs, k, slice_vecs, vec):
    """gn_silu.cu's statistics: rank r owns vectors [r slice, (r + 1) slice);
    thread t adds its vectors t, t + T, ... and their elements in order."""
    n_runs, run_len = runs.shape
    padded = np.zeros((n_runs, k * slice_vecs * vec), F32)
    padded[:, :run_len] = runs
    per = padded.reshape(n_runs, k, slice_vecs // SILU_THREADS, SILU_THREADS, vec)
    s = np.zeros((n_runs, k, SILU_THREADS), F32)
    ss = np.zeros_like(s)
    for j in range(per.shape[2]):
        for e in range(vec):
            v = per[:, :, j, :, e]
            s = (s + v).astype(F32)
            ss = _fma(v, v, ss)
    return _rank_sum(_block_sum(s)), _rank_sum(_block_sum(ss))


def _input(shape, bf16, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) + 0.3).astype(F32)
    if bf16:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _check(sums, sq, ref_s, ref_sq, abs_s):
    """Phase 3's bound: |err| / sum|x| and / sum x^2 at most 1e-5."""
    assert (np.abs(sums.astype(np.float64) - ref_s) / abs_s).max() <= 1e-5
    assert (np.abs(sq.astype(np.float64) - ref_sq) / ref_sq).max() <= 1e-5


# (shape, groups): the UNet's run lengths at 512 px (2560 to 81920 elements)
# and the VAE decoder's (64K; 512K and 1M with two groups of a narrow map)
CASES = [((2, 1280, 8, 8), 32), ((2, 320, 64, 64), 32), ((1, 640, 64, 64), 32),
         ((2, 512, 64, 64), 32), ((1, 16, 256, 256), 2), ((1, 8, 512, 512), 2)]


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape,g", CASES)
def test_emulated_kernel_sums_within_phase3_bound(shape, g, bf16):
    x = _input(shape, bf16, seed=shape[1] + shape[2])
    n = shape[0]
    runs = x.reshape(n * g, -1)
    run_len = runs.shape[1]
    vec = 8 if bf16 else 4  # 16 bytes of the kernels' dtype
    x64 = runs.astype(np.float64)
    ref_s, ref_sq, abs_s = x64.sum(-1), (x64 * x64).sum(-1), np.abs(x64).sum(-1)

    sums, sq, k = emulate_gn_stats(runs, vec)
    assert k == (2 if run_len >= 4 * STATS_THREADS * STATS_UNROLL * vec else 1)
    _check(sums, sq, ref_s, ref_sq, abs_s)

    hw = shape[2] * shape[3]
    for cluster16 in (True, False):
        k, mode, slice_vecs, v = silu_plan(run_len, hw, vec, cluster16)
        assert mode != "scalar" and k * slice_vecs * v >= run_len
        s2, sq2 = emulate_gn_silu_stats(runs, k, slice_vecs, v)
        _check(s2, sq2, ref_s, ref_sq, abs_s)

    nhwc = np.ascontiguousarray(x.transpose(0, 2, 3, 1).reshape(n, hw, shape[1]))
    j_s, j_sq = (np.asarray(a, np.float64).reshape(-1)
                 for a in _group_stats(jnp.asarray(nhwc), g, interpret=True))
    _check(sums, sq, j_s, j_sq, abs_s)


def test_emulated_plans_match_the_kernels_design():
    """The cluster sizes and ways through the notes in the sources state:
    gn_stats k = 1 up to three chunks, 2 from four on; gn_silu cached up to
    112 KB a slice (k = 16 only where the card allows), streamed with k = 8
    beyond, scalar where H*W is not a multiple of the vector."""
    assert [stats_cluster_size(n, 8) for n in (2560, 40960, 49152, 65536, 2**20)] == [1, 1, 1, 2, 2]
    assert silu_plan(10 * 4096, 4096, 8)[:2] == (1, "cached")
    assert silu_plan(30 * 4096, 4096, 8)[:2] == (4, "cached")
    assert silu_plan(8 * 65536, 65536, 8)[:2] == (16, "cached")
    assert silu_plan(8 * 65536, 65536, 8, cluster16=False)[:2] == (8, "streamed")
    assert silu_plan(4 * 262144, 262144, 8)[:2] == (8, "streamed")
    assert silu_plan(2 * 289, 289, 8)[:2] == (1, "scalar")


@pytest.mark.parametrize("cluster16", [True, False])
def test_emulated_gn_silu_output_matches_jax_kernel(cluster16):
    """Mean and rstd from the emulated sums (fp32: var = E[x^2] - E[x]^2,
    1/sqrt(var + eps)), then (x - mean) rstd scale + bias and y sigmoid(y),
    against JAX's Pallas kernel in interpret mode at a map it takes
    (c = 128, 64 x 64); rtol 1e-4, atol 1e-5 as tests/test_torch_gn_silu.py."""
    n, c, h, w, g, eps = 1, 128, 64, 64, 32, 1e-5
    x = _input((n, c, h, w), False, seed=7)
    rng = np.random.default_rng(8)
    scale, bias = rng.standard_normal(c).astype(F32), rng.standard_normal(c).astype(F32)
    runs = x.reshape(n * g, -1)
    k, _, slice_vecs, v = silu_plan(runs.shape[1], h * w, 4, cluster16)
    s, ss = emulate_gn_silu_stats(runs, k, slice_vecs, v)
    count = F32(runs.shape[1])
    mean = (s / count).astype(F32)
    rstd = (F32(1) / np.sqrt((ss / count - mean * mean + F32(eps)).astype(F32))).astype(F32)
    xr = x.reshape(n, g, c // g, h * w)
    y = ((xr - mean.reshape(n, g, 1, 1)) * rstd.reshape(n, g, 1, 1)).reshape(n, c, h * w)
    y = (y * scale[None, :, None] + bias[None, :, None]).astype(F32)
    out = (y / (F32(1) + np.exp(-y))).reshape(n, c, h, w)
    ref = jax_group_norm_silu(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(scale),
                              jnp.asarray(bias), num_groups=g, use_kernel=True, interpret=True)
    np.testing.assert_allclose(out.transpose(0, 2, 3, 1), np.asarray(ref), rtol=1e-4, atol=1e-5)
    plain = group_norm_silu_reference(torch.from_numpy(x), torch.from_numpy(scale),
                                      torch.from_numpy(bias), g, eps)
    np.testing.assert_allclose(out, plain.numpy(), rtol=1e-4, atol=1e-5)


def test_group_stats_returns_two_rows_of_one_tensor():
    x = torch.from_numpy(_input((2, 64, 8, 8), False, seed=3))
    sums, sq = group_stats(x, 32)
    assert sums.shape == sq.shape == (2, 32)
    assert sums._base is not None and sums._base is sq._base and sums._base.shape == (2, 2, 32)
    ref_s, ref_sq = group_stats_reference(x, 32)
    assert torch.equal(sums, ref_s) and torch.equal(sq, ref_sq)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_without_autograd_equals_autograd_path(silu):
    """No grad mode (the sampler's path, group_stats directly) and an x that
    needs no gradient give the bits of the GroupStats path."""
    x = torch.from_numpy(_input((2, 96, 8, 8), False, seed=4))
    scale, bias = torch.randn(96), torch.randn(96)
    with torch.no_grad():
        fast = group_norm(x, scale, bias, 32, silu=silu)
    no_grad_x = group_norm(x, scale, bias, 32, silu=silu)
    leaf = x.clone().requires_grad_()
    tracked = group_norm(leaf, scale, bias, 32, silu=silu)
    assert tracked.grad_fn is not None and fast.grad_fn is None
    assert torch.equal(fast, tracked.detach()) and torch.equal(no_grad_x, tracked.detach())
