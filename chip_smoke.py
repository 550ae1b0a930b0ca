#!/usr/bin/env python3
"""Drive the PyTorch port (ddpo_torch) on one NVIDIA GPU, end to end.

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit, torch and CUDA versions.
  2. build: nvcc builds ddpo_torch/csrc/*.cu for sm_90a; cuobjdump -sass on
     the library says which kernel functions hold tensor-core (HMMA)
     instructions: every instantiation of the bf16 flash forward, the bf16
     flash backward (dq and dk/dv) and the tap-GEMM must; ptxas's registers
     and spills of each of those instantiations.
  3. kernels: each forward kernel against its plain PyTorch version at the
     main path's shapes, with the bound stated, plus kernel and plain times;
     the bf16 flash forward and gn_stats on image 0 of each 8-image case
     alone must give the bits of its slice of the batched call (batch
     invariance). gn_stats prints each shape's cluster size (blocks a run;
     the phase fails unless some shape runs with more than one) and the
     wrapper's host microseconds a call beside var_mean's.
  3b. backward kernels: flash_bwd_dq and flash_bwd_dkv against the plain
     fp32 backward at the trainer's shapes (2B = 4), ragged lengths and
     D = 256, in bf16 and fp32; kernel times beside the plain backward's
     and SDPA's; in bf16, image 0 of each 4-image case alone must give the
     bits of its slice.
  4. serving: ddpo_torch.pipelines.generate.main at SD-1.4 width, 512 px,
     50 CFG DDIM steps, 4 images, random weights from a seed; checks the
     images and that the path launched each kernel the expected number of
     times.
  5. rollout: sample_trajectories at batch 4 (the DDPO sampling phase) and
     a score-mode recompute of step 0's log-prob.
  6. on-policy through the training code: ppo_loss on step 0 of that
     rollout, at its batch, with fp32 masters cast to bf16 at use, grad on
     and remat; the recomputed log-probs must equal the sampler's, and one
     backward must launch the expected kernels. The update runs under
     torch.profiler (CUDA activity only): device time by kernel family and
     the device's idle share over the update's wall time.
  3c. gn_silu: the fused GroupNorm+SiLU kernel, through
     group_norm_silu(use_kernel=True), at every GN+SiLU input shape of the
     UNet (2B = 8) and the VAE decoder (batch 4), bf16 and some fp32, and a
     gcd-clamped case that must take group_norm; against the fp32 plain
     version, two calls bit-equal, image 0 alone bit-equal to its slice;
     each shape's cluster size and way through (cached, streamed, scalar);
     device times and host microseconds a call beside F.group_norm +
     F.silu's.
  3d. conv3x3: the tap-GEMM kernel at every Conv3x3 input shape of the UNet
     (2B = 8) and the VAE decoder (batch 4), bf16, fp32 cases and an odd
     map; against the fp32 9-tap plain version; times beside F.conv2d; in
     bf16, image 0 alone against its slice of the batched call, bit for bit.
  3e. the conv probes p1, p2, p6, p7: ddpo_torch.bench.conv_probe.main at
     JAX's shape (B16, 64x64, 320 -> 320, bf16), then each probe against
     its plain version; library times: the p0 einsum for p1, F.conv2d with
     the (Cout, Cin, 3, 1) weight summed over dx for p2, F.conv2d for p6
     and p7.
  4-7 launch none of the new kernels.
  7. DDPO: ddpo_torch.pipelines.policy_gradient.main, one epoch at the
     defaults of --dataset compressed-animals (sample batch 8, 50 steps,
     train batch 2, bf16 over fp32 masters, adamw) with its JPEG reward
     (the native library built against the libjpeg the build finds, which
     is logged, with the reward's seconds for the epoch's images), a
     full-state checkpoint, and a --resume call that trains no further
     epoch; checks the exact launch counts of all four kernels.
  8. the conv path, with ops.conv.set_conv_kernel_enabled(True) (reset
     after): (a) one UNet forward at 2B = 8 with the switch on against off,
     and the median time of a UNet step each way;
     (b) phase 4 again: conv3x3 launches 49 per UNet forward x 50 + 31 in
     the VAE decode; (c) phases 5 and 6 again: the rollout, and the
     on-policy update, which launches conv3x3 twice per module (forward and
     remat recompute; the backward is the library conv's).

The line before the last is one JSON object describing the kernels; the
last line is {"ok": true, "device": {...}}. With no CUDA device, or run
outside the repository, it fails before printing any result.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (H100 SXM data sheet, dense): device memory,
# bf16 tensor cores, fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# UNet self-attentions per forward that meet the flash gate at 512 px:
# down blocks 0-2 (S = 4096, 1024, 256) x 2 and up blocks 1-3 x 3; the
# mid block's S = 64 takes the plain path.
FLASH_PER_UNET_FORWARD = 15


def fail(msg: str) -> None:
    print(f"[ chip_smoke ] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[ chip_smoke ] {msg}", flush=True)


def median_ms(fn, iters: int) -> float:
    """Median of per-call CUDA-event times, after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call: `calls` calls after warm-up, timed with
    time.perf_counter and no synchronize in between (the caller's thread
    cost: Python, allocation, the launch)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - start) / calls * 1e6
    torch.cuda.synchronize()
    return us


def roofline(flops: float, nbytes: float, dtype: str = "bfloat16"):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate of their type and the bytes (each input
    read once, each output written once) over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def expected(**counts):
    """Every kernel's launch count: those given, and 0 for the rest."""
    from ddpo_torch.ops import _build

    unknown = set(counts) - set(_build.launches)
    if unknown:
        fail(f"no launch counter for {sorted(unknown)}")
    return {name: counts.get(name, 0) for name in _build.launches}


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def timed_pair(kernel_fn, plain_fn, iters: int):
    """Median times of kernel and plain version, measured plain, kernel, kernel, plain."""
    p1 = median_ms(plain_fn, iters)
    k1 = median_ms(kernel_fn, iters)
    k2 = median_ms(kernel_fn, iters)
    p2 = median_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    # numbers are compared below: no TF32 in fp32 matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN")
    return smi


# kernel functions that must run their products on the tensor cores
TENSOR_CORE_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                       "flash_bwd_dkv_mma_kernel", "tap_gemm_mma_kernel")


def kernel_name(mangled: str) -> str:
    """The function name in a mangled kernel symbol: the first <length><name>
    pair naming a *_kernel, e.g. flash_fwd_mma_kernel from ...20flash_fwd_mma_kernelI..."""
    import re

    return next((m.group(2) for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*?_kernel))", mangled)
                 if int(m.group(1)) == len(m.group(2))), mangled)


def ptxas_instantiations(build_log: str, names):
    """{kernel function: [(template args, registers, spill store bytes, spill
    load bytes)]} for the named functions, from ptxas -v's "Compiling entry
    function", spill and "Used N registers" lines."""
    import re

    table, entry = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, entry = kernel_name(m.group(1)), None
            if name in names:
                args = re.search(re.escape(name) + r"I((?:Li\d+E)+)E", m.group(1))
                entry = [tuple(int(x) for x in re.findall(r"\d+", args.group(1))) if args else (),
                         0, 0, 0]
                table.setdefault(name, []).append(entry)
        elif entry is not None and "spill stores" in line:
            entry[2], entry[3] = (int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif entry is not None and "Used " in line and "registers" in line:
            entry[1] = int(line.split("Used ")[1].split()[0])
    return {name: sorted(tuple(e) for e in rows) for name, rows in table.items()}


def sass_hmma(path: str):
    """{kernel function: [HMMA count of each instantiation]} from
    cuobjdump -sass of the built library; fails if cuobjdump is missing."""
    import re

    from ddpo_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        fail("cuobjdump not found beside nvcc or on PATH: cannot read the SASS")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :")[1].strip())
            counts.setdefault(name, []).append(0)
        elif name is not None and re.search(r"\bHMMA\b", line):
            counts[name][-1] += 1
    return counts


def phase_build():
    from ddpo_torch.ops import _build

    kl = _build.load_library()
    log(f"built {os.path.relpath(kl.path, REPO)} in {kl.build_seconds:.1f} s")
    lines = kl.log.splitlines()
    regs = [int(l.split("Used ")[1].split()[0]) for l in lines if "Used " in l and "registers" in l]
    # ptxas prints "Function properties for <name>", then its stack and spills
    spills = sorted({f"{kernel_name(lines[i - 1].split()[-1])}: {l.strip()}"
                     for i, l in enumerate(lines) if i and "spill" in l
                     and "0 bytes spill stores, 0 bytes spill loads" not in l})
    log(f"ptxas: {len(regs)} kernels, {min(regs, default=0)}..{max(regs, default=0)} "
        f"registers per thread; spills: {spills or 'none'} (full log: {kl.path}.log)")
    hmma = sass_hmma(kl.path)
    for name, per in sorted(hmma.items()):
        log(f"sass: {name}: {len(per)} instantiations, {sum(n > 0 for n in per)} with HMMA "
            f"({min(per)}..{max(per)} HMMA instructions each)")
    for name in TENSOR_CORE_KERNELS:
        if name not in hmma or not all(hmma[name]):
            fail(f"{name}: every instantiation must hold HMMA instructions, got {hmma.get(name)}")
    for name, rows in sorted(ptxas_instantiations(kl.log, TENSOR_CORE_KERNELS).items()):
        log(f"ptxas {name} <template args>: registers, spill store/load bytes: " + "; ".join(
            f"<{','.join(map(str, args))}> {regs}, {st}/{ld}" for args, regs, st, ld in rows))
    return kl


def check_flash(results):
    import torch
    import torch.nn.functional as F

    from ddpo_torch.ops.attention import (
        attention_lse_reference,
        attention_reference,
        flash_attention_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    # (B, Sq, Sk, H, D): the UNet's three self-attention levels at 512 px
    # with the 2B = 8 CFG batch, then ragged lengths the kernel masks itself
    cases = [(8, 4096, 4096, 8, 40), (8, 1024, 1024, 8, 80), (8, 256, 256, 8, 160),
             (2, 1000, 1000, 8, 40), (2, 300, 700, 8, 80)]
    bounds = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-4)}
    for dtype in (torch.bfloat16, torch.float32):
        for b, sq, sk, h, d in cases:
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
            out, lse = flash_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            # the plain version in fp32 on the same values (TF32 off)
            ref = attention_reference(q.float(), k.float(), v.float())
            ref_lse = attention_lse_reference(q.float(), k.float())
            err = (out.float() - ref).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            bound, bound_lse = bounds[dtype]
            name = str(dtype).replace("torch.", "")
            line = (f"flash {name} B{b} Sq{sq} Sk{sk} H{h} D{d}: max|out-ref| "
                    f"{err:.3e} (bound {bound:g}), max|lse-ref| {err_lse:.3e} "
                    f"(bound {bound_lse:g})")
            if not (err <= bound and err_lse <= bound_lse):
                fail(line)
            entry = {"shape": [b, sq, sk, h, d], "dtype": name,
                     "max_abs_err": err, "max_abs_err_lse": err_lse}
            if b == 8 and dtype == torch.bfloat16:
                # batch invariance: image 0 alone gives the bits of its slice
                out1, lse1 = flash_attention_fwd(q[:1], k[:1], v[:1])
                same = torch.equal(out1, out[:1]) and torch.equal(lse1, lse[:1])
                line += f"; image 0 alone equals its slice of the batch: {same}"
                if not same:
                    fail(line)
                del out1, lse1
            if sq == sk and b == 8:
                iters = 10 if sq == 4096 else 30
                k_ms, p_ms = timed_pair(lambda: flash_attention_fwd(q, k, v),
                                        lambda: attention_reference(q, k, v), iters)
                # the library yardstick: SDPA on (B, H, S, D) views
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                lib_ms = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
                flops = 4.0 * b * h * sq * sk * d
                nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + 4 * b * h * sq
                bound_ms, bound_by = roofline(flops, nbytes, name)
                entry.update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
                line += (f"; kernel {k_ms:.3f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), "
                         f"plain {p_ms:.3f} ms, SDPA {lib_ms:.3f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by})")
            log(line)
            results.append(entry)
            del q, k, v, out, lse, ref, ref_lse
            torch.cuda.empty_cache()


def check_flash_bwd(results):
    import torch
    import torch.nn.functional as F

    from ddpo_torch.ops.attention import (
        _delta,
        attention_reference,
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_bwd_dkv,
        flash_bwd_dq,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    # (B, Sq, Sk, H, D): the UNet's three self-attention levels at 512 px
    # with the trainer's 2B = 4 CFG batch, ragged lengths the kernels mask
    # themselves, and D = 256, the widest the gate admits
    cases = [(4, 4096, 4096, 8, 40), (4, 1024, 1024, 8, 80), (4, 256, 256, 8, 160),
             (2, 1000, 1000, 8, 40), (2, 300, 700, 8, 80), (2, 300, 300, 2, 256)]
    for dtype in (torch.bfloat16, torch.float32):
        for b, sq, sk, h, d in cases:
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
            do = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
            out, lse = flash_attention_fwd(q, k, v)
            grads = flash_attention_bwd(q, k, v, out, lse, do)
            again = flash_attention_bwd(q, k, v, out, lse, do)
            torch.cuda.synchronize()
            refs = flash_attention_bwd_reference(q, k, v, out, lse, do)
            errs = [(g.float() - r).abs().max().item() for g, r in zip(grads, refs)]
            peak = max(r.abs().max().item() for r in refs)
            # fp32: summation order only; bf16: the rounding of the bf16
            # outputs, half an ulp = 2^-9 of the value
            bound = 1e-4 if dtype == torch.float32 else 1e-2 * max(1.0, peak)
            same = all(torch.equal(g, g2) for g, g2 in zip(grads, again))
            name = str(dtype).replace("torch.", "")
            line = (f"flash_bwd {name} B{b} Sq{sq} Sk{sk} H{h} D{d}: max|dq,dk,dv - ref| "
                    f"{errs[0]:.3e} {errs[1]:.3e} {errs[2]:.3e} (bound {bound:.3g}, "
                    f"max|ref| {peak:.3f}); two calls equal: {same}")
            if b == 4 and dtype == torch.bfloat16:
                # batch invariance: image 0 alone gives the bits of its slice
                alone = flash_attention_bwd(q[:1], k[:1], v[:1], out[:1], lse[:1], do[:1])
                inv = all(torch.equal(g1, g[:1]) for g1, g in zip(alone, grads))
                line += f"; image 0 alone equals its slice of the batch: {inv}"
                same = same and inv
                del alone
            if not (max(errs) <= bound and same):
                fail(line)
            entry = {"shape": [b, sq, sk, h, d], "dtype": name, "max_abs_err_dq": errs[0],
                     "max_abs_err_dkv": max(errs[1:])}
            if b == 4:
                scale = d**-0.5
                delta = _delta(out, do)
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                ref_out = attention_reference(*leaves)

                def plain():
                    return torch.autograd.grad(ref_out, leaves, do, retain_graph=True)

                iters = 5 if sq == 4096 else 20
                dq_ms, p1 = timed_pair(lambda: flash_bwd_dq(q, k, v, do, lse, delta, scale),
                                       plain, iters)
                dkv_ms, p2 = timed_pair(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, scale),
                                        plain, iters)
                # what FlashAttention's backward costs on each side: the
                # wrapper (delta + both kernels) against the fp32 branch's
                # recompute of attention_reference + autograd (JAX's gate)
                wrap_ms, rec_ms = timed_pair(
                    lambda: flash_attention_bwd(q, k, v, out, lse, do, scale),
                    lambda: torch.autograd.grad(attention_reference(*leaves), leaves, do),
                    iters)
                # the library yardstick: SDPA's whole backward (dq, dk, dv)
                sdpa_leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
                sdpa_out = F.scaled_dot_product_attention(*sdpa_leaves)
                do_t = do.transpose(1, 2)
                lib_ms = median_ms(lambda: torch.autograd.grad(sdpa_out, sdpa_leaves, do_t,
                                                               retain_graph=True), iters)
                flops = 2.0 * b * h * sq * sk * d  # one (Sq, Sk, D) product
                io = (q.numel() + k.numel() + v.numel() + do.numel()) * q.element_size()
                stats = 2 * 4 * b * h * sq  # lse and delta
                # dq: S, dP and dS K; dkv: S, dP, P^T dO and dS^T Q
                dq_bound = roofline(3 * flops, io + stats + q.numel() * q.element_size(), name)
                dkv_bound = roofline(4 * flops, io + stats + 2 * k.numel() * k.element_size(), name)
                entry.update(dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=(p1 + p2) / 2,
                             wrapper_ms=wrap_ms, recompute_plain_ms=rec_ms, library_ms=lib_ms,
                             dq_bound=dq_bound, dkv_bound=dkv_bound)
                line += (f"; dq {dq_ms:.3f} ms ({3 * flops / dq_ms / 1e9:.1f} TFLOP/s), "
                         f"dkv {dkv_ms:.3f} ms ({4 * flops / dkv_ms / 1e9:.1f} TFLOP/s), "
                         f"plain backward (autograd through attention_reference) "
                         f"{entry['plain_ms']:.3f} ms; flash_attention_bwd {wrap_ms:.3f} ms "
                         f"against recompute + plain backward {rec_ms:.3f} ms; SDPA backward "
                         f"{lib_ms:.3f} ms; bounds dq {dq_bound[0]:.4f}, dkv {dkv_bound[0]:.4f} ms")
                del leaves, ref_out, delta, sdpa_leaves, sdpa_out
            log(line)
            results.append(entry)
            del q, k, v, do, out, lse, grads, again, refs
            torch.cuda.empty_cache()


def check_gn_stats(results):
    import torch

    from ddpo_torch.ops.groupnorm import (
        gn_stats_cluster_size,
        group_stats,
        group_stats_reference,
        num_groups_for,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [
        # UNet at 512 px, 2B = 8 (incl. a skip-concat input)
        (8, 320, 64, 64), (8, 640, 64, 64), (8, 640, 32, 32), (8, 1280, 16, 16),
        (8, 1280, 8, 8),
        # VAE decoder at 512 px, batch 4
        (4, 512, 64, 64), (4, 512, 256, 256), (4, 256, 512, 512), (4, 128, 512, 512),
        # gcd group clamp (48 channels -> 16 groups), odd spatial size
        (2, 48, 17, 17),
    ]
    bound = 1e-5  # |err| relative to sum|x| (sums) and sum x^2 (sq_sums)
    largest_k = 0
    for dtype in (torch.bfloat16, torch.float32):
        for shape in cases:
            if dtype == torch.float32 and shape not in (cases[0], cases[-1], cases[-2]):
                continue
            x = (torch.randn(shape, generator=gen, device="cuda") + 0.3).to(dtype)
            g = num_groups_for(shape[1], 32)
            k = gn_stats_cluster_size(x.numel() // (shape[0] * g), dtype)
            largest_k = max(largest_k, k)
            sums, sq = group_stats(x, g)
            sums2, sq2 = group_stats(x, g)
            torch.cuda.synchronize()
            if not (torch.equal(sums, sums2) and torch.equal(sq, sq2)):
                fail(f"gn_stats {tuple(shape)}: two calls on one input differ")
            x64 = x.double().reshape(shape[0], g, -1)
            count = x64.shape[-1]
            ref_s, ref_sq = x64.sum(-1), (x64 * x64).sum(-1)
            abs_s, abs_sq = x64.abs().sum(-1), (x64 * x64).sum(-1)
            # absolute error of the moments GroupNorm uses: E[x] and E[x^2]
            err = max((sums.double() - ref_s).abs().max().item(),
                      (sq.double() - ref_sq).abs().max().item()) / count
            rel = max(((sums.double() - ref_s).abs() / abs_s).max().item(),
                      ((sq.double() - ref_sq).abs() / abs_sq).max().item())
            name = str(dtype).replace("torch.", "")
            line = (f"gn_stats {name} {tuple(shape)} g{g} cluster k={k}: max abs err of E[x], "
                    f"E[x^2] vs float64 {err:.3e}; of the sums relative to sum|x| {rel:.3e} "
                    f"(bound {bound:g}); deterministic")
            if not rel <= bound:
                fail(line)
            entry = {"shape": list(shape), "dtype": name, "max_abs_err": err,
                     "max_rel_err": rel, "cluster": k}
            if dtype == torch.bfloat16:
                view = x.view(shape[0], g, -1)
                # batch invariance: image 0 alone gives the bits of its slice
                s1, q1 = group_stats(x[:1], g)
                if not (torch.equal(s1, sums[:1]) and torch.equal(q1, sq[:1])):
                    fail(line + "; image 0 alone differs from its slice of the batch")
                k_ms, p_ms = timed_pair(lambda: group_stats(x, g),
                                        lambda: group_stats_reference(x, g), 20)
                lib_ms = median_ms(lambda: torch.var_mean(view, dim=-1), 20)
                k_us = host_us(lambda: group_stats(x, g))
                lib_us = host_us(lambda: torch.var_mean(view, dim=-1))
                nbytes = x.numel() * x.element_size() + 2 * 4 * shape[0] * g
                bound_ms, bound_by = roofline(3.0 * x.numel(), nbytes, "float32")
                gbs = x.numel() * x.element_size() / k_ms / 1e6
                entry.update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by, host_us=k_us, library_host_us=lib_us)
                line += (f"; image 0 alone equals its slice; kernel {k_ms:.4f} ms ({gbs:.0f} "
                         f"GB/s), plain {p_ms:.4f} ms, var_mean {lib_ms:.4f} ms, bound "
                         f"{bound_ms:.4f} ms ({bound_by}); host {k_us:.1f} us a call, "
                         f"var_mean's {lib_us:.1f} us")
            log(line)
            results.append(entry)
            del x
            torch.cuda.empty_cache()
    if largest_k < 2:
        fail(f"gn_stats ran every shape with one block a run (largest cluster {largest_k})")


def count_modules():
    """GroupNorms and Conv3x3s of the SD-1.4 UNet and of its VAE decoder."""
    from ddpo_torch.models.layers import Conv3x3, GroupNorm
    from ddpo_torch.utils.serialization import build_models

    _, vae, unet = build_models("sd14", "meta")

    def count(module, kind):
        return sum(isinstance(m, kind) for m in module.modules())

    counts = (count(unet, GroupNorm), count(vae.decoder, GroupNorm),
              count(unet, Conv3x3), count(vae.decoder, Conv3x3))
    # conv_in, 22 resnets x 2, 3 upsamplers, conv_out; 14 resnets x 2, 3 upsamplers
    if counts[2:] != (49, 31):
        fail(f"Conv3x3 modules: UNet {counts[2]}, VAE decoder {counts[3]}, expected 49 and 31")
    return counts


def collect_model_shapes():
    """The input shapes of every GroupNorm+SiLU and every Conv3x3 module:
    one bf16 forward of the SD-1.4 UNet at 2B = 8 and one VAE decode at
    batch 4, 512 px, random weights from seed 0."""
    import torch

    from ddpo_torch.models.layers import Conv3x3, GroupNorm
    from ddpo_torch.utils.serialization import load_stable_diffusion

    models = load_stable_diffusion(model_preset="sd14", device="cuda",
                                   dtype=torch.bfloat16, seed=0)
    gn_shapes, conv_shapes = [], []

    def record(shapes, key):
        if key not in shapes:
            shapes.append(key)

    hooks = []
    for m in [*models.unet.modules(), *models.vae.decoder.modules()]:
        if isinstance(m, GroupNorm) and m.silu:
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: record(gn_shapes, tuple(args[0].shape))))
        elif isinstance(m, Conv3x3):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: record(conv_shapes, (*args[0].shape, mod.out_channels))))
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        latents = torch.randn((8, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
        context = torch.randn((8, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
        models.unet(latents, torch.full((8,), 500, device="cuda"), context)
        models.vae.decode(latents[:4])
    for hook in hooks:
        hook.remove()
    del models
    torch.cuda.empty_cache()
    log(f"model shapes: {len(gn_shapes)} distinct GroupNorm+SiLU inputs, "
        f"{len(conv_shapes)} distinct Conv3x3 (N, Cin, H, W, Cout)")
    return gn_shapes, conv_shapes


def check_gn_silu(results, model_shapes):
    """The op-level path group_norm_silu(use_kernel=True) once at each shape
    (counted), then each output against the fp32 plain version."""
    import torch
    import torch.nn.functional as F

    from ddpo_torch.ops import _build
    from ddpo_torch.ops.groupnorm import gn_silu_plan, group_norm_silu, group_norm_silu_reference

    gen = torch.Generator(device="cuda").manual_seed(8)
    odd, clamped = (2, 64, 17, 17), (2, 48, 17, 17)  # 48 channels -> group_norm, 16 groups
    cases = [(shape, torch.bfloat16) for shape in model_shapes]
    largest = max(model_shapes, key=lambda t: t[0] * t[1] * t[2] * t[3])
    cases += [(model_shapes[0], torch.float32), (largest, torch.float32),
              (odd, torch.bfloat16), (odd, torch.float32), (clamped, torch.float32)]
    inputs = []
    for shape, dtype in cases:
        c = shape[1]
        inputs.append(((torch.randn(shape, generator=gen, device="cuda") + 0.3).to(dtype),
                       torch.randn(c, generator=gen, device="cuda").to(dtype),
                       torch.randn(c, generator=gen, device="cuda").to(dtype)))
    _build.reset_launch_counts()
    outs = [group_norm_silu(x, scale, bias, use_kernel=True) for x, scale, bias in inputs]
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    want = expected(gn_silu=len(cases) - 1, gn_stats=1)  # the clamped case: group_norm
    log(f"gn_silu path: {len(cases)} calls, launches {counts}")
    if counts != want:
        fail(f"gn_silu path launches {counts} != expected {want}")

    for (shape, dtype), (x, scale, bias), out in zip(cases, inputs, outs):
        name = dtype_name(dtype)
        again = group_norm_silu(x, scale, bias, use_kernel=True)
        ref = group_norm_silu_reference(x.float(), scale.float(), bias.float())
        peak = ref.abs().max().item()
        err = (out.float() - ref).abs().max().item()
        bound = (1e-2 if dtype == torch.bfloat16 else 1e-4) * max(1.0, peak)
        same = torch.equal(out, again)
        line = (f"gn_silu {name} {shape}: max|out-ref| {err:.3e} (bound {bound:.3g}, "
                f"max|ref| {peak:.2f}); two calls equal: {same}")
        if not (err <= bound and same and out.dtype == dtype):
            fail(line)
        entry = {"shape": list(shape), "dtype": name, "max_abs_err": err}
        if dtype == torch.bfloat16 and shape in model_shapes:
            g = 32
            k, way = gn_silu_plan(shape[1] // g, shape[2] * shape[3], dtype)
            alone = group_norm_silu(x[:1], scale, bias, use_kernel=True)
            if not torch.equal(alone, out[:1]):
                fail(line + "; image 0 alone differs from its slice of the batch")
            iters = 5 if x.numel() > 2**26 else 20
            k_ms, p_ms = timed_pair(
                lambda: group_norm_silu(x, scale, bias, use_kernel=True),
                lambda: group_norm_silu_reference(x, scale, bias), iters)
            lib_ms = median_ms(lambda: F.silu(F.group_norm(x, g, scale, bias, 1e-5)), iters)
            k_us = host_us(lambda: group_norm_silu(x, scale, bias, use_kernel=True))
            lib_us = host_us(lambda: F.silu(F.group_norm(x, g, scale, bias, 1e-5)))
            nbytes = 2 * x.numel() * x.element_size() + 2 * scale.numel() * scale.element_size()
            bound_ms, bound_by = roofline(8.0 * x.numel(), nbytes, "float32")
            entry.update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, cluster=k, way=way, host_us=k_us,
                         library_host_us=lib_us)
            line += (f"; cluster k={k}, {way}; image 0 alone equals its slice; kernel "
                     f"{k_ms:.4f} ms ({nbytes / k_ms / 1e6:.0f} GB/s), plain {p_ms:.4f} ms, "
                     f"F.group_norm + F.silu {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}); host {k_us:.1f} us a call, F.group_norm + F.silu's "
                     f"{lib_us:.1f} us")
        log(line)
        results.append(entry)
        del again, ref
    del inputs, outs
    torch.cuda.empty_cache()
    return counts["gn_silu"]


def check_conv3x3(results, model_shapes):
    """The direct conv kernel at every model shape against its 9-tap plain
    version in fp32 (TF32 off), with F.conv2d's time beside it."""
    import torch
    import torch.nn.functional as F

    from ddpo_torch.ops.conv import conv3x3_direct, conv3x3_reference, weight_kn

    gen = torch.Generator(device="cuda").manual_seed(9)
    odd = (2, 96, 13, 17, 40)
    cases = [(shape, torch.bfloat16) for shape in model_shapes]
    cases += [(model_shapes[0], torch.float32), (model_shapes[1], torch.float32),
              (odd, torch.bfloat16), (odd, torch.float32)]
    for shape, dtype in cases:
        n, cin, h, w, cout = shape
        name = dtype_name(dtype)
        x = torch.randn((n, cin, h, w), generator=gen, device="cuda").to(dtype)
        weight = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
                  * (9 * cin) ** -0.5).to(dtype)
        out = conv3x3_direct(x, weight)
        again = conv3x3_direct(x, weight)
        ref = conv3x3_reference(x.float(), weight.float())
        peak = ref.abs().max().item()
        err = (out.float() - ref).abs().max().item()
        bound = (1e-2 if dtype == torch.bfloat16 else 1e-4) * max(1.0, peak)
        same = torch.equal(out, again)
        line = (f"conv3x3 {name} x{(n, cin, h, w)} -> {cout}: max|out-ref| {err:.3e} (bound "
                f"{bound:.3g}, max|ref| {peak:.2f}); two calls equal: {same}")
        if dtype == torch.bfloat16 and n > 1:
            # batch invariance: image 0 alone gives the bits of its slice
            alone = torch.equal(conv3x3_direct(x[:1], weight), out[:1])
            line += f"; image 0 alone equals its slice of the batch: {alone}"
            same = same and alone
        if not (err <= bound and same and out.dtype == dtype):
            fail(line)
        del again, ref
        flops = 2.0 * n * h * w * 9 * cin * cout
        iters = 3 if flops > 1e11 else 10
        k_ms, p_ms = timed_pair(lambda: conv3x3_direct(x, weight),
                                lambda: conv3x3_reference(x, weight), iters)
        lib_ms = median_ms(lambda: F.conv2d(x, weight, padding=1), iters)
        nbytes = (x.numel() + weight.numel() + out.numel()) * x.element_size()
        bound_ms, bound_by = roofline(flops, nbytes, name)
        results.append({"shape": list(shape), "dtype": name, "max_abs_err": err, "ms": k_ms,
                        "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by})
        log(line + f"; kernel {k_ms:.3f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), plain "
            f"{p_ms:.3f} ms, F.conv2d {lib_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        del x, weight, out
        torch.cuda.empty_cache()
    # conv3x3_direct lays the OIHW weight out as (9 Cin, Cout) on each call:
    # the transpose kernel against torch's strided copy, at the widest weight
    n, cin, h, w, cout = max(model_shapes, key=lambda t: t[1] * t[4])
    weight = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda").to(torch.bfloat16)
    if not torch.equal(weight_kn(weight), weight.permute(2, 3, 1, 0).reshape(-1, cout)):
        fail("weight_kn differs from the permute")
    k_ms, p_ms = timed_pair(lambda: weight_kn(weight),
                            lambda: weight.permute(2, 3, 1, 0).contiguous(), 10)
    log(f"conv weight layout ({cout}, {cin}, 3, 3) -> ({9 * cin}, {cout}) bf16: transpose kernel "
        f"{k_ms:.4f} ms ({4 * weight.numel() / k_ms / 1e6:.0f} GB/s), permute + contiguous "
        f"{p_ms:.4f} ms; equal")
    del weight
    torch.cuda.empty_cache()


def phase_probes(results):
    """ddpo_torch.bench.conv_probe.main at JAX's shape (counted), then each
    probe against its plain version at that shape."""
    import torch
    import torch.nn.functional as F

    from ddpo_torch.bench import conv_probe as cp
    from ddpo_torch.ops import _build

    _build.reset_launch_counts()
    probe_ms = cp.main()
    counts = _build.launch_counts()
    log(f"conv_probe.main launches {counts}")
    probes = ("p1", "p2", "p6", "p7")
    if any(counts[f"conv_probe_{p}"] == 0 for p in probes) or counts["conv3x3"] == 0:
        fail("conv_probe.main did not launch every probe kernel")
    b, h, w, cin, cout = cp.B, cp.H, cp.W, cp.CIN, cp.COUT
    gen = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((b, cin, h, w), generator=gen, device="cuda").to(torch.bfloat16)
    w9 = (torch.randn((9, cin, cout), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    weights = {"p1": w9, "p2": w9, "p6": w9.reshape(3, 3 * cin, cout),
               "p7": w9.reshape(9 * cin, cout)}
    w_oihw = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous()
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    # p2's function as one library call: the row shifts with the dx taps
    # summed, a (3, 1) conv; the sum is taken here, outside the timed call
    w_rows = (w9.float().reshape(3, 3, cin, cout).sum(1).permute(2, 1, 0)[..., None]
              .to(torch.bfloat16).contiguous())
    library = {"p1": lambda: cp.p0_einsum(x_nhwc, w9),
               "p2": lambda: F.conv2d(x, w_rows, padding=(1, 0)),
               "p6": lambda: F.conv2d(x, w_oihw, padding=1),
               "p7": lambda: F.conv2d(x, w_oihw, padding=1)}
    flops = 2.0 * b * h * w * 9 * cin * cout
    nbytes = (x.numel() + x.numel() * cout // cin + w9.numel()) * 2
    # the least products each probe's function needs: p1 is x (sum_t W_t), one;
    # p2 is sum_dy shift_dy(x) (sum_i W[3 dy + i]), three; p6 and p7, the 3x3 conv, nine
    products = {"p1": 1, "p2": 3, "p6": 9, "p7": 9}
    for p in probes:
        bound_ms, bound_by = roofline(flops * products[p] / 9, nbytes)
        probe, reference = getattr(cp, p), getattr(cp, f"{p}_reference")
        out = probe(x, weights[p])
        again = probe(x, weights[p])
        ref = reference(x.float(), weights[p].float())
        peak = ref.abs().max().item()
        err = (out.float() - ref).abs().max().item()
        bound = 1e-2 * max(1.0, peak)
        same = torch.equal(out, again)
        line = (f"probe {p} bf16 x{(b, cin, h, w)} -> {cout}: max|out-ref| {err:.3e} (bound "
                f"{bound:.3g}); two calls equal: {same}")
        if not (err <= bound and same):
            fail(line)
        del out, again, ref
        k_ms, p_ms = timed_pair(lambda: probe(x, weights[p]),
                                lambda: reference(x, weights[p]), 5)
        lib_ms = median_ms(library[p], 10)
        results[p] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "launches": counts[f"conv_probe_{p}"], "main_ms": probe_ms[p]}
        log(line + f"; kernel {k_ms:.3f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), plain "
            f"{p_ms:.3f} ms, library {lib_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    del x, x_nhwc, w9, weights, w_oihw, w_rows
    torch.cuda.empty_cache()


# kernel families of the device-time breakdown: the first family whose
# words a kernel's lower-cased name holds (convs before GEMMs: cuDNN's
# implicit-GEMM convs and the tap-GEMM name both)
KERNEL_FAMILIES = (
    ("flash backward", ("flash_bwd",)),
    ("flash forward", ("flash_fwd",)),
    ("GroupNorm kernels", ("gn_stats", "gn_silu")),
    ("convs", ("conv", "fprop", "dgrad", "wgrad", "tap_gemm", "nchwtonhwc", "nhwctonchw")),
    ("GEMMs", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")),
    ("softmax and layer norm", ("softmax", "layer_norm", "layernorm")),
    ("elementwise and copies", ("elementwise", "copy", "memcpy", "memset", "reduce", "fill",
                                "cat", "index", "unroll", "vectorized", "foreach")),
)


def device_breakdown(run):
    """(run()'s result, a summary): run() once under torch.profiler with CUDA
    activity only (no host-op recording), then device time by kernel family
    and the idle share: 1 - (union of the device intervals) / (the host's
    wall time from the call to the final synchronize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except RuntimeError as exc:  # no CUPTI: the update runs unprofiled
        prof, why = None, exc
    start = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    if prof is None:
        return result, f"torch.profiler did not start ({why}); not measured"
    prof.stop()
    spans, by_family, other, group_norm = [], {}, {}, {}
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            continue
        t0, t1 = e.time_range.start, e.time_range.end  # microseconds
        spans.append((t0, t1))
        lower = e.name.lower()
        family = next((f for f, words in KERNEL_FAMILIES if any(w in lower for w in words)),
                      "other")
        by_family[family] = by_family.get(family, 0.0) + (t1 - t0) / 1e3
        if family == "other":
            other[e.name[:60]] = other.get(e.name[:60], 0.0) + (t1 - t0) / 1e3
        elif family == "GroupNorm kernels":
            short = e.name.replace("(anonymous namespace)::", "").split("(")[0]
            short = short.removeprefix("void ")[:60]
            n, ms = group_norm.get(short, (0, 0.0))
            group_norm[short] = (n + 1, ms + (t1 - t0) / 1e3)
    if not spans:
        return result, f"the profiler saw no device time (wall {wall_ms:.1f} ms); not measured"
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    busy_ms = busy / 1e3
    total = sum(by_family.values())
    parts = ", ".join(f"{f} {ms:.2f} ms ({100 * ms / total:.1f}%)"
                      for f, ms in sorted(by_family.items(), key=lambda kv: -kv[1]))
    top_other = ", ".join(f"{n} {ms:.2f}" for n, ms in
                          sorted(other.items(), key=lambda kv: -kv[1])[:3])
    gn_parts = ", ".join(f"{name} {n} launches {ms:.2f} ms"
                         for name, (n, ms) in sorted(group_norm.items()))
    return result, (f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
                    f"{100 * (1 - busy_ms / wall_ms):.1f}%; {len(spans)} device events; device "
                    f"time by family: {parts}; largest 'other': {top_other or 'none'}; "
                    f"GroupNorm kernels by name: {gn_parts or 'none'}")


def phase_serving(unet_gn, vae_gn, unet_conv=0, vae_conv=0):
    import numpy as np
    import torch

    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import generate
    from ddpo_torch.utils.metrics import read_metrics

    steps, n_images = 50, 4
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    start = time.perf_counter()
    result = generate.main([
        "--dataset", "compressed-animals", "--n_samples", str(n_images),
        "--n_samples_per_device", str(n_images), "--seed", "0",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = _build.launch_counts()
    images = result.images
    log(f"generate: {images.shape[0]} images {images.shape[1:]} in {wall:.1f} s "
        f"(model build included), outdir {result.outdir}")
    if images.shape != (n_images, 512, 512, 3):
        fail(f"images have shape {images.shape}")
    if not (np.isfinite(images).all() and images.min() >= 0.0 and images.max() <= 1.0):
        fail("images are not finite values in [0, 1]")
    sampler_calls = decode_calls = 1  # one batch of n_images
    want = expected(flash_fwd=FLASH_PER_UNET_FORWARD * steps * sampler_calls,
                    gn_stats=unet_gn * steps * sampler_calls + vae_gn * decode_calls,
                    conv3x3=unet_conv * steps * sampler_calls + vae_conv * decode_calls)
    log(f"launches {counts}, expected {want} "
        f"(UNet GroupNorms {unet_gn}, VAE decoder GroupNorms {vae_gn}; direct convs "
        f"{unet_conv} and {vae_conv})")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")
    events = read_metrics(result.outdir)  # the run dir keeps earlier runs' events too
    ips = [e["images_per_sec"] for e in events if e.get("phase") == "generate"][-sampler_calls:]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"images/s (sampling + decode, per batch): {ips}; "
        f"max_memory_allocated {peak:.2f} GiB")
    return counts, ips, peak


def phase_rollout():
    import torch

    from ddpo_torch.models.tokenizer import make_uncond_ids
    from ddpo_torch.sampling import SamplerConfig, sample_trajectories
    from ddpo_torch.sampling.sampler import _guided_eps
    from ddpo_torch.training import make_prompts
    from ddpo_torch.utils.serialization import load_stable_diffusion

    batch, steps = 4, 50
    models = load_stable_diffusion(model_preset="sd14", device="cuda",
                                   dtype=torch.bfloat16, seed=0)
    prompts, _, _ = make_prompts("imagenet_animals", batch)
    with torch.no_grad():
        embeds = models.text_encoder(torch.as_tensor(models.tokenizer(prompts), device="cuda"))
        uncond = models.text_encoder(
            torch.as_tensor(make_uncond_ids(models.tokenizer, batch), device="cuda"))
    config = SamplerConfig(num_inference_steps=steps, guidance_scale=5.0, eta=1.0)
    state = models.scheduler.create_state("cuda")
    generator = torch.Generator(device="cuda").manual_seed(0)
    start = time.perf_counter()
    traj = sample_trajectories(models.unet, models.scheduler, state, embeds, uncond,
                               config, generator=generator)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    if tuple(traj["latents"].shape) != (batch, steps, 4, 64, 64) or \
            tuple(traj["next_latents"].shape) != (batch, steps, 4, 64, 64) or \
            tuple(traj["log_probs"].shape) != (batch, steps):
        fail(f"trajectory shapes {[tuple(v.shape) for v in traj.values()]}")
    if not torch.isfinite(traj["log_probs"]).all():
        fail("non-finite log-probs")
    # score mode at step 0, same batch shape as the sampler's call
    sched = models.scheduler.set_timesteps(state, steps)
    t0 = sched.timesteps[0]
    with torch.no_grad():
        eps = _guided_eps(models.unet, traj["latents"][:, 0], t0,
                          torch.cat([uncond, embeds]), config.guidance_scale)
        _, logp = models.scheduler.step(sched, eps, t0, traj["latents"][:, 0],
                                        prev_sample=traj["next_latents"][:, 0],
                                        eta=config.eta)
    delta = (logp - traj["log_probs"][:, 0]).abs().max().item()
    bound = 1e-5
    log(f"rollout: batch {batch}, {steps} steps in {wall:.1f} s; log_probs finite, "
        f"mean {traj['log_probs'].mean().item():.4f}; step-0 score-mode recompute "
        f"max|dlogp| {delta:.3e} (bound {bound:g})")
    if not delta <= bound:
        fail(f"score-mode recompute differs by {delta}")
    return models, embeds, uncond, traj


def phase_onpolicy(rollout, unet_gn, unet_conv=0):
    """ppo_loss on step 0 of phase 5's rollout, through the trainer's path."""
    import torch

    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines.policy_gradient import make_train_apply
    from ddpo_torch.training.policy_gradient import ppo_loss
    from ddpo_torch.utils.serialization import build_models, init_weights_

    models, embeds, uncond, traj = rollout
    batch, steps = traj["log_probs"].shape
    # fp32 masters from the seed phase 5's bf16 UNet was made from
    masters = build_models("sd14", "cuda")[2]
    init_weights_(masters, torch.Generator(device="cuda").manual_seed(0))
    for (key, pm), ps in zip(masters.named_parameters(), models.unet.parameters()):
        if not torch.equal(pm.to(torch.bfloat16), ps):
            fail(f"the masters' bf16 cast differs from the sampler's UNet at {key}")
    params = dict(masters.requires_grad_(True).named_parameters())
    apply = make_train_apply(masters, torch.bfloat16, remat=True)
    sched = models.scheduler.set_timesteps(models.scheduler.create_state("cuda"), steps)
    data = {
        "latents": traj["latents"][:, 0], "next_latents": traj["next_latents"][:, 0],
        "ts": traj["ts"][:, 0], "log_probs": traj["log_probs"][:, 0],
        "advantages": torch.linspace(-1.0, 1.0, batch, device="cuda"),
        "prompt_embeds": embeds, "uncond_embeds": uncond,
    }
    def update():
        loss, info = ppo_loss(params, apply, data, models.scheduler, sched, True, 5.0, 1.0,
                              2e-4, cfg_concat=True)
        loss.backward()
        return loss, info

    _build.reset_launch_counts()
    (loss, info), breakdown = device_breakdown(update)
    counts = _build.launch_counts()
    # sum of squares = 2 * B * approx_kl bounds the largest |dlogp|
    max_dlogp = (2.0 * batch * info["approx_kl"].item()) ** 0.5
    clipfrac = info["clipfrac"].item()
    grads = [p.grad for p in params.values() if p.grad is not None]
    finite = bool(torch.stack([g.isfinite().all() for g in grads]).all())
    bound = 1e-5
    log(f"on-policy (trainer's path at the rollout's batch {batch}, 2B = {2 * batch}): "
        f"max|logp_new - logp_old| <= sqrt(2 B approx_kl) = {max_dlogp:.3e} (bound {bound:g}), "
        f"clipfrac {clipfrac}; loss {loss.item():.4e}; {len(grads)} of {len(params)} masters "
        f"got a gradient, all finite: {finite}")
    if not (max_dlogp <= bound and clipfrac == 0.0 and finite and grads):
        fail("the trainer's recompute is off-policy or its gradient is not finite")
    # one forward, its remat recompute and one backward (whose convs are
    # the library's)
    want = expected(flash_fwd=2 * FLASH_PER_UNET_FORWARD, flash_bwd_dq=FLASH_PER_UNET_FORWARD,
                    flash_bwd_dkv=FLASH_PER_UNET_FORWARD, gn_stats=2 * unet_gn,
                    conv3x3=2 * unet_conv)
    log(f"on-policy launches {counts}, expected {want}")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")
    log(f"on-policy update at 2B = {2 * batch} under torch.profiler: {breakdown}")
    return {k: p.detach().cpu() for k, p in params.items()}, counts


def phase_train(init_params, unet_gn, vae_gn):
    """One DDPO epoch at the compressed-animals defaults, then a resume."""
    import numpy as np
    import torch

    from ddpo_torch import training
    from ddpo_torch.native import build as native_build
    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import policy_gradient
    from ddpo_torch.utils import checkpoints
    from ddpo_torch.utils.metrics import read_metrics

    argv = ["--dataset", "compressed-animals", "--num_train_epochs", "1", "--seed", "0"]
    args = policy_gradient.Parser().parse_args("pg", list(argv))
    if args.filter_field != "jpeg":
        fail(f"compressed-animals trains on {args.filter_field!r}, not the JPEG reward")
    # the native library first, so that the reward's time below is encoding only
    start = time.perf_counter()
    native_build.build()
    log(f"JPEG reward's library: built or loaded in {time.perf_counter() - start:.2f} s, "
        f"libjpeg linked: {native_build.linked}")
    # the reward as policy_gradient.main builds it, timed on its batches (its thread pool
    # overlaps it with sampling, so the epoch's phase times do not show it)
    reward_calls = []
    factory = training.callback_fns["jpeg"]

    def timed_factory(**kwargs):
        fn = factory(**kwargs)

        def timed(images, prompts, metadata):
            start = time.perf_counter()
            result = fn(images, prompts, metadata)
            reward_calls.append((len(images), time.perf_counter() - start))
            return result

        return timed

    n_sample = args.num_sample_batches_per_epoch
    steps = args.n_inference_steps
    n_updates = (args.sample_batch_size * n_sample // args.train_batch_size) * int(
        steps * args.train_timestep_ratio)
    want = expected(
        # sampler: one 2B UNet call per step; trainer: forward + remat
        # recompute + backward per (minibatch, timestep)
        flash_fwd=FLASH_PER_UNET_FORWARD * (steps * n_sample + 2 * n_updates),
        flash_bwd_dq=FLASH_PER_UNET_FORWARD * n_updates,
        flash_bwd_dkv=FLASH_PER_UNET_FORWARD * n_updates,
        gn_stats=unet_gn * (steps * n_sample + 2 * n_updates) + vae_gn * n_sample,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    training.callback_fns["jpeg"] = timed_factory
    try:
        start = time.perf_counter()
        rewards = policy_gradient.main(list(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    finally:
        training.callback_fns["jpeg"] = factory
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not reward_calls:
        fail("the epoch never called the JPEG reward")
    log(f"JPEG reward: libjpeg linked {native_build.linked}; "
        + ", ".join(f"{n} images in {sec:.4f} s" for n, sec in reward_calls))

    localpath = "logs/" + args.savepath
    events = read_metrics(localpath)
    sample_ev = next(e for e in events if e.get("phase") == "sample")
    train_ev = next(e for e in events if e.get("phase") == "train")
    infos = np.load(os.path.join(localpath, "train_info", "0_0_0.npy"), allow_pickle=True).item()
    saved = dict(checkpoints.last_save)
    log(f"ddpo epoch (JPEG reward): {wall:.1f} s in all (model build "
        f"included); rollout + decode {sample_ev['sample_time_s']:.2f} s for "
        f"{args.sample_batch_size * n_sample} samples; training {train_ev['train_time_s']:.2f} s "
        f"for {n_updates} (minibatch, timestep) updates = "
        f"{train_ev['train_time_s'] / n_updates:.4f} s each; max_memory_allocated {peak:.2f} GiB")
    log(f"ddpo epoch: rewards {rewards}; loss {train_ev['loss']:.4e}, approx_kl "
        f"{train_ev['approx_kl']:.3e}, clipfrac {train_ev['clipfrac']:.3f} (epoch means); first "
        f"minibatch approx_kl {infos['approx_kl'][0]:.3e}, clipfrac {infos['clipfrac'][0]:.3f}")
    log(f"checkpoint: {saved.get('bytes', 0) / 1e9:.3f} GB, host copy {saved.get('copy_s', 0):.2f} s, "
        f"write {saved.get('write_s', 0):.2f} s, at {saved.get('path')}")
    numbers = [*rewards, train_ev["loss"], train_ev["approx_kl"], train_ev["clipfrac"],
               *infos["loss"], *infos["approx_kl"], *infos["clipfrac"]]
    if not (len(rewards) == 1 and np.isfinite(numbers).all()):
        fail("non-finite rewards or train infos")
    log(f"ddpo launches {counts}, expected {want} ({n_updates} updates)")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")

    restored, step = checkpoints.restore_train_state(args.savepath)
    if step != 0:
        fail(f"no checkpoint of epoch 0 under {args.savepath}")
    params = restored["state"]["params"]
    changed = sum(not torch.equal(params[k], p) for k, p in init_params.items())
    log(f"checkpoint restored: epoch {restored['epoch']}, optimizer count "
        f"{restored['state']['opt_state']['count']}; {changed} of {len(init_params)} master "
        f"tensors differ from the initial ones")
    if changed == 0 or set(params) != set(init_params):
        fail("the masters did not change, or the checkpoint lacks some")
    del restored, params

    _build.reset_launch_counts()
    resumed = policy_gradient.main(list(argv) + ["--resume", "True"])
    counts = _build.launch_counts()
    log(f"resume: rewards {resumed}, launches {counts}")
    if resumed != rewards or any(counts.values()):
        fail("the resumed run did not restore the epoch, or trained again")
    return want


def phase_conv_path(unet_gn, vae_gn, unet_conv, vae_conv):
    """Phases 4-6 again with every Conv3x3 on the direct kernel."""
    import torch

    from ddpo_torch.ops import _build
    from ddpo_torch.ops.conv import set_conv_kernel_enabled
    from ddpo_torch.utils.serialization import load_stable_diffusion

    try:
        # (a) one UNet forward at 2B = 8, switch on against off
        models = load_stable_diffusion(model_preset="sd14", device="cuda",
                                       dtype=torch.bfloat16, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(11)
        latents = torch.randn((8, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
        context = torch.randn((8, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
        t = torch.full((8,), 500, device="cuda")
        with torch.no_grad():
            set_conv_kernel_enabled(None)
            off = models.unet(latents, t, context).float()
            set_conv_kernel_enabled(True)
            _build.reset_launch_counts()
            on = models.unet(latents, t, context).float()
            launched = _build.launch_counts()["conv3x3"]
            # one UNet step's device time (CUDA events), switch on and off
            step_on = median_ms(lambda: models.unet(latents, t, context), 5)
            set_conv_kernel_enabled(None)
            step_off = median_ms(lambda: models.unet(latents, t, context), 5)
            set_conv_kernel_enabled(True)
        rel = ((on - off).abs().max() / off.abs().max()).item()
        bound = 5e-2
        log(f"conv path (a): UNet forward at 2B = 8, direct kernel against cuDNN: "
            f"max|on-off| / max|off| = {rel:.3e} (bound {bound:g}: bf16 through 49 convs), "
            f"conv3x3 launches {launched} (expected {unet_conv}); one UNet step (bf16, "
            f"2B = 8, 512 px) {step_off:.2f} ms with the switch off, {step_on:.2f} ms on")
        if not (rel <= bound and launched == unet_conv and torch.isfinite(on).all()):
            fail("the UNet with the direct conv kernel differs from the library's")
        del models, latents, context, off, on
        torch.cuda.empty_cache()
        # (b) serving
        counts, ips, peak = phase_serving(unet_gn, vae_gn, unet_conv, vae_conv)
        # (c) rollout and the on-policy update
        rollout = phase_rollout()
        _, update_counts = phase_onpolicy(rollout, unet_gn, unet_conv)
        del rollout
        torch.cuda.empty_cache()
    finally:
        set_conv_kernel_enabled(None)
    return counts, update_counts


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the GPU")
    if not os.path.isdir(os.path.join(REPO, "ddpo_torch", "csrc")):
        fail(f"ddpo_torch/csrc not found beside {__file__}: run from the repository")
    sys.path.insert(0, REPO)
    bucket = tempfile.mkdtemp(prefix="chip_smoke_")
    os.environ["DDPO_BUCKET"] = bucket

    smi = phase_device()
    phase_build()
    flash_results, bwd_results, gn_results, silu_results, conv_results = [], [], [], [], []
    probe_results = {}
    check_flash(flash_results)
    check_flash_bwd(bwd_results)
    check_gn_stats(gn_results)
    unet_gn, vae_gn, unet_conv, vae_conv = count_modules()
    gn_shapes, conv_shapes = collect_model_shapes()
    silu_launches = check_gn_silu(silu_results, gn_shapes)
    check_conv3x3(conv_results, conv_shapes)
    phase_probes(probe_results)
    phase_serving(unet_gn, vae_gn)
    rollout = phase_rollout()
    init_params, _ = phase_onpolicy(rollout, unet_gn)
    del rollout
    counts = phase_train(init_params, unet_gn, vae_gn)
    conv_counts, _ = phase_conv_path(unet_gn, vae_gn, unet_conv, vae_conv)
    shutil.rmtree(bucket, ignore_errors=True)

    def headline(results, shape):
        return next(r for r in results if r["shape"] == shape and r["dtype"] == "bfloat16")

    def timing(entry, ms="ms", bound=None):
        bound_ms, bound_by = bound or (entry["bound_ms"], entry["bound_by"])
        return {"ms": entry[ms], "plain_ms": entry["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": entry["library_ms"]}

    flash_main = headline(flash_results, [8, 4096, 4096, 8, 40])
    bwd_main = headline(bwd_results, [4, 4096, 4096, 8, 40])
    gn_main = headline(gn_results, [8, 320, 64, 64])
    silu_main = headline(silu_results, [8, 320, 64, 64])
    conv_main = headline(conv_results, [8, 320, 64, 64, 320])
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": "ddpo_torch/csrc/flash_fwd.cu",
         "replaces": "ddpo_tpu/ops/attention.py:58", "launches": counts["flash_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in flash_results), **timing(flash_main)},
        {"name": "flash_bwd_dq", "route": "cuda", "source": "ddpo_torch/csrc/flash_bwd.cu",
         "replaces": "ddpo_tpu/ops/attention.py:177", "launches": counts["flash_bwd_dq"],
         "max_abs_err": max(r["max_abs_err_dq"] for r in bwd_results),
         **timing(bwd_main, "dq_ms", bwd_main["dq_bound"])},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": "ddpo_torch/csrc/flash_bwd.cu",
         "replaces": "ddpo_tpu/ops/attention.py:211", "launches": counts["flash_bwd_dkv"],
         "max_abs_err": max(r["max_abs_err_dkv"] for r in bwd_results),
         **timing(bwd_main, "dkv_ms", bwd_main["dkv_bound"])},
        {"name": "gn_stats", "route": "cuda", "source": "ddpo_torch/csrc/gn_stats.cu",
         "replaces": "ddpo_tpu/ops/groupnorm.py:126", "launches": counts["gn_stats"],
         "max_abs_err": max(r["max_abs_err"] for r in gn_results), **timing(gn_main)},
        {"name": "gn_silu", "route": "cuda", "source": "ddpo_torch/csrc/gn_silu.cu",
         "replaces": "ddpo_tpu/ops/groupnorm.py:232", "launches": silu_launches,
         "max_abs_err": max(r["max_abs_err"] for r in silu_results), **timing(silu_main)},
        {"name": "conv3x3", "route": "cuda", "source": "ddpo_torch/csrc/conv3x3.cu",
         "replaces": "ddpo_tpu/ops/conv.py:58", "launches": conv_counts["conv3x3"],
         "max_abs_err": max(r["max_abs_err"] for r in conv_results), **timing(conv_main)},
    ]
    for probe, line in (("p1", 46), ("p2", 71), ("p6", 164), ("p7", 196)):
        entry = probe_results[probe]
        kernels.append({
            "name": f"conv_probe_{probe}", "route": "cuda", "source": "ddpo_torch/csrc/conv3x3.cu",
            "replaces": f"bench_conv_probe.py:{line}", "launches": entry["launches"],
            "max_abs_err": entry["max_abs_err"], **timing(entry)})
    if any(k["launches"] <= 0 for k in kernels):
        fail(f"a kernel was never launched on its path: {[k['name'] for k in kernels]}")
    log("kernels: launches are the DDPO phase's for the four kernels of the default path, "
        "the op-level path's for gn_silu, the serving phase's with the conv switch on for "
        "conv3x3 and conv_probe.main's for the probes; a backward kernel's plain_ms and "
        "library_ms are the whole backward (dq, dk and dv); times at the headline shapes: "
        "flash (8, 4096, 8, 40) and (4, 4096, 8, 40), GroupNorm (8, 320, 64, 64), conv "
        "(8, 320, 64, 64) -> 320 and the probes' (16, 320, 64, 64) -> 320, bf16")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
