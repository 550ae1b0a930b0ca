#!/usr/bin/env python3
"""Drive the PyTorch port (ddpo_torch) on one NVIDIA GPU, end to end.

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit, torch and CUDA versions; the
     port's device setup (utils/serialization.py resolve_device) must have
     turned TF32 off.
  2. build: nvcc builds ddpo_torch/csrc/*.cu for sm_90a; cuobjdump -sass on
     the library says which kernel functions hold tensor-core (HMMA, and
     for int8 IMMA) instructions: every instantiation of the bf16 flash
     forward, the bf16 flash backward (dq and dk/dv), the tap-GEMM and the
     s8 tap-GEMM must; ptxas's registers and spills of each of those
     instantiations.
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
  6b. batch invariance (ddpo_torch/bench/batch_invariance.py): a batch-8
     rollout (the DDPO sampler's 2B = 16), then each leaf module of the bf16
     UNet called again on the rows of the trainer's first minibatch
     (2B = 4, [uncond; cond]) and its bits compared, by family (nn.Linear by
     M, 3x3, strided and 1x1 convs, LayerNorm, plain and flash attention,
     GroupNorm); once with the ops as they are (naming the families that
     differ) and once inside ops.invariance.batch_invariant(), the DDPO
     driver's setting, where none may differ; the first minibatch's
     recompute at 2B = 4 against the 2B = 16 rollout must give |dlogp| <=
     1e-5 and clipfrac 0; the times of both settings.
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
     train batch 2, bf16 over fp32 masters, adamw; cut to
     --train_timestep_ratio 0.5, 100 updates) with its JPEG reward
     (the native library built against the libjpeg the build finds, which
     is logged, with the reward's seconds for the epoch's images), a
     full-state checkpoint, and a --resume call that trains no further
     epoch; checks the exact launch counts of all five kernels (conv3x3:
     the sampler and trainer run inside batch_invariant()), and that the
     first minibatch, recomputed at the trainer's 2B = 4 against the
     sampler's 2B = 16, has |dlogp| <= 1e-5 and clipfrac 0.
  9. LoRA: ddpo_torch.pipelines.policy_gradient.main with --dataset
     compressed-animals-lora (r 8, lr 1e-3, adamw), one epoch as in 7:
     1,594,368 trainable parameters in 256 adapter tensors, an adapter-only
     checkpoint (its bytes printed), the seconds per update beside phase
     7's and the peak memory, the launch counts; the on-policy recompute
     through the LoRA trainer's apply with the epoch's adapters at a
     rollout's own batch (|dlogp| <= 1e-5, clipfrac 0, phase 6's launches);
     the exported unet_0.pkl loaded at bf16 equal to the merge bit for bit;
     generate --iteration 1 on it, with the serving launch counts.
  8. the conv path, with ops.conv.set_conv_kernel_enabled(True) (reset
     after): (a) one UNet forward at 2B = 8 with the switch on against off,
     and the median time of a UNet step each way;
     (b) phase 4 again: conv3x3 launches 49 per UNet forward x 50 + 31 in
     the VAE decode; (c) phases 5 and 6 again: the rollout, and the
     on-policy update, which launches conv3x3 twice per module (forward and
     remat recompute; the backward is the library conv's); (d) phase 6b
     with the switch on.
  10. RWR: one iteration of --dataset compressed-animals-rwr. It prints
     whether h5py imports; without it (the card's machine) the HDF5 write,
     save_sizes and the HDF5 reader cannot run, and the same collection and
     finetune functions the drivers call run over an in-memory writer.
     (a) the vae reward (the VAE encoder) at fp32 on 8 decoded 512 px
     images, on the kernels against plain ops (``plain_ops``), with the conv
     switch off and on: 22 gn_stats and 20 conv3x3 launches (conv_in and
     conv_out stay cuDNN), ms an encode; (b) the collection of 8 samples
     (batch 4, 50 steps, CFG 5, bf16): seconds by stage and images/s a
     batch, launch counts; (c) the fp32 finetune at the preset's settings
     (train_cfg, batch 1, weighted_dataset at temperature 1/5, remat), cut
     to 8 steps with save_freq 1: s a step, peak memory, the export's bytes
     and seconds, launch counts, then one step from the same params and
     draws on the kernels against plain ops (loss, gradients, params after
     a fresh adamw step, each within its stated bound); (d) two steps at
     --dtype bfloat16 (cfg_concat; fp32 compute as JAX's, so no flash
     backward launch); (e) sample --iteration 1 loads the export bit for
     bit at bf16 and collects one batch.
  11. checkpoints and the CLIP rewards: (a) phase 4's stack (seed 0, bf16)
     written by save_stable_diffusion_export (the diffusers-Flax msgpack
     layout) and loaded back by load_stable_diffusion(pretrained_model=
     <dir>), every tensor bit for bit; bytes, write seconds, the reader's
     and the whole load's seconds and GB/s; (b) the same weights at fp16 in
     the torch-safetensors layout (written by ``write_safetensors``, the
     card's machine has no safetensors), the VAE attention under the newer
     to_q/to_k/to_v/to_out.0 names and a position_ids buffer, loaded as the
     fp16 cast (max|d| 0); (c) generate --pretrained_model <(a)'s dir>: the
     images of phase 4 bit for bit (else within two in-memory calls'
     spread) and phase 4's launches; (d) a random ViT-L/14 (seed 0) written
     as a CLIP directory and a random aesthetic MLP as
     <cache>/sac+logos+ava1-l14-linearMSE.pth, loaded by
     load_clip_checkpoint and load_weights; the ViT-L/14 tower's ms for a
     batch of 4 at fp32; the aesthetic, rotational, thumbnail and (random
     ViT-B/32 and B/32 text, hash tokenizer) consistency rewards at fp32
     on (c)'s images, ms a batch on the card, each within 1e-4 of the same
     function with device="cpu" (max|d| over the batch's largest |score|).
  12. the serving extras at SD-1.4 width: (a) the s8 tap-GEMM
     (csrc/conv3x3_s8.cu) against its plain version on the same int8 codes
     at four of the quantized UNet's conv shapes (2B = 8), bf16 and fp32
     out with a bias, and a ragged case: max |d| must be 0, two calls and
     image 0 alone give the same bits; kernel, plain, cuDNN's bf16 conv and
     im2col + torch._int_mm (a yardstick, checked against the exact sums)
     times, the quantize pass over x and the bound (operations over the
     1979 TOPS int8 peak against bytes); (b) generate at 512 px, batch 4,
     seed 0: DDIM-50 and DPM++-20, each bf16 and --quant int8 in turns
     (bf16, int8, int8, bf16), images/s and the launches (47 conv3x3_s8 a
     UNet forward), then the final latents' relative L2 distances of int8
     from bf16 and of DPM++-20 and eta-0 DDIM-20 from eta-0 DDIM-50
     (random weights: printed, not bounded); (c) one collection batch of
     compressed-animals-rwr with --scheduler dpm++ --quant int8
     --n_inference_steps 20: seconds by stage, images/s beside 10b's, the
     launches; (d) calibrate with two scales, one batch of 4, 20 DDIM steps,
     then generate --guidance_scale auto on its savepath must print and use
     the argmax; whether matplotlib imports and which renderer drew
     calibration.png.
  13. two ranks of DDPO on the one card: two ``python -m
     ddpo_torch.pipelines.policy_gradient`` processes (RANK 0 and 1,
     WORLD_SIZE 2, LOCAL_RANK 0, so both on cuda:0 and their gradients over
     gloo), --dataset compressed-animals at SD-1.4 width, sample batch 2 and
     train batch 1 a rank, 50 steps, CFG 5.0, cut only in
     --train_timestep_ratio 0.2, to a gs:// savepath on a DDPO_TPU_FAKE_GCS
     stand-in: (a) one epoch with the fp32 all-reduce; (b) --resume from a
     fresh local directory with --grad_reduce_dtype bfloat16, which fetches
     the checkpoint from the stand-in and trains epoch 1. Each fails unless
     both ranks exit 0, print the same rewards and parameter digests, drew
     different noise, chose gloo, launched phase 7's kernels per rank at
     this shape and recomputed the first minibatch on-policy (|dlogp| <=
     1e-5, clipfrac 0); the bucket must hold reward_curve.json, the checkpoint and
     both host pickles, and (b) must start at epoch 1. Printed: each
     all-reduce's bytes and seconds, the seconds per update, the epoch
     walls, each rank's peak memory and launches. Each rank's whole output
     goes to chiprun_out/phase13/.
  14. the sp mesh axis, two ranks of one sp group on the one card (gloo):
     (k) the kernels at the sp path's new shapes against their plain
     versions: flash forward and backward at local Sq != Sk (2, 2048 x 4096,
     8, 40) and (2, 512 x 1024, 8, 80) in bf16; conv3x3 and the s8 tap-GEMM
     on a halo'd (4, 320, 34, 64) frame, the SAME map's first and last rows
     dropped, against the plain VALID-over-H conv (and conv3x3 bit for bit
     against the unsharded map's rows, the s8 kernel against
     conv3x3_w8a8(padding=VALID_ROWS)); (a) one DDPO epoch of
     ``policy_gradient --mesh_sp 2`` (the spatial mode) as phase 13's but
     cut to --train_timestep_ratio 0.1 (10 updates), inside
     batch_invariant(): both ranks print the same rewards, parameter digests
     and initial noise, the first minibatch recomputes on-policy (|dlogp| <=
     1e-5, clipfrac 0), each rank launches phase 7's kernels with flash_fwd
     at 10 a sharded UNet forward, and makes exactly 49 halo, 3 top-halo, 61
     all-reduce and 16 K/V-gather collectives a forward and one output
     gather an apply (outside remat), and their transposes a backward (but
     the output gather's, a slice, and conv_in's halo: the latents need no
     gradient); printed: those per forward with
     their bytes and seconds, the ms of a sampler UNet step, s an update,
     the gradient all-reduce's bytes and seconds, peak memory per rank;
     (b, c) ``ddpo_torch.bench.sp_check`` on two ranks: the sharded UNet's
     eps at the rollout's 2B = 4 and one update's gradients, spatial (b) and
     attention (c) modes, against the unsharded ones within 2^-6 of their
     max, with 10 flash_fwd launches a forward. Each rank's output goes to
     chiprun_out/phase14/.

The line before the last is one JSON object describing the kernels; the
last line is {"ok": true, "device": {...}}. With no CUDA device, or run
outside the repository, it fails before printing any result.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import glob
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
# bf16 and int8 tensor cores, fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}

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
    # numbers are compared below: the port's device setup keeps fp32
    # matmuls and convolutions off TF32
    from ddpo_torch.utils.serialization import resolve_device

    resolve_device("cuda")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("the port's device setup left TF32 on")
    log("TF32 off for matmul and cuDNN (resolve_device)")
    return smi


# kernel functions that must run their products on the tensor cores
TENSOR_CORE_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                       "flash_bwd_dkv_mma_kernel", "tap_gemm_mma_kernel", "tap_gemm_s8_kernel")


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
    """{kernel function: [HMMA or IMMA count of each instantiation]} from
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
        elif name is not None and re.search(r"\b[HI]MMA\b", line):
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
            f"or IMMA ({min(per)}..{max(per)} such instructions each)")
    for name in TENSOR_CORE_KERNELS:
        if name not in hmma or not all(hmma[name]):
            fail(f"{name}: every instantiation must hold tensor-core instructions, got "
                 f"{hmma.get(name)}")
    for name, rows in sorted(ptxas_instantiations(kl.log, TENSOR_CORE_KERNELS).items()):
        log(f"ptxas {name} <template args>: registers, spill store/load bytes: " + "; ".join(
            f"<{','.join(map(str, args))}> {regs}, {st}/{ld}" for args, regs, st, ld in rows))
    return kl


# (B, Sq, Sk, H, D): the UNet's three self-attention levels at 512 px
# with the 2B = 8 CFG batch, then ragged lengths the kernel masks itself
FLASH_CASES = [(8, 4096, 4096, 8, 40), (8, 1024, 1024, 8, 80), (8, 256, 256, 8, 160),
               (2, 1000, 1000, 8, 40), (2, 300, 700, 8, 80)]
# the trainer's 2B = 4 at the same levels, ragged lengths, and D = 256, the
# widest the gate admits
FLASH_BWD_CASES = [(4, 4096, 4096, 8, 40), (4, 1024, 1024, 8, 80), (4, 256, 256, 8, 160),
                   (2, 1000, 1000, 8, 40), (2, 300, 700, 8, 80), (2, 300, 300, 2, 256)]


def check_flash(results, cases=FLASH_CASES, dtypes=None, tag=""):
    import torch
    import torch.nn.functional as F

    from ddpo_torch.ops.attention import (
        attention_lse_reference,
        attention_reference,
        flash_attention_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    bounds = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-4)}
    for dtype in dtypes or (torch.bfloat16, torch.float32):
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
            line = (f"{tag}flash {name} B{b} Sq{sq} Sk{sk} H{h} D{d}: max|out-ref| "
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


def check_flash_bwd(results, cases=FLASH_BWD_CASES, dtypes=None, tag=""):
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
    for dtype in dtypes or (torch.bfloat16, torch.float32):
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
            line = (f"{tag}flash_bwd {name} B{b} Sq{sq} Sk{sk} H{h} D{d}: max|dq,dk,dv - ref| "
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
    result = generate.main(list(SERVING_ARGV))
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
    return counts, ips, peak, images


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


def phase_batch_invariance(models, conv_kernel=False):
    """6b (and 8d with the conv switch on): which module families give an
    image other bits at the trainer's 2B = 4 than at the sampler's 2B = 16,
    with the ops as they are ("library") and inside batch_invariant()
    ("port"), then the first minibatch's recompute at 2B = 4 against a
    2B = 16 rollout under the port's setting, and what the setting costs."""
    from ddpo_torch.bench import batch_invariance as bi
    from ddpo_torch.ops.conv import set_conv_kernel_enabled

    tag = "8d (conv switch on)" if conv_kernel else "6b"
    results = {}
    set_conv_kernel_enabled(True if conv_kernel else None)
    try:
        for setting in ("port", "library"):
            results[setting] = bi.run(models, setting)
    finally:
        set_conv_kernel_enabled(None)
    for setting, result in results.items():
        differ = {k: v for k, v in result["table"].items() if v["differ"]}
        log(f"{tag} {setting}: module families whose bits differ at 2B = 4 against 2B = 16: "
            + (", ".join(f"{k} ({v['differ']} of {v['modules']}, max|d| {v['max_abs']:.3e})"
                         for k, v in differ.items()) or "none")
            + f"; first minibatch at 2B = 4: approx_kl {result['approx_kl']:.3e}, clipfrac "
            f"{result['clipfrac']:.3f}, max|dlogp| {result['max_dlogp']:.3e}; rollout of 8 "
            f"{result['rollout_s']:.2f} s, UNet forward at 2B = 16 "
            f"{result['unet_fwd_ms_2B16']:.2f} ms, forward + backward at 2B = 4 "
            f"{result['unet_fwd_bwd_ms_2B4']:.2f} ms")
    log(f"{tag} module table ('port'):\n{bi.format_table(results['port']['table'])}")
    port = results["port"]
    if any(v["differ"] for v in port["table"].values()):
        fail(f"{tag}: an image's bits still depend on the batch under the port's setting")
    if not (port["max_dlogp"] <= 1e-5 and port["clipfrac"] == 0.0):
        fail(f"{tag}: the first minibatch's recompute is off-policy at the trainer's shapes")
    return results


def phase_train(init_params, unet_gn, vae_gn, unet_conv):
    """One DDPO epoch at the compressed-animals defaults, then a resume."""
    import numpy as np
    import torch

    from ddpo_torch import training
    from ddpo_torch.native import build as native_build
    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import policy_gradient
    from ddpo_torch.utils import checkpoints
    from ddpo_torch.utils.metrics import read_metrics

    # depth cut to keep the script inside its time limit with phase 13:
    # half the trained timesteps
    argv = ["--dataset", "compressed-animals", "--num_train_epochs", "1", "--seed", "0",
            "--train_timestep_ratio", "0.5"]
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
        # recompute + backward per (minibatch, timestep); both inside
        # batch_invariant(), where the UNet's 3x3 convs take the tap-GEMM
        # (forward and remat; the backward is the library conv's)
        flash_fwd=FLASH_PER_UNET_FORWARD * (steps * n_sample + 2 * n_updates),
        flash_bwd_dq=FLASH_PER_UNET_FORWARD * n_updates,
        flash_bwd_dkv=FLASH_PER_UNET_FORWARD * n_updates,
        gn_stats=unet_gn * (steps * n_sample + 2 * n_updates) + vae_gn * n_sample,
        conv3x3=unet_conv * (steps * n_sample + 2 * n_updates),
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
    # the first minibatch is on-policy: sum of dlogp^2 over its B samples and
    # T timesteps = 2 B T approx_kl (the mean over T) bounds the largest |dlogp|
    first_dlogp = (2.0 * args.train_batch_size * int(steps * args.train_timestep_ratio)
                   * infos["approx_kl"][0]) ** 0.5
    log(f"ddpo epoch: rewards {rewards}; loss {train_ev['loss']:.4e}, approx_kl "
        f"{train_ev['approx_kl']:.3e}, clipfrac {train_ev['clipfrac']:.3f} (epoch means); first "
        f"minibatch (2B = {2 * args.train_batch_size} against the sampler's "
        f"2B = {2 * args.sample_batch_size}) approx_kl {infos['approx_kl'][0]:.3e}, clipfrac "
        f"{infos['clipfrac'][0]:.3f}, max|dlogp| <= {first_dlogp:.3e} (bound 1e-5)")
    if not (first_dlogp <= 1e-5 and infos["clipfrac"][0] == 0.0):
        fail("the first minibatch's recompute at the trainer's shapes is off-policy")
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
    return want, train_ev["train_time_s"] / n_updates


def phase_lora(unet_gn, vae_gn, unet_conv, full_update_s):
    """9: one LoRA epoch of --dataset compressed-animals-lora at SD-1.4 width,
    the on-policy recompute through the LoRA trainer's apply, then generate
    --iteration 1 on the merged UNet the run exported."""
    import numpy as np
    import torch

    from ddpo_torch.models.lora import merge_lora, n_lora_params, target_paths
    from ddpo_torch.models.tokenizer import make_uncond_ids
    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import generate, policy_gradient
    from ddpo_torch.sampling import SamplerConfig, sample_trajectories
    from ddpo_torch.training import make_prompts
    from ddpo_torch.training.policy_gradient import ppo_loss
    from ddpo_torch.utils import checkpoints
    from ddpo_torch.utils.metrics import read_metrics
    from ddpo_torch.utils.serialization import load_stable_diffusion, load_unet

    argv = ["--dataset", "compressed-animals-lora", "--num_train_epochs", "1", "--seed", "0",
            "--train_timestep_ratio", "0.5"]  # the depth cut of phase 7
    args = policy_gradient.Parser().parse_args("pg", list(argv))
    if (args.lora_rank, args.learning_rate, args.optimizer) != (8, 1e-3, "adamw"):
        fail(f"compressed-animals-lora resolves to r {args.lora_rank}, lr "
             f"{args.learning_rate}, {args.optimizer}")
    steps, n_sample = args.n_inference_steps, args.num_sample_batches_per_epoch
    n_updates = (args.sample_batch_size * n_sample // args.train_batch_size) * int(
        steps * args.train_timestep_ratio)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    start = time.perf_counter()
    policy_gradient.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = expected(
        flash_fwd=FLASH_PER_UNET_FORWARD * (steps * n_sample + 2 * n_updates),
        flash_bwd_dq=FLASH_PER_UNET_FORWARD * n_updates,
        flash_bwd_dkv=FLASH_PER_UNET_FORWARD * n_updates,
        gn_stats=unet_gn * (steps * n_sample + 2 * n_updates) + vae_gn * n_sample,
        conv3x3=unet_conv * (steps * n_sample + 2 * n_updates),
    )
    localpath = os.path.abspath("logs/" + args.savepath)
    train_ev = next(e for e in read_metrics(localpath) if e.get("phase") == "train")
    infos = np.load(os.path.join(localpath, "train_info", "0_0_0.npy"), allow_pickle=True).item()
    saved = dict(checkpoints.last_save)
    restored, _ = checkpoints.restore_train_state(args.savepath)
    adapters = {k: v.cuda() for k, v in restored["state"]["params"].items()}
    n_trainable = n_lora_params(adapters)
    first_dlogp = (2.0 * args.train_batch_size * int(steps * args.train_timestep_ratio)
                   * infos["approx_kl"][0]) ** 0.5
    log(f"lora epoch (r {args.lora_rank}, lr {args.learning_rate:g}, {args.optimizer}, "
        f"{int(steps * args.train_timestep_ratio)} of {steps} timesteps trained): {wall:.1f} s in all (model build included); {n_trainable} "
        f"trainable in {len(adapters)} tensors (expected 1594368 in 256); training "
        f"{train_ev['train_time_s']:.2f} s for {n_updates} updates = "
        f"{train_ev['train_time_s'] / n_updates:.4f} s each (full finetune, phase 7: "
        f"{full_update_s:.4f}); max_memory_allocated {peak:.2f} GiB; checkpoint "
        f"{saved.get('bytes', 0)} bytes ({saved.get('bytes', 0) / 1e6:.2f} MB), host copy "
        f"{saved.get('copy_s', 0):.3f} s, write {saved.get('write_s', 0):.3f} s; first minibatch "
        f"approx_kl {infos['approx_kl'][0]:.3e}, clipfrac {infos['clipfrac'][0]:.3f}, "
        f"max|dlogp| <= {first_dlogp:.3e}")
    log(f"lora launches {counts}, expected {want}")
    if n_trainable != 1594368 or len(adapters) != 256:
        fail("the LoRA run does not train 1,594,368 parameters in 256 adapter tensors")
    if any(not k.endswith((".a", ".b")) for k in adapters):
        fail("the LoRA checkpoint holds more than the adapters")
    if not (first_dlogp <= 1e-5 and infos["clipfrac"][0] == 0.0):
        fail("the LoRA run's first minibatch is off-policy")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")
    del restored

    # the on-policy recompute through the LoRA trainer's apply, at the
    # rollout's own shape, with the trained adapters
    models = load_stable_diffusion(model_preset="sd14", device="cuda", dtype=torch.bfloat16,
                                   seed=0)
    base = dict(models.unet.named_parameters())
    own = [path + ".weight" for path in target_paths(base)]
    sampler = policy_gradient.sampler_unet(models.unet, torch.bfloat16, own)
    with torch.no_grad():
        merged = merge_lora(base, adapters)
        policy_gradient.refresh_sampler(sampler, merged)
    batch = 4
    prompts, _, _ = make_prompts("imagenet_animals", batch)
    with torch.no_grad():
        embeds = models.text_encoder(torch.as_tensor(models.tokenizer(prompts), device="cuda"))
        uncond = models.text_encoder(
            torch.as_tensor(make_uncond_ids(models.tokenizer, batch), device="cuda"))
    config = SamplerConfig(num_inference_steps=steps, guidance_scale=5.0, eta=1.0)
    sched = models.scheduler.set_timesteps(models.scheduler.create_state("cuda"), steps)
    traj = sample_trajectories(sampler, models.scheduler, models.scheduler.create_state("cuda"),
                               embeds, uncond, config,
                               generator=torch.Generator(device="cuda").manual_seed(0))
    params = {k: v.clone().requires_grad_(True) for k, v in adapters.items()}
    apply = policy_gradient.make_train_apply(models.unet, torch.bfloat16, remat=True, base=base)
    data = {
        "latents": traj["latents"][:, 0], "next_latents": traj["next_latents"][:, 0],
        "ts": traj["ts"][:, 0], "log_probs": traj["log_probs"][:, 0],
        "advantages": torch.linspace(-1.0, 1.0, batch, device="cuda"),
        "prompt_embeds": embeds, "uncond_embeds": uncond,
    }
    _build.reset_launch_counts()
    loss, info = ppo_loss(params, apply, data, models.scheduler, sched, True, 5.0, 1.0, 2e-4,
                          cfg_concat=True)
    loss.backward()
    counts = _build.launch_counts()
    max_dlogp = (2.0 * batch * info["approx_kl"].item()) ** 0.5
    finite = all(p.grad is not None and bool(p.grad.isfinite().all()) for p in params.values())
    want = expected(flash_fwd=2 * FLASH_PER_UNET_FORWARD, flash_bwd_dq=FLASH_PER_UNET_FORWARD,
                    flash_bwd_dkv=FLASH_PER_UNET_FORWARD, gn_stats=2 * unet_gn)
    log(f"lora on-policy (the LoRA trainer's apply at the rollout's batch {batch}, 2B = "
        f"{2 * batch}, merged adapters of the epoch): max|dlogp| <= {max_dlogp:.3e} (bound "
        f"1e-5), clipfrac {info['clipfrac'].item()}; every adapter got a finite gradient: "
        f"{finite}; launches {counts}, expected {want} (phase 6's)")
    if not (max_dlogp <= 1e-5 and info["clipfrac"].item() == 0.0 and finite):
        fail("the LoRA trainer's recompute is off-policy or its gradient is not finite")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")
    del traj, params, loss, sampler
    torch.cuda.empty_cache()

    # serve the export
    export = os.path.join(localpath, f"unet_{args.num_train_epochs - 1}.pkl")
    log(f"lora export: {export}, {os.path.getsize(export)} bytes")
    loaded = load_unet(localpath, epoch=0, device="cuda", dtype=torch.bfloat16, seed=0)
    loaded_params = dict(loaded.unet.named_parameters())
    same = sum(torch.equal(loaded_params[k], merged[k]) for k in own)
    rest = sum(torch.equal(loaded_params[k], base[k]) for k in base if k not in own)
    changed = sum(not torch.equal(merged[k], base[k]) for k in own)
    log(f"lora export loaded at bf16: {same} of {len(own)} targeted weights equal the merge "
        f"bitwise ({changed} differ from the base), {rest} of {len(base) - len(own)} others "
        f"equal the base")
    if same != len(own) or rest != len(base) - len(own) or changed == 0:
        fail("the exported UNet does not load as the merged one")
    del models, loaded, base, merged, adapters
    torch.cuda.empty_cache()
    n_images = 4
    _build.reset_launch_counts()
    result = generate.main([
        "--dataset", "compressed-animals", "--n_samples", str(n_images),
        "--n_samples_per_device", str(n_images), "--seed", "0", "--iteration", "1",
        "--loadpath", localpath, "--load_epoch", "0",
    ])
    counts = _build.launch_counts()
    want = expected(flash_fwd=FLASH_PER_UNET_FORWARD * steps, gn_stats=unet_gn * steps + vae_gn)
    ips = [e["images_per_sec"] for e in read_metrics(result.outdir)
           if e.get("phase") == "generate"][-1:]
    images = result.images
    log(f"generate --iteration 1: {images.shape} images, images/s {ips}; launches {counts}, "
        f"expected {want}")
    if images.shape != (n_images, 512, 512, 3) or not np.isfinite(images).all():
        fail("generate on the export made no finite 512 px images")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")
    shutil.rmtree(localpath, ignore_errors=True)  # the 3.4 GB export


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
        counts, ips, peak, _ = phase_serving(unet_gn, vae_gn, unet_conv, vae_conv)
        # (c) rollout and the on-policy update
        rollout = phase_rollout()
        _, update_counts = phase_onpolicy(rollout, unet_gn, unet_conv)
        # (d) 6b with the switch on
        phase_batch_invariance(rollout[0], conv_kernel=True)
        del rollout
        torch.cuda.empty_cache()
    finally:
        set_conv_kernel_enabled(None)
    return counts, update_counts


@contextlib.contextmanager
def plain_ops():
    """Route the ops that have kernels to their plain versions, on the card
    too: the flash forward to attention_reference (fp32 softmax), the
    GroupNorm sums to group_stats_reference, the direct conv to the 9-tap
    conv3x3_reference. The kernel-vs-plain checks of phase 10 run a whole
    module or step both ways."""
    import importlib

    # the module, not the package's re-exported attention() function
    attn_ops = importlib.import_module("ddpo_torch.ops.attention")
    from ddpo_torch.ops import conv as conv_ops
    from ddpo_torch.ops import groupnorm as gn_ops

    saved = (attn_ops.flash_attention_fwd, gn_ops.group_stats, conv_ops.conv3x3_direct)
    attn_ops.flash_attention_fwd = lambda q, k, v, scale=None: (
        attn_ops.attention_reference(q, k, v, scale), attn_ops.attention_lse_reference(q, k, scale))
    gn_ops.group_stats = lambda x, g: gn_ops.group_stats_reference(x, g)
    conv_ops.conv3x3_direct = conv_ops.conv3x3_reference
    try:
        yield
    finally:
        attn_ops.flash_attention_fwd, gn_ops.group_stats, conv_ops.conv3x3_direct = saved


class MemoryWriter:
    """The HDF5 writer's interface over lists in memory, for a machine
    without h5py: each field's values encoded with its codec, as
    H5Writer.add stores them, and read back through MemoryReader."""

    def __init__(self):
        self.fields, self.encode_fns, self.decode_fns = {}, {}, {}

    def configure(self, field, encode_fn=None, decode_fn=None, vlen=False):
        self.fields[field] = []
        self.encode_fns[field], self.decode_fns[field] = encode_fn, decode_fn

    def add_batch(self, batch, mask=None):
        import numpy as np

        indices = range(len(next(iter(batch.values())))) if mask is None else np.where(mask)[0]
        for i in indices:
            for key, values in batch.items():
                x = values[i]
                if self.encode_fns[key] is not None:
                    x = self.encode_fns[key](x)
                self.fields[key].append(x.encode() if isinstance(x, str) else x)
        return len(indices)

    def close(self):
        pass

    def reader(self):
        from ddpo_torch.data.hdf5 import _MultiFileReader

        writer = self

        class MemoryReader(_MultiFileReader):
            def __init__(self):
                self.weighted = False
                self.fields = list(writer.fields)
                self.decode_fns, self.encode_fns = writer.decode_fns, writer.encode_fns
                self._build_index([len(next(iter(writer.fields.values())))])

            def _get_file(self, fid):
                return writer.fields

        return MemoryReader()


def rwr_launches(unet_gn, vae_gn, enc_gn, batches, steps):
    """Kernel launches of ``batches`` collection batches: the sampler's
    UNet each step, one decode and one VAE encode (the vae reward)."""
    return expected(flash_fwd=FLASH_PER_UNET_FORWARD * steps * batches,
                    gn_stats=(unet_gn * steps + vae_gn + enc_gn) * batches)


def phase_rwr_encoder(enc_gn, enc_conv):
    """10a: the vae reward on 8 decoded 512 px images at fp32, kernels
    against plain ops; gn_stats and (switch on) conv3x3 launches."""
    import numpy as np
    import torch

    from ddpo_torch.models import AutoencoderKL
    from ddpo_torch.ops import _build
    from ddpo_torch.ops.conv import set_conv_kernel_enabled
    from ddpo_torch.sampling import vae_decode
    from ddpo_torch.training import callback_fns
    from ddpo_torch.utils.serialization import init_weights_

    with torch.device("meta"):
        vae = AutoencoderKL()
    vae = vae.to_empty(device="cuda").eval().requires_grad_(False)
    init_weights_(vae, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(5)
    latents = torch.randn((8, 4, 64, 64), generator=gen, device="cuda")
    images = vae_decode(vae, latents).cpu().numpy()
    reward = callback_fns["vae"](vae=vae)
    bound = 1e-4
    try:
        for switch in (None, True):
            set_conv_kernel_enabled(switch)
            _build.reset_launch_counts()
            start = time.perf_counter()
            moments, _ = reward(images, [], [])
            reward_s = time.perf_counter() - start
            counts = _build.launch_counts()
            want = expected(gn_stats=enc_gn, conv3x3=enc_conv if switch else 0)
            with plain_ops():
                plain, _ = reward(images, [], [])
            x = torch.as_tensor(images, device="cuda").permute(0, 3, 1, 2) * 2 - 1
            with torch.no_grad():
                k_ms = median_ms(lambda: vae.encode(x), 3)
                with plain_ops():
                    p_ms = median_ms(lambda: vae.encode(x), 3)
            rel = float(np.abs(moments - plain).max() / np.abs(plain).max())
            tag = "on" if switch else "off"
            log(f"10a encoder (vae reward, 8 images 512 px, fp32, conv switch {tag}): moments "
                f"{moments.shape}; max|kernels - plain| / max|plain| = {rel:.3e} (bound {bound:g}: "
                f"fp32 sums in another order through the encoder); launches {counts}, expected "
                f"{want}; encode {k_ms:.2f} ms a call on the kernels, {p_ms:.2f} ms plain; the "
                f"reward (host copies included) {reward_s:.3f} s")
            if moments.shape != (8, 64, 64, 8) or not np.isfinite(moments).all():
                fail("the vae reward gave no finite (8, 64, 64, 8) moments")
            if not rel <= bound:
                fail(f"the encoder on its kernels differs from the plain ops by {rel:.3e}")
            if counts != want:
                fail(f"kernel launches {counts} != expected {want}")
    finally:
        set_conv_kernel_enabled(None)
    del vae, latents, x
    torch.cuda.empty_cache()


def phase_rwr_collect(unet_gn, vae_gn, enc_gn, has_h5py):
    """10b: the collection driver for compressed-animals-rwr, 8 samples."""
    import torch

    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import sample, save_sizes
    from ddpo_torch.utils.metrics import read_metrics, run_dir

    argv = ["--dataset", "compressed-animals-rwr", "--max_samples", "8", "--seed", "0"]
    args = sample.Parser().parse_args("sample", list(argv))
    if (args.n_samples_per_device, args.n_inference_steps, args.guidance_scale, args.dtype,
            args.filter_field) != (4, 50, 5.0, "bfloat16", "jpeg"):
        fail("compressed-animals-rwr does not resolve to batch 4, 50 steps, CFG 5, bf16, jpeg")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    start = time.perf_counter()
    writer = None
    if has_h5py:
        n = sample.main(list(argv))
        manifest = save_sizes.main(["--dataset", "compressed-animals-rwr"])
        stored = sum(manifest.values())
        how = "sample.main (HDF5 split files) and save_sizes.main: manifest counts"
    else:
        c = sample.build_collector(args)
        writer = MemoryWriter()
        sample.configure_writer(writer, c.callback_fns)
        n = sample.collect(c, writer)
        stored = len(writer.reader())
        how = ("h5py absent: sample.build_collector + sample.collect on an in-memory writer "
               "(the HDF5 write and save_sizes.main did not run); rows stored")
        del c
    wall = time.perf_counter() - start
    counts = _build.launch_counts()
    events = [e for e in read_metrics(run_dir(args.savepath)) if e.get("phase") == "sample"]
    want = rwr_launches(unet_gn, vae_gn, enc_gn, len(events), args.n_inference_steps)
    keys = ("sample_s", "decode_s", "reward_jpeg_s", "reward_vae_s", "write_s")
    split = "; ".join(f"batch {e['step']}: " + ", ".join(f"{k} {e[k]:.3f}" for k in keys)
                      + f", images/s {e['images_per_sec']:.3f}" for e in events)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"10b collection: {how} {stored} (expected 8); {n} samples in {wall:.1f} s (model "
        f"build included); {split}; max_memory_allocated {peak:.2f} GiB")
    log(f"10b launches {counts}, expected {want} (UNet {unet_gn}, decoder {vae_gn}, encoder "
        f"{enc_gn} GroupNorms; {len(events)} batches)")
    if n != 8 or stored != 8:
        fail(f"the collection stored {stored} of {n} samples, expected 8")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")
    torch.cuda.empty_cache()
    return writer


def finetune_data(args, ft, writer):
    """The finetune's (dataset, loader): the HDF5 bucket loader, or the same
    loader over the in-memory collection."""
    from ddpo_torch.data import bucket_loader, get_bucket_loader

    if writer is None:
        return get_bucket_loader(args.loadpath, ft.models.tokenizer,
                                 batch_size=args.train_batch_size,
                                 max_train_samples=args.max_train_samples)
    return bucket_loader(writer.reader(), ft.models.tokenizer, args.train_batch_size,
                         args.max_train_samples, args.num_workers)


def one_step(ft, batch, draws):
    """finetune_step from a fresh optimizer state; (loss, grads, params after)."""
    from ddpo_torch.pipelines import finetune

    ft.state.opt_state = ft.state.tx.init(ft.state.params)
    loss = finetune.finetune_step(ft, batch, 1, draws=draws)
    return (float(loss), {k: p.grad.detach().clone() for k, p in ft.state.params.items()},
            {k: p.detach().clone() for k, p in ft.state.params.items()})


def phase_rwr_finetune(unet_gn, writer, has_h5py):
    """10c: the fp32 finetune at the preset's settings, cut to 8 steps; then
    one step from the same params and draws on the kernels and on plain ops."""
    import numpy as np
    import torch

    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import finetune
    from ddpo_torch.training import diffusion
    from ddpo_torch.utils.metrics import read_metrics, run_dir

    argv = ["--dataset", "compressed-animals-rwr", "--max_train_steps", "8", "--save_freq", "1",
            "--seed", "0"]
    args = finetune.Parser().parse_args("train", list(argv))
    if (args.dtype, args.train_cfg, args.train_batch_size, args.weighted_dataset,
            args.temperature, args.remat) != ("float32", True, 1, True, 0.2, True):
        fail("compressed-animals-rwr's train block is not fp32, train_cfg, batch 1, "
             "weighted_dataset at temperature 1/5, remat")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    start = time.perf_counter()
    if has_h5py:
        ft = finetune.main(list(argv))
    else:
        ft = finetune.build_finetuner(args)
        finetune.train(ft, *finetune_data(args, ft, writer))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ev = [e for e in read_metrics(run_dir(args.savepath)) if e.get("phase") == "finetune"][-1]
    steps = ev["global_step"]
    # fp32: each of the two CFG applies runs the UNet forward and its remat
    # recompute through the kernels; the fp32 backward recomputes attention
    # in plain torch (JAX's XLA VJP) and GroupNorm's backward is analytic
    want = expected(flash_fwd=4 * FLASH_PER_UNET_FORWARD * steps, gn_stats=4 * unet_gn * steps)
    log(f"10c finetune (fp32, train_cfg, batch 1, weighted_dataset at 1/5, remat; "
        f"{'finetune.main' if has_h5py else 'build_finetuner + train over the in-memory data'}):"
        f" {steps} steps in {wall:.1f} s (model build included), loss {ev['loss']:.5f}; first "
        f"step {ev['first_step_s']:.3f} s, then {ev['step_s']:.4f} s a step; "
        f"max_memory_allocated {peak:.2f} GiB; unet_1.pkl {ev.get('save_bytes', 0)} bytes "
        f"written in {ev.get('save_s', 0):.2f} s")
    log(f"10c launches {counts}, expected {want}")
    if steps != 8 or not np.isfinite(ev["loss"]) or "save_bytes" not in ev:
        fail("the finetune did not take 8 finite steps and export the UNet")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")
    # what unet_1.pkl holds, at the sampler's dtype (10e loads it)
    exported_bf16 = {k: p.detach().to(torch.bfloat16) for k, p in ft.state.params.items()}

    # one step from the same params and draws: kernels, then plain ops
    dataset, loader = finetune_data(args, ft, writer)
    dataset.make_weights(args.filter_field, args.temperature, args.per_prompt_weights)
    batch = next(iter(loader))
    moments = torch.as_tensor(batch["vae"], device="cuda")
    draws = diffusion.draw(moments, 1000, torch.Generator(device="cuda").manual_seed(1))
    start_params = {k: p.detach().clone() for k, p in ft.state.params.items()}
    _build.reset_launch_counts()
    k_loss, k_grads, k_after = one_step(ft, batch, draws)
    k_counts = _build.launch_counts()
    with torch.no_grad():
        for k, p in ft.state.params.items():
            p.copy_(start_params[k])
    with plain_ops():
        p_loss, p_grads, p_after = one_step(ft, batch, draws)
    if any(_build.launch_counts()[k] != v for k, v in k_counts.items()):
        fail("the plain step launched a kernel")
    lr, eps = args.learning_rate, args.epsilon
    grad_rel, exceed, dparam = 0.0, 0, 0.0
    gk_norm = torch.sqrt(sum(g.square().sum() for g in k_grads.values()))
    gp_norm = torch.sqrt(sum(g.square().sum() for g in p_grads.values()))
    ck, cp = (min(1.0, args.max_grad_norm / float(n)) for n in (gk_norm, gp_norm))
    for k in k_grads:
        gk, gp = k_grads[k], p_grads[k]
        grad_rel = max(grad_rel, float((gk - gp).abs().max() / gp.abs().max().clamp_min(1e-30)))
        # the first adamw step: p -= lr * (g/(|g| + eps) + wd * p), g clipped
        uk, up = gk * ck, gp * cp
        uk, up = uk / (uk.abs() + eps), up / (up.abs() + eps)
        p0 = start_params[k]
        bound = lr * (uk - up).abs() + 2 * torch.finfo(p0.dtype).eps * p0.abs() + 1e-5 * lr
        diff = (k_after[k] - p_after[k]).abs()
        exceed += int((diff > bound).sum())
        dparam = max(dparam, float(diff.max()))
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    log(f"10c one step, kernels against plain ops (same params, same draws, fresh adamw): loss "
        f"{k_loss:.6f} / {p_loss:.6f}, rel {loss_rel:.3e} (bound 1e-4); max per-leaf "
        f"|dgrad| / max|grad| {grad_rel:.3e} (bound 1e-3); max|dparam| {dparam:.3e}, bound "
        f"elementwise lr |u_k - u_p| + 2 ulp(p) + 1e-5 lr (at most 2 lr = {2 * lr:g}), u = "
        f"g/(|g| + eps) of each side's clipped gradient (the first adamw step): {exceed} "
        f"elements over it; launches {k_counts}")
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3 and exceed == 0):
        fail("the finetune step on its kernels differs from the plain ops")
    del ft, k_grads, p_grads, k_after, p_after, start_params
    torch.cuda.empty_cache()
    return exported_bf16, args.savepath


def phase_rwr_bf16(unet_gn, writer):
    """10d: two finetune steps at --dtype bfloat16 (cfg_concat)."""
    import numpy as np
    import torch

    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import finetune

    argv = ["--dataset", "compressed-animals-rwr", "--dtype", "bfloat16", "--seed", "0",
            "--savepath", "models/bf16"]
    args = finetune.Parser().parse_args("train", list(argv))
    ft = finetune.build_finetuner(args)
    dataset, loader = finetune_data(args, ft, writer)
    dataset.make_weights(args.filter_field, args.temperature, args.per_prompt_weights)
    batches = iter(loader)
    _build.reset_launch_counts()
    losses, secs = [], []
    for _ in range(2):
        start = time.perf_counter()
        losses.append(float(finetune.finetune_step(ft, next(batches), 1)))
        secs.append(time.perf_counter() - start)
    counts = _build.launch_counts()
    # one 2B apply a step, forward + remat recompute; JAX's finetune
    # computes in fp32 over bf16 weights, so no bf16 flash backward runs
    want = expected(flash_fwd=2 * 2 * FLASH_PER_UNET_FORWARD, gn_stats=2 * 2 * unet_gn)
    dtypes = {p.dtype for p in ft.state.params.values()}
    log(f"10d finetune at --dtype bfloat16 (params {dtypes}, compute fp32 as JAX's, cfg_concat): "
        f"losses {losses}, {secs[0]:.3f} s then {secs[1]:.3f} s a step; flash_bwd_dq "
        f"{counts['flash_bwd_dq']}, flash_bwd_dkv {counts['flash_bwd_dkv']} launches (expected 0:"
        f" the backward's attention is fp32); launches {counts}, expected {want}")
    if not np.isfinite(losses).all() or dtypes != {torch.bfloat16}:
        fail("the bf16 finetune steps gave a non-finite loss or other parameter dtypes")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")
    del ft
    torch.cuda.empty_cache()
    return counts


def phase_rwr_iteration1(unet_gn, vae_gn, enc_gn, exported_bf16, has_h5py):
    """10e: sample --iteration 1 on the finetune's export."""
    import numpy as np
    import torch

    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import sample
    from ddpo_torch.utils.metrics import read_metrics, run_dir

    argv = ["--dataset", "compressed-animals-rwr", "--iteration", "1", "--seed", "0",
            "--max_steps", "1", "--savepath", "samples/1"]
    args = sample.Parser().parse_args("sample", list(argv))
    c = sample.build_collector(args)
    same = sum(torch.equal(p, exported_bf16[k]) for k, p in c.models.unet.named_parameters())
    log(f"10e iteration 1: {args.loadpath} loaded at {args.dtype}: {same} of {len(exported_bf16)} "
        f"UNet tensors equal the finetuned params (after the 8 steps) cast to bf16, bit for bit")
    if same != len(exported_bf16):
        fail("sample --iteration 1 did not load the finetune's export bit for bit")
    _build.reset_launch_counts()
    if has_h5py:
        del c
        n = sample.main(list(argv))
    else:
        writer = MemoryWriter()
        sample.configure_writer(writer, c.callback_fns)
        n = sample.collect(c, writer)
        del c
    counts = _build.launch_counts()
    ev = [e for e in read_metrics(run_dir(args.savepath)) if e.get("phase") == "sample"][-1]
    want = rwr_launches(unet_gn, vae_gn, enc_gn, 1, args.n_inference_steps)
    log(f"10e iteration 1: {n} samples, images/s {ev['images_per_sec']:.3f} (sample "
        f"{ev['sample_s']:.3f} s, decode {ev['decode_s']:.3f}, jpeg {ev['reward_jpeg_s']:.3f}, "
        f"vae {ev['reward_vae_s']:.3f}, write {ev['write_s']:.3f}); launches {counts}, "
        f"expected {want}")
    if n != args.n_samples_per_device or not np.isfinite(ev["mean_reward"]):
        fail("iteration 1 did not collect one batch with finite rewards")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")
    torch.cuda.empty_cache()
    return ev["images_per_sec"]


def phase_rwr(unet_gn, vae_gn):
    """10: one RWR iteration of compressed-animals-rwr at SD-1.4 width."""
    import importlib.util

    from ddpo_torch.models.layers import Conv3x3, GroupNorm
    from ddpo_torch.utils.serialization import build_models

    has_h5py = importlib.util.find_spec("h5py") is not None
    log(f"h5py: {'present' if has_h5py else 'absent'}")
    encoder = build_models("sd14", "meta")[1].encoder
    enc_gn = sum(isinstance(m, GroupNorm) for m in encoder.modules())
    enc_conv = sum(isinstance(m, Conv3x3) for m in encoder.modules())
    # 4 blocks x 2 resnets x 2 + mid (2 resnets x 2 + attention) + conv_norm_out;
    # the ResnetBlock convs: 4 x 2 x 2 + 2 x 2
    if (enc_gn, enc_conv) != (22, 20):
        fail(f"VAE encoder: {enc_gn} GroupNorms and {enc_conv} Conv3x3s, expected 22 and 20")
    marks = [("start", time.perf_counter())]
    phase_rwr_encoder(enc_gn, enc_conv)
    marks.append(("10a", time.perf_counter()))
    writer = phase_rwr_collect(unet_gn, vae_gn, enc_gn, has_h5py)
    marks.append(("10b", time.perf_counter()))
    exported_bf16, export_dir = phase_rwr_finetune(unet_gn, writer, has_h5py)
    marks.append(("10c", time.perf_counter()))
    phase_rwr_bf16(unet_gn, writer)
    marks.append(("10d", time.perf_counter()))
    phase_rwr_iteration1(unet_gn, vae_gn, enc_gn, exported_bf16, has_h5py)
    marks.append(("10e", time.perf_counter()))
    shutil.rmtree(export_dir, ignore_errors=True)  # the 3.4 GB export
    log("phase 10 wall: " + ", ".join(f"{name} {t - marks[i][1]:.1f} s"
                                      for i, (name, t) in enumerate(marks[1:])))


def write_safetensors(path, tensors) -> int:
    """A .safetensors file of ``tensors`` (the card's machine has no
    safetensors package); its size in bytes."""
    import torch

    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int64: "I64"}
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous().reshape(-1)
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(tensors[name].shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
        blobs.append(t)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in blobs:
            f.write(t.view(torch.uint8).numpy())
        return f.tell()


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def stack_state(models):
    return {f"{sub}.{k}": v for sub in ("unet", "vae", "text_encoder")
            for k, v in getattr(models, sub).state_dict().items()}


def phase_checkpoint_export(workdir):
    """11a: the serving stack written in the diffusers-Flax layout and
    loaded back through load_stable_diffusion(pretrained_model=<dir>)."""
    import torch

    from ddpo_torch.models.convert import load_sd_checkpoint
    from ddpo_torch.utils.serialization import (load_stable_diffusion,
                                                save_stable_diffusion_export)

    models = load_stable_diffusion(model_preset="sd14", device="cuda", dtype=torch.bfloat16, seed=0)
    want = stack_state(models)
    export = os.path.join(workdir, "sd14-export")
    torch.cuda.synchronize()
    start = time.perf_counter()
    save_stable_diffusion_export(export, models)
    write_s = time.perf_counter() - start
    nbytes = dir_bytes(export)
    del models
    torch.cuda.empty_cache()
    start = time.perf_counter()
    host = load_sd_checkpoint(export)  # the reader alone, into host tensors
    read_s = time.perf_counter() - start
    del host
    start = time.perf_counter()
    loaded = load_stable_diffusion(pretrained_model=export, model_preset="sd14", device="cuda",
                                   dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - start
    got = stack_state(loaded)
    same = sum(k in got and got[k].dtype == v.dtype and torch.equal(got[k], v)
               for k, v in want.items())
    log(f"11a export (diffusers-Flax msgpack, bf16): {nbytes} bytes in {len(want)} tensors, "
        f"written in {write_s:.2f} s ({nbytes / write_s / 1e9:.2f} GB/s); read to host "
        f"tensors in {read_s:.2f} s ({nbytes / read_s / 1e9:.2f} GB/s); "
        f"load_stable_diffusion onto the card in {load_s:.2f} s ({nbytes / load_s / 1e9:.2f} "
        f"GB/s); {same} of {len(want)} tensors equal bit for bit")
    if same != len(want) or set(got) != set(want):
        fail("the exported stack did not load back bit for bit")
    del loaded, got
    torch.cuda.empty_cache()
    return export, want


def phase_checkpoint_safetensors(workdir, want):
    """11b: the same weights at fp16 in the torch-safetensors layout, with
    a newer diffusers VAE's attention names and the text encoder's
    position_ids buffer."""
    import torch

    from ddpo_torch.utils.serialization import load_stable_diffusion

    root = os.path.join(workdir, "sd14-safetensors")
    fp16 = {k: v.to(torch.float16) for k, v in want.items()}
    nbytes = 0
    start = time.perf_counter()
    for sub, fname in (("unet", "diffusion_pytorch_model.safetensors"),
                       ("vae", "diffusion_pytorch_model.safetensors"),
                       ("text_encoder", "model.safetensors")):
        state = {k[len(sub) + 1:]: v.cpu() for k, v in fp16.items() if k.startswith(sub + ".")}
        if sub == "vae":
            renamed = {}
            for key, value in state.items():
                for old, new in ((".query.", ".to_q."), (".key.", ".to_k."),
                                 (".value.", ".to_v."), (".proj_attn.", ".to_out.0.")):
                    key = key.replace(old, new)
                renamed[key] = value
            if not any(".to_out.0." in k for k in renamed):
                fail("the VAE has no mid-block attention to rename")
            state = renamed
        if sub == "text_encoder":
            state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        nbytes += write_safetensors(os.path.join(root, sub, fname), state)
    write_s = time.perf_counter() - start
    start = time.perf_counter()
    loaded = load_stable_diffusion(pretrained_model=root, model_preset="sd14", device="cuda",
                                   dtype=torch.float16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - start
    got = stack_state(loaded)
    if set(got) != set(fp16):
        fail(f"the safetensors stack has other keys: {sorted(set(got) ^ set(fp16))[:5]}")
    delta = max((got[k].float() - v.float()).abs().max().item() for k, v in fp16.items())
    log(f"11b torch-safetensors layout, fp16 (VAE attention as to_q/to_k/to_v/to_out.0, "
        f"text_model.embeddings.position_ids present): {nbytes} bytes written in {write_s:.2f} s; "
        f"load_stable_diffusion onto the card in {load_s:.2f} s ({nbytes / load_s / 1e9:.2f} "
        f"GB/s); max|loaded - fp16 cast| = {delta:g} over {len(fp16)} tensors")
    if delta != 0 or any(got[k].dtype != torch.float16 for k in got):
        fail("the safetensors stack did not load as the fp16 cast")
    del loaded, got, fp16
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)


SERVING_ARGV = ["--dataset", "compressed-animals", "--n_samples", "4",
                "--n_samples_per_device", "4", "--seed", "0"]


def phase_checkpoint_generate(export, serving_images, serving_counts):
    """11c: generate --pretrained_model <the export> gives the in-memory
    stack's images, through the same kernels."""
    import numpy as np

    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import generate

    _build.reset_launch_counts()
    start = time.perf_counter()
    result = generate.main(SERVING_ARGV + ["--pretrained_model", export])
    wall = time.perf_counter() - start
    counts = _build.launch_counts()
    delta = float(np.abs(result.images - serving_images).max())
    log(f"11c generate --pretrained_model <export>: {result.images.shape[0]} images in "
        f"{wall:.1f} s (the load included); max|images - phase 4's| = {delta:g}; launches "
        f"{counts} (phase 4: {serving_counts})")
    if counts != serving_counts or counts["flash_fwd"] <= 0 or counts["gn_stats"] <= 0:
        fail("generate on the loaded stack launched other kernels than phase 4")
    if delta != 0:
        again = generate.main(list(SERVING_ARGV)).images
        spread = float(np.abs(again - serving_images).max())
        log(f"11c two calls of the in-memory stack differ by max|d| = {spread:g}")
        if delta > spread:
            fail(f"the loaded stack's images differ by {delta}, beyond the in-memory spread")
    return result


def phase_clip_rewards(workdir, images, prompts):
    """11d: the CLIP rewards at fp32 on 11c's images, on the card against
    the same functions on the CPU."""
    import numpy as np
    import torch

    from ddpo_torch.models.aesthetic import WEIGHTS_FNAME, AestheticClassifier
    from ddpo_torch.models.clip import B32_TEXT, VIT_B_32, VIT_L_14, CLIPImageEncoder, CLIPTextModel
    from ddpo_torch.models.convert import load_clip_checkpoint
    from ddpo_torch.models.tokenizer import get_tokenizer
    from ddpo_torch.training import callbacks
    from ddpo_torch.utils.serialization import init_weights_

    def random_module(make, seed):
        with torch.device("meta"):
            module = make()
        module = module.to_empty(device="cpu")
        init_weights_(module, torch.Generator().manual_seed(seed))
        return module

    clip_dir = os.path.join(workdir, "clip-vit-large-patch14")
    cache = os.path.join(workdir, "cache")
    os.makedirs(clip_dir)
    os.makedirs(cache)
    start = time.perf_counter()
    tower = random_module(CLIPImageEncoder, 0)
    nbytes = write_safetensors(os.path.join(clip_dir, "model.safetensors"), tower.state_dict())
    torch.save(random_module(AestheticClassifier, 0).state_dict(), os.path.join(cache, WEIGHTS_FNAME))
    clip_params = load_clip_checkpoint(clip_dir)
    if any(not torch.equal(clip_params[k], v) for k, v in tower.state_dict().items()):
        fail("load_clip_checkpoint did not give back the ViT-L/14 written")
    log(f"11d random ViT-L/14 (seed 0): {sum(p.numel() for p in tower.parameters())} "
        f"parameters, model.safetensors {nbytes} bytes, written and loaded in "
        f"{time.perf_counter() - start:.1f} s")

    # the tower alone: ms for a batch of 4 at 224 px, fp32
    gpu_tower = tower.to("cuda")
    pixels = torch.as_tensor(callbacks.clip_preprocess(images), device="cuda")
    with torch.no_grad():
        tower_ms = median_ms(lambda: gpu_tower(pixels), 10)
    tokens = (VIT_L_14.image_size // VIT_L_14.patch_size) ** 2 + 1
    flops = 4 * (2 * sum(p.numel() for p in tower.parameters()) * tokens
                 + 4 * tokens * tokens * VIT_L_14.hidden_size * VIT_L_14.num_layers)
    bound_ms, bound_by = roofline(flops, 4 * sum(p.numel() for p in tower.parameters()), "float32")
    log(f"11d ViT-L/14 tower, batch 4, fp32: {tower_ms:.2f} ms ({flops / 1e9:.0f} GFLOP, "
        f"{flops / tower_ms / 1e9:.1f} TFLOP/s; bound {bound_ms:.2f} ms by {bound_by})")
    del gpu_tower, tower

    b32 = {**random_module(lambda: CLIPImageEncoder(VIT_B_32), 1).state_dict(),
           **random_module(lambda: CLIPTextModel(B32_TEXT), 2).state_dict()}
    g = torch.Generator().manual_seed(3)
    b32["text_projection.weight"] = torch.randn((512, 512), generator=g) / 512 ** 0.5
    b32["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    tokenizer = get_tokenizer(None)
    rewards = {
        "aesthetic": lambda device: callbacks.aesthetic_fn(
            clip_params=clip_params, cache=cache, device=device),
        "rotational": lambda device: callbacks.rotational_symmetry_fn(
            clip_params=clip_params, device=device),
        "thumbnail": lambda device: callbacks.thumbnail_fn(clip_params=clip_params, device=device),
        "consistency": lambda device: callbacks.consistency_fn(
            clip_model_params=b32, tokenizer=tokenizer, device=device),
    }
    bound = 1e-4
    for name, make in rewards.items():
        fn = make("cuda")
        fn(images, prompts, None)  # warm-up
        times = []
        for _ in range(3):
            start = time.perf_counter()
            scores, _ = fn(images, prompts, None)
            times.append((time.perf_counter() - start) * 1e3)
        del fn
        torch.cuda.empty_cache()
        start = time.perf_counter()
        cpu_scores, _ = make("cpu")(images, prompts, None)
        cpu_s = time.perf_counter() - start
        scores, cpu_scores = np.asarray(scores, np.float64), np.asarray(cpu_scores, np.float64)
        rel = float(np.abs(scores - cpu_scores).max() / np.abs(cpu_scores).max())
        log(f"11d {name}: scores {np.round(scores.ravel(), 6).tolist()}; "
            f"{statistics.median(times):.1f} ms a batch of {len(images)} on the card (median of 3, "
            f"preprocessing included), {cpu_s:.1f} s on the CPU; max|cuda - cpu| / max|cpu| = "
            f"{rel:.3e} (bound {bound:g})")
        if scores.shape != cpu_scores.shape or not np.isfinite(scores).all() or not rel <= bound:
            fail(f"the {name} reward on the card differs from the CPU's")
    shutil.rmtree(clip_dir, ignore_errors=True)


def phase_checkpoints(serving_images, serving_counts):
    """11: local checkpoints and the CLIP rewards at SD-1.4 width."""
    import torch

    workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    marks = [("start", time.perf_counter())]
    export, want = phase_checkpoint_export(workdir)
    marks.append(("11a", time.perf_counter()))
    phase_checkpoint_safetensors(workdir, want)
    del want
    torch.cuda.empty_cache()
    marks.append(("11b", time.perf_counter()))
    result = phase_checkpoint_generate(export, serving_images, serving_counts)
    marks.append(("11c", time.perf_counter()))
    phase_clip_rewards(workdir, result.images, result.prompts)
    marks.append(("11d", time.perf_counter()))
    shutil.rmtree(workdir, ignore_errors=True)
    log("phase 11 wall: " + ", ".join(f"{name} {t - marks[i][1]:.1f} s"
                                      for i, (name, t) in enumerate(marks[1:])))


# ---- phase 12: the serving extras (DPM-Solver++, W8A8 int8 convs, calibrate) ----

# the UNet's quantized convs per forward: 22 resnets x 2 + 3 upsamplers
QUANT_PER_UNET_FORWARD = 47
# (N, Cin, H, W, Cout) of the s8 kernel at 2B = 8: the first resnet conv of
# each resolution's blocks, and two of the up path's widest inputs
S8_SHAPES = [(8, 320, 64, 64, 320), (8, 640, 32, 32, 640), (8, 1920, 16, 16, 1280),
             (8, 2560, 8, 8, 1280)]


def int_mm_conv(xq, wq):
    """The int32 sums of the s8 conv as im2col + torch._int_mm: one int8
    GEMM over a (N*H*W, 9*Cin) copy of the codes. A yardstick for the
    kernel's time, never on the port's path."""
    import torch
    import torch.nn.functional as F

    n, cin, h, w = xq.shape
    xp = F.pad(xq, (1, 1, 1, 1))
    cols = torch.stack([xp[:, :, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                       dim=1)  # (N, 9, Cin, H, W): K in (tap, cin) order
    return torch._int_mm(cols.permute(0, 3, 4, 1, 2).reshape(n * h * w, 9 * cin), wq.t())


def check_conv3x3_s8(results, smi):
    """12a: the s8 tap-GEMM against its plain version on the same codes,
    bf16 and fp32 out with a bias; max |d| must be 0. Times beside cuDNN's
    bf16 conv, im2col + _int_mm and the plain version."""
    import torch
    import torch.nn.functional as F

    from ddpo_torch.ops.quant import (quantize_symmetric, tap_gemm_s8, tap_gemm_s8_reference,
                                      weight_codes)

    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = [(shape, dtype) for shape in S8_SHAPES for dtype in (torch.bfloat16, torch.float32)]
    cases += [((2, 40, 13, 17, 24), torch.bfloat16)]  # Cin not a multiple of 16, ragged maps
    for shape, dtype in cases:
        n, cin, h, w, cout = shape
        name = dtype_name(dtype)
        x = torch.randn((n, cin, h, w), generator=gen, device="cuda").to(torch.bfloat16)
        weight = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
                  * (9 * cin) ** -0.5).to(torch.bfloat16)
        bias = torch.randn(cout, generator=gen, device="cuda")
        xq, sx = quantize_symmetric(x, (1, 2, 3))
        sx = sx.reshape(-1)
        wq, sw = weight_codes(weight)
        out = tap_gemm_s8(xq, wq, sx, sw, bias, dtype)
        again = tap_gemm_s8(xq, wq, sx, sw, bias, dtype)
        alone = tap_gemm_s8(xq[:1].contiguous(), wq, sx[:1].contiguous(), sw, bias, dtype)
        ref = tap_gemm_s8_reference(xq, wq, sx, sw, bias, dtype)
        err = (out.float() - ref.float()).abs().max().item()
        same = torch.equal(out, again) and torch.equal(alone, out[:1])
        line = (f"12a conv3x3_s8 {name} out x{(n, cin, h, w)} -> {cout}: max|kernel - plain| "
                f"{err:g} (bound 0: the same codes); two calls and image 0 alone equal: {same}")
        if not (err == 0 and same and out.dtype == dtype):
            fail(line)
        entry = {"shape": list(shape), "dtype": name, "max_abs_err": err}
        if shape in S8_SHAPES and dtype == torch.bfloat16:
            ops = 2.0 * n * h * w * 9 * cin * cout
            nbytes = (xq.numel() + wq.numel() + out.numel() * out.element_size()
                      + 4 * (sx.numel() + sw.numel() + bias.numel()))
            bound_ms, bound_by = roofline(ops, nbytes, "int8")
            iters = 5 if ops > 1e11 else 10
            k_ms, p_ms = timed_pair(lambda: tap_gemm_s8(xq, wq, sx, sw, bias, dtype),
                                    lambda: tap_gemm_s8_reference(xq, wq, sx, sw, bias, dtype),
                                    iters)
            b16 = bias.to(torch.bfloat16)
            cudnn_ms = median_ms(lambda: F.conv2d(x, weight, b16, padding=1), iters)
            sums = int_mm_conv(xq, wq)
            exact = tap_gemm_s8_reference(xq, wq, torch.ones_like(sx), torch.ones_like(sw),
                                          None, torch.float32)
            if not torch.equal(sums.float().view(n, h, w, cout).permute(0, 3, 1, 2), exact):
                fail(f"im2col + _int_mm differs from the exact sums at {shape}")
            int_mm_ms = median_ms(lambda: int_mm_conv(xq, wq), iters)
            quant_ms = median_ms(lambda: quantize_symmetric(x, (1, 2, 3)), iters)
            entry.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None, cudnn_bf16_ms=cudnn_ms, int_mm_ms=int_mm_ms,
                         quantize_ms=quant_ms)
            line += (f"; kernel {k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TOPS), bound "
                     f"{bound_ms:.4f} ms ({bound_by}), plain {p_ms:.4f} ms, cuDNN bf16 F.conv2d "
                     f"{cudnn_ms:.4f} ms, im2col + _int_mm {int_mm_ms:.4f} ms; the quantize "
                     f"pass over x {quant_ms:.4f} ms a call ({smi})")
            del sums, exact
        log(line)
        results.append(entry)
        del x, weight, xq, wq, out, again, alone, ref
        torch.cuda.empty_cache()


def run_generate(tag, extra, steps, quant, unet_gn, vae_gn):
    """generate.main on the serving cell plus ``extra``: images/s of its
    batch, after checking the images and the launches."""
    import numpy as np
    import torch

    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import generate
    from ddpo_torch.utils.metrics import read_metrics

    _build.reset_launch_counts()
    start = time.perf_counter()
    result = generate.main(SERVING_ARGV + extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = _build.launch_counts()
    images = result.images
    if images.shape != (4, 512, 512, 3) or not np.isfinite(images).all():
        fail(f"12b {tag}: images {images.shape} are not four finite 512 px images")
    want = expected(flash_fwd=FLASH_PER_UNET_FORWARD * steps, gn_stats=unet_gn * steps + vae_gn,
                    conv3x3_s8=QUANT_PER_UNET_FORWARD * steps if quant else 0)
    ips = [e["images_per_sec"] for e in read_metrics(result.outdir)
           if e.get("phase") == "generate"][-1]
    log(f"12b generate {tag}: {ips:.3f} images/s (sampling + decode of the batch of 4); "
        f"{wall:.1f} s with the model build; launches {counts}")
    if counts != want:
        fail(f"12b {tag}: kernel launches {counts} != expected {want}")
    return ips, counts


def serving_distances():
    """12b: the final latents of one bf16 stack (seed 0) from the same init
    latents and prompts: int8 against bf16 (DDIM-50 at eta 1 with the same
    noise, DPM++-20), and DPM++-20 and eta-0 DDIM-20 against eta-0 DDIM-50.
    The weights are random, so the distances are printed, not bounded."""
    import dataclasses
    import types

    import torch

    from ddpo_torch.models.tokenizer import make_uncond_ids
    from ddpo_torch.pipelines.generate import inference_sampler
    from ddpo_torch.sampling import SamplerConfig
    from ddpo_torch.utils.serialization import load_stable_diffusion

    models = load_stable_diffusion(model_preset="sd14", device="cuda", dtype=torch.bfloat16,
                                   seed=0)
    with torch.no_grad():
        prompt = models.text_encoder(torch.as_tensor(
            models.tokenizer(["a cat", "a dog", "a horse", "a llama"]), device="cuda"))
        uncond = models.text_encoder(torch.as_tensor(make_uncond_ids(models.tokenizer, 4),
                                                     device="cuda"))
    init = torch.randn((4, 4, 64, 64), generator=torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    config = SamplerConfig(guidance_scale=5.0)

    def run(scheduler_name, steps, eta, quant):
        args = types.SimpleNamespace(quant="int8" if quant else "none",
                                     scheduler=scheduler_name, eta=eta)
        models.unet.set_quant(False)
        scheduler, sample_fn = inference_sampler(args, [], models, "12b")
        return sample_fn(models.unet, scheduler, scheduler.create_state("cuda"), prompt, uncond,
                         dataclasses.replace(config, num_inference_steps=steps, eta=eta),
                         generator=torch.Generator(device="cuda").manual_seed(1),
                         init_latents=init)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    ddim50 = {q: run("ddim", 50, 1.0, q) for q in (False, True)}
    dpm20 = {q: run("dpm++", 20, 0.0, q) for q in (False, True)}
    ode50, ode20 = run("ddim", 50, 0.0, False), run("ddim", 20, 0.0, False)
    models.unet.set_quant(False)
    latents = (*ddim50.values(), *dpm20.values(), ode50, ode20)
    if not all(torch.isfinite(t).all() for t in latents):
        fail("12b: a sampler gave non-finite latents")
    log(f"12b final latents, relative L2 (random weights: printed, not bounded): int8 against "
        f"bf16 at the same seed: DDIM-50 {rel(ddim50[True], ddim50[False]):.4f}, DPM++-20 "
        f"{rel(dpm20[True], dpm20[False]):.4f}; from eta-0 DDIM-50 with the same init latents: "
        f"DPM++-20 {rel(dpm20[False], ode50):.4f}, eta-0 DDIM-20 {rel(ode20, ode50):.4f}")
    del models
    torch.cuda.empty_cache()


def phase_extras_collect(unet_gn, vae_gn, enc_gn):
    """12c: one collection batch of compressed-animals-rwr with --scheduler
    dpm++ --quant int8 --n_inference_steps 20, beside phase 10b's."""
    from ddpo_torch.models.layers import Conv3x3
    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import sample
    from ddpo_torch.utils.metrics import read_metrics, run_dir

    steps = 20
    argv = ["--dataset", "compressed-animals-rwr", "--seed", "0", "--scheduler", "dpm++",
            "--quant", "int8", "--n_inference_steps", str(steps)]
    args = sample.Parser().parse_args("sample", list(argv))
    c = sample.build_collector(args, argv)
    quantized = sum(m.quant for m in c.models.unet.modules() if isinstance(m, Conv3x3))
    if quantized != QUANT_PER_UNET_FORWARD:
        fail(f"12c: {quantized} quantized convs in the sampling UNet, expected 47")
    _build.reset_launch_counts()
    batch, mask, rewards, seconds = sample.collect_batch(c)
    counts = _build.launch_counts()
    want = expected(flash_fwd=FLASH_PER_UNET_FORWARD * steps,
                    gn_stats=unet_gn * steps + vae_gn + enc_gn,
                    conv3x3_s8=QUANT_PER_UNET_FORWARD * steps)
    n = len(batch["images"])
    ips = n / sum(seconds.values())
    base = run_dir(sample.Parser().parse_args("sample", ["--dataset",
                                                         "compressed-animals-rwr"]).savepath)
    earlier = [e["images_per_sec"] for e in (read_metrics(base) if os.path.exists(
        os.path.join(base, "metrics.jsonl")) else []) if e.get("phase") == "sample"]
    log(f"12c collection batch of {n} (dpm++, 20 steps, int8): " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()) + f"; {ips:.3f} images/s (no write), "
        f"phase 10b's batches {[round(x, 3) for x in earlier]} images/s (write included); "
        f"launches {counts}")
    if n != 4 or len(rewards) != 4 or batch["vae"].shape[0] != 4:
        fail("12c: the collection batch is not 4 samples")
    if counts != want:
        fail(f"12c: kernel launches {counts} != expected {want}")
    del c
    return ips


def phase_extras_calibrate():
    """12d: calibrate with two scales and one batch of 4 at 512 px, then
    generate --guidance_scale auto on its savepath reads the argmax."""
    import contextlib
    import io
    import json

    from ddpo_torch.pipelines import calibrate, generate

    argv = ["--dataset", "compressed-animals", "--guidance_scales", "[2.0, 7.5]",
            "--n_eval_batches", "1", "--n_samples_per_device", "4", "--n_inference_steps", "20",
            "--seed", "0"]
    start = time.perf_counter()
    result = calibrate.main(argv)
    wall = time.perf_counter() - start
    savepath = calibrate.Parser().parse_args("calibrate", list(argv)).savepath
    with open(os.path.join(savepath, "calibration.json")) as f:
        cal = json.load(f)
    with open(os.path.join(savepath, "metadata.json")) as f:
        meta = json.load(f)
    means = {float(k): v["mean"] for k, v in cal["curve"].items()}
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    log(f"12d calibrate (2 scales, a batch of 4, 20 DDIM steps, the jpeg reward): curve "
        f"{means}, best {result.best:g}, in {wall:.1f} s with the model build; matplotlib "
        f"imports: {has_mpl}; calibration.png drawn with {result.renderer}")
    if not (cal["best"] == meta["guidance_scale"] == max(means, key=means.get) == result.best
            and all(v["n"] == 4 for v in cal["curve"].values())
            and os.path.getsize(os.path.join(savepath, "calibration.png")) > 0):
        fail("12d: calibration.json, metadata.json or calibration.png is not the sweep's")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen = generate.main(SERVING_ARGV + ["--guidance_scale", "auto", "--loadpath", savepath,
                                            "--scheduler", "dpm++", "--n_inference_steps", "20"])
    printed = out.getvalue()
    with open(os.path.join(gen.outdir, "prompts.json")) as f:
        used = json.load(f)["guidance_scale"]
    line = next((l for l in printed.splitlines() if "calibrated guidance scale" in l), "")
    log(f"12d generate --guidance_scale auto: '{line.strip()}'; prompts.json "
        f"guidance_scale {used}")
    if f"calibrated guidance scale: {result.best:g}" not in printed or used != result.best:
        fail("12d: generate --guidance_scale auto did not read the calibrated argmax")


def phase_serving_extras(unet_gn, vae_gn, serving_ips, smi):
    """12: the serving extras at SD-1.4 width, on the card ``smi`` names."""
    from ddpo_torch.models.layers import GroupNorm
    from ddpo_torch.utils.serialization import build_models

    log(f"12: the serving extras on {smi}")
    marks = [("start", time.perf_counter())]
    s8_results = []
    check_conv3x3_s8(s8_results, smi)
    marks.append(("12a", time.perf_counter()))
    # each scheduler's bf16 and int8 runs in turns (bf16, int8, int8, bf16)
    # in one process, so that both see the same warm state
    ips, counts = {}, None
    for sched, extra, steps in (("DDIM-50", [], 50),
                                ("DPM++-20", ["--scheduler", "dpm++", "--n_inference_steps",
                                              "20"], 20)):
        for quant in (False, True, True, False):
            tag = f"{sched} {'int8' if quant else 'bf16'}"
            rate, launched = run_generate(tag, extra + (["--quant", "int8"] if quant else []),
                                          steps, quant, unet_gn, vae_gn)
            ips.setdefault(tag, []).append(rate)
            if tag == "DDIM-50 int8":
                counts = launched
    log(f"12b images/s, batch 4 at 512 px, bf16 activations, two runs each in turns: "
        + "; ".join(f"{tag} {sum(r) / len(r):.3f} ({', '.join(f'{x:.3f}' for x in r)})"
                    for tag, r in ips.items())
        + f"; phase 4's DDIM-50 bf16 {serving_ips:.3f} ({smi})")
    serving_distances()
    marks.append(("12b", time.perf_counter()))
    encoder = build_models("sd14", "meta")[1].encoder
    enc_gn = sum(isinstance(m, GroupNorm) for m in encoder.modules())
    phase_extras_collect(unet_gn, vae_gn, enc_gn)
    marks.append(("12c", time.perf_counter()))
    phase_extras_calibrate()
    marks.append(("12d", time.perf_counter()))
    log("phase 12 wall: " + ", ".join(f"{name} {t - marks[i][1]:.1f} s"
                                      for i, (name, t) in enumerate(marks[1:])))
    return s8_results, counts


PHASE13_ARGV = ["--dataset", "compressed-animals", "--sample_batch_size", "2",
                "--train_batch_size", "1", "--train_timestep_ratio", "0.2", "--seed", "0",
                "--logbase", "gs://chip-smoke/logs"]


def rank_values(outs, pattern, cast=str):
    """Each rank's matches of ``pattern`` (its first group, or all groups)."""
    import re

    found = []
    for out in outs:
        ms = [m for m in (re.search(pattern, line) for line in out.splitlines()) if m]
        found.append([cast(m.group(1)) if m.re.groups == 1 else m.groups() for m in ms])
    return found


def run_ranks(tag, argv, cwd, env, timeout, module="ddpo_torch.pipelines.policy_gradient"):
    """Two ranks of ``module`` (the DDPO driver) on the one card (LOCAL_RANK 0
    each); each rank's whole output goes to chiprun_out/phase<tag's phase>/."""
    from ddpo_torch.parallel.launch import launch

    os.makedirs(cwd, exist_ok=True)
    start = time.perf_counter()
    results = launch([sys.executable, "-m", module, *argv],
                     2, timeout=timeout, env=env, cwd=cwd, local_rank=lambda r: 0)
    wall = time.perf_counter() - start
    logdir = os.path.join(REPO, "chiprun_out", f"phase{tag[:2]}")
    os.makedirs(logdir, exist_ok=True)
    for rank, (rc, out) in enumerate(results):
        with open(os.path.join(logdir, f"{tag}_rank{rank}.log"), "w") as f:
            f.write(out)
        if rc != 0:
            print(out[-6000:], file=sys.stderr, flush=True)
            fail(f"{tag}: rank {rank} exited {rc}")
    return [out for _, out in results], wall


def check_ranks(tag, outs, want, smi, epochs, remote, args):
    """The checks and numbers of one two-rank run; returns the reward history."""
    import json as _json

    import numpy as np

    rewards = rank_values(outs, r"epoch (\d+) mean reward: (\S+)")
    noise = rank_values(outs, r"initial noise digest (\w+)")
    digests = rank_values(outs, r"epoch (\d+) params digest (\w+)")
    backend = rank_values(outs, r"gradient all-reduce: (\w+), (\w+)")
    reduces = rank_values(outs, r"gradient all-reduce \(\w+, (\w+)\): (\d+) calls, (\d+) bytes "
                                r"each, seconds (.*)")
    updates = rank_values(outs, r"epoch (\d+)\.0: .*\| (\S+)s, (\S+) s an update \((\d+)\)")
    walls = rank_values(outs, r"epoch (\d+) wall (\S+) s")
    ends = rank_values(outs, r"rank (\d+): peak memory (\S+) GiB \| kernel launches (\{.*\})")
    if rewards[0] != rewards[1] or [e for e, _ in rewards[0]] != [str(e) for e in epochs]:
        fail(f"{tag}: the ranks' reward histories differ or miss epochs: {rewards}")
    if digests[0] != digests[1] or len(digests[0]) != len(epochs):
        fail(f"{tag}: the ranks' parameter digests differ: {digests}")
    if len(noise[0]) != len(epochs) or any(a == b for a, b in zip(*noise)):
        fail(f"{tag}: the ranks drew the same sampler noise: {noise}")
    if any([name for name, _ in b] != ["gloo"] for b in backend):
        fail(f"{tag}: ranks sharing a card must reduce over gloo: {backend}")
    if not all(len(e) == 1 for e in ends):
        fail(f"{tag}: a rank printed no peak memory and launches")
    # each rank's first minibatch is on-policy: the infos are the ranks'
    # mean, so 2 B T x 2 ranks x approx_kl bounds the sum of dlogp^2
    infos = np.load(os.path.join(remote, "train_info", f"0_{epochs[-1]}_0.npy"),
                    allow_pickle=True).item()
    num_ts = int(args.n_inference_steps * args.train_timestep_ratio)
    first_dlogp = (4.0 * args.train_batch_size * num_ts * infos["approx_kl"][0]) ** 0.5
    log(f"13 {tag}: first minibatch (2B = {2 * args.train_batch_size} against the sampler's "
        f"2B = {2 * args.sample_batch_size}, both ranks) approx_kl {infos['approx_kl'][0]:.3e}, "
        f"clipfrac {infos['clipfrac'][0]:.3f}, max|dlogp| <= {first_dlogp:.3e} (bound 1e-5); "
        f"the second, after an update: approx_kl {infos['approx_kl'][1]:.3e}, clipfrac "
        f"{infos['clipfrac'][1]:.3f}")
    if not (first_dlogp <= 1e-5 and infos["clipfrac"][0] == 0.0):
        fail(f"{tag}: the first minibatch's recompute is off-policy")
    log(f"13 {tag}: backend {backend[0][0][0]} (both ranks on cuda:0), all-reduce dtype "
        f"{backend[0][0][1]}; rewards {rewards[0]}; params digests {digests[0]} (equal on both "
        f"ranks); initial noise digests rank 0 {noise[0]}, rank 1 {noise[1]} ({smi})")
    for rank in range(2):
        for dtype, calls, nbytes, secs in reduces[rank]:
            log(f"13 {tag} rank {rank}: gradient all-reduce ({dtype}) {calls} calls of "
                f"{int(nbytes)} bytes, seconds {secs} (pinned host staging + gloo; includes "
                f"the wait for the other rank) ({smi})")
        for epoch, train_s, per_update, n in updates[rank]:
            log(f"13 {tag} rank {rank}: epoch {epoch} training {train_s} s, {per_update} s "
                f"an update ({n} updates) ({smi})")
        log(f"13 {tag} rank {rank}: epoch walls "
            + ", ".join(f"{e}: {w} s" for e, w in walls[rank])
            + f"; peak memory {ends[rank][0][1]} GiB ({smi})")
        launched = _json.loads(ends[rank][0][2])
        log(f"13 {tag} rank {rank}: launches {launched}, expected {want}")
        if launched != want:
            fail(f"{tag}: rank {rank} launched {launched}, expected {want}")
    return rewards[0]


def phase_ddpo_ranks(unet_gn, vae_gn, unet_conv, smi):
    """13: two ranks of SD-1.4 DDPO on the one card (gloo), to a gs:// stand-in;
    13a one epoch at an fp32 all-reduce, 13b a resume on a fresh host at bf16."""
    import torch

    from ddpo_torch.native import build as native_build
    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import policy_gradient

    # the ranks load the kernel and JPEG libraries built here (earlier
    # phases), and never build them at the same time
    _build.load_library()
    native_build.build()
    torch.cuda.empty_cache()
    log(f"13: two DDPO ranks on one card; the parent holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB ({smi})")
    args = policy_gradient.Parser().parse_args("pg", list(PHASE13_ARGV), setup=False)
    steps, n_sample = args.n_inference_steps, args.num_sample_batches_per_epoch
    num_ts = int(steps * args.train_timestep_ratio)
    n_updates = args.sample_batch_size * n_sample // args.train_batch_size * num_ts
    log(f"13: --dataset compressed-animals at SD-1.4 width, per rank sample batch "
        f"{args.sample_batch_size}, train batch {args.train_batch_size}, {steps} steps, CFG "
        f"{args.guidance_scale}; cut: --train_timestep_ratio {args.train_timestep_ratio} "
        f"({num_ts} of {steps} timesteps trained, {n_updates} updates a rank an epoch)")
    # per rank and epoch, as phase 7: the sampler's 2B calls, the trainer's
    # forward + remat + backward, inside batch_invariant()
    want = expected(
        flash_fwd=FLASH_PER_UNET_FORWARD * (steps * n_sample + 2 * n_updates),
        flash_bwd_dq=FLASH_PER_UNET_FORWARD * n_updates,
        flash_bwd_dkv=FLASH_PER_UNET_FORWARD * n_updates,
        gn_stats=unet_gn * (steps * n_sample + 2 * n_updates) + vae_gn * n_sample,
        conv3x3=unet_conv * (steps * n_sample + 2 * n_updates),
    )
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    fake = os.path.join(work, "fake_gcs")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               DDPO_TPU_FAKE_GCS=fake, DDPO_BUCKET=os.path.join(work, "bucket"))
    remote = os.path.join(fake, "chip-smoke", "logs", "models", "pg")
    marks = [("start", time.perf_counter())]

    outs, wall = run_ranks("13a", PHASE13_ARGV + ["--num_train_epochs", "1"],
                           os.path.join(work, "host_a"), env, timeout=420)
    marks.append(("13a", time.perf_counter()))
    first = check_ranks("13a", outs, want, smi, [0], remote, args)
    log(f"13a: two ranks, one epoch, {wall:.1f} s from launch to exit ({smi})")
    needed = ["reward_curve.json", "checkpoints/0/state.pt", "checkpoints/0_host.pkl",
              "checkpoints/0_host_p1.pkl"]
    missing = [p for p in needed if not os.path.exists(os.path.join(remote, p))]
    if missing:
        fail(f"13a: not in the stand-in bucket: {missing}")
    log(f"13a: in the bucket: {needed}; state.pt "
        f"{os.path.getsize(os.path.join(remote, 'checkpoints/0/state.pt'))} bytes")
    shutil.rmtree(os.path.join(work, "host_a"))  # the next host starts with nothing

    outs, wall = run_ranks("13b", PHASE13_ARGV + ["--num_train_epochs", "2", "--resume", "True",
                                                  "--grad_reduce_dtype", "bfloat16"],
                           os.path.join(work, "host_b"), env, timeout=480)
    marks.append(("13b", time.perf_counter()))
    resumed = rank_values(outs, r"resumed from checkpoint at epoch (\d+)", int)
    fetched = rank_values(outs, r"(fetched remote checkpoints)")
    if resumed != [[0], [0]] or sum(map(len, fetched)) != 1:
        fail(f"13b: expected both ranks to resume at epoch 0 + 1 = 1 from one fetch: "
             f"{resumed}, {fetched}")
    second = check_ranks("13b", outs, want, smi, [1], remote, args)
    with open(os.path.join(remote, "reward_curve.json")) as f:
        curve = json.load(f)["mean"]
    if len(curve) != 2 or f"{curve[0]:.4f}" != first[0][1] or f"{curve[1]:.4f}" != second[0][1]:
        fail(f"13b: the bucket's reward curve {curve} is not 13a's then 13b's epoch")
    if not os.path.exists(os.path.join(remote, "checkpoints/1_host_p1.pkl")):
        fail("13b: rank 1's epoch-1 host pickle is not in the bucket")
    log(f"13b: start epoch 1 on a fresh host (one rank fetched the bucket's checkpoints), "
        f"reward curve {curve}, {wall:.1f} s from launch to exit ({smi})")
    shutil.rmtree(work, ignore_errors=True)
    log("phase 13 wall: " + ", ".join(f"{name} {t - marks[i][1]:.1f} s"
                                      for i, (name, t) in enumerate(marks[1:])))


# ---- phase 14: the sp mesh axis, two ranks on the one card ----

# self-attentions per UNet forward sharded over sp = 2 at 512 px that meet
# the flash gate: local Sq 2048 and 512 (down 0-1 x 2, up 2-3 x 3); the
# 16x16 level's 128 and the mid block's 32 take the plain path
FLASH_PER_SP_FORWARD = 10
# collectives per sharded UNet forward at SD-1.4: a halo a stride-1 3x3
# conv, a top halo a stride-2 conv, an all-reduce a GroupNorm, a K/V gather
# a self-attention, the output gather (once an apply: outside the remat
# checkpoint); an update's backward transposes all but the output gather
# (its backward is a slice) and conv_in's halo (the latents need no gradient)
SP_PER_UNET_FORWARD = {"halo": 49, "halo_top": 3, "psum": 61, "gather_kv": 16, "gather_out": 1}
SP_PER_UNET_BACKWARD = {"halo": 48, "halo_top": 3, "psum": 61, "gather_kv": 16}
# (B, Sq, Sk, H, D) at the trainer's 2B = 2 (train batch 1): the two levels
# whose local queries meet the flash gate, against the gathered K/V
SP_FLASH_CASES = [(2, 2048, 4096, 8, 40), (2, 512, 1024, 8, 80)]
# cut: 5 of 50 timesteps trained (phase 13 trains 10), so phase 14 keeps the
# script well inside its limit on a slow host
PHASE14_ARGV = ["--dataset", "compressed-animals", "--sample_batch_size", "2",
                "--train_batch_size", "1", "--train_timestep_ratio", "0.1", "--seed", "0",
                "--mesh_sp", "2", "--num_train_epochs", "1"]


def check_sp_kernels(flash_results, bwd_results, conv_results, s8_results, smi):
    """14k: the kernels at the sp path's new shapes against their plain
    versions: flash forward and backward at local Sq != Sk (bf16); conv3x3
    and the s8 tap-GEMM on a halo'd (4, 320, 34, 64) frame with the SAME
    map's first and last rows dropped, against the plain VALID-over-H conv,
    and bit for bit against the unsharded map's rows."""
    import torch
    import torch.nn.functional as F

    from ddpo_torch.ops.conv import conv3x3_direct, conv3x3_reference
    from ddpo_torch.ops.quant import (VALID_ROWS, conv3x3_w8a8, quantize_symmetric, tap_gemm_s8,
                                      tap_gemm_s8_reference, weight_codes)

    check_flash(flash_results, SP_FLASH_CASES, (torch.bfloat16,), "14k ")
    check_flash_bwd(bwd_results, SP_FLASH_CASES, (torch.bfloat16,), "14k ")
    gen = torch.Generator(device="cuda").manual_seed(14)
    n, cin, h, w, cout = 4, 320, 64, 64, 320
    rows = h // 2
    x = torch.randn((n, cin, h, w), generator=gen, device="cuda").to(torch.bfloat16)
    weight = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
              * (9 * cin) ** -0.5).to(torch.bfloat16)
    bias = torch.randn(cout, generator=gen, device="cuda")
    # shard 0 of 2: zero top row (the global pad), its 32 rows, shard 1's first
    xh = F.pad(x, (0, 0, 1, 1))[:, :, :rows + 2].contiguous()

    def halo_conv():
        return conv3x3_direct(xh, weight)[:, :, 1:-1]

    out = halo_conv()
    ref = conv3x3_reference(xh.float(), weight.float())[:, :, 1:-1]  # the plain VALID rows
    whole = conv3x3_direct(x, weight)[:, :, :rows]
    peak = ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    bound = 1e-2 * max(1.0, peak)
    same = torch.equal(out, whole)
    line = (f"14k conv3x3 bf16 halo'd x{tuple(xh.shape)} -> {cout}, rows 1..{rows} kept: "
            f"max|out-ref| {err:.3e} (bound {bound:.3g}, max|ref| {peak:.2f}); equal to the "
            f"unsharded map's rows bit for bit: {same}")
    if not (err <= bound and same):
        fail(line)
    flops = 2.0 * n * rows * w * 9 * cin * cout
    k_ms, p_ms = timed_pair(halo_conv, lambda: conv3x3_reference(xh, weight)[:, :, 1:-1], 10)
    lib_ms = median_ms(lambda: F.conv2d(xh, weight, padding=(0, 1)), 10)
    bound_ms, bound_by = roofline(flops, (xh.numel() + weight.numel() + out.numel()) * 2)
    conv_results.append({"shape": [n, cin, rows + 2, w, cout], "dtype": "bfloat16",
                         "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                         "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by})
    log(line + f"; kernel (SAME on the frame, 2 rows dropped) {k_ms:.3f} ms, plain "
        f"{p_ms:.3f} ms, F.conv2d VALID over H {lib_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}) for the kept rows ({smi})")

    xq, sx = quantize_symmetric(xh, (1, 2, 3))  # the scale is the halo'd shard's
    sx = sx.reshape(-1)
    wq, sw = weight_codes(weight)

    def halo_s8():
        return tap_gemm_s8(xq, wq, sx, sw, bias, torch.bfloat16)[:, :, 1:-1]

    out = halo_s8()
    ref = tap_gemm_s8_reference(xq, wq, sx, sw, bias, torch.bfloat16)[:, :, 1:-1]
    op = conv3x3_w8a8(xh, weight, bias, padding=VALID_ROWS)
    err = (out.float() - ref.float()).abs().max().item()
    same = torch.equal(out, op)
    line = (f"14k conv3x3_s8 bf16 out halo'd x{tuple(xh.shape)} -> {cout}: max|kernel - plain| "
            f"{err:g} (bound 0: the same codes); conv3x3_w8a8(padding=VALID_ROWS) equal: {same}")
    if not (err == 0 and same):
        fail(line)
    k_ms, p_ms = timed_pair(halo_s8, lambda: tap_gemm_s8_reference(
        xq, wq, sx, sw, bias, torch.bfloat16)[:, :, 1:-1], 10)
    nbytes = xq.numel() + wq.numel() + out.numel() * 2 + 4 * (sx.numel() + sw.numel() + cout)
    bound_ms, bound_by = roofline(flops, nbytes, "int8")
    s8_results.append({"shape": [n, cin, rows + 2, w, cout], "dtype": "bfloat16",
                       "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                       "bound_ms": bound_ms, "bound_by": bound_by})
    log(line + f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}) ({smi})")
    del x, xh, weight, xq, wq, out, ref, op, whole
    torch.cuda.empty_cache()


def sp_comm_expected(forwards, applies, updates):
    """The sp collectives' calls of ``forwards`` sharded UNet forwards (remat
    recomputes included) in ``applies`` applies, and ``updates`` backwards."""
    want = {k: v * (applies if k == "gather_out" else forwards)
            for k, v in SP_PER_UNET_FORWARD.items()}
    want.update({f"{k}.bwd": v * updates for k, v in SP_PER_UNET_BACKWARD.items()})
    return want


def phase_sp_ranks(unet_gn, vae_gn, unet_conv, smi):
    """14a: one DDPO epoch on two ranks of one sp group (spatial mode);
    14b/14c: ddpo_torch.bench.sp_check, the sharded UNet's eps and an
    update's gradients against the unsharded ones, in both modes."""
    import numpy as np
    import torch

    from ddpo_torch.pipelines import policy_gradient

    torch.cuda.empty_cache()
    args = policy_gradient.Parser().parse_args("pg", list(PHASE14_ARGV), setup=False)
    steps, n_sample = args.n_inference_steps, args.num_sample_batches_per_epoch
    num_ts = int(steps * args.train_timestep_ratio)
    n_updates = args.sample_batch_size * n_sample // args.train_batch_size * num_ts
    forwards = steps * n_sample + 2 * n_updates  # sampler + trainer forward and remat
    log(f"14: two ranks, one sp group (dp 1 x sp 2, --sp_mode spatial) on one card, "
        f"--dataset compressed-animals at SD-1.4 width, sample batch {args.sample_batch_size}, "
        f"train batch {args.train_batch_size}, {steps} steps, CFG {args.guidance_scale}; cut: "
        f"--train_timestep_ratio {args.train_timestep_ratio} ({n_updates} updates)")
    want = expected(
        flash_fwd=FLASH_PER_SP_FORWARD * forwards,
        flash_bwd_dq=FLASH_PER_SP_FORWARD * n_updates,
        flash_bwd_dkv=FLASH_PER_SP_FORWARD * n_updates,
        gn_stats=unet_gn * forwards + vae_gn * n_sample,
        conv3x3=unet_conv * forwards,
    )
    want_comm = sp_comm_expected(forwards, steps * n_sample + n_updates, n_updates)
    work = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               DDPO_BUCKET=os.path.join(work, "bucket"))
    marks = [("start", time.perf_counter())]
    cwd = os.path.join(work, "host")
    outs, wall = run_ranks("14a", PHASE14_ARGV, cwd, env, timeout=480)
    marks.append(("14a", time.perf_counter()))

    rewards = rank_values(outs, r"epoch (\d+) mean reward: (\S+)")
    noise = rank_values(outs, r"initial noise digest (\w+)")
    digests = rank_values(outs, r"epoch (\d+) params digest (\w+)")
    modes = rank_values(outs, r"(sp=2 spatial)")
    samples = rank_values(outs, r"sample batch \d+: \d+ samples in (\S+)s", float)
    updates = rank_values(outs, r"epoch 0\.0: .*\| (\S+)s, (\S+) s an update \((\d+)\)")
    reduces = rank_values(outs, r"gradient all-reduce \((\w+), (\w+)\): (\d+) calls, (\d+) bytes "
                                r"each, seconds (.*)")
    ends = rank_values(outs, r"rank (\d+): peak memory (\S+) GiB \| kernel launches (\{.*\})")
    comms = rank_values(outs, r"rank \d+: sp collectives \(calls, bytes, seconds\) (\{.*\})",
                        json.loads)
    if rewards[0] != rewards[1] or len(rewards[0]) != 1:
        fail(f"14a: the sp ranks' rewards differ: {rewards}")
    if digests[0] != digests[1] or len(digests[0]) != 1:
        fail(f"14a: the sp ranks' parameter digests differ: {digests}")
    if noise[0] != noise[1] or len(noise[0]) != 1:
        fail(f"14a: the sp ranks of one dp slice must draw the same noise: {noise}")
    if not all(modes) or not all(len(c) == 1 for c in comms) or not all(len(e) == 1 for e in ends):
        fail(f"14a: a rank did not run the spatial mode or print its collectives and launches")
    found = glob.glob(os.path.join(cwd, "logs", "**", "train_info", "0_0_0.npy"), recursive=True)
    if len(found) != 1:
        fail(f"14a: expected one train_info/0_0_0.npy under {cwd}/logs, found {found}")
    infos = np.load(found[0], allow_pickle=True).item()
    first_dlogp = (2.0 * args.train_batch_size * num_ts * infos["approx_kl"][0]) ** 0.5
    log(f"14a: first minibatch (2B = {2 * args.train_batch_size} sharded against the "
        f"sampler's 2B = {2 * args.sample_batch_size} sharded) approx_kl "
        f"{infos['approx_kl'][0]:.3e}, clipfrac {infos['clipfrac'][0]:.3f}, max|dlogp| <= "
        f"{first_dlogp:.3e} (bound 1e-5)")
    if not (first_dlogp <= 1e-5 and infos["clipfrac"][0] == 0.0):
        fail("14a: the first minibatch's recompute is off-policy")
    log(f"14a: rewards {rewards[0]}, params digests {digests[0]}, initial noise digests "
        f"{noise[0]} (equal on both sp ranks) ({smi})")
    for rank in range(2):
        comm = comms[rank][0]
        calls = {k: v[0] for k, v in comm.items() if not k.startswith("shard_in")}
        if calls != want_comm:
            fail(f"14a: rank {rank} made the collectives {calls}, expected {want_comm}")
        per_fwd = {k: (SP_PER_UNET_FORWARD[k], comm[k][1] / comm[k][0] * SP_PER_UNET_FORWARD[k],
                       comm[k][2] / comm[k][0] * SP_PER_UNET_FORWARD[k])
                   for k in SP_PER_UNET_FORWARD}
        fwd_bytes = sum(b for _, b, _ in per_fwd.values())
        fwd_secs = sum(sec for _, _, sec in per_fwd.values())
        bwd = {k: v for k, v in comm.items() if k.endswith(".bwd")}
        log(f"14a rank {rank}: collectives a UNet forward (calls, bytes this rank put in, s) "
            + ", ".join(f"{k} {c} / {b:.0f} B / {sec:.5f} s" for k, (c, b, sec) in per_fwd.items())
            + f"; in all {sum(c for c, _, _ in per_fwd.values())} calls, {fwd_bytes:.0f} B, "
            f"{fwd_secs:.4f} s a forward (means over the epoch's {forwards} forwards: sampler "
            f"steps at 2B = {2 * args.sample_batch_size}, the trainer's forward and remat at 2B "
            f"= {2 * args.train_batch_size}); the backwards' over {n_updates} updates "
            f"(calls, bytes, s) {bwd} ({smi})")
        step_ms = 1e3 * samples[rank][0] / steps
        _, per_update, n = updates[rank][0]
        _, dtype, red_calls, nbytes, secs = reduces[rank][0]
        log(f"14a rank {rank}: sampler {samples[rank][0]:.2f} s for {steps} steps = "
            f"{step_ms:.1f} ms a sampler UNet step (the batch's VAE decode and collectives "
            f"included); "
            f"{per_update} s an update ({n}); gradient all-reduce ({dtype}) {red_calls} calls of "
            f"{int(nbytes)} bytes, seconds {secs}; peak memory {ends[rank][0][1]} GiB ({smi})")
        launched = json.loads(ends[rank][0][2])
        log(f"14a rank {rank}: launches {launched}, expected {want}")
        if launched != want:
            fail(f"14a: rank {rank} launched {launched}, expected {want}")
    log(f"14a: {wall:.1f} s from launch to exit ({smi})")

    outs, wall = run_ranks("14b", [], os.path.join(work, "check"), env, timeout=300,
                           module="ddpo_torch.bench.sp_check")
    marks.append(("14b+c", time.perf_counter()))
    reports = rank_values(outs, r"^SP_CHECK (\{.*\})$", json.loads)
    if not all(len(r) == 1 for r in reports):
        fail("14b: a rank printed no SP_CHECK line")
    for rank, (rep,) in enumerate(reports):
        for mode, tag in (("spatial", "14b"), ("attention", "14c")):
            m = rep[mode]
            flash = m["launches_forward"].get("flash_fwd", 0)
            log(f"{tag} rank {rank} ({mode}, 2B = {rep['batch_2B']}, bf16, batch_invariant()): "
                f"eps max|d| {m['eps_max_rel']:.3e} of max|eps|, an update's gradients max|d| "
                f"{m['grads_max_rel']:.3e} of max|g| (bound 2^-6 = {2 ** -6:g}); a forward "
                f"{m['forward_ms']:.2f} ms sharded against {rep['unsharded_forward_ms']:.2f} ms "
                f"unsharded (both ranks on the one card); flash_fwd {flash} a forward; "
                f"collectives a forward {m['comm_forward']} ({smi})")
            if "module_table" in m:
                differ = {k: v["differ"] for k, v in m["module_table"].items() if v["differ"]}
                log(f"{tag} rank {rank}: module families whose bits for sample 0 differ at the "
                    f"trainer's 2B = 2 from the sampler's 2B = {rep['batch_2B']}: {differ}")
            if not m["passed"] or flash != FLASH_PER_SP_FORWARD:
                fail(f"{tag}: rank {rank} {mode}: {m}")
    shutil.rmtree(work, ignore_errors=True)
    log("phase 14 wall: " + ", ".join(f"{name} {t - marks[i][1]:.1f} s"
                                      for i, (name, t) in enumerate(marks[1:])))


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
    started = time.perf_counter()
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
    serving_counts, serving_ips, _, serving_images = phase_serving(unet_gn, vae_gn)
    rollout = phase_rollout()
    init_params, _ = phase_onpolicy(rollout, unet_gn)
    phase_batch_invariance(rollout[0])
    del rollout
    counts, full_update_s = phase_train(init_params, unet_gn, vae_gn, unet_conv)
    phase_lora(unet_gn, vae_gn, unet_conv, full_update_s)
    conv_counts, _ = phase_conv_path(unet_gn, vae_gn, unet_conv, vae_conv)
    phase_rwr(unet_gn, vae_gn)
    phase_checkpoints(serving_images, serving_counts)
    s8_results, s8_counts = phase_serving_extras(unet_gn, vae_gn, serving_ips[-1], smi)
    shutil.rmtree(bucket, ignore_errors=True)
    del serving_images
    phase_ddpo_ranks(unet_gn, vae_gn, unet_conv, smi)
    check_sp_kernels(flash_results, bwd_results, conv_results, s8_results, smi)
    phase_sp_ranks(unet_gn, vae_gn, unet_conv, smi)

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
    s8_main = headline(s8_results, [8, 320, 64, 64, 320])
    kernels.append({
        "name": "conv3x3_s8", "route": "cuda", "source": "ddpo_torch/csrc/conv3x3_s8.cu",
        "replaces": "ddpo_tpu/ops/quant.py:80", "launches": s8_counts["conv3x3_s8"],
        "max_abs_err": max(r["max_abs_err"] for r in s8_results), **timing(s8_main)})
    if any(k["launches"] <= 0 for k in kernels):
        fail(f"a kernel was never launched on its path: {[k['name'] for k in kernels]}")
    log("kernels: launches are the DDPO phase's for the four kernels of the default path, "
        "the op-level path's for gn_silu, the serving phase's with the conv switch on for "
        "conv3x3, conv_probe.main's for the probes and phase 12b's DDIM-50 int8 generate's "
        "for conv3x3_s8 (an XLA op in JAX, no Pallas kernel; no one PyTorch call computes "
        "it, so its library_ms is null); a backward kernel's plain_ms and "
        "library_ms are the whole backward (dq, dk and dv); times at the headline shapes: "
        "flash (8, 4096, 8, 40) and (4, 4096, 8, 40), GroupNorm (8, 320, 64, 64), conv "
        "(8, 320, 64, 64) -> 320 and the probes' (16, 320, 64, 64) -> 320, bf16 (the s8 "
        "conv: int8 codes in, bf16 out); max_abs_err over every case, phase 14k's sp shapes "
        "included")
    log(f"chip_smoke wall: {time.perf_counter() - started:.1f} s ({smi})")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
