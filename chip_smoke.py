#!/usr/bin/env python3
"""Drive the PyTorch port (ddpo_torch) on one NVIDIA GPU, end to end.

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit, torch and CUDA versions.
  2. build: nvcc builds ddpo_torch/csrc/*.cu for sm_90a.
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes, with the bound stated, plus kernel and plain times.
  4. serving: ddpo_torch.pipelines.generate.main at SD-1.4 width, 512 px,
     50 CFG DDIM steps, 4 images, random weights from a seed; checks the
     images and that the path launched each kernel the expected number of
     times.
  5. rollout: sample_trajectories at batch 4 (the DDPO sampling phase) and
     a score-mode recompute of step 0's log-prob.

The line before the last is one JSON object describing the kernels; the
last line is {"ok": true, "device": {...}}. With no CUDA device, or run
outside the repository, it fails before printing any result.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

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


def phase_build():
    from ddpo_torch.ops import _build

    kl = _build.load_library()
    log(f"built {os.path.relpath(kl.path, REPO)} in {kl.build_seconds:.1f} s")
    lines = kl.log.splitlines()
    regs = [int(l.split("Used ")[1].split()[0]) for l in lines if "Used " in l and "registers" in l]
    spills = sorted({l.strip() for l in lines
                     if "spill" in l and "0 bytes spill stores, 0 bytes spill loads" not in l})
    log(f"ptxas: {len(regs)} kernels, {min(regs, default=0)}..{max(regs, default=0)} "
        f"registers per thread; spills: {spills or 'none'} (full log: {kl.path}.log)")
    return kl


def check_flash(results):
    import torch

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
            if sq == sk and b == 8:
                iters = 10 if sq == 4096 else 30
                k_ms, p_ms = timed_pair(lambda: flash_attention_fwd(q, k, v),
                                        lambda: attention_reference(q, k, v), iters)
                flops = 4.0 * b * h * sq * sk * d
                entry.update(ms=k_ms, plain_ms=p_ms)
                line += (f"; kernel {k_ms:.3f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), "
                         f"plain {p_ms:.3f} ms")
            log(line)
            results.append(entry)
            del q, k, v, out, lse, ref, ref_lse
            torch.cuda.empty_cache()


def check_gn_stats(results):
    import torch

    from ddpo_torch.ops.groupnorm import group_stats, group_stats_reference, num_groups_for

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
    for dtype in (torch.bfloat16, torch.float32):
        for shape in cases:
            if dtype == torch.float32 and shape not in (cases[0], cases[-1], cases[-2]):
                continue
            x = (torch.randn(shape, generator=gen, device="cuda") + 0.3).to(dtype)
            g = num_groups_for(shape[1], 32)
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
            line = (f"gn_stats {name} {tuple(shape)} g{g}: max abs err of E[x], E[x^2] "
                    f"vs float64 {err:.3e}; of the sums relative to sum|x| {rel:.3e} "
                    f"(bound {bound:g}); deterministic")
            if not rel <= bound:
                fail(line)
            entry = {"shape": list(shape), "dtype": name, "max_abs_err": err,
                     "max_rel_err": rel}
            if dtype == torch.bfloat16:
                k_ms, p_ms = timed_pair(lambda: group_stats(x, g),
                                        lambda: group_stats_reference(x, g), 20)
                gbs = x.numel() * x.element_size() / k_ms / 1e6
                entry.update(ms=k_ms, plain_ms=p_ms)
                line += f"; kernel {k_ms:.4f} ms ({gbs:.0f} GB/s), plain {p_ms:.4f} ms"
            log(line)
            results.append(entry)
            del x
            torch.cuda.empty_cache()


def count_group_norms():
    from ddpo_torch.models.layers import GroupNorm
    from ddpo_torch.utils.serialization import build_models

    _, vae, unet = build_models("sd14", "meta")
    return (sum(isinstance(m, GroupNorm) for m in unet.modules()),
            sum(isinstance(m, GroupNorm) for m in vae.decoder.modules()))


def phase_serving():
    import numpy as np
    import torch

    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import generate
    from ddpo_torch.utils.metrics import read_metrics

    unet_gn, vae_gn = count_group_norms()
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
    want = {"flash_fwd": FLASH_PER_UNET_FORWARD * steps * sampler_calls,
            "gn_stats": unet_gn * steps * sampler_calls + vae_gn * decode_calls}
    log(f"launches {counts}, expected {want} "
        f"(UNet GroupNorms {unet_gn}, VAE decoder GroupNorms {vae_gn})")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")
    events = read_metrics(result.outdir)
    ips = [e["images_per_sec"] for e in events if e.get("phase") == "generate"]
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
    flash_results, gn_results = [], []
    check_flash(flash_results)
    check_gn_stats(gn_results)
    counts, _, _ = phase_serving()
    phase_rollout()

    def headline(results, shape):
        return next(r for r in results if r["shape"] == shape and r["dtype"] == "bfloat16")

    flash_main = headline(flash_results, [8, 4096, 4096, 8, 40])
    gn_main = headline(gn_results, [8, 320, 64, 64])
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": "ddpo_torch/csrc/flash_fwd.cu",
         "replaces": "ddpo_tpu/ops/attention.py:58", "launches": counts["flash_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in flash_results),
         "ms": flash_main["ms"], "plain_ms": flash_main["plain_ms"]},
        {"name": "gn_stats", "route": "cuda", "source": "ddpo_torch/csrc/gn_stats.cu",
         "replaces": "ddpo_tpu/ops/groupnorm.py:126", "launches": counts["gn_stats"],
         "max_abs_err": max(r["max_abs_err"] for r in gn_results),
         "ms": gn_main["ms"], "plain_ms": gn_main["plain_ms"]},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
