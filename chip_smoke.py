#!/usr/bin/env python3
"""Drive the PyTorch port (ddpo_torch) on one NVIDIA GPU, end to end.

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit, torch and CUDA versions.
  2. build: nvcc builds ddpo_torch/csrc/*.cu for sm_90a.
  3. kernels: each forward kernel against its plain PyTorch version at the
     main path's shapes, with the bound stated, plus kernel and plain times.
  3b. backward kernels: flash_bwd_dq and flash_bwd_dkv against the plain
     fp32 backward at the trainer's shapes (2B = 4), ragged lengths and
     D = 256, in bf16 and fp32; kernel times beside the plain backward's.
  4. serving: ddpo_torch.pipelines.generate.main at SD-1.4 width, 512 px,
     50 CFG DDIM steps, 4 images, random weights from a seed; checks the
     images and that the path launched each kernel the expected number of
     times.
  5. rollout: sample_trajectories at batch 4 (the DDPO sampling phase) and
     a score-mode recompute of step 0's log-prob.
  6. on-policy through the training code: ppo_loss on step 0 of that
     rollout, at its batch, with fp32 masters cast to bf16 at use, grad on
     and remat; the recomputed log-probs must equal the sampler's, and one
     backward must launch the expected kernels.
  7. DDPO: ddpo_torch.pipelines.policy_gradient.main, one epoch at the
     defaults of --dataset compressed-animals (sample batch 8, 50 steps,
     train batch 2, bf16 over fp32 masters, adamw), a full-state
     checkpoint, and a --resume call that trains no further epoch; checks
     the exact launch counts of all four kernels.

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


def check_flash_bwd(results):
    import torch

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
                flops = 2.0 * b * h * sq * sk * d  # one (Sq, Sk, D) product
                entry.update(dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=(p1 + p2) / 2,
                             wrapper_ms=wrap_ms, recompute_plain_ms=rec_ms)
                line += (f"; dq {dq_ms:.3f} ms ({3 * flops / dq_ms / 1e9:.1f} TFLOP/s), "
                         f"dkv {dkv_ms:.3f} ms ({4 * flops / dkv_ms / 1e9:.1f} TFLOP/s), "
                         f"plain backward (autograd through attention_reference) "
                         f"{entry['plain_ms']:.3f} ms; flash_attention_bwd {wrap_ms:.3f} ms "
                         f"against recompute + plain backward {rec_ms:.3f} ms")
                del leaves, ref_out, delta
            log(line)
            results.append(entry)
            del q, k, v, do, out, lse, grads, again, refs
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


def phase_serving(unet_gn, vae_gn):
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
    want = {"flash_fwd": FLASH_PER_UNET_FORWARD * steps * sampler_calls,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
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
    return models, embeds, uncond, traj


def phase_onpolicy(rollout, unet_gn):
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
    _build.reset_launch_counts()
    loss, info = ppo_loss(params, apply, data, models.scheduler, sched, True, 5.0, 1.0,
                          2e-4, cfg_concat=True)
    loss.backward()
    torch.cuda.synchronize()
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
    # one forward, its remat recompute and one backward
    want = {"flash_fwd": 2 * FLASH_PER_UNET_FORWARD, "flash_bwd_dq": FLASH_PER_UNET_FORWARD,
            "flash_bwd_dkv": FLASH_PER_UNET_FORWARD, "gn_stats": 2 * unet_gn}
    log(f"on-policy launches {counts}, expected {want}")
    if counts != want:
        fail(f"kernel launches {counts} != expected {want}")
    return {k: p.detach().cpu() for k, p in params.items()}


def phase_train(init_params, unet_gn, vae_gn):
    """One DDPO epoch at the compressed-animals defaults, then a resume."""
    import numpy as np
    import torch

    from ddpo_torch.native import build as native_build
    from ddpo_torch.ops import _build
    from ddpo_torch.pipelines import policy_gradient
    from ddpo_torch.utils import checkpoints
    from ddpo_torch.utils.metrics import read_metrics

    argv = ["--dataset", "compressed-animals", "--num_train_epochs", "1", "--seed", "0"]
    try:
        native_build.build()
    except RuntimeError as e:
        reason = next((l for l in str(e).splitlines() if "error" in l), str(e)[:200])
        log(f"the JPEG reward's native library does not build here ({reason.strip()}): "
            "this phase passes --filter_field mirror; the JPEG reward is held by the CPU "
            "tests only")
        argv += ["--filter_field", "mirror"]
    args = policy_gradient.Parser().parse_args("pg", list(argv))
    n_sample = args.num_sample_batches_per_epoch
    steps = args.n_inference_steps
    n_updates = (args.sample_batch_size * n_sample // args.train_batch_size) * int(
        steps * args.train_timestep_ratio)
    want = {
        # sampler: one 2B UNet call per step; trainer: forward + remat
        # recompute + backward per (minibatch, timestep)
        "flash_fwd": FLASH_PER_UNET_FORWARD * (steps * n_sample + 2 * n_updates),
        "flash_bwd_dq": FLASH_PER_UNET_FORWARD * n_updates,
        "flash_bwd_dkv": FLASH_PER_UNET_FORWARD * n_updates,
        "gn_stats": unet_gn * (steps * n_sample + 2 * n_updates) + vae_gn * n_sample,
    }

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    start = time.perf_counter()
    rewards = policy_gradient.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30

    localpath = "logs/" + args.savepath
    events = read_metrics(localpath)
    sample_ev = next(e for e in events if e.get("phase") == "sample")
    train_ev = next(e for e in events if e.get("phase") == "train")
    infos = np.load(os.path.join(localpath, "train_info", "0_0_0.npy"), allow_pickle=True).item()
    saved = dict(checkpoints.last_save)
    log(f"ddpo epoch ({args.filter_field} reward): {wall:.1f} s in all (model build "
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
    flash_results, bwd_results, gn_results = [], [], []
    check_flash(flash_results)
    check_flash_bwd(bwd_results)
    check_gn_stats(gn_results)
    unet_gn, vae_gn = count_group_norms()
    phase_serving(unet_gn, vae_gn)
    rollout = phase_rollout()
    init_params = phase_onpolicy(rollout, unet_gn)
    del rollout
    counts = phase_train(init_params, unet_gn, vae_gn)
    shutil.rmtree(bucket, ignore_errors=True)

    def headline(results, shape):
        return next(r for r in results if r["shape"] == shape and r["dtype"] == "bfloat16")

    flash_main = headline(flash_results, [8, 4096, 4096, 8, 40])
    bwd_main = headline(bwd_results, [4, 4096, 4096, 8, 40])
    gn_main = headline(gn_results, [8, 320, 64, 64])
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": "ddpo_torch/csrc/flash_fwd.cu",
         "replaces": "ddpo_tpu/ops/attention.py:58", "launches": counts["flash_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in flash_results),
         "ms": flash_main["ms"], "plain_ms": flash_main["plain_ms"]},
        {"name": "flash_bwd_dq", "route": "cuda", "source": "ddpo_torch/csrc/flash_bwd.cu",
         "replaces": "ddpo_tpu/ops/attention.py:177", "launches": counts["flash_bwd_dq"],
         "max_abs_err": max(r["max_abs_err_dq"] for r in bwd_results),
         "ms": bwd_main["dq_ms"], "plain_ms": bwd_main["plain_ms"]},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": "ddpo_torch/csrc/flash_bwd.cu",
         "replaces": "ddpo_tpu/ops/attention.py:211", "launches": counts["flash_bwd_dkv"],
         "max_abs_err": max(r["max_abs_err_dkv"] for r in bwd_results),
         "ms": bwd_main["dkv_ms"], "plain_ms": bwd_main["plain_ms"]},
        {"name": "gn_stats", "route": "cuda", "source": "ddpo_torch/csrc/gn_stats.cu",
         "replaces": "ddpo_tpu/ops/groupnorm.py:126", "launches": counts["gn_stats"],
         "max_abs_err": max(r["max_abs_err"] for r in gn_results),
         "ms": gn_main["ms"], "plain_ms": gn_main["plain_ms"]},
    ]
    log("kernels: launches are the DDPO phase's; a backward kernel's plain_ms is the "
        "whole plain backward (dq, dk and dv)")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
