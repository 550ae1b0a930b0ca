"""The sp and tp mesh axes against the unsharded UNet, one forward and one update.

Run as the ranks of one sp group (dp = 1), which are then the ranks of one
tp group: one launch for the three modes below, against one set of
unsharded references, e.g. two ranks on one card:

    torchrun --nproc_per_node 2 -m ddpo_torch.bench.sp_check
    python -m torch.distributed.run --nproc_per_node 2 -m ddpo_torch.bench.sp_check \\
        --device cpu --preset tiny --resolution 64

Every rank builds the same UNet from a seed (SD-1.4 width by default) and
the same inputs, then, at the sampler's setting (no grad, inside
``ops.invariance.batch_invariant()``, the DDPO driver's):

  spatial   (``--sp_mode spatial``, parallel/spatial.py): one sampler UNet
            call at 2B = 4 against the unsharded UNet's eps;
            then one update's gradients (the trainer's apply over fp32
            masters, remat, CFG as one 2B apply, loss mean(eps^2) at
            2B = 2), reduced as the driver reduces them, against the
            unsharded gradients;
  attention (``--sp_mode attention``, parallel/sequence.py): the same two;
  tp        (``--mesh_tp``: parallel/sharding.py and
            parallel/tensor.py): the same two, with each rank's slices of
            the gradients gathered (``gather_state_dict``) before the
            comparison. The row-parallel partials (bf16 in the bf16 run)
            are summed in fp32, the bias added, and the total rounded to
            the input dtype (parallel/tensor.py).

Each comparison runs twice, and two gates decide it, for eps and for the
gradients alike:

  (a) the sharding logic, at fp32 (the fp32 UNet, the trainer's apply at
      fp32, TF32 off as ``resolve_device`` sets it): max|sharded -
      unsharded| <= 2^-12 of max|unsharded|;
  (b) the bf16 path (the sampler's bf16 UNet, the trainer's apply at bf16
      over the same masters) against the unsharded fp32 result of (a): the
      sharded run's error, over max|ref|, may be at most 1.5 times the
      unsharded bf16 run's in its maximum and 1.1 times in its RMS. Sharding
      may add no error beyond what bf16 makes.

The bf16-to-bf16 maximum, max|sharded - unsharded| over max|unsharded| at
bf16, is printed beside 2^-6 as before; it is no gate (bf16 rounding noise
of two paths that sum in different orders). In the spatial mode
the sharded UNet's module table (bench/batch_invariance.py
``module_table``: each leaf module recomputed on the rows of the trainer's
first minibatch, [uncond; cond] of sample 0) says which op families give a
sample other bits at the trainer's 2B than at the sampler's. Printed per mode: the
collectives of one forward and of one update by kind (calls, bytes this
rank put in, seconds: staging and the collective, with the wait for the
other rank), the kernel launches of one bf16 forward, the median ms of a
bf16 forward beside the unsharded one's, and the three parameter tensors
with the largest shares of the bf16 gradients' squared error against
fp32, sharded and unsharded; per rank, the peak device memory and the
launch's timeline as the DDPO driver prints it (the process's age at
``main``, the start-up's parts, the checks' seconds, the wall clock at the
return). Each error is printed over max|ref| and as it is (absolute). The
last line is ``SP_CHECK <json>``.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import statistics
import sys
import time
from typing import Dict

import torch

from ddpo_torch.bench.batch_invariance import format_table, minibatch_rows, module_table
from ddpo_torch.ops import _build
from ddpo_torch.ops.attention import set_attention_sharding
from ddpo_torch.ops.invariance import batch_invariant
from ddpo_torch.ops.spatial import comm_counts, reset_comm, shard_rows
from ddpo_torch.parallel import (
    MeshConfig,
    create_mesh,
    destroy_distributed,
    maybe_initialize_distributed,
    process_count,
)
from ddpo_torch.parallel.sharding import TensorParallel, param_specs
from ddpo_torch.parallel.spatial import make_spatial_unet_apply
from ddpo_torch.pipelines.policy_gradient import gradient_reduce, make_train_apply
from ddpo_torch.utils.profiling import StepTimer, launch_timeline, process_seconds
from ddpo_torch.utils.serialization import build_models, init_weights_, resolve_device

FP32_BOUND = 2.0 ** -12  # (a): sharded against unsharded at fp32, of max|ref|
MAX_RATIO = 1.5  # (b): the sharded bf16 run's error maximum over the unsharded one's
RMS_RATIO = 1.1  # (b): the same for the errors' RMS
OLD_BOUND = 2.0 ** -6  # printed beside the bf16-to-bf16 maximum, which is no gate
BATCH = 2  # samples: the sampler's UNet call sees 2B = 4, the rollout's of phase 14a
ITERS = 3  # timed forwards


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_ms(fn, device, iters: int) -> float:
    fn()
    times = []
    for _ in range(iters):
        _sync(device)
        start = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def error_stats(got, ref) -> Dict[str, float]:
    """{"max": max|got - ref|, "rms": the RMS of got - ref}, each over
    max|ref|, and the same two as they are ("abs_max", "abs_rms"); over one
    tensor or, pooled, over a dict of them."""
    if not isinstance(ref, dict):
        got, ref = {"": got}, {"": ref}
    peak = max(r.abs().max().item() for r in ref.values())
    worst, squares, count = 0.0, 0.0, 0
    for key, r in ref.items():
        d = got[key].float() - r.float()
        worst = max(worst, d.abs().max().item())
        squares += d.double().square().sum().item()
        count += d.numel()
    rms = math.sqrt(squares / count)
    return {"max": worst / peak, "rms": rms / peak, "abs_max": worst, "abs_rms": rms}


def largest_shares(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], n: int = 3):
    """The n tensors of a dict with the largest shares of the summed squared
    error of got - ref: [(name, share)], largest first."""
    squares = {k: (got[k].float() - r.float()).double().square().sum().item()
               for k, r in ref.items()}
    total = sum(squares.values()) or 1.0
    return sorted(((k, round(v / total, 4)) for k, v in squares.items()),
                  key=lambda kv: -kv[1])[:n]


def fp32_gate(stats: Dict[str, float]) -> bool:
    """(a): the sharded fp32 result within 2^-12 of the unsharded one."""
    return stats["max"] <= FP32_BOUND


def bf16_gate(sharded: Dict[str, float], unsharded: Dict[str, float]) -> bool:
    """(b): against the same fp32 reference, the sharded bf16 run's error
    no larger than the unsharded bf16 run's, by MAX_RATIO in its maximum
    and RMS_RATIO in its RMS."""
    return (sharded["max"] <= MAX_RATIO * unsharded["max"]
            and sharded["rms"] <= RMS_RATIO * unsharded["rms"])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--preset", default="sd14")
    parser.add_argument("--resolution", type=int, default=512)
    args = parser.parse_args(argv)
    entered = time.perf_counter()
    before_main = process_seconds()  # the interpreter and the imports
    boot = StepTimer()
    with boot.phase("gloo_group"):
        maybe_initialize_distributed()
    device = resolve_device(args.device)
    if device.type == "cuda":
        with boot.phase("cuda_context"):
            torch.zeros(1, device=device)
    # the same ranks as one sp group, then as one tp group
    n = process_count()
    with boot.phase("gloo_group"):
        sp_mesh = create_mesh(MeshConfig(sp=n, tp=1), device)
        tp_mesh = create_mesh(MeshConfig(sp=1, tp=n), device)
    rank = sp_mesh.sp_index
    with boot.phase("models"):
        _, _, unet = build_models(args.preset, device)
        init_weights_(unet, torch.Generator(device=device).manual_seed(0))
    with boot.phase("sampler_copy"):
        sample_unet = copy.deepcopy(unet).to(torch.bfloat16).requires_grad_(False)
    checks_start = time.perf_counter()
    unet.requires_grad_(True)
    params = dict(unet.named_parameters())

    gen = torch.Generator(device=device).manual_seed(1)
    h = args.resolution // 8
    ctx_dim = unet.config.cross_attention_dim
    x = torch.randn((2 * BATCH, 4, h, h), generator=gen, device=device)
    t = torch.full((2 * BATCH,), 500, device=device)
    ctx = torch.randn((2 * BATCH, 77, ctx_dim), generator=gen, device=device)
    xt, tt, ct = x[:2], torch.tensor([500, 500], device=device), ctx[:2]

    def update(apply, spatial: bool, mesh, params=params, layout=None):
        """One update's gradients at 2B = 2, reduced as the driver does
        (under tp, each rank's slices gathered into the whole)."""
        loss = apply(params, xt, tt, ct).square().mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = {k: g for k, g in zip(params, grads)}
        reduce = gradient_reduce(mesh, spatial, None, "gloo")
        grads = reduce(grads) if reduce is not None else grads
        return grads if layout is None else layout.gather(grads)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with batch_invariant():
        with torch.no_grad():
            eps_ref = sample_unet(x, t, ctx)
            eps32_ref = unet(x, t, ctx)
        plain_ms = _median_ms(lambda: sample_unet(x, t, ctx), device, ITERS)
        grads_ref = update(make_train_apply(unet, torch.bfloat16, remat=True), False, sp_mesh)
        grads32_ref = update(make_train_apply(unet, torch.float32, remat=True), False, sp_mesh)
    # the unsharded bf16 run's error against the fp32 reference: (b)'s yardstick
    unsharded = {"eps": error_stats(eps_ref, eps32_ref), "grads": error_stats(grads_ref, grads32_ref)}

    report = {"rank": rank, "sp": sp_mesh.sp, "batch_2B": 2 * BATCH,
              "unsharded_forward_ms": plain_ms, "bf16_unsharded": unsharded,
              "bounds": {"fp32": FP32_BOUND, "max_ratio": MAX_RATIO, "rms_ratio": RMS_RATIO,
                         "old_bf16": OLD_BOUND}}
    ok = True
    for mode in ("spatial", "attention", "tp"):
        update_params, layout = params, None
        mesh = tp_mesh if mode == "tp" else sp_mesh
        if device.type == "cuda":
            torch.cuda.empty_cache()  # the last mode's blocks, before tp's copies
        if mode == "tp":
            axis = mesh.axis("tp")
            layout = TensorParallel(axis, param_specs(params))
            apply = copy.deepcopy(sample_unet).set_tensor_parallel(axis)
            apply32 = copy.deepcopy(unet).set_tensor_parallel(axis)
            update_params = dict(apply32.named_parameters())
            train_apply, train_apply32 = (make_train_apply(apply32, dtype, remat=True)
                                          for dtype in (torch.bfloat16, torch.float32))
        elif mode == "spatial":
            apply = make_spatial_unet_apply(mesh, sample_unet)
            apply32 = make_spatial_unet_apply(mesh, unet)
            train_apply, train_apply32 = (
                make_train_apply(unet, dtype, remat=True, spatial=mesh.axis())
                for dtype in (torch.bfloat16, torch.float32))
        else:
            sample_unet.set_spatial(None)
            unet.set_spatial(None)
            set_attention_sharding(mesh, batch_axis="dp", seq_axis="sp")
            apply, apply32 = sample_unet, unet
            train_apply, train_apply32 = (make_train_apply(unet, dtype, remat=True)
                                          for dtype in (torch.bfloat16, torch.float32))
        with batch_invariant():
            _build.reset_launch_counts()
            reset_comm()
            with torch.no_grad():
                eps = apply(x, t, ctx)
            _sync(device)
            launches = {k: v for k, v in _build.launch_counts().items() if v}
            fwd_comm = comm_counts()
            ms = _median_ms(lambda: apply(x, t, ctx), device, ITERS)
            reset_comm()
            grads = update(train_apply, mode == "spatial", mesh, update_params, layout)
            upd_comm = comm_counts()
            table = None
            if mode == "spatial":
                rows = minibatch_rows(BATCH, [0])
                with torch.no_grad():
                    table = module_table(sample_unet, shard_rows(x, mesh.axis(), 2), t, ctx, rows)
            with torch.no_grad():
                eps32 = apply32(x, t, ctx)
            grads32 = update(train_apply32, mode == "spatial", mesh, update_params, layout)
        set_attention_sharding(None)
        fp32 = {"eps": error_stats(eps32, eps32_ref), "grads": error_stats(grads32, grads32_ref)}
        sharded = {"eps": error_stats(eps, eps32_ref), "grads": error_stats(grads, grads32_ref)}
        err, gerr = error_stats(eps, eps_ref)["max"], error_stats(grads, grads_ref)["max"]
        # where the bf16 gradients' squared error against fp32 sits, sharded
        # and unsharded: what (b)'s RMS ratio reads
        shares = {"sharded": largest_shares(grads, grads32_ref),
                  "unsharded": largest_shares(grads_ref, grads32_ref)}
        del grads, grads32
        finite = bool(torch.isfinite(eps).all()) and bool(torch.isfinite(eps32).all())
        passed = finite and all(fp32_gate(fp32[k]) and bf16_gate(sharded[k], unsharded[k])
                                for k in ("eps", "grads"))
        ok = ok and passed
        report[mode] = {"eps_max_rel": err, "grads_max_rel": gerr, "fp32": fp32,
                        "bf16_sharded": sharded, "grads_error_shares": shares,
                        "finite": finite, "forward_ms": ms,
                        "launches_forward": launches, "comm_forward": fwd_comm,
                        "comm_update": upd_comm, "passed": passed}
        if table is not None:
            report[mode]["module_table"] = table
            print(f"[ sp_check ] rank {rank} {mode}: module families whose bits for sample 0 "
                  f"differ at 2B = 2 from 2B = {2 * BATCH}:\n{format_table(table)}",
                  flush=True)
        for key in ("eps", "grads"):
            a, s, u = fp32[key], sharded[key], unsharded[key]
            print(f"[ sp_check ] rank {rank} {mode} {key}: (a) fp32 sharded against "
                  f"unsharded max|d| {a['max']:.3e} of max|ref| (bound 2^-12 = "
                  f"{FP32_BOUND:.3e}): {fp32_gate(a)}; (b) bf16 against the fp32 reference, "
                  f"sharded max {s['max']:.3e} rms {s['rms']:.3e}, unsharded max "
                  f"{u['max']:.3e} rms {u['rms']:.3e}, ratios {s['max'] / u['max']:.3f} "
                  f"(bound {MAX_RATIO}) and {s['rms'] / u['rms']:.3f} (bound {RMS_RATIO}): "
                  f"{bf16_gate(s, u)}; bf16 sharded against bf16 unsharded max|d| "
                  f"{err if key == 'eps' else gerr:.3e} (2^-6 = {OLD_BOUND:g}, not a gate)",
                  flush=True)
            print(f"[ sp_check ] rank {rank} {mode} {key}: absolute errors, bf16 sharded max "
                  f"{s['abs_max']:.4e} rms {s['abs_rms']:.4e}, unsharded max {u['abs_max']:.4e} "
                  f"rms {u['abs_rms']:.4e}; fp32 sharded against unsharded max "
                  f"{a['abs_max']:.4e}", flush=True)
        print(f"[ sp_check ] rank {rank} {mode}: the bf16 gradients' largest shares of the "
              f"squared error against fp32: {shares}", flush=True)
        print(f"[ sp_check ] rank {rank} {mode}: max|eps| {eps_ref.abs().max().item():.3f}; "
              f"finite {finite}; passed {passed}; forward {ms:.2f} ms against unsharded "
              f"{plain_ms:.2f} ms; launches a forward {launches}; collectives a forward "
              f"{fwd_comm}, an update {upd_comm}", flush=True)
    report["ok"] = ok
    if device.type == "cuda":
        report["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        print(f"[ sp_check ] rank {rank}: peak memory {report['peak_gib']:.2f} GiB", flush=True)
    timeline = launch_timeline(entered, before_main, boot, checks_start, time.perf_counter())
    print(f"[ sp_check ] rank {rank}: launch timeline (s) {json.dumps(timeline)}", flush=True)
    print("SP_CHECK " + json.dumps(report, sort_keys=True), flush=True)
    return report


if __name__ == "__main__":
    result = main()
    destroy_distributed()
    sys.exit(0 if result["ok"] else 1)
