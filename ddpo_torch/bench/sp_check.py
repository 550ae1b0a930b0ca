"""The sp mesh axis against the unsharded UNet, one forward and one update.

Run as the ranks of one sp group (dp = 1), e.g. two ranks on one card:

    torchrun --nproc_per_node 2 -m ddpo_torch.bench.sp_check
    python -m torch.distributed.run --nproc_per_node 2 -m ddpo_torch.bench.sp_check \\
        --device cpu --preset tiny --resolution 64

Every rank builds the same UNet from a seed (SD-1.4 width by default) and
the same inputs, then, in bf16 at the sampler's setting (no grad, inside
``ops.invariance.batch_invariant()``, the DDPO driver's):

  spatial   (``--sp_mode spatial``, parallel/spatial.py): one sampler UNet
            call at 2B = 4 against the unsharded UNet's eps;
            then one update's gradients (the trainer's apply over fp32
            masters cast to bf16, remat, CFG as one 2B apply, loss mean(eps^2)
            at 2B = 2), reduced as the driver reduces them, against the
            unsharded gradients;
  attention (``--sp_mode attention``, parallel/sequence.py): the same two.

Each comparison must hold max|d| <= 2^-6 max|ref|. In the spatial mode
the sharded UNet's module table (bench/batch_invariance.py
``module_table``: each leaf module recomputed on the rows of the trainer's
first minibatch, [uncond; cond] of sample 0) says which op families give a
sample other bits at the trainer's 2B than at the sampler's. Printed per mode: the
collectives of one forward and of one update by kind (calls, bytes this
rank put in, seconds: staging and the collective, with the wait for the
other rank), the kernel launches of one forward, and the median ms of a
forward beside the unsharded one's. The last line is ``SP_CHECK <json>``.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import time

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
from ddpo_torch.parallel.spatial import make_spatial_unet_apply
from ddpo_torch.pipelines.policy_gradient import gradient_reduce, make_train_apply
from ddpo_torch.utils.serialization import build_models, init_weights_, resolve_device

BOUND = 2.0 ** -6  # of max|ref|
BATCH = 2  # samples: the sampler's UNet call sees 2B = 4, the rollout's of phase 14a
ITERS = 5  # timed forwards


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


def _max_rel(got, ref) -> float:
    """max|got - ref| over max|ref|, over one tensor or a dict of them."""
    if isinstance(ref, dict):
        num = max((got[k].float() - r.float()).abs().max().item() for k, r in ref.items())
        return num / max(r.abs().max().item() for r in ref.values())
    return (got.float() - ref.float()).abs().max().item() / ref.abs().max().item()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--preset", default="sd14")
    parser.add_argument("--resolution", type=int, default=512)
    args = parser.parse_args(argv)
    maybe_initialize_distributed()
    device = resolve_device(args.device)
    mesh = create_mesh(MeshConfig(sp=process_count()), device)  # one sp group
    rank = mesh.sp_index
    _, _, unet = build_models(args.preset, device)
    init_weights_(unet, torch.Generator(device=device).manual_seed(0))
    sample_unet = copy.deepcopy(unet).to(torch.bfloat16).requires_grad_(False)
    unet.requires_grad_(True)
    params = dict(unet.named_parameters())

    gen = torch.Generator(device=device).manual_seed(1)
    h = args.resolution // 8
    ctx_dim = unet.config.cross_attention_dim
    x = torch.randn((2 * BATCH, 4, h, h), generator=gen, device=device)
    t = torch.full((2 * BATCH,), 500, device=device)
    ctx = torch.randn((2 * BATCH, 77, ctx_dim), generator=gen, device=device)
    xt, tt, ct = x[:2], torch.tensor([500, 500], device=device), ctx[:2]

    def update(apply, spatial: bool):
        """One update's gradients at 2B = 2, reduced as the driver does."""
        loss = apply(params, xt, tt, ct).square().mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = {k: g for k, g in zip(params, grads)}
        reduce = gradient_reduce(mesh, spatial, None, "gloo")
        return reduce(grads) if reduce is not None else grads

    with batch_invariant():
        with torch.no_grad():
            eps_ref = sample_unet(x, t, ctx)
        plain_ms = _median_ms(lambda: sample_unet(x, t, ctx), device, ITERS)
        grads_ref = update(make_train_apply(unet, torch.bfloat16, remat=True), False)

    report = {"rank": rank, "sp": mesh.sp, "batch_2B": 2 * BATCH,
              "unsharded_forward_ms": plain_ms}
    ok = True
    for mode in ("spatial", "attention"):
        if mode == "spatial":
            apply = make_spatial_unet_apply(mesh, sample_unet)
            train_apply = make_train_apply(unet, torch.bfloat16, remat=True, spatial=mesh.axis())
        else:
            sample_unet.set_spatial(None)
            unet.set_spatial(None)
            set_attention_sharding(mesh, batch_axis="dp", seq_axis="sp")
            apply = sample_unet
            train_apply = make_train_apply(unet, torch.bfloat16, remat=True)
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
            grads = update(train_apply, mode == "spatial")
            upd_comm = comm_counts()
            table = None
            if mode == "spatial":
                rows = minibatch_rows(BATCH, [0])
                with torch.no_grad():
                    table = module_table(sample_unet, shard_rows(x, mesh.axis(), 2), t, ctx, rows)
        set_attention_sharding(None)
        err, gerr = _max_rel(eps, eps_ref), _max_rel(grads, grads_ref)
        passed = err <= BOUND and gerr <= BOUND and bool(torch.isfinite(eps).all())
        ok = ok and passed
        report[mode] = {"eps_max_rel": err, "grads_max_rel": gerr, "forward_ms": ms,
                        "launches_forward": launches, "comm_forward": fwd_comm,
                        "comm_update": upd_comm, "passed": passed}
        if table is not None:
            report[mode]["module_table"] = table
            print(f"[ sp_check ] rank {rank} {mode}: module families whose bits for sample 0 "
                  f"differ at 2B = 2 from 2B = {2 * BATCH}:\n{format_table(table)}",
                  flush=True)
        print(f"[ sp_check ] rank {rank} {mode}: eps max|d| {err:.3e} of max|eps| "
              f"{eps_ref.abs().max().item():.3f}, gradients max|d| {gerr:.3e} of max|g| "
              f"(bound {BOUND:g}); forward {ms:.2f} ms against unsharded {plain_ms:.2f} ms; "
              f"launches a forward {launches}; collectives a forward {fwd_comm}, an update "
              f"{upd_comm}", flush=True)
    report["ok"] = ok
    print("SP_CHECK " + json.dumps(report, sort_keys=True), flush=True)
    return report


if __name__ == "__main__":
    result = main()
    destroy_distributed()
    sys.exit(0 if result["ok"] else 1)
