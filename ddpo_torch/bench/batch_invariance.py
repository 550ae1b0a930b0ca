"""Which ops of the bf16 UNet change a sample's bits with the batch shape.

The DDPO sampler runs the UNet at 2B = 2 x sample_batch_size rows
([uncond; cond]), and the PPO trainer recomputes the same samples at
2B = 2 x train_batch_size. Every op whose reduction order depends on the
batch makes the recompute off-policy. This measures it on the card:

  - the module table: one UNet forward at the sampler's 2B records each leaf
    module's input (nn.Linear, the convs, LayerNorm, GroupNorm, and the
    attention op of ``models.layers``), calls the module again on the rows
    of the trainer's first minibatch ([uncond; cond] of two samples, the
    layout ``ppo_loss`` builds) and compares the bits of those rows. Rows
    are grouped by family: nn.Linear by its M (the time MLP at M = 2B, the
    context K/V at M = 2B * 77, the projections at M = 2B * S), 3x3, strided
    and 1x1 convs, LayerNorm, plain and flash attention, GroupNorm;
  - the whole UNet on those rows, the same way;
  - the first minibatch's recompute through ``ppo_loss`` at the trainer's
    2B against the rollout's log-probs at the sampler's 2B: approx_kl,
    clipfrac at ``clip_range`` and the largest |dlogp|.

``SETTINGS`` are the choices ``main`` compares; ``"port"`` is what the DDPO
driver runs (``ops.invariance.batch_invariant``). ``--variants`` runs each
3x3 conv and each plain attention of one forward through the library in
several ways (one call, pieces, another order, twice) to show which
property an op lacks.

Run on a machine with a CUDA card:
    python -m ddpo_torch.bench.batch_invariance [--conv_kernel] [setting ...]
    python -m ddpo_torch.bench.batch_invariance --variants
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Dict

import torch
import torch.nn as nn

from ddpo_torch.models import layers
from ddpo_torch.models.layers import GroupNorm
from ddpo_torch.ops import conv, invariance

# what main() compares: the ops as they are ("library"), the same with
# cuDNN's deterministic flag, and the port's repair, inside
# ops.invariance.batch_invariant() ("port")
SETTINGS = {
    "library": {"invariant": False},
    "cudnn_deterministic": {"invariant": False, "cudnn_deterministic": True},
    "port": {"invariant": True},
}


def family(module: nn.Module, x: torch.Tensor) -> str:
    """The row of the module table a leaf module's call belongs to."""
    if isinstance(module, nn.Linear):
        if x.dim() == 2:
            return "Linear M = 2B (time MLP)"
        if x.shape[1] == 77:
            return "Linear M = 2B*77 (context K/V)"
        return f"Linear M = 2B*{x.shape[1]}"
    if isinstance(module, nn.Conv2d):
        if module.kernel_size == (1, 1):
            return "conv 1x1"
        return "conv 3x3" if module.stride == (1, 1) else "conv 3x3 stride 2"
    if isinstance(module, nn.LayerNorm):
        return "LayerNorm"
    if isinstance(module, GroupNorm):
        return "GroupNorm"
    return type(module).__name__


def _add(table: Dict, name: str, full: torch.Tensor, part: torch.Tensor) -> None:
    row = table.setdefault(name, {"modules": 0, "differ": 0, "max_abs": 0.0})
    row["modules"] += 1
    if not torch.equal(full, part):
        row["differ"] += 1
        row["max_abs"] = max(row["max_abs"], (full.float() - part.float()).abs().max().item())


@torch.no_grad()
def module_table(unet: nn.Module, latents, t, context, rows: torch.Tensor) -> Dict:
    """{family: {"modules", "differ", "max_abs"}} for one UNet forward at
    latents' batch, each leaf module (and attention call) recomputed on
    ``rows``; the "UNet" row holds the whole forward."""
    n = latents.shape[0]
    table: Dict = {}
    live = [True]

    def take(a):
        return a[rows] if torch.is_tensor(a) and a.dim() and a.shape[0] == n else a

    def hook(module, args, out):
        if not live[0] or isinstance(module, nn.Identity):
            return
        live[0] = False
        try:
            _add(table, family(module, args[0]), out[rows], module(*map(take, args)))
        finally:
            live[0] = True

    attention = layers.attention

    def traced_attention(q, k, v, scale=None, **kw):
        out = attention(q, k, v, scale, **kw)
        if live[0]:
            sk = k.shape[1] * (kw["spatial"].size if kw.get("spatial") else 1)
            name = ("flash attention" if q.is_cuda and q.shape[1] >= 256 and sk >= 256
                    else f"plain attention Sk = {sk}")
            _add(table, name, out[rows], attention(take(q), take(k), take(v), scale, **kw))
        return out

    handles = [m.register_forward_hook(hook) for m in unet.modules()
               if not any(True for _ in m.children())]
    layers.attention = traced_attention
    try:
        full = unet(latents, t, context)
    finally:
        layers.attention = attention
        for h in handles:
            h.remove()
    _add(table, "UNet", full[rows], unet(latents[rows], t[rows], context[rows]))
    return table


@torch.no_grad()
def variants(unet: nn.Module, latents, t, context, rows: torch.Tensor) -> Dict:
    """Each 3x3 conv's and each plain attention's inputs of one UNet forward
    at latents' batch, run through the library in several ways; per op and
    way, how many calls give ``rows`` other bits than the trainer's call on
    ``rows`` alone (N = len(rows)), with the differing shapes."""
    import torch.nn.functional as F

    from ddpo_torch.ops.attention import attention_reference

    k = len(rows)
    perm = torch.arange(k - 1, -1, -1, device=rows.device)
    table: Dict = {}

    def probe(op, fn, args, shape):
        """fn(*args) -> output; args share the batch dim 0."""
        def sub(index):
            return [a[index] for a in args]

        part = fn(*sub(rows))
        ways = {
            "one call": (fn(*args)[rows], part),
            f"pieces of {k}": (invariance.in_pieces(fn, args, k)[rows], part),
            f"{k}, reversed": (part[perm], fn(*[a[perm] for a in sub(rows)])),
            f"{k}, twice": (part, fn(*sub(rows))),
            "pieces of 1": (invariance.in_pieces(fn, args, 1)[rows],
                            invariance.in_pieces(fn, sub(rows), 1)),
        }
        for way, (full, alone) in ways.items():
            row = table.setdefault(f"{op}: {way}", {"modules": 0, "differ": 0, "max_abs": 0.0,
                                                    "shapes": []})
            if not torch.equal(full, alone):
                row["shapes"].append(shape)
            _add(table, f"{op}: {way}", full, alone)

    def conv_hook(module, args, out):
        def fn(x):
            return F.conv2d(x, module.weight, module.bias, stride=module.stride,
                            padding=module.padding)
        probe("3x3 conv", fn, [args[0]],
              tuple(args[0].shape[1:]) + (module.weight.shape[0], module.stride[0]))

    attention = layers.attention

    def traced_attention(q, kk, v, scale=None):
        if not (q.shape[1] >= 256 and kk.shape[1] >= 256):
            probe("plain attention", lambda *qkv: attention_reference(*qkv, scale),
                  [q, kk, v], tuple(q.shape[1:]) + (kk.shape[1],))
        return attention(q, kk, v, scale)

    handles = [m.register_forward_hook(conv_hook) for m in unet.modules()
               if isinstance(m, nn.Conv2d) and m.kernel_size == (3, 3)]
    layers.attention = traced_attention
    try:
        unet(latents, t, context)
    finally:
        layers.attention = attention
        for h in handles:
            h.remove()
    return table


def minibatch_rows(batch: int, samples) -> torch.Tensor:
    """Rows of [uncond; cond] at 2 * batch that hold ``samples``, in the
    order ppo_loss's cfg_concat puts them: [uncond of samples; cond of samples]."""
    return torch.tensor([*samples, *(batch + s for s in samples)])


@torch.no_grad()
def recompute(unet, scheduler, traj, embeds, uncond, samples, guidance_scale, eta,
              clip_range) -> Dict:
    """The first minibatch's log-probs through ppo_loss at 2B = 2 len(samples),
    sample i at timestep index (j + 17 i) mod T, as the trainer's per-sample
    shuffle gives it, against the rollout's."""
    from ddpo_torch.training.policy_gradient import ppo_loss

    idx = torch.tensor(samples, device=embeds.device)
    steps = traj["log_probs"].shape[1]
    sched = scheduler.set_timesteps(scheduler.create_state(embeds.device), steps)
    kl, clipped, dmax = [], [], 0.0
    for j in range(steps):
        cols = torch.tensor([(j + 17 * i) % steps for i in range(len(samples))],
                            device=embeds.device)
        batch = {
            k: traj[k][idx, cols] for k in ("latents", "next_latents", "ts", "log_probs")
        }
        batch.update(prompt_embeds=embeds[idx], uncond_embeds=uncond[idx],
                     advantages=torch.ones(len(samples), device=embeds.device))
        _, info = ppo_loss({}, lambda p, *a: unet(*a), batch, scheduler, sched, True,
                           guidance_scale, eta, clip_range, cfg_concat=True)
        kl.append(info["approx_kl"].item())
        clipped.append(info["clipfrac"].item())
        dmax = max(dmax, (2.0 * len(samples) * kl[-1]) ** 0.5)
    return {"approx_kl": statistics.fmean(kl), "clipfrac": statistics.fmean(clipped),
            "max_dlogp": dmax}


def format_table(table: Dict) -> str:
    lines = []
    for name, row in table.items():
        lines.append(f"    {name}: {row['modules']} calls, {row['differ']} differ"
                     + (f", max|d| {row['max_abs']:.3e}" if row["differ"] else ""))
    return "\n".join(lines)


def _median_ms(fn, iters: int = 5) -> float:
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(models, setting: str, sample_batch: int = 8, train_batch: int = 2,
        clip_range: float = 2e-4) -> Dict:
    """One setting: a rollout at the sampler's 2B, its module table at step 0,
    the first minibatch's recompute, and the times of a UNet forward at the
    sampler's 2B and a forward + backward at the trainer's."""
    setup = SETTINGS[setting]
    torch.backends.cudnn.deterministic = setup.get("cudnn_deterministic", False)
    try:
        with invariance.batch_invariant(setup["invariant"]):
            return {"setting": setting, **_run(models, sample_batch, train_batch, clip_range)}
    finally:
        torch.backends.cudnn.deterministic = False


def _run(models, sample_batch, train_batch, clip_range) -> Dict:
    from ddpo_torch.models.tokenizer import make_uncond_ids
    from ddpo_torch.sampling import SamplerConfig, sample_trajectories
    from ddpo_torch.training import make_prompts

    unet, dev = models.unet, "cuda"
    prompts, _, _ = make_prompts("imagenet_animals", sample_batch)
    with torch.no_grad():
        embeds = models.text_encoder(torch.as_tensor(models.tokenizer(prompts), device=dev))
        uncond = models.text_encoder(
            torch.as_tensor(make_uncond_ids(models.tokenizer, sample_batch), device=dev))
    config = SamplerConfig(num_inference_steps=50, guidance_scale=5.0, eta=1.0)
    generator = torch.Generator(device=dev).manual_seed(0)
    start = time.perf_counter()
    traj = sample_trajectories(unet, models.scheduler, models.scheduler.create_state(dev),
                               embeds, uncond, config, generator=generator)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - start

    samples = (5, 2)[:train_batch] if sample_batch > 5 else tuple(range(train_batch))
    rows = minibatch_rows(sample_batch, samples).to(dev)
    lat = traj["latents"][:, 0]
    x = torch.cat([lat, lat])
    t = traj["ts"][:, 0].repeat(2)
    context = torch.cat([uncond, embeds])
    table = module_table(unet, x, t, context, rows)
    logp = recompute(unet, models.scheduler, traj, embeds, uncond, samples,
                     config.guidance_scale, config.eta, clip_range)

    with torch.no_grad():
        fwd_ms = _median_ms(lambda: unet(x, t, context))
    params = [p.requires_grad_(True) for p in unet.parameters()]

    def fwd_bwd():
        unet(x[rows], t[rows], context[rows]).square().mean().backward()
        for p in params:
            p.grad = None

    try:
        fwd_bwd_ms = _median_ms(fwd_bwd)
    finally:
        for p in params:
            p.requires_grad_(False)
    return {"table": table, **logp, "rollout_s": rollout_s,
            "unet_fwd_ms_2B16": fwd_ms, "unet_fwd_bwd_ms_2B4": fwd_bwd_ms}


def run_variants() -> Dict:
    """``variants`` on a batch-8 step-0 UNet input (2B = 16) against the
    trainer's first minibatch rows, printed as a table."""
    from ddpo_torch.ops import _build
    from ddpo_torch.utils.serialization import load_stable_diffusion

    _build.load_library()
    models = load_stable_diffusion(model_preset="sd14", device="cuda",
                                   dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lat = torch.randn((8, 4, 64, 64), generator=gen, device="cuda")
    ctx = torch.randn((16, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.full((16,), 981, device="cuda")
    table = variants(models.unet, torch.cat([lat, lat]), t, ctx,
                     minibatch_rows(8, (5, 2)).cuda())
    print(f"[ batch_invariance ] library ops by way:\n{format_table(table)}", flush=True)
    for name, row in table.items():
        if row["shapes"]:
            print(f"    {name}: differing shapes {sorted(set(row['shapes']))}", flush=True)
    return table


def main(argv=None) -> list:
    from ddpo_torch.ops import _build
    from ddpo_torch.utils.serialization import load_stable_diffusion

    argv = list(sys.argv[1:] if argv is None else argv)
    conv_kernel = "--conv_kernel" in argv
    if "--variants" in argv:
        return run_variants()
    names = [a for a in argv if a != "--conv_kernel"] or list(SETTINGS)
    _build.load_library()  # the build first, so that no setting's times hold it
    models = load_stable_diffusion(model_preset="sd14", device="cuda",
                                   dtype=torch.bfloat16, seed=0)
    results = []
    conv.set_conv_kernel_enabled(True if conv_kernel else None)
    try:
        for name in names:
            result = run(models, name)
            result["conv_kernel"] = conv_kernel
            print(f"[ batch_invariance ] {name} (conv switch {'on' if conv_kernel else 'off'}): "
                  f"first minibatch at 2B = 4 against 2B = 16: approx_kl "
                  f"{result['approx_kl']:.3e}, clipfrac {result['clipfrac']:.3f}, max|dlogp| "
                  f"{result['max_dlogp']:.3e}; rollout {result['rollout_s']:.2f} s, UNet forward "
                  f"2B = 16 {result['unet_fwd_ms_2B16']:.2f} ms, forward + backward 2B = 4 "
                  f"{result['unet_fwd_bwd_ms_2B4']:.2f} ms\n{format_table(result['table'])}",
                  flush=True)
            results.append(result)
    finally:
        conv.set_conv_kernel_enabled(None)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
