"""Generation-only inference driver: text -> images.

Port of ddpo_tpu/pipelines/generate.py, on one device: prompts -> CLIP
text encode -> CFG sampler (50-step DDIM, or ``--scheduler dpm++``: the
DPM-Solver++(2M) ODE sampler, about 20 steps) -> VAE decode -> PNGs under
the run's savepath. It runs on the CUDA device (where the
UNet's self-attention and every GroupNorm go through the kernels in
ddpo_torch/csrc) and raises at once when there is none, unless
``--device cpu`` asks for the CPU. With ``ops.conv.set_conv_kernel_enabled(True)``
every 3x3 conv of the UNet and the VAE decoder runs the direct kernel too.
``--quant int8`` runs the UNet's 47 resnet and upsampler convs as W8A8
int8 convs (ops/quant.py; on the card the s8 tap-GEMM kernel), alone or
with ``--scheduler dpm++``.

``--iteration`` > 0 serves a finetuned UNet: ``load_unet`` overlays
``unet_{load_epoch}.pkl`` from ``--loadpath`` (the Flax-layout export of
either package, e.g. the merged UNet a LoRA run of
pipelines/policy_gradient.py writes) on the stack built from ``--seed``.
``--guidance_scale auto`` reads the scale pipelines/calibrate.py wrote to
``--loadpath``'s metadata.json.

Run: python -m ddpo_torch.pipelines.generate --dataset compressed-animals \
         --prompts "['a dog', 'a cheetah']" --n_samples 8
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from ddpo_torch import training
from ddpo_torch.core.scheduler import DPMSolverPlusPlus
from ddpo_torch.models.tokenizer import make_uncond_ids
from ddpo_torch.sampling import SamplerConfig, sample_images, sample_images_ode, vae_decode
from ddpo_torch.utils import Timer
from ddpo_torch.utils.images import save_image, save_images
from ddpo_torch.utils.metrics import MetricsLogger, run_dir
from ddpo_torch.utils.parser import Parser as BaseParser
from ddpo_torch.utils.serialization import load_unet, resolve_device


class Parser(BaseParser):
    config: str = "ddpo_torch.config.base"
    dataset: str = "compressed_animals"


class GenerateResult(NamedTuple):
    outdir: str
    prompts: List[str]
    images: np.ndarray  # (n_samples, H, W, 3) float32 in [0, 1]


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def inference_sampler(args, argv, models, tag: str) -> Tuple[object, Callable]:
    """``--quant`` on the loaded UNet, then ``--scheduler``'s scheduler and
    sampler function: (models.scheduler, sample_images) for ddim, a
    DPMSolverPlusPlus with the DDIM scheduler's noise schedule and
    prediction type and sample_images_ode for dpm++. ``argv`` (None: the
    command line) tells whether --eta was given, which dpm++ ignores."""
    if args.quant == "int8":
        models.unet.set_quant(True)
        print(f"[ {tag} ] quant=int8: W8A8 resnet convs in the sampling UNet")
    elif args.quant != "none":
        raise ValueError(f"unknown quant {args.quant!r} (none|int8)")
    if args.scheduler == "ddim":
        return models.scheduler, sample_images
    if args.scheduler != "dpm++":
        raise ValueError(f"unknown scheduler {args.scheduler!r} (ddim|dpm++)")
    raw_argv = argv if argv is not None else sys.argv[1:]
    if "--eta" in raw_argv and float(args.eta) != 0.0:
        print(f"[ {tag} ] warning: --eta has no effect with "
              "--scheduler dpm++ (deterministic ODE solver, eta=0)")
    d = models.scheduler
    return DPMSolverPlusPlus(
        num_train_timesteps=d.num_train_timesteps,
        beta_start=d.beta_start,
        beta_end=d.beta_end,
        beta_schedule=d.beta_schedule,
        prediction_type=d.prediction_type,
    ), sample_images_ode


def main(argv=None) -> GenerateResult:
    args = Parser().parse_args("generate", argv)
    device = resolve_device(args.device)
    if args.guidance_scale == "auto":
        from ddpo_torch.utils.loaders import load_guidance_scale

        args.set("guidance_scale", load_guidance_scale(args.loadpath))
        print(f"[ generate ] calibrated guidance scale: {args.guidance_scale:g}")

    print(f"[ generate ] device: {device}")
    batch_size = args.n_samples_per_device
    models = load_unet(
        None if args.iteration == 0 else args.loadpath,
        epoch=args.load_epoch,
        pretrained_model=args.pretrained_model,
        model_preset=args.model_preset,
        device=device,
        dtype=_dtype(args.dtype),
        seed=args.seed or 0,
    )
    scheduler, sample_fn = inference_sampler(args, argv, models, "generate")
    sched_state = scheduler.create_state(device)
    sampler_config = SamplerConfig(
        num_inference_steps=args.n_inference_steps,
        guidance_scale=float(args.guidance_scale),
        eta=args.eta,
        height=args.resolution,
        width=args.resolution,
        vae_scale_factor=2 ** (len(models.vae.config.block_out_channels) - 1),
        latent_channels=models.vae.config.latent_channels,
    )

    def text_encode(ids: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return models.text_encoder(torch.as_tensor(ids, device=device))

    uncond_embeds = text_encode(make_uncond_ids(models.tokenizer, batch_size))

    outdir = run_dir(args.savepath)
    os.makedirs(outdir, exist_ok=True)
    metrics = MetricsLogger(outdir)

    fixed_prompts = list(args.prompts) if args.prompts else None
    generator = torch.Generator(device=device).manual_seed(args.seed or 0)
    timer = Timer()
    all_prompts, all_images, generated, batch_idx = [], [], 0, 0
    while generated < args.n_samples:
        if fixed_prompts:
            prompts = [
                fixed_prompts[(generated + i) % len(fixed_prompts)]
                for i in range(batch_size)
            ]
        else:
            prompts, _, _ = training.make_prompts(
                args.prompt_fn, batch_size, args.identical_batch,
                evaluate=args.evaluate, **args.prompt_kwargs,
            )
        prompt_embeds = text_encode(models.tokenizer(list(prompts)))
        latents = sample_fn(
            models.unet, scheduler, sched_state, prompt_embeds, uncond_embeds,
            sampler_config, generator=generator,
        )
        images = vae_decode(models.vae, latents).cpu().numpy()  # waits for the device
        elapsed = timer()

        n_keep = min(batch_size, args.n_samples - generated)
        for i in range(n_keep):
            save_image(os.path.join(outdir, f"{generated + i:05d}.png"), images[i])
        if args.grid:
            save_images(images[:n_keep], os.path.join(outdir, f"grid_{batch_idx}.png"))
        all_prompts.extend(prompts[:n_keep])
        all_images.append(images[:n_keep])
        generated += n_keep
        print(
            f"[ generate ] batch {batch_idx}: {n_keep} images in "
            f"{elapsed:.2f}s ({batch_size / elapsed:.3f}/s) -> {outdir}"
        )
        metrics.log(
            batch_idx, phase="generate", n_images=int(n_keep),
            images_per_sec=float(batch_size / elapsed),
        )
        batch_idx += 1

    with open(os.path.join(outdir, "prompts.json"), "w") as f:
        json.dump(
            {
                "prompts": all_prompts,
                "guidance_scale": float(args.guidance_scale),
                "n_inference_steps": args.n_inference_steps,
                "scheduler": args.scheduler,
                "seed": args.seed,
                "device": str(device),
            },
            f, indent=2,
        )
    return GenerateResult(outdir, all_prompts, np.concatenate(all_images))


if __name__ == "__main__":
    main()
