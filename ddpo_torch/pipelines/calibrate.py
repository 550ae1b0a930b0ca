"""Guidance-scale calibration sweep: reward against CFG scale, the argmax
to metadata.json.

Port of ddpo_tpu/pipelines/calibrate.py, on one device: the CUDA device,
raising at once when there is none, unless ``--device cpu`` asks for the
CPU. The reference consumes a calibrated scale (``pipeline/sample.py:48-49``
reads metadata.json) but has no sweep that writes one; this driver does:

  for each batch: one draw of prompts, then for each scale the CFG DDIM
      sampler from one saved generator state, so every scale sees the same
      initial latents and the same per-step noise (a paired comparison:
      reward differences are the guidance's alone), the VAE decode and the
      dataset's filter_field reward;
  write calibration.json ({scale: mean/std/sem/n}, best), metadata.json
  ({"guidance_scale": best, "filter_field": ...}) and calibration.png
  (utils/images.py plot_calibration) into --savepath, the model directory
  by default, where ``generate`` and ``sample --guidance_scale auto`` read
  it.

JAX's sampler here is ``sample_trajectories``; the port runs
``sample_images``, the same chain and random stream without the recorded
trajectory. JAX's gather of the rewards across processes waits with
multi-device work (ROADMAP.md Queue 1).

Run: python -m ddpo_torch.pipelines.calibrate --dataset compressed-animals \
         --guidance_scales "[1,2,3,5,8,12]"
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, NamedTuple

import numpy as np
import torch

from ddpo_torch import training
from ddpo_torch.models.tokenizer import make_uncond_ids
from ddpo_torch.sampling import SamplerConfig, sample_images, vae_decode
from ddpo_torch.utils import Timer
from ddpo_torch.utils import filesystem as fs
from ddpo_torch.utils.images import plot_calibration
from ddpo_torch.utils.metrics import MetricsLogger, run_dir
from ddpo_torch.utils.parser import Parser as BaseParser
from ddpo_torch.utils.serialization import load_unet, resolve_device

DEFAULT_SCALES = [1.0, 2.0, 3.0, 5.0, 8.0, 12.0]


class Parser(BaseParser):
    config: str = "ddpo_torch.config.base"
    dataset: str = "compressed_animals"


class CalibrationResult(NamedTuple):
    best: float
    curve: Dict[float, Dict[str, float]]  # scale -> mean, std, sem, n
    renderer: str  # what drew calibration.png: "matplotlib" or "pil"


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def main(argv=None) -> CalibrationResult:
    args = Parser().parse_args("calibrate", argv)
    device = resolve_device(args.device)
    batch_size = args.n_samples_per_device
    scales = [float(s) for s in (args.guidance_scales or DEFAULT_SCALES)]
    print(f"[ calibrate ] device: {device} | batch {batch_size} | scales {scales}")

    models = load_unet(
        None if args.iteration == 0 else args.loadpath,
        epoch=args.load_epoch,
        pretrained_model=args.pretrained_model,
        model_preset=args.model_preset,
        device=device,
        dtype=_dtype(args.dtype),
        seed=args.seed or 0,
    )
    scheduler = models.scheduler
    sched_state = scheduler.create_state(device)
    sampler_config = SamplerConfig(
        num_inference_steps=args.n_inference_steps,
        eta=args.eta,
        height=args.resolution,
        width=args.resolution,
        vae_scale_factor=2 ** (len(models.vae.config.block_out_channels) - 1),
        latent_channels=models.vae.config.latent_channels,
    )
    callback_fns = {
        args.filter_field: training.callback_fns[args.filter_field](
            vae=models.vae, cache=args.cache)
    }

    def text_encode(ids: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return models.text_encoder(torch.as_tensor(ids, device=device))

    uncond_embeds = text_encode(make_uncond_ids(models.tokenizer, batch_size))
    metrics = MetricsLogger(run_dir(args.savepath))

    generator = torch.Generator(device=device).manual_seed(args.seed or 0)
    timer = Timer()
    per_scale = {scale: [] for scale in scales}
    for batch_idx in range(args.n_eval_batches):
        inference_prompts, training_prompts, prompt_metadata = training.make_prompts(
            args.prompt_fn, batch_size, args.identical_batch,
            evaluate=args.evaluate, **args.prompt_kwargs,
        )
        prompt_embeds = text_encode(models.tokenizer(list(inference_prompts)))
        # one draw of initial latents and per-step noise, shared by every scale
        draws = generator.get_state()
        for scale in scales:
            generator.set_state(draws)
            latents = sample_images(
                models.unet, scheduler, sched_state, prompt_embeds, uncond_embeds,
                dataclasses.replace(sampler_config, guidance_scale=scale),
                generator=generator,
            )
            images = vae_decode(models.vae, latents).cpu().numpy().astype(np.float32)
            infos = training.evaluate_callbacks(
                callback_fns, images, training_prompts, prompt_metadata
            )
            rewards = np.asarray(infos[args.filter_field][0], dtype=np.float64)
            per_scale[scale].append(rewards)
            print(
                f"[ calibrate ] batch {batch_idx} scale {scale:g}: "
                f"reward {rewards.mean():.4f} ({timer():.2f}s)"
            )

    curve = {}
    for scale, reward_batches in per_scale.items():
        rewards = np.concatenate(reward_batches)
        curve[scale] = {
            "mean": float(rewards.mean()),
            "std": float(rewards.std()),
            "sem": float(rewards.std() / np.sqrt(len(rewards))),
            "n": int(len(rewards)),
        }
    best = max(curve, key=lambda s: curve[s]["mean"])
    print(f"[ calibrate ] best guidance scale: {best:g} "
          f"(reward {curve[best]['mean']:.4f})")

    for scale, stats in sorted(curve.items()):
        metrics.log(0, phase="calibrate", guidance_scale=scale, **stats)

    fs.save_json(
        os.path.join(args.savepath, "calibration.json"),
        {"filter_field": args.filter_field, "curve": curve, "best": best},
    )
    # what generate and sample --guidance_scale auto read
    fs.save_json(
        os.path.join(args.savepath, "metadata.json"),
        {"guidance_scale": best, "filter_field": args.filter_field},
    )
    renderer = plot_calibration(
        os.path.join(args.savepath, "calibration.png"),
        {s: v["mean"] for s, v in curve.items()},
        ylabel=args.filter_field,
    )
    print(f"[ calibrate ] calibration.png drawn with {renderer}")
    return CalibrationResult(best, curve, renderer)


if __name__ == "__main__":
    main()
