"""RWR data collection: sample, reward, filter, write sharded HDF5.

Port of ddpo_tpu/pipelines/sample.py, on the CUDA device, raising at once
when there is none, unless ``--device cpu`` asks for the CPU; under a
launcher each rank collects its own batches (seed base_seed + rank, its own
``-w{rank}-`` split files) from the same model (built from base_seed), and
the sample count that ends the loop is the sum over ranks. Each batch:
prompts -> CLIP text encode -> the trajectory-free CFG sampler (DDIM's
``sample_images``, or with ``--scheduler dpm++`` the DPM-Solver++(2M)
``sample_images_ode``: collection keeps only images and rewards, so the
few-step ODE solver applies) -> VAE decode -> the ``filter_field`` reward
and the ``vae`` posterior moments (the finetune loss's inputs) -> the
masker -> ``RemoteWriter`` split files. The models run in ``--dtype``
(bf16 by default), the moments come back in fp32.

``--iteration`` > 0 samples from the finetuned UNet ``unet_{load_epoch}.pkl``
under ``--loadpath`` (the previous iteration's ``pipelines/finetune.py``
export, of either package); ``--guidance_scale auto`` reads the calibrated
scale from the model directory's metadata.json. ``--quant int8`` runs the
sampling UNet's resnet and upsampler convs as W8A8 int8 convs
(ops/quant.py), alone or with ``--scheduler dpm++``.

``main`` is ``build_collector`` (models, sampler, rewards, masker), the
writer and ``collect`` (the loop); ``collect_batch`` is one batch,
with its seconds by stage (sample, decode, each reward), which ``collect``
logs to metrics.jsonl with the writer's seconds.

Run: python -m ddpo_torch.pipelines.sample --dataset compressed-animals-rwr
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch

from ddpo_torch import training
from ddpo_torch.data.hdf5 import RemoteWriter, decode_generic, encode_generic
from ddpo_torch.models.tokenizer import make_uncond_ids
from ddpo_torch.parallel import (
    destroy_distributed,
    maybe_initialize_distributed,
    process_index,
    worker_sum,
)
from ddpo_torch.pipelines.generate import inference_sampler
from ddpo_torch.sampling import SamplerConfig, vae_decode
from ddpo_torch.utils import Timer
from ddpo_torch.utils.images import decode_jpeg, encode_jpeg
from ddpo_torch.utils.maskers import StreamingAverage, make_masker
from ddpo_torch.utils.metrics import MetricsLogger, run_dir
from ddpo_torch.utils.parser import Parser as BaseParser
from ddpo_torch.utils.serialization import load_unet, resolve_device


class Parser(BaseParser):
    config: str = "ddpo_torch.config.base"
    dataset: str = "compressed_animals_rwr"


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Collector(NamedTuple):
    args: Any
    device: torch.device
    models: Any
    scheduler: Any  # --scheduler's: DDIM or DPM-Solver++
    sample_fn: Callable  # sample_images or sample_images_ode
    sched_state: Any
    sampler_config: SamplerConfig
    uncond_embeds: torch.Tensor
    callback_fns: Dict[str, Callable]
    masker: Any
    avg: StreamingAverage
    generator: torch.Generator


def build_collector(args, argv=None) -> Collector:
    """Everything a batch needs: the models (the finetuned UNet at
    ``--iteration`` > 0, quantized under ``--quant int8``), the scheduler
    and sampler of ``--scheduler``, the sampler's configuration, the
    rewards, the masker and the sampler's generator. ``argv`` is the
    command line the arguments came from (None: sys.argv)."""
    device = resolve_device(args.device)
    batch_size = args.n_samples_per_device
    print(f"[ sample ] device: {device} | batch {batch_size}")
    if args.guidance_scale == "auto":
        # reference pipeline/sample.py:48-49: the calibrated scale from the
        # model dir's metadata.json (written by the calibration driver)
        from ddpo_torch.utils.loaders import load_guidance_scale

        args.set("guidance_scale", load_guidance_scale(args.loadpath))
        print(f"[ sample ] calibrated guidance scale: {args.guidance_scale:g}")

    models = load_unet(
        None if args.iteration == 0 else args.loadpath,
        epoch=args.load_epoch,
        pretrained_model=args.pretrained_model,
        model_preset=args.model_preset,
        device=device,
        dtype=_dtype(args.dtype),
        seed=args.base_seed,
    )
    scheduler, sample_fn = inference_sampler(args, argv, models, "sample")
    sampler_config = SamplerConfig(
        num_inference_steps=args.n_inference_steps,
        guidance_scale=float(args.guidance_scale),
        eta=args.eta,
        height=args.resolution,
        width=args.resolution,
        vae_scale_factor=2 ** (len(models.vae.config.block_out_channels) - 1),
        latent_channels=models.vae.config.latent_channels,
    )
    # reward callbacks: the filter field + the VAE posterior for training
    callback_fns = {
        key: training.callback_fns[key](vae=models.vae, cache=args.cache)
        for key in (args.filter_field, "vae")
    }
    with torch.no_grad():
        uncond_embeds = models.text_encoder(
            torch.as_tensor(make_uncond_ids(models.tokenizer, batch_size), device=device))
    return Collector(
        args=args, device=device, models=models, scheduler=scheduler, sample_fn=sample_fn,
        sched_state=scheduler.create_state(device), sampler_config=sampler_config,
        uncond_embeds=uncond_embeds, callback_fns=callback_fns,
        masker=make_masker(args.mask_mode, args.mask_param), avg=StreamingAverage(),
        generator=torch.Generator(device=device).manual_seed(args.seed),
    )


def collect_batch(c: Collector):
    """One batch: (batch of fields to write, mask, rewards, seconds by stage)."""
    args, models = c.args, c.models
    seconds: Dict[str, float] = {}
    inference_prompts, training_prompts, prompt_metadata = training.make_prompts(
        args.prompt_fn, args.n_samples_per_device, args.identical_batch,
        evaluate=args.evaluate, **args.prompt_kwargs,
    )
    start = time.perf_counter()
    with torch.no_grad():
        prompt_embeds = models.text_encoder(
            torch.as_tensor(models.tokenizer(list(inference_prompts)), device=c.device))
    latents = c.sample_fn(models.unet, c.scheduler, c.sched_state, prompt_embeds,
                          c.uncond_embeds, c.sampler_config, generator=c.generator)
    _sync(c.device)
    seconds["sample_s"] = time.perf_counter() - start
    start = time.perf_counter()
    images = vae_decode(models.vae, latents).cpu().numpy()
    seconds["decode_s"] = time.perf_counter() - start

    def timed(key, fn):
        def run(*a):
            start = time.perf_counter()
            out = fn(*a)
            seconds[f"reward_{key}_s"] = time.perf_counter() - start
            return out
        return run

    infos = training.evaluate_callbacks(
        {key: timed(key, fn) for key, fn in c.callback_fns.items()},
        images, training_prompts, prompt_metadata,
    )
    rewards = np.asarray(infos[args.filter_field][0])
    c.avg(float(rewards.mean()))
    mask = c.masker(rewards)
    batch = {
        "inference_prompts": list(inference_prompts),
        "training_prompts": list(training_prompts),
        "images": images,
        **{key: np.asarray(rew) for key, (rew, _) in infos.items()},
    }
    return batch, mask, rewards, seconds


def configure_writer(writer, callback_keys) -> None:
    """The dataset's schema: JPEG images, plain inference prompts, pickled
    training prompts (lists of strings), plain reward fields."""
    writer.configure("images", encode_fn=encode_jpeg, decode_fn=decode_jpeg)
    writer.configure("inference_prompts")
    writer.configure("training_prompts", encode_fn=encode_generic, decode_fn=decode_generic)
    for key in callback_keys:
        writer.configure(key)


def collect(c: Collector, writer) -> int:
    """Batches until ``max_samples`` are written (or ``max_steps`` batches);
    returns the samples written."""
    args = c.args
    metrics = MetricsLogger(run_dir(args.savepath), enabled=process_index() == 0)
    timer = Timer()
    n_steps, n_samples = 0, 0
    while True:
        batch, mask, rewards, seconds = collect_batch(c)
        print(f"[ sample ] {len(batch['images'])} samples in {timer():.2f}s")
        start = time.perf_counter()
        n_added = writer.add_batch(batch, mask=mask)
        seconds["write_s"] = time.perf_counter() - start
        n_steps += 1
        n_samples += worker_sum(n_added)
        print(
            f"[ sample ] batch {n_steps} | saved {n_added} | total "
            f"{int(n_samples)}/{args.max_samples} | avg {c.avg.avg:.3f} | {c.masker}"
        )
        metrics.log(
            n_steps, phase="sample", mean_reward=float(rewards.mean()), n_saved=int(n_added),
            n_total=int(n_samples),
            images_per_sec=len(batch["images"]) / sum(seconds.values()), **seconds,
        )
        if args.max_steps is not None and n_steps >= args.max_steps:
            break
        if args.max_samples is not None and n_samples >= args.max_samples:
            break
    writer.close()
    return int(n_samples)


def main(argv=None) -> int:
    maybe_initialize_distributed()
    args = Parser().parse_args("sample", argv)
    c = build_collector(args, argv)
    writer = RemoteWriter(args.savepath, split_size=args.local_size)
    configure_writer(writer, c.callback_fns)
    return collect(c, writer)


if __name__ == "__main__":
    main()
    destroy_distributed()
