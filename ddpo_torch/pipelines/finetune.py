"""RWR supervised finetuning over a sampled HDF5 dataset.

Port of ddpo_tpu/pipelines/finetune.py, on the CUDA device, raising at
once when there is none, unless ``--device cpu`` asks for the CPU. Under a
launcher each rank reads its own contiguous shard of the dataset, the pod
batch is the rank's batch times the world size, and the gradients are
reduced over ranks (the unweighted loss's averaged, the weighted one's
summed: training/diffusion.py). The bucket loader (data/bucket.py) reads
the dataset the collection wrote; ``--weighted_dataset`` gives each sample
a softmax RWR weight over the whole dataset (optionally per prompt),
``--weighted_batch`` over each batch; clip + adamw (or adafactor); one
``training.diffusion.train_step`` per batch; the UNet exported as
``unet_{epoch}.pkl`` every ``save_freq`` epochs, the artifact the next RWR
iteration's sampler loads.

As in the JAX package the step computes in fp32 whatever ``--dtype``:
``--dtype`` is the dtype the parameters (and the text tower) are stored and
updated in, as JAX's ``load_unet(dtype=...)`` with its fp32 activation
dtype; with ``bfloat16`` the CFG recombination runs as one 2B apply
(``cfg_concat``). ``--lora_rank r > 0`` trains rank-r adapters on the
attention projections over the frozen UNet and exports the merged UNet.
The UNet call is rematerialized when ``--remat`` is set.

``main`` is ``build_finetuner`` (models, train state), the loader and
``train`` (the epoch loop), which any (dataset, loader) pair can drive;
``finetune_step`` is one batch.

Run: python -m ddpo_torch.pipelines.finetune --dataset compressed-animals-rwr
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ddpo_torch import training
from ddpo_torch.core.scheduler import DDPMScheduler
from ddpo_torch.data import get_bucket_loader
from ddpo_torch.models.lora import init_lora, merge_lora, n_lora_params
from ddpo_torch.parallel import (
    GradientAllReduce,
    all_processes_equal,
    destroy_distributed,
    global_batch_size,
    gradient_group,
    maybe_initialize_distributed,
    process_barrier,
    process_count,
    process_index,
    sharded_softmax,
    worker_sum,
)
from ddpo_torch.pipelines.policy_gradient import make_train_apply
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import AccumulatingTrainState
from ddpo_torch.utils.checkpoints import save_unet
from ddpo_torch.utils.metrics import MetricsLogger, run_dir
from ddpo_torch.utils.progress import Progress
from ddpo_torch.utils.parser import Parser as BaseParser
from ddpo_torch.utils.serialization import load_unet, resolve_device


class Parser(BaseParser):
    config: str = "ddpo_torch.config.base"
    dataset: str = "compressed_animals_rwr"


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class Finetuner(NamedTuple):
    args: Any
    device: torch.device
    models: Any
    state: AccumulatingTrainState
    lora_base: Optional[dict]
    scheduler: DDPMScheduler
    sched_state: Any
    generator: torch.Generator


def build_finetuner(args) -> Finetuner:
    """The stack (the finetuned UNet of ``--modelpath`` at ``--iteration``
    > 0), the train state over the UNet's parameters or its LoRA adapters,
    and the step's generator."""
    device = resolve_device(args.device)
    print(f"[ finetune ] device: {device}")
    models = load_unet(
        None if args.iteration == 0 else args.modelpath,
        epoch=args.load_epoch,
        pretrained_model=args.pretrained_model,
        model_preset=args.model_preset,
        device=device,
        dtype=_dtype(args.dtype),
        seed=args.base_seed,  # the same on every rank: the replicas start equal
    )
    # JAX's finetune computes in its fp32 activation dtype over the stored
    # (possibly bf16) weights
    models.text_encoder.float()
    unet = models.unet
    print(f"[ finetune ] unet params: {sum(p.numel() for p in unet.parameters()) / 1e6:.1f}M")
    lora_base = None
    if args.lora_rank:
        lora_base = dict(unet.named_parameters())
        params = init_lora(lora_base, args.lora_rank,
                           torch.Generator(device=device).manual_seed(args.base_seed))
        for p in params.values():
            p.requires_grad_(True)
        print(f"[ finetune ] lora: rank {args.lora_rank}, {n_lora_params(params)} trainable "
              f"in {len(params)} tensors (base frozen)")
    else:
        params = dict(unet.requires_grad_(True).named_parameters())
    group, backend = gradient_group(device)
    state = AccumulatingTrainState(
        apply_fn=make_train_apply(unet, torch.float32, args.remat, lora_base),
        params=params, tx=build_optimizer(args), accumulate=False,
        grad_reduce=GradientAllReduce(group, backend) if process_count() > 1 else None,
    )
    if process_count() > 1:
        print(f"[ finetune ] rank {process_index()} of {process_count()} | gradient "
              f"all-reduce: {backend}")
        all_processes_equal(params, "initial params")
    scheduler = DDPMScheduler()
    return Finetuner(
        args=args, device=device, models=models, state=state, lora_base=lora_base,
        scheduler=scheduler, sched_state=scheduler.create_state(device),
        generator=torch.Generator(device=device).manual_seed(args.seed),
    )


def finetune_step(ft: Finetuner, batch: dict, pod_batch_size: int,
                  draws: Optional[training.diffusion.Draws] = None) -> torch.Tensor:
    """One train step on a collated numpy batch (this rank's rows); returns
    this rank's loss. The step's random inputs come from the finetuner's
    generator unless ``draws`` gives them; the weights of
    ``--weighted_batch`` are a softmax over every rank's batch."""
    args, device = ft.args, ft.device
    if args.weighted_batch:
        rewards = torch.as_tensor(np.asarray(batch[args.filter_field]).squeeze(),
                                  dtype=torch.float32, device=device)
        weights = sharded_softmax(rewards, temperature=args.temperature)
    elif args.weighted_dataset:
        weights = torch.as_tensor(np.asarray(batch["weights"]).squeeze() / pod_batch_size,
                                  dtype=torch.float32, device=device)
    else:
        weights = None
    device_batch = {
        "vae": torch.as_tensor(batch["vae"], dtype=torch.float32, device=device),
        "input_ids": torch.as_tensor(batch["input_ids"], device=device),
        "uncond_text": torch.as_tensor(batch["uncond_text"], device=device),
    }
    return training.diffusion.train_step(
        ft.state, ft.models.text_encoder, device_batch, ft.sched_state, ft.scheduler,
        train_cfg=args.train_cfg, guidance_scale=args.guidance_scale, weights=weights,
        # CFG as one 2B apply for bf16, as the JAX package chooses
        cfg_concat=args.dtype == "bfloat16", generator=ft.generator, draws=draws,
    )


def export_unet(ft: Finetuner, savepath: str, epoch: int) -> str:
    """unet_{epoch}.pkl: the trained UNet (with LoRA, the merged one)."""
    if ft.lora_base is None:
        return save_unet(savepath, ft.models.unet, epoch=epoch)
    with torch.no_grad():
        merged = merge_lora(ft.lora_base, ft.state.params)
    return save_unet(savepath, ft.models.unet, epoch=epoch, params=merged)


def train(ft: Finetuner, dataset, loader) -> Finetuner:
    """The epoch loop over ``loader`` (its ``dataset`` gives the RWR weights
    and sizes the epochs): steps, metrics.jsonl (the epoch's loss and
    seconds per step, the export's bytes and seconds), and the exports
    every ``save_freq`` epochs."""
    args = ft.args
    assert not (args.weighted_batch and args.weighted_dataset)
    if args.weighted_dataset:
        dataset.make_weights(args.filter_field, args.temperature, args.per_prompt_weights)
    worker_batch_size = args.train_batch_size
    pod_batch_size = global_batch_size(worker_batch_size)
    steps_per_epoch = max(1, len(dataset) // worker_batch_size)
    max_steps = args.max_train_steps or args.num_train_epochs * steps_per_epoch
    num_epochs = (
        args.num_train_epochs
        if args.max_train_steps is None
        else math.ceil(max_steps / steps_per_epoch)
    )
    print(
        f"[ finetune ] dataset {len(dataset)} | worker bs {worker_batch_size} | "
        f"pod bs {pod_batch_size} | steps {max_steps}"
    )
    rank, world = process_index(), process_count()
    metrics = MetricsLogger(run_dir(args.savepath), enabled=rank == 0)
    # the global batch's loss: the ranks' mean for the unweighted loss, their
    # sum for the weighted one (training/diffusion.py)
    weighted = args.weighted_batch or args.weighted_dataset
    global_step = 0
    for epoch in range(num_epochs):
        losses, step_s = [], []
        progress = Progress(steps_per_epoch, name=f"epoch {epoch}")
        for batch in loader:
            start = time.perf_counter()
            loss = float(finetune_step(ft, batch, pod_batch_size))  # waits for the device
            step_s.append(time.perf_counter() - start)
            losses.append(worker_sum(loss) / (1 if weighted else world))
            progress({"loss": losses[-1], "idx_max": int(np.max(batch["idxs"])),
                      "cfg": args.train_cfg})
            global_step += 1
            if global_step >= max_steps:
                break
        progress.stamp()
        print(f"[ finetune ] epoch {epoch} loss {np.mean(losses):.5f}, "
              f"{len(step_s)} steps in {sum(step_s):.3f} s")
        saved = {}
        if (epoch + 1) % args.save_freq == 0 or epoch == num_epochs - 1:
            start = time.perf_counter()
            path = export_unet(ft, args.savepath,
                               epoch=(epoch + 1) // args.save_freq * args.save_freq)
            process_barrier(f"finetune_export_{epoch}")  # rank 0 wrote it
            saved = {"save_bytes": os.path.getsize(path), "save_s": time.perf_counter() - start}
            print(f"[ finetune ] saved {path}: {saved['save_bytes']} bytes in "
                  f"{saved['save_s']:.2f} s")
        timing = {"first_step_s": step_s[0],
                  "step_s": float(np.mean(step_s[1:] if len(step_s) > 1 else step_s))
                  } if step_s else {}
        metrics.log(epoch, phase="finetune", loss=float(np.mean(losses)),
                    global_step=int(global_step), **timing, **saved)
        if global_step >= max_steps:
            break
    return ft


def main(argv=None) -> Finetuner:
    maybe_initialize_distributed()
    args = Parser().parse_args("train", argv)
    ft = build_finetuner(args)
    dataset, loader = get_bucket_loader(
        args.loadpath,
        ft.models.tokenizer,
        batch_size=args.train_batch_size,
        resolution=args.resolution,
        max_train_samples=args.max_train_samples,
        num_workers=args.num_workers,
    )
    return train(ft, dataset, loader)


if __name__ == "__main__":
    main()
    destroy_distributed()
