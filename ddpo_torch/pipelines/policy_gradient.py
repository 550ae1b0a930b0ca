"""DDPO training pipeline: sample -> reward -> advantage -> PPO update, one process.

Port of ddpo_tpu/pipelines/policy_gradient.py (its single-process host
loop), on one device: the CUDA device, raising at once when there is none,
unless ``--device cpu`` asks for the CPU:

  - the sampler runs the UNet in ``sample_dtype`` (bf16 by default) on a
    copy cast from the fp32 master parameters once per epoch;
  - reward callbacks run in a 2-worker thread pool, overlapped with the next
    sampling batch;
  - the PPO update runs the UNet in ``train_dtype`` through
    ``make_train_apply``: the fp32 masters are cast at use, a differentiable
    cast, so gradients land on them in fp32, and the whole UNet call is
    rematerialized (``torch.utils.checkpoint``) when ``remat`` is set; CFG
    is one 2B apply (``cfg_concat``) when ``train_dtype`` is bf16;
  - the fused loop trains all timesteps of a minibatch and then updates
    once; the non-fused loop updates on each minibatch's last timestep;
  - full-state checkpoints (params, optimizer, RNGs, reward history, stat
    buffers) give a true resume; SIGTERM checkpoints at the epoch boundary
    and exits;
  - artifacts under logs/<savepath>: rewards/, prompts/, callback_info/,
    train_info/, samples/, per_prompt_stats/, metrics.jsonl,
    reward_curve.json, and log_0.png where matplotlib imports.

Not ported yet, each raising: lora_rank > 0, resident_inner_loop,
mesh_tp/mesh_sp > 1, more than one process, grad_reduce_dtype other than
none, a remote savepath, profile_dir, and optimizer adafactor.

Run: python -m ddpo_torch.pipelines.policy_gradient --dataset compressed-animals
"""

from __future__ import annotations

import copy
import json
import os
import random
import signal
from concurrent import futures
from typing import Callable, Dict

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ddpo_torch import training
from ddpo_torch.models.tokenizer import make_uncond_ids
from ddpo_torch.sampling import SamplerConfig, sample_trajectories, vae_decode
from ddpo_torch.training.optim import build_optimizer
from ddpo_torch.training.policy_gradient import (
    AccumulatingTrainState,
    train_step,
    train_step_fused,
)
from ddpo_torch.training.stat_tracking import PerPromptStatTracker
from ddpo_torch.utils import Timer, fs
from ddpo_torch.utils.checkpoints import (
    prune_checkpoints,
    restore_train_state,
    save_train_state,
    wait_for_pending_saves,
)
from ddpo_torch.utils.images import save_image
from ddpo_torch.utils.metrics import MetricsLogger
from ddpo_torch.utils.parser import Parser as BaseParser
from ddpo_torch.utils.serialization import load_stable_diffusion, resolve_device


class Parser(BaseParser):
    config: str = "ddpo_torch.config.base"
    dataset: str = "compressed_animals"


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _check_ported(args) -> None:
    not_ported = {
        "--lora_rank > 0": args.lora_rank > 0,
        "--resident_inner_loop": args.resident_inner_loop,
        "--mesh_tp/--mesh_sp > 1": args.mesh_tp > 1 or args.mesh_sp > 1,
        "more than one process": int(os.environ.get("WORLD_SIZE", "1")) > 1,
        "--grad_reduce_dtype": args.grad_reduce_dtype != "none",
        "a remote --savepath": fs.is_remote(args.savepath),
        "--profile_dir": bool(args.profile_dir),
    }
    for what, asked in not_ported.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported yet")


def make_train_apply(unet: torch.nn.Module, compute_dtype: torch.dtype,
                     remat: bool) -> Callable:
    """The trainer's UNet apply over a dict of master parameters.

    Each master is cast to ``compute_dtype`` at use, inside the call (as
    flax does with dtype=bf16 over fp32 params): the cast gives the bf16
    values the sampler's once-per-epoch cast gives, and it is differentiable,
    so the gradients reach the masters in their own dtype. With ``remat``
    the whole call is checkpointed and recomputed in the backward.
    """

    def run(params, latents, t, context):
        cast = {k: p.to(compute_dtype) for k, p in params.items()}
        return functional_call(unet, cast, (latents, t, context))

    def apply(params: Dict[str, torch.Tensor], latents, t, context):
        if remat:
            return checkpoint(run, params, latents, t, context, use_reentrant=False)
        return run(params, latents, t, context)

    return apply


def main(argv=None):
    args = Parser().parse_args("pg", argv)
    device = resolve_device(args.device)
    _check_ported(args)

    sample_bs = args.sample_batch_size
    train_bs = args.train_batch_size
    train_effective_bs = train_bs * args.train_accumulation_steps
    total_samples_per_epoch = args.num_sample_batches_per_epoch * sample_bs
    print(f"[ pg ] device: {device}")
    print(
        f"[ pg ] sample batch: {sample_bs} | train batch: {train_bs} | "
        f"effective: {train_effective_bs} | samples/epoch: {total_samples_per_epoch}"
    )
    assert args.sample_batch_size >= args.train_batch_size
    assert args.sample_batch_size % args.train_batch_size == 0
    assert total_samples_per_epoch % train_effective_bs == 0

    worker_id = 0
    localpath = "logs/" + args.savepath
    os.makedirs(localpath, exist_ok=True)
    metrics = MetricsLogger(localpath)

    # --------------------------------- models --------------------------------- #
    master_dtype = _dtype(args.dtype)
    sample_dtype = _dtype(args.sample_dtype)
    train_dtype = _dtype(args.train_dtype)
    models = load_stable_diffusion(
        args.pretrained_model,
        model_preset=args.model_preset,
        device=device,
        dtype=master_dtype,
        seed=args.base_seed,
    )
    # the text encoder and the VAE compute in the sampling dtype; the UNet
    # holds the master parameters (the optimizer's), trained in place
    models.text_encoder.to(sample_dtype)
    models.vae.to(sample_dtype)
    unet = models.unet.requires_grad_(True)
    print(f"[ pg ] unet params: {sum(p.numel() for p in unet.parameters()) / 1e6:.1f}M")
    # the sampler's copy at the sampling dtype, refreshed from the masters
    # once per epoch (the masters themselves when the dtypes agree)
    sample_unet = unet
    if sample_dtype != master_dtype:
        sample_unet = copy.deepcopy(unet).to(sample_dtype).requires_grad_(False)

    scheduler = models.scheduler
    sched_state = scheduler.set_timesteps(
        scheduler.create_state(device), args.n_inference_steps
    )
    # CFG as one 2B apply for bf16 training; fp32 keeps the two-apply form,
    # as the JAX package chooses
    cfg_concat = train_dtype == torch.bfloat16

    # ------------------------------- train state ------------------------------ #
    fused = args.fused_train_loop
    state = AccumulatingTrainState(
        apply_fn=make_train_apply(unet, train_dtype, args.remat),
        params=dict(unet.named_parameters()),
        tx=build_optimizer(args),
        # the fp32 accumulation buffer (3.4 GB at SD-1.4 scale) exists only
        # when something accumulates: explicit accumulation steps, or the
        # non-fused loop, which accumulates over the trained timesteps
        accumulate=args.train_accumulation_steps > 1 or not fused,
    )
    ckpt_root = args.savepath
    start_epoch = 0
    restored_host = None
    if args.resume:
        restored, _ = restore_train_state(ckpt_root)
        if restored is not None:
            state.load_state_dict(restored["state"])
            start_epoch = int(restored["epoch"]) + 1
            restored_host = restored.get("host")
            print(f"[ pg ] resumed from checkpoint at epoch {restored['epoch']}")

    vae_scale = 2 ** (len(models.vae.config.block_out_channels) - 1)
    sampler_config = SamplerConfig(
        num_inference_steps=args.n_inference_steps,
        guidance_scale=args.guidance_scale,
        eta=args.eta,
        height=args.resolution,
        width=args.resolution,
        vae_scale_factor=vae_scale,
        latent_channels=models.vae.config.latent_channels,
    )

    def text_encode(ids: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return models.text_encoder(torch.as_tensor(ids, device=device))

    step_fn = train_step_fused if fused else train_step
    step_kwargs = dict(
        scheduler_state=sched_state, scheduler=scheduler, train_cfg=args.train_cfg,
        guidance_scale=args.guidance_scale, eta=args.eta,
        clip_range=args.ppo_clip_range, cfg_concat=cfg_concat,
    )

    # ------------------------------ prompts/rewards --------------------------- #
    uncond_embed = text_encode(make_uncond_ids(models.tokenizer, 1))[0]
    sample_uncond = uncond_embed.expand(sample_bs, *uncond_embed.shape)
    train_uncond = sample_uncond[:train_bs]

    assert args.filter_field in training.callback_fns, (
        f"filter_field {args.filter_field!r} is not a registered reward "
        f"(known: {sorted(training.callback_fns)}); unknown --dataset names "
        "fall back to base defaults with filter_field=None"
    )
    callback_fns = {
        args.filter_field: training.callback_fns[args.filter_field](
            vae=models.vae, cache=args.cache
        )
    }
    executor = futures.ThreadPoolExecutor(max_workers=2)

    per_prompt_stats = None
    if args.per_prompt_stats_bufsize is not None:
        per_prompt_stats = PerPromptStatTracker(
            args.per_prompt_stats_bufsize, args.per_prompt_stats_min_count
        )

    # the sampler's noise; host-side RNGs (prompts, shuffles) are python's
    # and numpy's, seeded by the parser
    sample_gen = torch.Generator(device=device).manual_seed(args.base_seed)

    mean_rewards, std_rewards = [], []
    if restored_host is not None:
        # true resume: every stateful host object continues where it stopped
        sample_gen.set_state(restored_host["sample_generator"])
        mean_rewards = list(restored_host["mean_rewards"])
        std_rewards = list(restored_host["std_rewards"])
        if per_prompt_stats is not None and restored_host.get("per_prompt_stats"):
            per_prompt_stats.load_state_dict(restored_host["per_prompt_stats"])
        random.setstate(restored_host["py_random"])
        np.random.set_state(restored_host["np_random"])

    def host_checkpoint_state():
        return {
            "sample_generator": sample_gen.get_state(),
            "mean_rewards": list(mean_rewards),
            "std_rewards": list(std_rewards),
            "per_prompt_stats": per_prompt_stats.state_dict() if per_prompt_stats else None,
            "py_random": random.getstate(),
            "np_random": np.random.get_state(),
        }

    # Preemption safety: the handler only sets a flag; the loop checkpoints
    # the full state at the next epoch boundary and exits cleanly, so
    # --resume True continues exactly where the preempted run stopped.
    shutdown_requested = {"flag": False}

    def _on_sigterm(signum, frame):
        shutdown_requested["flag"] = True
        print("[ pg ] SIGTERM: checkpointing at the epoch boundary, then exiting")

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread (embedded use): skip the hook
        prev_sigterm = None

    timer = Timer()
    for epoch in range(start_epoch, args.num_train_epochs):
        # ============================ sampling phase =========================== #
        if sample_unet is not unet:
            with torch.no_grad():
                for ps, pm in zip(sample_unet.parameters(), unet.parameters()):
                    ps.copy_(pm)
        samples = []
        sample_phase_time = 0.0
        for i in range(args.num_sample_batches_per_epoch):
            sample_prompts, training_prompts, prompt_metadata = training.make_prompts(
                args.prompt_fn, sample_bs, args.identical_batch,
                evaluate=args.evaluate, **args.prompt_kwargs,
            )
            prompt_embeds = text_encode(models.tokenizer(list(sample_prompts)))
            timer()
            traj = sample_trajectories(
                sample_unet, scheduler, sched_state, prompt_embeds, sample_uncond,
                sampler_config, generator=sample_gen,
            )
            images = vae_decode(models.vae, traj["final_latents"]).cpu().numpy()
            sample_time = timer()
            sample_phase_time += sample_time

            callbacks = executor.submit(
                training.evaluate_callbacks, callback_fns, images,
                sample_prompts, prompt_metadata,
            )
            samples.append({
                "embeds": prompt_embeds,
                "latents": traj["latents"],
                "next_latents": traj["next_latents"],
                "log_probs": traj["log_probs"],
                "ts": traj["ts"],
                "prompts": np.array(sample_prompts),
                "callbacks": callbacks,
            })
            print(
                f"[ pg ] epoch {epoch} sample batch {i}: {sample_bs} samples "
                f"in {sample_time:.2f}s ({sample_bs / sample_time:.3f}/s)"
            )
            save_image(
                fs.join_and_create(localpath, f"samples/{worker_id}_{epoch}_{i}.png"),
                images[0],
            )

        # collect rewards
        for sample in samples:
            sample["rewards"], sample["callback_info"] = sample.pop("callbacks").result()[
                args.filter_field
            ]
        samples = _concat(samples)
        rewards = np.asarray(samples["rewards"], dtype=np.float64).reshape(
            len(samples["prompts"]), -1
        )[:, 0]
        samples["rewards"] = rewards

        if per_prompt_stats is not None:
            advantages = per_prompt_stats.update(samples["prompts"], rewards)
            np.save(
                fs.join_and_create(localpath, f"per_prompt_stats/{worker_id}_{epoch}.npy"),
                per_prompt_stats.get_stats(),
            )
        else:
            advantages = (rewards - rewards.mean()) / (rewards.std() + 1e-8)

        samples["advantages"] = torch.as_tensor(advantages, dtype=torch.float32, device=device)
        mean_rewards.append(float(rewards.mean()))
        std_rewards.append(float(rewards.std()))
        print(f"[ pg ] epoch {epoch} mean reward: {rewards.mean():.4f}")
        metrics.log(
            epoch,
            phase="sample",
            mean_reward=float(rewards.mean()),
            std_reward=float(rewards.std()),
            n_samples=int(rewards.shape[0]),
            sample_time_s=float(sample_phase_time),
        )

        for name in ("rewards", "prompts", "callback_info"):
            np.save(
                fs.join_and_create(localpath, f"{name}/{worker_id}_{epoch}.npy"),
                samples[name],
            )
            if name != "rewards":
                del samples[name]

        # ============================ training phase =========================== #
        for inner_epoch in range(args.num_inner_epochs):
            total_bs, num_timesteps = samples["log_probs"].shape
            assert num_timesteps == args.n_inference_steps

            perm = torch.as_tensor(np.random.permutation(total_bs), device=device)
            keys = ["embeds", "latents", "next_latents", "log_probs", "ts", "advantages"]
            shuffled = {k: samples[k][perm] for k in keys}

            # independent per-sample timestep permutation
            perms = torch.as_tensor(
                np.stack([np.random.permutation(num_timesteps) for _ in range(total_bs)]),
                device=device,
            )
            row = torch.arange(total_bs, device=device)[:, None]
            for key in ("latents", "next_latents", "log_probs", "ts"):
                shuffled[key] = shuffled[key][row, perms]

            # rebatch to (n_batches, train_bs, ...)
            n_batches = total_bs // train_bs
            batched = {
                k: v.reshape(n_batches, train_bs, *v.shape[1:]) for k, v in shuffled.items()
            }

            num_train_ts = int(num_timesteps * args.train_timestep_ratio)
            infos = []
            timer()
            for i in range(n_batches):
                base = {
                    "prompt_embeds": batched["embeds"][i],
                    "uncond_embeds": train_uncond,
                    "advantages": batched["advantages"][i],
                }
                do_opt_update = (i + 1) % args.train_accumulation_steps == 0
                if fused:
                    batch = dict(base, **{
                        k: batched[k][i][:, :num_train_ts].transpose(0, 1)
                        for k in ("latents", "next_latents", "log_probs", "ts")
                    })
                    state, info = step_fn(state, batch, do_opt_update=do_opt_update,
                                          **step_kwargs)
                    infos.append({k: float(v) for k, v in info.items()})
                else:
                    for j in range(num_train_ts):
                        batch = dict(base, **{
                            k: batched[k][i][:, j]
                            for k in ("latents", "next_latents", "log_probs", "ts")
                        })
                        upd = do_opt_update and (j == num_train_ts - 1)
                        state, info = step_fn(state, batch, do_opt_update=upd,
                                              **step_kwargs)
                        infos.append({k: float(v) for k, v in info.items()})
            train_time = timer()
            infos = {k: np.stack([i[k] for i in infos]) for k in infos[0]}
            print(
                f"[ pg ] epoch {epoch}.{inner_epoch}: "
                f"loss {infos['loss'].mean():.5f} | kl {infos['approx_kl'].mean():.2e} "
                f"| clipfrac {infos['clipfrac'].mean():.3f} | {train_time:.2f}s"
            )
            metrics.log(
                epoch,
                phase="train",
                inner_epoch=inner_epoch,
                loss=float(infos["loss"].mean()),
                approx_kl=float(infos["approx_kl"].mean()),
                clipfrac=float(infos["clipfrac"].mean()),
                train_time_s=float(train_time),
            )
            np.save(
                fs.join_and_create(localpath, f"train_info/{worker_id}_{epoch}_{inner_epoch}.npy"),
                infos,
            )

        # ============================ checkpointing ============================ #
        if (
            (epoch + 1) % args.save_freq == 0
            or epoch == args.num_train_epochs - 1
            or shutdown_requested["flag"]
        ):
            # the host copy is synchronous (training updates the tensors in
            # place); serialization and the disk write overlap the next epoch
            save_train_state(
                ckpt_root, epoch, {"state": state.state_dict(), "epoch": epoch},
                host_state=host_checkpoint_state(), block=False,
            )
            if args.keep_checkpoints > 0:
                prune_checkpoints(ckpt_root, args.keep_checkpoints)

        _plot_rewards(mean_rewards, std_rewards, localpath, worker_id)
        with open(os.path.join(localpath, "reward_curve.json"), "w") as f:
            json.dump({"mean": mean_rewards, "std": std_rewards}, f)

        if shutdown_requested["flag"]:
            print(f"[ pg ] graceful shutdown after epoch {epoch} (checkpointed)")
            break

    if prev_sigterm is not None:
        signal.signal(signal.SIGTERM, prev_sigterm)
    executor.shutdown()
    wait_for_pending_saves()
    return mean_rewards


def _concat(batches):
    """Concatenate a list of sample batches leaf by leaf (tensors on their
    device, arrays with numpy, dicts key by key)."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: _concat([b[k] for b in batches]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.cat(batches)
    return np.concatenate(batches)


def _plot_rewards(mean_rewards, std_rewards, localpath, worker_id):
    try:
        import matplotlib
    except ImportError:
        print("[ pg ] matplotlib is not installed: log_0.png skipped "
              "(reward_curve.json has the curve)")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.clf()
    mean, std = np.array(mean_rewards), np.array(std_rewards)
    plt.plot(mean, color="black")
    plt.fill_between(range(len(mean)), mean - std, mean + std, alpha=0.4, color="blue")
    plt.savefig(os.path.join(localpath, f"log_{worker_id}.png"))
    plt.close()


if __name__ == "__main__":
    main()
