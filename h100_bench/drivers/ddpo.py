"""The DDPO epoch of ddpo_torch, driven as ``policy_gradient.main`` drives it.

``main`` builds its own models, takes no weights from its caller and writes
the full-state checkpoint on its last epoch, so it cannot be the window.
This driver calls what ``main`` calls, in ``main``'s order and with its
arguments, in one process on one card:

  set-up: the stack at the configuration's sizes with weights made here from
  the seed (``weights.py``), the text encoder and the VAE cast to the
  sampling dtype, the LoRA base and adapters or the fp32 masters, the
  sampler's UNet (``sampler_unet``), ``make_train_apply``,
  ``build_optimizer`` and ``AccumulatingTrainState``, the unconditional
  embedding, the JPEG reward in a two-worker thread pool and
  ``PerPromptStatTracker``;

  an epoch: ``training.make_prompts``, the text encode, ``sample_trajectories``
  under ``batch_invariant()``, ``vae_decode`` to host images, the reward
  through ``training.evaluate_callbacks`` on the pool, the advantages, the
  host-drawn permutations and ``inner_epoch_resident`` under
  ``batch_invariant()``, then ``refresh_sampler`` (of ``merge_lora`` for LoRA).

It leaves out what writes to disk (sample PNGs, the reward and info arrays,
checkpoints) and what only a multi-process run does (gathers, barriers).
The first epoch warms every shape and is recorded for the check; the window
then runs the whole number of epochs nearest ``seconds`` at the warm-up
epoch's pace, at least one.
"""

from __future__ import annotations

import contextlib
import gc
import random
import time
import types
from concurrent import futures

import numpy as np
import torch

from h100_bench import weights

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Spans:
    """Host-clock intervals by name; each ends in a synchronize on the card."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.intervals = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.cuda:
                torch.cuda.synchronize()
            self.intervals.setdefault(name, []).append((start, time.perf_counter()))

    def total(self, name: str, since: float = float("-inf")) -> float:
        return sum(b - a for a, b in self.intervals.get(name, ()) if a >= since)


def port_configs(model: dict):
    """The port's config objects for the configuration file's groups, and
    a check that every key the port does not read has the value it builds."""
    from ddpo_torch.models import CLIPTextConfig, UNetConfig, VAEConfig

    u, v, t = model["unet"], model["vae"], model["text_encoder"]
    fixed = {"act_fn": "silu", "norm_num_groups": 32, "norm_eps": 1e-05, "flip_sin_to_cos": True,
             "downsample_padding": 1, "center_input_sample": False, "mid_block_scale_factor": 1}
    for key, value in fixed.items():
        for group in (u, v):
            if key in group and group[key] != value:
                raise ValueError(f"the port builds {key} = {value}, the configuration has {group[key]}")
    if t.get("hidden_act", "quick_gelu") != "quick_gelu":
        raise ValueError("the port's text encoder is quick_gelu")
    unet = UNetConfig(
        sample_size=u["sample_size"], in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]), layers_per_block=u["layers_per_block"],
        attention_heads=u["attention_head_dim"], cross_attention_dim=u["cross_attention_dim"],
        down_block_has_attn=tuple(b.startswith("CrossAttn") for b in u["down_block_types"]),
        freq_shift=float(u["freq_shift"]))
    up = tuple(b.startswith("CrossAttn") for b in u["up_block_types"])
    if up != tuple(reversed(unet.down_block_has_attn)):
        raise ValueError("the port's up blocks mirror its down blocks")
    vae = VAEConfig(in_channels=v["in_channels"], out_channels=v["out_channels"],
                    block_out_channels=tuple(v["block_out_channels"]),
                    layers_per_block=v["layers_per_block"], latent_channels=v["latent_channels"],
                    scaling_factor=v["scaling_factor"])
    text = CLIPTextConfig(vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                          intermediate_size=t["intermediate_size"],
                          num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                          max_position_embeddings=t["max_position_embeddings"],
                          layer_norm_eps=t["layer_norm_eps"])
    return text, vae, unet


def build_stack(model: dict, device, seed: int):
    """(text_encoder, vae, unet) of the port at the configuration's sizes,
    fp32, with the weights of ``seed``; as ``load_stable_diffusion`` leaves
    them: eval mode, no gradients."""
    from ddpo_torch.models import AutoencoderKL, CLIPTextModel, UNet2DCondition

    text_cfg, vae_cfg, unet_cfg = port_configs(model)
    with torch.device("meta"):
        modules = (CLIPTextModel(text_cfg), AutoencoderKL(vae_cfg), UNet2DCondition(unet_cfg))
    modules = tuple(m.to_empty(device=device) for m in modules)
    for m, name in zip(modules, ("text_encoder", "vae", "unet")):
        weights.fill_module_(m, seed, name)
        m.eval().requires_grad_(False)
    return modules


def optimizer_args(model: dict) -> types.SimpleNamespace:
    keys = ("optimizer", "learning_rate", "beta1", "beta2", "epsilon", "weight_decay",
            "max_grad_norm", "lr_schedule", "lr_warmup_steps", "lr_total_steps")
    return types.SimpleNamespace(**{k: model[k] for k in keys})


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


class DDPOEpochs:
    """The set-up of ``main`` for one process and its epoch, for the window."""

    def __init__(self, model: dict, traffic: dict, seed: int, device):
        from ddpo_torch import training
        from ddpo_torch.models.lora import init_lora, target_paths
        from ddpo_torch.models.tokenizer import get_tokenizer, make_uncond_ids
        from ddpo_torch.pipelines.policy_gradient import (
            make_train_apply, sampler_unet)
        from ddpo_torch.sampling import SamplerConfig
        from ddpo_torch.training.optim import build_optimizer
        from ddpo_torch.training.policy_gradient import AccumulatingTrainState
        from ddpo_torch.training.stat_tracking import PerPromptStatTracker
        from ddpo_torch.utils.serialization import resolve_device, sd_scheduler

        self.model, self.traffic, self.seed = model, traffic, seed
        self.device = device = resolve_device(device)
        self.cuda = device.type == "cuda"
        self.spans = Spans(self.cuda)
        random.seed(seed)
        np.random.seed(seed % 2**32)
        torch.manual_seed(seed)
        if self.cuda:
            from ddpo_torch.ops._build import load_library

            torch.zeros(1, device=device)
            load_library()
        master, self.sample_dtype, train_dtype = (DTYPES[model[k]] for k in
                                                  ("dtype", "sample_dtype", "train_dtype"))
        self.text_encoder, self.vae, unet = build_stack(model, device, seed)
        self.text_encoder.to(self.sample_dtype)
        self.vae.to(self.sample_dtype)
        self.tokenizer = get_tokenizer(None)
        self.lora_base = None
        if model["lora_rank"] > 0:
            unet.to(train_dtype if train_dtype == self.sample_dtype else master)
            self.lora_base = dict(unet.named_parameters())
            params = init_lora(self.lora_base, model["lora_rank"],
                               torch.Generator(device=device).manual_seed(seed),
                               targets=tuple(model["lora_targets"]))
            weights.fill_lora_(params, seed)
            for p in params.values():
                p.requires_grad_(True)
            own = [path + ".weight" for path in target_paths(self.lora_base,
                                                             tuple(model["lora_targets"]))]
        else:
            unet.to(master)
            params = dict(unet.requires_grad_(True).named_parameters())
            own = ()
        self.sample_unet = sampler_unet(unet, self.sample_dtype, own)
        self.scheduler = sd_scheduler()
        self.sched_state = self.scheduler.set_timesteps(
            self.scheduler.create_state(device), traffic["n_inference_steps"])
        self.applies = 0
        train_apply = make_train_apply(unet, train_dtype, model["remat"], self.lora_base, None)

        def counted_apply(*a):
            self.applies += 1
            return train_apply(*a)

        self.state = AccumulatingTrainState(
            apply_fn=counted_apply, params=params, tx=build_optimizer(optimizer_args(model)),
            accumulate=traffic["train_accumulation_steps"] > 1, grad_reduce=None)
        vae_scale = 2 ** (len(self.vae.config.block_out_channels) - 1)
        self.sampler_config = SamplerConfig(
            num_inference_steps=traffic["n_inference_steps"],
            guidance_scale=traffic["guidance_scale"], eta=traffic["eta"],
            height=traffic["resolution"], width=traffic["resolution"],
            vae_scale_factor=vae_scale, latent_channels=self.vae.config.latent_channels)
        self.uncond_embed = self.text_encode(make_uncond_ids(self.tokenizer, 1))[0]
        self.sample_uncond = self.uncond_embed.expand(traffic["sample_batch_size"],
                                                      *self.uncond_embed.shape)
        self.training = training
        self.reward = traffic["reward"]
        self.callback_fns = {self.reward: training.callback_fns[self.reward](vae=self.vae,
                                                                            cache="cache")}
        self.executor = futures.ThreadPoolExecutor(max_workers=2)
        self.stats = PerPromptStatTracker(traffic["per_prompt_stats_bufsize"],
                                          traffic["per_prompt_stats_min_count"])
        self.sample_gen = weights.generator(seed, "sampler", device)
        self.epoch_kwargs = dict(
            scheduler_state=self.sched_state, scheduler=self.scheduler,
            train_cfg=model["train_cfg"], guidance_scale=traffic["guidance_scale"],
            eta=traffic["eta"], clip_range=model["ppo_clip_range"],
            cfg_concat=train_dtype == torch.bfloat16,
            accumulation_steps=traffic["train_accumulation_steps"])
        self.sampler_steps = 0

    def text_encode(self, ids: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return self.text_encoder(torch.as_tensor(ids, device=self.device))

    def sampler_params(self) -> dict:
        from ddpo_torch.models.lora import merge_lora

        if self.lora_base is None:
            return self.state.params
        return merge_lora(self.lora_base, self.state.params)

    def epoch(self, record: dict = None) -> None:
        """One DDPO epoch; ``record`` (a dict) keeps what the check compares."""
        from ddpo_torch.ops.invariance import batch_invariant
        from ddpo_torch.pipelines.policy_gradient import _concat, refresh_sampler
        from ddpo_torch.sampling import sample_trajectories, vae_decode
        from ddpo_torch.training.policy_gradient import inner_epoch_resident

        t, span, b = self.traffic, self.spans, self.traffic["sample_batch_size"]
        samples = []
        for _ in range(t["num_sample_batches_per_epoch"]):
            with span("prompts"):
                prompts, _, metadata = self.training.make_prompts(
                    t["prompt_fn"], b, False, evaluate=False, **t["prompt_kwargs"])
                embeds = self.text_encode(self.tokenizer(list(prompts)))
            if record is not None:
                record.update(prompts=list(prompts), embeds=embeds.float().cpu(),
                              gen_state=self.sample_gen.get_state())
            with span("sampler"), batch_invariant():
                traj = sample_trajectories(self.sample_unet, self.scheduler, self.sched_state,
                                           embeds, self.sample_uncond, self.sampler_config,
                                           generator=self.sample_gen)
            self.sampler_steps += t["n_inference_steps"]
            with span("decode"):
                images = vae_decode(self.vae, traj["final_latents"]).cpu().numpy()
            callbacks = self.executor.submit(self.training.evaluate_callbacks,
                                             self.callback_fns, images, prompts, metadata)
            samples.append({"embeds": embeds, "latents": traj["latents"],
                            "next_latents": traj["next_latents"],
                            "log_probs": traj["log_probs"], "ts": traj["ts"],
                            "prompts": np.array(prompts), "callbacks": callbacks})
            if record is not None:
                record.update(images=images, ts=traj["ts"].cpu(),
                              **{k: traj[k].float().cpu() for k in
                                 ("latents", "next_latents", "log_probs", "final_latents")})
        with span("reward_wait"):
            for sample in samples:
                sample["rewards"], _ = sample.pop("callbacks").result()[self.reward]
        with span("advantages"):
            samples = _concat(samples)
            rewards = np.asarray(samples["rewards"], dtype=np.float64).reshape(
                len(samples["prompts"]), -1)[:, 0]
            advantages = self.stats.update(samples["prompts"], rewards)
            samples["advantages"] = torch.as_tensor(advantages, dtype=torch.float32,
                                                    device=self.device)
        total_bs, num_timesteps = samples["log_probs"].shape
        num_train_ts = int(num_timesteps * self.model["train_timestep_ratio"])
        keys = ["embeds", "latents", "next_latents", "log_probs", "ts", "advantages"]
        epoch_samples = {k: samples[k] for k in keys}
        epoch_samples["uncond_embeds"] = self.uncond_embed.expand(total_bs,
                                                                  *self.uncond_embed.shape)
        if record is not None:
            record.update(rewards=rewards, advantages=advantages, n_train=num_train_ts)
        for _ in range(t["num_inner_epochs"]):
            perm = np.random.permutation(total_bs)
            t_perms = np.stack([np.random.permutation(num_timesteps) for _ in range(total_bs)])
            with span("train"), batch_invariant():
                self.state, infos = inner_epoch_resident(
                    self.state, epoch_samples, num_train_ts=num_train_ts,
                    perm=torch.as_tensor(perm, device=self.device),
                    t_perms=torch.as_tensor(t_perms, device=self.device),
                    train_batch_size=t["train_batch_size"], **self.epoch_kwargs)
                infos = {k: v.double().cpu().numpy() for k, v in infos.items()}
            if record is not None:
                record.update(perm=perm, t_perms=t_perms, infos=infos)
        with span("refresh"), torch.no_grad():
            refresh_sampler(self.sample_unet, self.sampler_params())

    def close(self) -> None:
        self.executor.shutdown()


def record_update(run: DDPOEpochs, record: dict, before: dict) -> None:
    """What the first optimizer step did, read from the program's state: each
    leaf's gradient norm as adamw got it (from its second moment after one
    step, (1 - b2) g^2), its signed first moment ((1 - b1) g, as the
    optimizer stores it), the norm of each leaf's change, and the sampler's
    weights after the refresh for a few leaves with the parameters they
    came from."""
    b2 = run.model["beta2"]
    nu = run.state.opt_state["nu"]
    record["grad_norms"] = {k: float(torch.sqrt(v.double().sum() / (1 - b2))) for k, v in nu.items()}
    record["first_moments"] = {k: v.detach().to("cpu", copy=True) for k, v in run.state.opt_state["mu"].items()}
    record["change_norms"] = leaf_norms({k: p.detach() - before[k]
                                         for k, p in run.state.params.items()})
    record["opt_count"] = int(run.state.opt_state["count"])
    sampler = dict(run.sample_unet.named_parameters())
    names = sorted(k for k in sampler if k.endswith("weight"))
    if run.lora_base is not None:
        chosen = sorted(k[:-2] + ".weight" for k in run.state.params if k.endswith(".a"))
        record["adapters"] = {k: v.detach().to("cpu", copy=True) for k, v in run.state.params.items()}
    else:
        chosen = names
    pick = np.random.default_rng(run.seed % 2**32).choice(len(chosen), size=min(8, len(chosen)),
                                                          replace=False)
    chosen = [chosen[i] for i in sorted(pick)]
    record["sampler_weights"] = {k: sampler[k].detach().to("cpu", copy=True) for k in chosen}
    if run.lora_base is None:
        record["masters"] = {k: run.state.params[k].detach().to("cpu", copy=True) for k in chosen}


def recorded_epoch(ddpo: DDPOEpochs) -> dict:
    """The first epoch, with what the check compares recorded."""
    record = {}
    before = {k: p.detach().clone() for k, p in ddpo.state.params.items()}
    ddpo.epoch(record)
    record_update(ddpo, record, before)
    return record


def record_first_epoch(cell: dict, seed: int, device) -> dict:
    """A run's set-up and its recorded first epoch alone, the state freed."""
    ddpo = DDPOEpochs(cell["model"], cell["traffic"], seed, device)
    record = recorded_epoch(ddpo)
    ddpo.close()
    del ddpo
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return record


def run(cell: dict, seed: int, seconds: float, device, trace: bool, t0: float):
    """Set-up, one recorded warm-up epoch, the window, then the program's
    state freed. Returns the measurements and the records for the check."""
    from h100_bench import trace as tracing
    from h100_bench.work import EpochWork

    model, traffic = cell["model"], cell["traffic"]
    entered = time.perf_counter()
    ddpo = DDPOEpochs(model, traffic, seed, device)
    built = time.perf_counter()
    record = recorded_epoch(ddpo)
    warm_epoch_s = time.perf_counter() - built
    # the whole number of epochs nearest ``seconds`` at the warm-up's pace,
    # fixed before the window so that its count does not follow the
    # window's own speed
    epochs = max(1, round(seconds / warm_epoch_s))
    if ddpo.cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    profiler = tracing.Profiler(ddpo.cuda) if trace else None
    if profiler is not None:
        profiler.start()
    start = time.perf_counter()
    setup_s = start - t0
    steps0, applies0 = ddpo.sampler_steps, ddpo.applies
    for _ in range(epochs):
        ddpo.epoch()
    if ddpo.cuda:
        torch.cuda.synchronize()
    end = time.perf_counter()
    trace_summary = profiler.stop(ddpo.spans, start, end) if profiler is not None else None
    peak = torch.cuda.max_memory_allocated() if ddpo.cuda else 0
    work = EpochWork(model, traffic, model["lora_rank"], model["lora_targets"],
                     int(traffic["n_inference_steps"] * model["train_timestep_ratio"]))
    result = types.SimpleNamespace(
        setup_s=setup_s, window_s=end - start, epochs=epochs, spans=ddpo.spans, start=start,
        sampler_steps=ddpo.sampler_steps - steps0, applies=ddpo.applies - applies0,
        work=work, peak_bytes=peak, trace=trace_summary, record=record,
        setup_parts={"imports": entered - t0, "build": built - entered, "warmup": start - built})
    ddpo.close()
    del ddpo
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return result
