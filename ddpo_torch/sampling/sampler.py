"""Trajectory-recording CFG DDIM sampler, the DPM-Solver++ ODE sampler,
VAE decode.

Port of ddpo_tpu/sampling/sampler.py, on one device. Classifier-free
guidance runs as one 2B batch ([uncond; cond]); ``sample_trajectories``
records the policy trajectory the PPO trainer consumes (latents,
next_latents, log_probs, ts), batch-major; ``sample_images`` keeps only the
final latents; ``sample_images_ode`` runs the deterministic DPM-Solver++(2M)
in few steps for inference. UNet activations run in the model's dtype;
scheduler math stays fp32.

The JAX scan becomes a Python loop. Randomness comes from an explicit
``torch.Generator``: the initial latents first, then one draw per step.
Tests inject ``init_latents`` and the per-step ``noise`` instead, since
torch and jax.random never give the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ddpo_torch.core.scheduler import (
    DDIMScheduler,
    DDIMState,
    DPMSolverPlusPlus,
    DPMSolverState,
)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_inference_steps: int = 50
    guidance_scale: float = 5.0
    eta: float = 1.0
    height: int = 512
    width: int = 512
    vae_scale_factor: int = 8
    latent_channels: int = 4


def _init_latents(state, prompt_embeds, config, generator, init_latents):
    cfg = config
    if init_latents is None:
        shape = (
            prompt_embeds.shape[0], cfg.latent_channels,
            cfg.height // cfg.vae_scale_factor, cfg.width // cfg.vae_scale_factor,
        )
        init_latents = torch.randn(
            shape, generator=generator, device=prompt_embeds.device, dtype=torch.float32
        )
    return init_latents.float() * state.init_noise_sigma


def _guided_eps(unet, latents, t, context, scale):
    """CFG as one 2B UNet call: eps_u + scale * (eps_c - eps_u)."""
    latents_input = torch.cat([latents] * 2)
    t_batch = t.expand(latents_input.shape[0])
    eps_uncond, eps_text = unet(latents_input, t_batch, context).chunk(2)
    return eps_uncond + scale * (eps_text - eps_uncond)


def _denoise(unet, scheduler, scheduler_state, prompt_embeds, uncond_embeds,
             config, generator, init_latents, noise):
    """The chain, one step at a time: yields (t, latents, next_latents, log_prob)."""
    state = scheduler.set_timesteps(scheduler_state, config.num_inference_steps)
    context = torch.cat([uncond_embeds, prompt_embeds])
    latents = _init_latents(state, prompt_embeds, config, generator, init_latents)
    for i, t in enumerate(state.timesteps):
        eps = _guided_eps(unet, latents, t, context, config.guidance_scale)
        new_latents, log_prob = scheduler.step(
            state, eps, t, latents,
            generator=None if noise is not None else generator,
            noise=None if noise is None else noise[i],
            eta=config.eta,
        )
        yield t, latents, new_latents, log_prob
        latents = new_latents


@torch.no_grad()
def sample_trajectories(
    unet: Callable,
    scheduler: DDIMScheduler,
    scheduler_state: DDIMState,
    prompt_embeds: torch.Tensor,  # (B, 77, D)
    uncond_embeds: torch.Tensor,  # (B, 77, D)
    config: SamplerConfig = SamplerConfig(),
    generator: Optional[torch.Generator] = None,
    init_latents: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,  # (T, B, 4, h, w) per-step noise
) -> Dict[str, torch.Tensor]:
    """Run the denoising chain, recording the policy trajectory.

    unet(latents_2B, timesteps_2B, context_2B) -> eps_2B (fp32).
    """
    ts, lat, next_lat, log_probs = zip(*_denoise(
        unet, scheduler, scheduler_state, prompt_embeds, uncond_embeds,
        config, generator, init_latents, noise,
    ))
    return {
        "final_latents": next_lat[-1],  # (B, 4, h, w)
        "latents": torch.stack(lat, dim=1),  # (B, T, 4, h, w)
        "next_latents": torch.stack(next_lat, dim=1),
        "log_probs": torch.stack(log_probs, dim=1),  # (B, T)
        "ts": torch.stack(ts)[None].expand(prompt_embeds.shape[0], -1),
    }


@torch.no_grad()
def sample_images(
    unet: Callable,
    scheduler: DDIMScheduler,
    scheduler_state: DDIMState,
    prompt_embeds: torch.Tensor,
    uncond_embeds: torch.Tensor,
    config: SamplerConfig = SamplerConfig(),
    generator: Optional[torch.Generator] = None,
    init_latents: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generation only: the final latents, keeping no trajectory.

    Same chain and random stream as ``sample_trajectories``, so the same
    generator state gives the same final latents.
    """
    for _, _, latents, _ in _denoise(
        unet, scheduler, scheduler_state, prompt_embeds, uncond_embeds,
        config, generator, init_latents, noise,
    ):
        pass
    return latents


@torch.no_grad()
def sample_images_ode(
    unet: Callable,
    scheduler: DPMSolverPlusPlus,
    scheduler_state: DPMSolverState,
    prompt_embeds: torch.Tensor,
    uncond_embeds: torch.Tensor,
    config: SamplerConfig = SamplerConfig(),
    generator: Optional[torch.Generator] = None,
    init_latents: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Deterministic few-step generation with DPM-Solver++(2M).

    The same CFG batching and initial draw as ``sample_images``, then
    ``num_inference_steps`` model calls of the second-order solver, carrying
    (latents, previous x0 estimate). ``config.eta`` is ignored: the solver
    integrates the eta-0 probability-flow ODE, so the generator is drawn
    from once, for the initial latents.
    """
    state = scheduler.set_timesteps(scheduler_state, config.num_inference_steps)
    context = torch.cat([uncond_embeds, prompt_embeds])
    latents = _init_latents(state, prompt_embeds, config, generator, init_latents)
    prev_x0 = torch.zeros_like(latents)
    for i, t in enumerate(state.timesteps):
        eps = _guided_eps(unet, latents, t, context, config.guidance_scale)
        latents, prev_x0 = scheduler.step(state, eps, i, latents, prev_x0)
    return latents


@torch.no_grad()
def vae_decode(vae, latents: torch.Tensor, scaling_factor: float = 0.18215) -> torch.Tensor:
    """Latents (B, 4, h, w) -> images (B, H, W, 3) in [0, 1], fp32."""
    images = vae.decode(latents / scaling_factor)
    return torch.clamp(images / 2 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
