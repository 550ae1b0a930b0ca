"""RWR: weighted/filtered supervised finetuning on sampled data.

Port of ddpo_tpu/training/diffusion.py (the reference's
training/diffusion.py:6-102):

  - batch["vae"] holds the stored VAE posterior moments (channel-last,
    (B, h, w, 8)); sample the posterior, transpose to NCHW, scale 0.18215,
  - draw a uniform random timestep per sample, add forward-process noise,
  - text-encode inside the step, optional CFG recombination at train time
    (two B applies, or one 2B apply with ``cfg_concat``),
  - epsilon-MSE loss, the mean over samples, or with per-sample weights
    (softmax RWR weights, normalized by the caller to a batch sum of about
    1) their weighted sum,
  - one optimizer step of ``state`` (training/policy_gradient.py's
    ``AccumulatingTrainState`` without an accumulation buffer: clip + adamw
    or adafactor, training/optim.py); over ranks its ``grad_reduce``
    averages the unweighted gradients and sums the weighted ones (JAX's
    weights come from the global ``sharded_softmax`` or ``/ pod_batch_size``,
    so its global step is a sum of the ranks' weighted sums).

``state.apply_fn(params, latents, t, context)`` runs the UNet; the finetune
driver builds it with pipelines/policy_gradient.py's ``make_train_apply``,
which casts the parameters to the compute dtype at use, merges LoRA
adapters onto their frozen base, and rematerializes the UNet call.

Randomness comes from an explicit ``torch.Generator``, in JAX's order
(posterior noise, noise, timesteps), or is injected as ``Draws``: tests feed
the draws of JAX's ``jax.random.split(rng, 4)``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ddpo_torch.core.scheduler import DDIMState, DDPMScheduler
from ddpo_torch.models.vae import DiagonalGaussian


class Draws(NamedTuple):
    posterior: torch.Tensor  # (B, h, w, latent) noise of the posterior sample
    noise: torch.Tensor  # (B, latent, h, w) forward-process noise
    timesteps: torch.Tensor  # (B,) int64 in [0, num_train_timesteps)


def draw(moments: torch.Tensor, num_train_timesteps: int,
         generator: Optional[torch.Generator]) -> Draws:
    """The step's random inputs for channel-last (B, h, w, 2 * latent)
    moments, from ``generator`` in JAX's order."""
    b, h, w, c = moments.shape
    kwargs = dict(generator=generator, device=moments.device)
    posterior = torch.randn((b, h, w, c // 2), dtype=moments.dtype, **kwargs)
    noise = torch.randn((b, c // 2, h, w), dtype=torch.float32, **kwargs)
    timesteps = torch.randint(0, num_train_timesteps, (b,), **kwargs)
    return Draws(posterior, noise, timesteps)


def train_step(
    state,
    text_encoder,
    batch: Dict[str, torch.Tensor],
    scheduler_state: DDIMState,
    scheduler: DDPMScheduler,
    train_cfg: bool,
    guidance_scale: float,
    weights: Optional[torch.Tensor] = None,
    scaling_factor: float = 0.18215,
    cfg_concat: bool = False,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
) -> torch.Tensor:
    """One supervised finetune step; returns the loss (detached).

    batch: "vae" (B, h, w, 8) fp32 moments, "input_ids" and "uncond_text"
    (B, 77) token ids, on the device. Each parameter's ``.grad`` holds this
    step's gradient afterwards (reduced over ranks by ``state.grad_reduce``).
    The loss is this rank's.
    """
    params = state.params
    for p in params.values():
        p.grad = None
    moments = batch["vae"]
    if draws is None:
        draws = draw(moments, scheduler.num_train_timesteps, generator)

    # stored channel-last moments -> latents (NCHW), SD scaling
    latents = DiagonalGaussian(moments, dim=-1).sample(noise=draws.posterior)
    latents = latents.permute(0, 3, 1, 2).contiguous() * scaling_factor
    noise, timesteps = draws.noise, draws.timesteps
    noisy = scheduler.add_noise(scheduler_state, latents, noise, timesteps)

    with torch.no_grad():  # the text tower is frozen
        context = text_encoder(batch["input_ids"])
        uncond_context = text_encoder(batch["uncond_text"]) if train_cfg else None

    apply_fn = state.apply_fn
    if train_cfg and cfg_concat:
        eps = apply_fn(params, torch.cat([noisy, noisy]), torch.cat([timesteps, timesteps]),
                       torch.cat([uncond_context, context]))
        eps_uncond, eps_text = eps.chunk(2)
        noise_pred = eps_uncond + guidance_scale * (eps_text - eps_uncond)
    elif train_cfg:
        eps_text = apply_fn(params, noisy, timesteps, context)
        eps_uncond = apply_fn(params, noisy, timesteps, uncond_context)
        noise_pred = eps_uncond + guidance_scale * (eps_text - eps_uncond)
    else:
        noise_pred = apply_fn(params, noisy, timesteps, context)

    loss = ((noise - noise_pred) ** 2).mean(dim=tuple(range(1, noise.dim())))
    loss = loss.mean() if weights is None else (loss * weights).sum()
    loss.backward()
    # over ranks: the unweighted loss is a mean over the global batch, so
    # ranks average; the weighted one is a sum with globally normalized
    # weights, so ranks sum
    state.apply_gradients(grads={k: p.grad for k, p in params.items()},
                          reduce="mean" if weights is None else "sum")
    return loss.detach()
