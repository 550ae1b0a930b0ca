"""DDPO: PPO-style clipped policy gradient over the denoising chain.

Port of ddpo_tpu/training/policy_gradient.py:

  - recompute eps at the stored (latent, t) under the current params (CFG as
    one 2B apply with ``cfg_concat``, as two B applies without, or no CFG),
  - score the stored next_latents through the DDIM step in score mode to get
    the new log-prob,
  - PPO clipped surrogate on exp(logp_new - logp_old) with advantages clipped
    to +-ADV_CLIP_MAX; info = approx_kl / clipfrac / loss,
  - gradient accumulation with a ``do_update`` flag
    (``AccumulatingTrainState``).

``train_step_fused`` is the JAX scan over the timestep axis as a Python
loop: each timestep's backward adds its gradient to the fp32 ``.grad`` of
the fp32 master parameters, so the sum is taken in fp32 as JAX's scan takes
it; the sum is divided by T and applied in one optimizer update.

``apply_fn(params, latents, t, context)`` runs the UNet on a dict of master
parameters; pipelines/policy_gradient.py builds it to cast them to the compute dtype at use
(pipelines/policy_gradient.py).

Data parallelism: each rank computes the mean gradient of its own rows,
and the state's ``grad_reduce`` (parallel/collectives.py
``GradientAllReduce``) averages it over ranks once per optimizer step,
after accumulation and before the clip: equal rows per rank make that the
global-batch mean JAX's GSPMD step takes; with a ``reduce_dtype`` it is
JAX's ``grad_reduce_dtype``. ``inner_epoch_resident`` is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ddpo_torch.core.scheduler import DDIMScheduler, DDIMState

ADV_CLIP_MAX = 10.0

Tensors = Dict[str, torch.Tensor]


class AccumulatingTrainState:
    """Master params, optimizer state, and a gradient-accumulation buffer.

    ``params`` are the fp32 master tensors (``requires_grad``), updated in
    place by ``tx``. ``grad_acc`` (fp32, params-sized: 3.4 GB at SD-1.4
    scale) exists only when ``accumulate`` is set, as in the JAX package.
    ``grad_reduce`` (None in one process) reduces the gradients over ranks
    just before each optimizer update: their mean, or with
    ``reduce="sum"`` their sum (the weighted RWR loss, training/diffusion.py).
    """

    def __init__(self, apply_fn: Callable, params: Tensors, tx,
                 accumulate: bool = True, grad_reduce: Optional[Callable] = None):
        self.apply_fn = apply_fn
        self.params = params
        self.tx = tx
        self.grad_reduce = grad_reduce
        self.opt_state = tx.init(params)
        self.step = 0
        self.grad_acc: Optional[Tensors] = (
            {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
            if accumulate else None
        )
        self.n_acc = 0

    def _update(self, grads: Tensors, reduce: str) -> None:
        if self.grad_reduce is not None:
            grads = self.grad_reduce(grads, reduce)
        self.tx.step(self.params, grads, self.opt_state)
        self.step += 1

    @torch.no_grad()
    def apply_gradients(self, *, grads: Tensors, do_update: bool = True,
                        reduce: str = "mean") -> None:
        if self.grad_acc is None:
            assert do_update, "created without an accumulation buffer"
            self._update(grads, reduce)
            return
        if do_update:
            n = self.n_acc + 1
            self._update({k: (ga + grads[k]) / n for k, ga in self.grad_acc.items()}, reduce)
            for ga in self.grad_acc.values():
                ga.zero_()
            self.n_acc = 0
            return
        for k, ga in self.grad_acc.items():
            ga.add_(grads[k])
        self.n_acc += 1

    def state_dict(self) -> dict:
        return {
            "params": {k: p.detach() for k, p in self.params.items()},
            "opt_state": self.opt_state,
            "step": self.step,
            "grad_acc": self.grad_acc,
            "n_acc": self.n_acc,
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for k, p in self.params.items():
            p.copy_(state["params"][k])
        opt = state["opt_state"]
        self.opt_state["count"] = int(opt["count"])
        for moment, tensors in self.opt_state.items():
            if moment != "count":
                for k, m in tensors.items():
                    m.copy_(opt[moment][k])
        self.step = int(state["step"])
        if self.grad_acc is not None and state.get("grad_acc") is not None:
            for k, ga in self.grad_acc.items():
                ga.copy_(state["grad_acc"][k])
        self.n_acc = int(state["n_acc"]) if self.grad_acc is not None else 0


def ppo_loss(
    params: Tensors,
    apply_fn: Callable,
    batch: Tensors,
    scheduler: DDIMScheduler,
    scheduler_state: DDIMState,
    train_cfg: bool,
    guidance_scale: float,
    eta: float,
    clip_range: float,
    cfg_concat: bool = False,
) -> Tuple[torch.Tensor, Tensors]:
    """Clipped-surrogate loss for one (batch, timestep) slice.

    batch keys: latents (B,4,h,w), next_latents, ts (B,), log_probs (B,),
    advantages (B,), prompt_embeds (B,77,D), uncond_embeds (B,77,D).

    cfg_concat runs CFG as one 2B apply ([uncond; cond], the sampler's
    order) instead of two B applies; the UNet is pointwise across the batch,
    so the math is the same.
    """
    if train_cfg and cfg_concat:
        eps = apply_fn(
            params,
            torch.cat([batch["latents"], batch["latents"]]),
            torch.cat([batch["ts"], batch["ts"]]),
            torch.cat([batch["uncond_embeds"], batch["prompt_embeds"]]),
        )
        eps_uncond, eps_text = eps.chunk(2)
        noise_pred = eps_uncond + guidance_scale * (eps_text - eps_uncond)
    elif train_cfg:
        eps_text = apply_fn(params, batch["latents"], batch["ts"], batch["prompt_embeds"])
        eps_uncond = apply_fn(params, batch["latents"], batch["ts"], batch["uncond_embeds"])
        noise_pred = eps_uncond + guidance_scale * (eps_text - eps_uncond)
    else:
        noise_pred = apply_fn(params, batch["latents"], batch["ts"], batch["prompt_embeds"])

    _, log_prob = scheduler.step(
        scheduler_state, noise_pred, batch["ts"], batch["latents"],
        prev_sample=batch["next_latents"], eta=eta,
    )

    advantages = torch.clamp(batch["advantages"], -ADV_CLIP_MAX, ADV_CLIP_MAX)
    ratio = torch.exp(log_prob - batch["log_probs"])
    unclipped = -advantages * ratio
    clipped = -advantages * torch.clamp(ratio, 1.0 - clip_range, 1.0 + clip_range)
    loss = torch.mean(torch.maximum(unclipped, clipped))

    with torch.no_grad():
        info = {
            # http://joschu.net/blog/kl-approx.html (same estimator as the reference)
            "approx_kl": 0.5 * torch.mean((log_prob - batch["log_probs"]) ** 2),
            "clipfrac": torch.mean((torch.abs(ratio - 1.0) > clip_range).float()),
            "loss": loss.detach(),
        }
    return loss, info


def _backward(loss: torch.Tensor, params: Tensors) -> None:
    """Add d loss / d params to each master's fp32 ``.grad``."""
    loss.backward(inputs=list(params.values()))


def _take_grads(params: Tensors) -> Tensors:
    grads = {}
    for k, p in params.items():
        grads[k] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return grads


def train_step(
    state: AccumulatingTrainState,
    batch: Tensors,
    scheduler_state: DDIMState,
    scheduler: DDIMScheduler,
    train_cfg: bool,
    guidance_scale: float,
    eta: float,
    clip_range: float,
    do_opt_update: bool,
    cfg_concat: bool = False,
) -> Tuple[AccumulatingTrainState, Tensors]:
    """One PPO update/accumulation step on one (batch, timestep) slice."""
    loss, info = ppo_loss(
        state.params, state.apply_fn, batch, scheduler, scheduler_state,
        train_cfg, guidance_scale, eta, clip_range, cfg_concat,
    )
    _backward(loss, state.params)
    state.apply_gradients(grads=_take_grads(state.params), do_update=do_opt_update)
    return state, info


def train_step_fused(
    state: AccumulatingTrainState,
    batch: Tensors,
    scheduler_state: DDIMState,
    scheduler: DDIMScheduler,
    train_cfg: bool,
    guidance_scale: float,
    eta: float,
    clip_range: float,
    do_opt_update: bool,
    cfg_concat: bool = False,
) -> Tuple[AccumulatingTrainState, Tensors]:
    """All timesteps of a minibatch, then one update.

    batch carries a leading timestep axis on latents/next_latents/ts/
    log_probs: (T, B, ...). The T gradients are summed in fp32 and divided
    by T (the reference's T accumulation steps with the optimizer firing on
    the last), then reduced over ranks by ``state.grad_reduce`` in its dtype
    (JAX's ``grad_reduce_mesh``/``grad_reduce_dtype``); infos are averaged
    over T (this rank's rows).
    """
    num_t = batch["ts"].shape[0]
    shared = {k: batch[k] for k in ("advantages", "prompt_embeds", "uncond_embeds")}
    info_sum = None
    for t in range(num_t):
        full = dict(shared, **{
            k: batch[k][t] for k in ("latents", "next_latents", "ts", "log_probs")
        })
        loss, info = ppo_loss(
            state.params, state.apply_fn, full, scheduler, scheduler_state,
            train_cfg, guidance_scale, eta, clip_range, cfg_concat,
        )
        _backward(loss, state.params)
        info_sum = info if info_sum is None else {k: info_sum[k] + v for k, v in info.items()}
    grads = _take_grads(state.params)
    with torch.no_grad():
        for g in grads.values():
            g.div_(num_t)
    state.apply_gradients(grads=grads, do_update=do_opt_update)
    return state, {k: v / num_t for k, v in info_sum.items()}
