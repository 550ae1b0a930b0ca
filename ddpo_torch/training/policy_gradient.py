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
JAX's ``grad_reduce_dtype``.

Tensor parallelism: with ``tp`` (a parallel/sharding.py ``TensorParallel``)
the state holds this rank's slices of the sharded parameters, and so do
the accumulation buffer and the optimizer moments; ``state_dict`` gathers
the whole state in JAX's global layout (every rank of the group calls it)
and ``load_state_dict`` takes this rank's slices of a whole one, so a
checkpoint written at one tp resumes at any other.

``inner_epoch_resident`` is JAX's one-program inner epoch: the shuffle, the
per-sample timestep permutations and the rebatch on the device, then every
minibatch through ``train_step_fused``. The driver's fused host loop is the
same function on permutations drawn on the host; ``inner_epoch_per_timestep``
is the non-fused one (``train_step`` on each trained timestep).

Spans (utils/profiling.py): ``train.inner_epoch`` around each inner epoch;
``train.apply`` around each trained timestep's ``train.forward``
(``ppo_loss``) and ``train.backward``; ``train.optimizer`` around each
update (the reduce, if any, and ``tx.step``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ddpo_torch.parallel.sharding import place_train_state

from ddpo_torch.core.scheduler import DDIMScheduler, DDIMState
from ddpo_torch.utils.profiling import span

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
                 accumulate: bool = True, grad_reduce: Optional[Callable] = None,
                 tp=None):
        self.apply_fn = apply_fn
        self.params = params
        self.tx = tx
        self.grad_reduce = grad_reduce
        self.tp = tp
        self.opt_state = tx.init(params)
        self.step = 0
        self.grad_acc: Optional[Tensors] = (
            {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
            if accumulate else None
        )
        self.n_acc = 0

    def _update(self, grads: Tensors, reduce: str) -> None:
        with span("train.optimizer"):
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

    def _moment_specs(self, moment: str, tensors: Tensors) -> dict:
        return {k: place_train_state(self.tp, self.tx, k, moment) for k in tensors}

    def global_params(self) -> Tensors:
        """The whole parameters (gathered over tp; these ones without)."""
        params = {k: p.detach() for k, p in self.params.items()}
        return params if self.tp is None else self.tp.gather(params)

    def state_dict(self) -> dict:
        """The whole state; under tp every rank of the group calls it."""
        opt, grad_acc = self.opt_state, self.grad_acc
        if self.tp is not None:
            opt = {m: t if m == "count" else self.tp.gather(t, self._moment_specs(m, t))
                   for m, t in opt.items()}
            grad_acc = None if grad_acc is None else self.tp.gather(grad_acc)
        return {
            "params": self.global_params(),
            "opt_state": opt,
            "step": self.step,
            "grad_acc": grad_acc,
            "n_acc": self.n_acc,
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Load a whole state (this rank's slices of it under tp)."""
        tp = self.tp

        def local(tensors, specs=None):
            return tensors if tp is None else tp.local(tensors, specs)

        params = local(state["params"])
        for k, p in self.params.items():
            p.copy_(params[k])
        opt = state["opt_state"]
        self.opt_state["count"] = int(opt["count"])
        for moment, tensors in self.opt_state.items():
            if moment != "count":
                saved = local(opt[moment], self._moment_specs(moment, tensors)
                              if tp is not None else None)
                for k, m in tensors.items():
                    m.copy_(saved[k])
        self.step = int(state["step"])
        if self.grad_acc is not None and state.get("grad_acc") is not None:
            saved = local(state["grad_acc"])
            for k, ga in self.grad_acc.items():
                ga.copy_(saved[k])
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


def _apply(state: AccumulatingTrainState, batch: Tensors, scheduler: DDIMScheduler,
           scheduler_state: DDIMState, *loss_args) -> Tensors:
    """One trained timestep: ``ppo_loss`` on ``batch`` (``loss_args``: its
    train_cfg to cfg_concat), then its gradient added to the masters'
    ``.grad``; returns its info. Spans ``train.apply``, ``train.forward``
    and ``train.backward``."""
    with span("train.apply"):
        with span("train.forward"):
            loss, info = ppo_loss(state.params, state.apply_fn, batch, scheduler,
                                  scheduler_state, *loss_args)
        with span("train.backward"):
            _backward(loss, state.params)
    return info


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
    info = _apply(state, batch, scheduler, scheduler_state, train_cfg, guidance_scale, eta,
                  clip_range, cfg_concat)
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
        info = _apply(state, full, scheduler, scheduler_state, train_cfg, guidance_scale, eta,
                      clip_range, cfg_concat)
        info_sum = info if info_sum is None else {k: info_sum[k] + v for k, v in info.items()}
    grads = _take_grads(state.params)
    with torch.no_grad():
        for g in grads.values():
            g.div_(num_t)
    state.apply_gradients(grads=grads, do_update=do_opt_update)
    return state, {k: v / num_t for k, v in info_sum.items()}


PER_T = ("latents", "next_latents", "log_probs", "ts")


def rebatch(samples: Tensors, perm: torch.Tensor, t_perms: torch.Tensor,
            train_batch_size: int) -> Tensors:
    """The inner epoch's shuffle: rows in ``perm``'s order, each row's
    timesteps in its own ``t_perms`` order (the reference's independent
    per-sample permutation), cut into (n_batches, train_batch_size, ...)."""
    shuffled = {k: v[perm] for k, v in samples.items()}
    row = torch.arange(perm.shape[0], device=perm.device)[:, None]
    for key in PER_T:
        shuffled[key] = shuffled[key][row, t_perms]
    n_batches = perm.shape[0] // train_batch_size
    return {k: v.reshape(n_batches, train_batch_size, *v.shape[1:])
            for k, v in shuffled.items()}


def fused_minibatch(batched: Tensors, i: int, num_train_ts: int,
                    rows: Optional[slice] = None) -> Tensors:
    """Minibatch ``i`` of ``rebatch``'s output as ``train_step_fused`` takes
    it: its first ``num_train_ts`` shuffled timesteps on a leading axis,
    ``rows`` of it (all by default)."""
    rows = slice(None) if rows is None else rows
    batch = {"prompt_embeds": batched["embeds"][i][rows],
             "uncond_embeds": batched["uncond_embeds"][i][rows],
             "advantages": batched["advantages"][i][rows]}
    for k in PER_T:
        batch[k] = batched[k][i][rows, :num_train_ts].transpose(0, 1)
    return batch


def draw_permutations(total_b: int, num_timesteps: int, generator: torch.Generator,
                      device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, t_perms): a permutation of the rows and one of each row's
    timesteps, from ``generator`` on ``device`` (JAX draws them from
    ``jax.random``, which the port cannot reproduce: tests inject JAX's)."""
    perm = torch.randperm(total_b, generator=generator, device=device)
    keys = torch.rand((total_b, num_timesteps), generator=generator, device=device)
    return perm, keys.argsort(dim=1)


def inner_epoch_resident(
    state: AccumulatingTrainState,
    samples: Tensors,
    scheduler_state: DDIMState,
    scheduler: DDIMScheduler,
    train_batch_size: int,
    num_train_ts: int,
    train_cfg: bool,
    guidance_scale: float,
    eta: float,
    clip_range: float,
    accumulation_steps: int = 1,
    cfg_concat: bool = False,
    perm: Optional[torch.Tensor] = None,
    t_perms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    dp: Tuple[int, int] = (1, 0),
) -> Tuple[AccumulatingTrainState, Tensors]:
    """One PPO inner epoch on the device (JAX's ``inner_epoch_resident``).

    samples keys: latents/next_latents (B, T, 4, h, w), ts/log_probs (B, T),
    advantages (B,), embeds (B, 77, D), uncond_embeds (B, 77, D): the whole
    epoch's samples, gathered over dp. ``perm`` (B,) and ``t_perms`` (B, T)
    are the row and per-row timestep permutations; unset, they are drawn
    from ``generator`` (seeded alike on every rank, so every rank takes the
    same global permutation). The rows are cut into minibatches of
    ``train_batch_size`` (global: the per-rank size times dp) and each
    minibatch trained by ``train_step_fused`` on its first ``num_train_ts``
    shuffled timesteps; ``dp`` = (size, index): this rank trains its
    index's contiguous rows of each minibatch, and the state's reduce
    averages the gradients over dp. With ``accumulation_steps`` A > 1 the
    minibatches go in groups of A: the first A - 1 accumulate, the last
    updates. Returns (state, infos): each info (n_batches,), this rank's
    rows'.
    """
    total_b, num_timesteps = samples["log_probs"].shape
    n_batches = total_b // train_batch_size
    assert n_batches * train_batch_size == total_b, (total_b, train_batch_size)
    assert n_batches % accumulation_steps == 0, (
        f"n_batches {n_batches} not divisible by accumulation_steps {accumulation_steps}")
    size, index = dp
    assert train_batch_size % size == 0, (train_batch_size, size)
    with span("train.inner_epoch"):
        if perm is None:
            perm, t_perms = draw_permutations(total_b, num_timesteps, generator,
                                              samples["log_probs"].device)
        batched = rebatch(samples, perm, t_perms, train_batch_size)
        local = train_batch_size // size
        rows = slice(index * local, (index + 1) * local)
        infos = []
        for i in range(n_batches):
            state, info = train_step_fused(
                state, fused_minibatch(batched, i, num_train_ts, rows), scheduler_state,
                scheduler, train_cfg, guidance_scale, eta, clip_range,
                do_opt_update=(i + 1) % accumulation_steps == 0, cfg_concat=cfg_concat)
            infos.append(info)
        return state, {k: torch.stack([info[k] for info in infos]) for k in infos[0]}


def inner_epoch_per_timestep(
    state: AccumulatingTrainState,
    samples: Tensors,
    scheduler_state: DDIMState,
    scheduler: DDIMScheduler,
    train_batch_size: int,
    num_train_ts: int,
    train_cfg: bool,
    guidance_scale: float,
    eta: float,
    clip_range: float,
    perm: torch.Tensor,
    t_perms: torch.Tensor,
    accumulation_steps: int = 1,
    cfg_concat: bool = False,
) -> Tuple[AccumulatingTrainState, Tensors]:
    """The non-fused inner epoch (``--fused_train_loop False``): the rows
    and timesteps shuffled as ``inner_epoch_resident`` shuffles them, then
    one ``train_step`` for each of a minibatch's first ``num_train_ts``
    timesteps, accumulating in the state's buffer, the update on the last
    timestep of every ``accumulation_steps``-th minibatch. Returns (state,
    infos): each info (n_batches * num_train_ts,)."""
    with span("train.inner_epoch"):
        batched = rebatch(samples, perm, t_perms, train_batch_size)
        infos = []
        for i in range(perm.shape[0] // train_batch_size):
            update = (i + 1) % accumulation_steps == 0
            base = {"prompt_embeds": batched["embeds"][i],
                    "uncond_embeds": batched["uncond_embeds"][i],
                    "advantages": batched["advantages"][i]}
            for j in range(num_train_ts):
                batch = dict(base, **{k: batched[k][i][:, j] for k in PER_T})
                state, info = train_step(state, batch, scheduler_state, scheduler, train_cfg,
                                         guidance_scale, eta, clip_range,
                                         do_opt_update=update and j == num_train_ts - 1,
                                         cfg_concat=cfg_concat)
                infos.append(info)
        return state, {k: torch.stack([info[k] for info in infos]) for k in infos[0]}
