"""Learning-rate schedules and the clip + adamw optimizer, with optax semantics.

Port of ddpo_tpu/training/optim.py. The JAX package chains optax's
``clip_by_global_norm(max_grad_norm)`` with ``adamw(..., mu_dtype=bfloat16)``;
``torch.optim.AdamW`` keeps its first moment in the parameters' dtype and
orders the weight decay differently, so the same steps are written out here
over plain tensors:

  1. g = g * max_norm / ||g|| when the global norm ||g|| >= max_norm;
  2. mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu, where the stored
     mu is bf16 (b1 * mu is taken in bf16, with b1 rounded to bf16, as jax's
     weak typing does) and nu fp32;
  3. update = mu_hat / (sqrt(nu_hat) + eps) with the bias-corrected moments,
     using the fp32 mu *before* it is rounded to bf16 for storage;
  4. update += weight_decay * param (decoupled, on every parameter);
  5. param -= lr(count) * update, with count the optimizer steps taken.

The port updates the parameters and the moments in place, which saves a
copy of the 860M-parameter state per step; the values are optax's.

Schedules are per optimizer step, as in optax: "constant", "linear" or
"cosine", each after an optional linear warmup. They are evaluated in
float32, as optax's are.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable

import numpy as np
import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    f32 = np.float32

    def fn(count):
        c = f32(min(max(count, 0), steps))
        return float(f32(init - end) * (f32(1) - c / f32(steps)) + f32(end))

    return fn


def _cosine(init: float, steps: int) -> Schedule:
    f32 = np.float32

    def fn(count):
        c = f32(min(count, steps))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(steps), dtype=f32))
        return float(f32(init) * cos)

    return fn


def _join(schedules, boundaries) -> Schedule:
    def fn(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return fn


def build_lr_schedule(args) -> Schedule:
    kind, base = args.lr_schedule, args.learning_rate
    warmup, total = args.lr_warmup_steps, args.lr_total_steps

    if kind == "constant":
        sched = lambda count: float(np.float32(base))  # noqa: E731
        if warmup:
            sched = _join([_linear(0.0, base, warmup), sched], [warmup])
        return sched

    assert total is not None, (
        f"lr_schedule={kind!r} needs --lr_total_steps (the decay horizon in "
        "optimizer steps; it cannot be inferred safely)"
    )
    decay = int(total) - warmup
    assert decay > 0, f"lr_total_steps {total} <= lr_warmup_steps {warmup}"
    if kind == "linear":
        main = _linear(base, 0.0, decay)
    elif kind == "cosine":
        main = _cosine(base, decay)
    else:
        raise ValueError(f"unknown lr_schedule {kind!r}")
    if warmup:
        return _join([_linear(0.0, base, warmup), main], [warmup])
    return main


class ClipAdamW:
    """clip_by_global_norm(max_grad_norm) then adamw with a bf16 first moment.

    State: {"count": optimizer steps taken, "mu": {name: bf16},
    "nu": {name: fp32}}, as optax's ScaleByAdamState.
    """

    def __init__(self, schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, max_grad_norm: float):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p, dtype=torch.bfloat16) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        }

    @staticmethod
    def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
        return torch.sqrt(sum(g.float().square().sum() for g in grads))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: dict) -> None:
        """One update of ``params`` and ``state``, in place."""
        g_norm = self.global_norm(grads.values())
        clip = bool(g_norm >= self.max_grad_norm)
        count = state["count"] + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
        lr = self.schedule(state["count"])
        for name, p in params.items():
            g = grads[name].float()
            if clip:
                g = (g / g_norm.to(g.device)) * self.max_grad_norm
            mu_store = state["mu"][name]
            # jax turns the python b1 into the stored dtype before multiplying
            mu = (1 - b1) * g + (mu_store * torch.tensor(b1, dtype=mu_store.dtype)).float()
            nu = state["nu"][name]
            nu.mul_(b2).add_((1 - b2) * g.square())
            update = (mu / bc1.to(g.device)) / (
                torch.sqrt(nu / bc2.to(g.device)) + self.eps
            )
            update = update + self.weight_decay * p.float()
            p.add_((-lr * update).to(p.dtype))
            mu_store.copy_(mu)
        state["count"] = count


def build_optimizer(args) -> ClipAdamW:
    """Global-norm clip + adamw (bf16 mu), on the schedule."""
    if args.optimizer != "adamw":
        raise NotImplementedError(f"--optimizer {args.optimizer!r} is not ported yet (adamw only)")
    return ClipAdamW(
        build_lr_schedule(args), b1=args.beta1, b2=args.beta2, eps=args.epsilon,
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
    )
