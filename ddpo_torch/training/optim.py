"""Learning-rate schedules and the clip + adamw / adafactor optimizers, with
optax semantics.

Port of ddpo_tpu/training/optim.py. The JAX package chains optax's
``clip_by_global_norm(max_grad_norm)`` with ``adamw(..., mu_dtype=bfloat16)``
or with ``adafactor(learning_rate=schedule, weight_decay_rate=weight_decay)``
(``ClipAdafactor`` below);
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

Under tensor parallelism (``tp``, a parallel/sharding.py
``TensorParallel``) each rank holds its slices of the sharded parameters,
gradients and moments, and every whole-tensor quantity that GSPMD computed
for JAX is taken over the group: the global norm (each sharded leaf's sum
of squares all-reduced, each replicated leaf counted once), and in
adafactor the factored axes (from the whole shape), the row and column
means of g^2 over a split dim, and the update's and the parameter's RMS.
So every rank takes the same clip, and a replicated leaf the same update.
The optimizers' collectives (``tp_optim`` in ops/spatial.py's ``COMM``) are
one scalar all-reduce a step for the norm, and in adafactor three more, one
for each pass of its whole-tensor means over all leaves.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

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
                 weight_decay: float, max_grad_norm: float, tp=None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.tp = tp

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p, dtype=torch.bfloat16) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        }

    @staticmethod
    def moment_spec(moment: str, name: str, spec):
        """A moment's Shard: its parameter's."""
        return spec

    @staticmethod
    def global_norm(grads: Iterable[torch.Tensor], tp=None, names: Sequence[str] = ()
                    ) -> torch.Tensor:
        """The norm of all gradients; under ``tp`` (with each gradient's
        ``names``) of the whole gradients: the sharded leaves' sum of
        squares all-reduced over the group, the replicated ones once."""
        if tp is None:
            return torch.sqrt(sum(g.float().square().sum() for g in grads))
        grads = list(grads)
        split = [g for g, n in zip(grads, names) if tp.sharded(n)]
        whole = [g for g, n in zip(grads, names) if not tp.sharded(n)]
        total = tp.psum(sum(g.float().square().sum() for g in split))
        return torch.sqrt(total + sum(g.float().square().sum() for g in whole))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: dict) -> None:
        """One update of ``params`` and ``state``, in place."""
        g_norm = self.global_norm(grads.values(), self.tp, list(grads))
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


# optax 0.2.6's adafactor defaults
FACTOR_MIN_DIM = 128
DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
BLOCK_RMS_CLIP = 1.0
PARAM_SCALE_MIN = 1e-3


def flax_axes(name: str, shape: Sequence[int]) -> list:
    """For each axis of the Flax layout, the port's axis holding it.

    A parameter whose name ends in "weight" is in torch's layout: 2-D is a
    Dense kernel transposed ((out, in) for Flax's (in, out)), 4-D a conv
    kernel as OIHW (Flax's HWIO). Everything else (biases, norm scales,
    LoRA's A and B) has Flax's layout. The models train no nn.Embedding,
    whose 2-D weight this rule would take for a Dense kernel.
    """
    if name.endswith("weight") and len(shape) == 2:
        return [1, 0]
    if name.endswith("weight") and len(shape) == 4:
        return [2, 3, 1, 0]
    return list(range(len(shape)))


def factored_axes(name: str, shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims`` in the port's axes: (d1, d0), the port's
    axes of the second-largest and the largest dimension of the Flax
    layout, or None when there are fewer than two axes or the
    second-largest is below 128.

    The ranking is a stable sort of the Flax shape, as numpy's argsort is
    for so few axes: of two equal dimensions the later Flax axis counts as
    the larger. For a conv kernel with Cin = Cout that is HWIO's O, so d0 is
    the port's axis 0 (Cout) and d1 its axis 1 (Cin); for a square Dense
    kernel d0 is Flax's out, the port's axis 0.
    """
    if len(shape) < 2:
        return None
    axes = flax_axes(name, shape)
    flax_shape = [shape[a] for a in axes]
    order = np.argsort(flax_shape, kind="stable")
    if flax_shape[order[-2]] < FACTOR_MIN_DIM:
        return None
    return axes[order[-2]], axes[order[-1]]


class ClipAdafactor:
    """clip_by_global_norm(max_grad_norm) then optax's adafactor at its
    defaults, with ``weight_decay_rate = weight_decay``:

      1. v = decay_t v + (1 - decay_t)(g^2 + 1e-30), decay_t = 1 - (count + 1)^-0.8;
         factored (``factored_axes``) as a row statistic (the mean over d0)
         and a column one (the mean over d1), the update
         g * (v_row / mean(v_row))^-1/2 * v_col^-1/2; else g * v^-1/2;
      2. the update divided by max(1, its rms) (clip_by_block_rms(1.0));
      3. times lr(count), then times max(rms(param), 1e-3);
      4. plus weight_decay * param (after the learning rate, as optax
         chains it), and subtracted from the param.

    State: {"count", "v_row", "v_col", "v"}, the last three {name: fp32},
    v_row and v_col for the factored parameters and v for the others.
    """

    def __init__(self, schedule: Schedule, weight_decay: float, max_grad_norm: float, tp=None):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.tp = tp
        self.axes: Dict[str, Optional[Tuple[int, int]]] = {}

    def moment_spec(self, moment: str, name: str, spec):
        """A state leaf's Shard: v takes its parameter's; v_row (reduced
        over d0) and v_col (over d1) drop that axis from it."""
        if moment == "v":
            return spec
        d1, d0 = self.axes[name]
        return spec.drop(d0 if moment == "v_row" else d1)

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for name, p in params.items():
            # from the whole shape, as GSPMD's global view chooses them
            shape = p.shape if self.tp is None else self.tp.global_shape(name, p.shape)
            axes = self.axes[name] = factored_axes(name, shape)
            if axes is None:
                state["v"][name] = torch.zeros_like(p, dtype=torch.float32)
            else:
                d1, d0 = axes
                shape = list(p.shape)
                state["v_row"][name] = p.new_zeros(shape[:d0] + shape[d0 + 1:], dtype=torch.float32)
                state["v_col"][name] = p.new_zeros(shape[:d1] + shape[d1 + 1:], dtype=torch.float32)
        return state

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: dict) -> None:
        """One update of ``params`` and ``state``, in place."""
        names = list(params)
        g = [grads[n].float() for n in names]
        g_norm = ClipAdamW.global_norm(g, self.tp, names)
        if bool(g_norm >= self.max_grad_norm):
            g = torch._foreach_div(g, g_norm)
            torch._foreach_mul_(g, self.max_grad_norm)
        f32 = np.float32
        decay = float(f32(1) - f32(state["count"] + 1) ** f32(-DECAY_RATE))
        keep = float(f32(1) - f32(decay))
        lr = self.schedule(state["count"])
        tp = self.tp
        specs = [tp.specs.get(n) if tp is not None else None for n in names]

        # whole-tensor means from this rank's slices: under tp each pass's
        # reductions over a split dim go in one all-reduce
        def partial(x, spec, dim=None, keepdim=False):
            if tp is None:
                return (x.mean() if dim is None else x.mean(dim, keepdim=keepdim)), None
            return tp.partial_mean(x, spec, dim, keepdim)

        def finish(parts):
            return [m for m, _ in parts] if tp is None else tp.finish_means(parts)

        # 1. the row and column means of g^2 (v for the unfactored), and
        #    each parameter's mean square
        stats, p_sq = [], []
        for name, grad, spec in zip(names, g, specs):
            sq = grad * grad + ADAFACTOR_EPS
            axes = self.axes[name]
            if axes is None:
                state["v"][name].mul_(decay).add_(sq, alpha=keep)
            else:
                d1, d0 = axes
                stats += [partial(sq, spec, d0), partial(sq, spec, d1)]
            p_sq.append(partial(params[name].float().square(), spec))
        done = finish(stats + p_sq)
        stats, p_rms = iter(done[:len(stats)]), [m.sqrt() for m in done[len(stats):]]
        # 2. v_row, v_col, and the mean of v_row
        row_means = []
        for name, spec in zip(names, specs):
            if self.axes[name] is not None:
                d1, d0 = self.axes[name]
                v_row = state["v_row"][name].mul_(decay).add_(next(stats), alpha=keep)
                state["v_col"][name].mul_(decay).add_(next(stats), alpha=keep)
                row_spec = spec.drop(d0) if spec is not None else None
                row_means.append(partial(v_row, row_spec, d1 - 1 if d1 > d0 else d1,
                                         keepdim=True))
        row_means = iter(finish(row_means))
        # 3. the update and its mean square
        us, u_sq = [], []
        for name, grad, spec in zip(names, g, specs):
            if self.axes[name] is None:
                u = grad * state["v"][name].rsqrt()
            else:
                d1, d0 = self.axes[name]
                v_row, v_col = state["v_row"][name], state["v_col"][name]
                u = (grad * (v_row / next(row_means)).rsqrt().unsqueeze(d0)
                     * v_col.rsqrt().unsqueeze(d1))
            us.append(u)
            u_sq.append(partial(u.square(), spec))
        u_rms = [m.sqrt() for m in finish(u_sq)]
        updates = []
        for i, name in enumerate(names):
            p = params[name]
            u = us[i] / torch.clamp(u_rms[i] / BLOCK_RMS_CLIP, min=1.0)
            us[i] = None
            u = u * lr * torch.clamp(p_rms[i], min=PARAM_SCALE_MIN)
            updates.append((u + self.weight_decay * p.float()).to(p.dtype))
        torch._foreach_sub_([params[n] for n in names], updates)
        state["count"] += 1


def build_optimizer(args, tp=None):
    """Global-norm clip + adamw (bf16 mu) | adafactor, on the schedule;
    ``args.optimizer`` defaults to adamw (the RWR train block has no key).
    ``tp``: the parameters' tp layout (module docstring), None when whole."""
    optimizer = getattr(args, "optimizer", "adamw")
    if optimizer == "adafactor":
        return ClipAdafactor(build_lr_schedule(args), weight_decay=args.weight_decay,
                             max_grad_norm=args.max_grad_norm, tp=tp)
    if optimizer != "adamw":
        raise ValueError(f"unknown --optimizer {optimizer!r} (adamw | adafactor)")
    return ClipAdamW(
        build_lr_schedule(args), b1=args.beta1, b2=args.beta2, eps=args.epsilon,
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm, tp=tp,
    )
