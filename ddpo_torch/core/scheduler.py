"""DDIM scheduler with differentiable per-step Gaussian log-probs, the
DDPM forward-noising schedule of RWR, and the DPM-Solver++(2M) ODE solver
for few-step inference.

Port of ddpo_tpu/core/scheduler.py. The DDIM reverse step doubles as the
DDPO policy: ``step`` in sample mode draws x_{t-1} and returns its
log-density; in score mode it takes a stored ``prev_sample`` and scores that
transition under the current model, with gradients flowing through the mean
only. ``add_noise`` is the forward
process q(x_t | x_0) at per-sample timesteps (diffusers' add_noise_common),
which the RWR finetune step (training/diffusion.py) draws its inputs from
through ``DDPMScheduler``. ``DPMSolverPlusPlus`` is the deterministic
multistep solver behind ``sampling.sample_images_ode`` (``--scheduler
dpm++`` of the generate and sample drivers).

Scheduler math is float32 whatever the model's activation dtype. Sample mode
draws its noise from an explicit ``torch.Generator`` or takes it injected
(``noise``), never from a global seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def make_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Noise schedule. Defaults are Stable Diffusion v1.x (scaled_linear)."""
    if beta_schedule == "linear":
        return torch.linspace(
            beta_start, beta_end, num_train_timesteps, dtype=dtype, device=device
        )
    if beta_schedule == "scaled_linear":
        return (
            torch.linspace(
                beta_start**0.5, beta_end**0.5, num_train_timesteps,
                dtype=dtype, device=device,
            )
            ** 2
        )
    if beta_schedule == "squaredcos_cap_v2":
        t = torch.arange(num_train_timesteps, dtype=dtype, device=device)

        def alpha_bar(x):
            return torch.cos((x + 0.008) / 1.008 * math.pi / 2) ** 2

        return torch.clamp(
            1.0 - alpha_bar((t + 1) / num_train_timesteps)
            / alpha_bar(t / num_train_timesteps),
            max=0.999,
        )
    raise ValueError(f"unknown beta_schedule: {beta_schedule}")


def _left_broadcast(x: torch.Tensor, shape) -> torch.Tensor:
    """(B,) against (B, C, H, W) -> (B, 1, 1, 1); scalars pass through."""
    assert x.dim() <= len(shape)
    return x.reshape(tuple(x.shape) + (1,) * (len(shape) - x.dim()))


@dataclasses.dataclass(frozen=True)
class DDIMState:
    """alphas_cumprod: (num_train_timesteps,) cumulative product of (1 - beta).
    final_alpha_cumprod: alpha-bar used when the previous timestep is < 0.
    timesteps: descending inference grid (set by set_timesteps).
    """

    alphas_cumprod: torch.Tensor
    final_alpha_cumprod: torch.Tensor
    init_noise_sigma: torch.Tensor
    timesteps: torch.Tensor
    num_inference_steps: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    """DDIM reverse process with per-step Gaussian log-probs.

    Stable Diffusion v1.4 uses num_train_timesteps=1000, scaled_linear betas
    in [0.00085, 0.012], set_alpha_to_one=False, steps_offset=1,
    prediction_type="epsilon".
    """

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    prediction_type: str = "epsilon"
    dtype: torch.dtype = torch.float32

    def create_state(self, device=None) -> DDIMState:
        betas = make_betas(
            self.num_train_timesteps, self.beta_start, self.beta_end,
            self.beta_schedule, self.dtype, device,
        )
        alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
        final_alpha_cumprod = (
            torch.tensor(1.0, dtype=self.dtype, device=device)
            if self.set_alpha_to_one
            else alphas_cumprod[0]
        )
        return DDIMState(
            alphas_cumprod=alphas_cumprod,
            final_alpha_cumprod=final_alpha_cumprod,
            init_noise_sigma=torch.tensor(1.0, dtype=self.dtype, device=device),
            timesteps=torch.arange(
                self.num_train_timesteps - 1, -1, -1, device=device
            ),
        )

    def set_timesteps(self, state: DDIMState, num_inference_steps: int) -> DDIMState:
        """Descending stride grid: (arange(n) * (T // n))[::-1] + steps_offset."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        grid = torch.arange(
            num_inference_steps - 1, -1, -1, device=state.alphas_cumprod.device
        )
        timesteps = (grid * step_ratio + self.steps_offset).to(torch.int32)
        return dataclasses.replace(
            state, num_inference_steps=num_inference_steps, timesteps=timesteps
        )

    def _alpha_pair(self, state: DDIMState, timestep, prev_timestep):
        alpha_prod_t = state.alphas_cumprod[timestep.long()]
        alpha_prod_t_prev = torch.where(
            prev_timestep >= 0,
            state.alphas_cumprod[torch.clamp(prev_timestep, min=0).long()],
            state.final_alpha_cumprod,
        )
        return alpha_prod_t, alpha_prod_t_prev

    def variance(self, state: DDIMState, timestep, prev_timestep) -> torch.Tensor:
        """sigma_t^2(eta=1): (1-a_prev)/(1-a_t) * (1 - a_t/a_prev)."""
        alpha_prod_t, alpha_prod_t_prev = self._alpha_pair(
            state, timestep, prev_timestep
        )
        beta_prod_t = 1.0 - alpha_prod_t
        beta_prod_t_prev = 1.0 - alpha_prod_t_prev
        return (beta_prod_t_prev / beta_prod_t) * (1.0 - alpha_prod_t / alpha_prod_t_prev)

    def step_mean_std(
        self,
        state: DDIMState,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        eta: float,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and std of x_{t-1} given (x_t, model_output).

        DDIM paper eq. (12). ``timestep`` is a scalar or a (B,) tensor of
        per-sample timesteps.
        """
        if state.num_inference_steps is None:
            raise ValueError("call set_timesteps before step")
        timestep = torch.as_tensor(timestep, device=sample.device)
        prev_timestep = timestep - self.num_train_timesteps // state.num_inference_steps

        alpha_prod_t, alpha_prod_t_prev = self._alpha_pair(
            state, timestep, prev_timestep
        )
        beta_prod_t = 1.0 - alpha_prod_t

        alpha_prod_t = _left_broadcast(alpha_prod_t, sample.shape)
        alpha_prod_t_prev = _left_broadcast(alpha_prod_t_prev, sample.shape)
        beta_prod_t = _left_broadcast(beta_prod_t, sample.shape)

        if self.prediction_type == "epsilon":
            pred_original = (sample - beta_prod_t**0.5 * model_output) / alpha_prod_t**0.5
            pred_epsilon = model_output
        elif self.prediction_type == "sample":
            pred_original = model_output
            pred_epsilon = (sample - alpha_prod_t**0.5 * pred_original) / beta_prod_t**0.5
        elif self.prediction_type == "v_prediction":
            pred_original = alpha_prod_t**0.5 * sample - beta_prod_t**0.5 * model_output
            pred_epsilon = alpha_prod_t**0.5 * model_output + beta_prod_t**0.5 * sample
        else:
            raise ValueError(f"unknown prediction_type: {self.prediction_type}")

        var = self.variance(state, timestep, prev_timestep)
        std_dev_t = _left_broadcast(eta * var**0.5, sample.shape)

        direction = (1.0 - alpha_prod_t_prev - std_dev_t**2) ** 0.5 * pred_epsilon
        mean = alpha_prod_t_prev**0.5 * pred_original + direction
        return mean, std_dev_t

    def step(
        self,
        state: DDIMState,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        prev_sample: Optional[torch.Tensor] = None,
        eta: float = 0.0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One reverse step, returning ``(prev_sample, log_prob)``.

        Sample mode draws x_{t-1} = mean + sigma * z, with z given as
        ``noise`` or drawn from ``generator`` (neither: z = 0). Score mode
        takes ``prev_sample`` and returns it unchanged with its log-prob.

        log_prob is the Gaussian log-density with sigma clipped at 1e-6,
        averaged over all non-batch dims; ``prev_sample`` is detached so
        policy gradients flow through the mean only.
        """
        if prev_sample is not None and (generator is not None or noise is not None):
            raise ValueError("pass either prev_sample or generator/noise, not both")
        if generator is not None and noise is not None:
            raise ValueError("pass either generator or noise, not both")

        mean, std = self.step_mean_std(state, model_output, timestep, sample, eta)

        if prev_sample is None:
            if noise is None and generator is not None:
                noise = torch.randn(
                    sample.shape, generator=generator, device=mean.device,
                    dtype=mean.dtype,
                )
            prev_sample = mean if noise is None else mean + std * noise

        std = torch.clamp(std, min=1e-6)
        log_prob = (
            -((prev_sample.detach() - mean) ** 2) / (2.0 * std**2)
            - torch.log(std)
            - _LOG_SQRT_2PI
        )
        log_prob = log_prob.mean(dim=tuple(range(1, log_prob.dim())))
        return prev_sample, log_prob

    def add_noise(
        self,
        state: DDIMState,
        original_samples: torch.Tensor,
        noise: torch.Tensor,
        timesteps: torch.Tensor,
    ) -> torch.Tensor:
        """Forward process q(x_t | x_0) (diffusers add_noise_common)."""
        alphas = state.alphas_cumprod[timesteps.long()]
        sqrt_alpha = _left_broadcast(alphas**0.5, original_samples.shape)
        sqrt_one_minus = _left_broadcast((1.0 - alphas) ** 0.5, original_samples.shape)
        return sqrt_alpha * original_samples + sqrt_one_minus * noise

    def get_velocity(
        self,
        state: DDIMState,
        sample: torch.Tensor,
        noise: torch.Tensor,
        timesteps: torch.Tensor,
    ) -> torch.Tensor:
        alphas = state.alphas_cumprod[timesteps.long()]
        sqrt_alpha = _left_broadcast(alphas**0.5, sample.shape)
        sqrt_one_minus = _left_broadcast((1.0 - alphas) ** 0.5, sample.shape)
        return sqrt_alpha * noise - sqrt_one_minus * sample


@dataclasses.dataclass(frozen=True)
class DDPMScheduler:
    """Forward-noising schedule for RWR supervised finetuning.

    Only the pieces the finetune trainer needs: ``create_state`` and
    ``add_noise``. It shares ``DDIMState``, so both trainers use one state
    type.
    """

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    dtype: torch.dtype = torch.float32

    def _ddim(self) -> DDIMScheduler:
        return DDIMScheduler(
            num_train_timesteps=self.num_train_timesteps,
            beta_start=self.beta_start,
            beta_end=self.beta_end,
            beta_schedule=self.beta_schedule,
            dtype=self.dtype,
        )

    def create_state(self, device=None) -> DDIMState:
        return self._ddim().create_state(device)

    def add_noise(self, state, original_samples, noise, timesteps):
        return self._ddim().add_noise(state, original_samples, noise, timesteps)


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """fp32 ``jnp.linspace(start, stop, num)`` by JAX's own formula,
    start * (1 - i/(num-1)) + stop * i/(num-1) with the last entry stop,
    which torch.linspace does not share to the last ulp."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32)])


@dataclasses.dataclass(frozen=True)
class DPMSolverState:
    """DPM-Solver++ state.

    Boundary tensors have ``num_inference_steps + 1`` entries: index ``i`` is
    the noise level the i-th model call starts from; the last entry is the
    t = 0 target level. ``timesteps`` (length T) is the descending
    model-call grid in train-timestep units.
    """

    alphas_cumprod: torch.Tensor
    timesteps: torch.Tensor
    lambdas: torch.Tensor  # log(alpha / sigma) per boundary, ascending
    alphas: torch.Tensor  # sqrt(alpha_bar) per boundary
    sigmas: torch.Tensor  # sqrt(1 - alpha_bar) per boundary
    init_noise_sigma: torch.Tensor
    num_inference_steps: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DPMSolverPlusPlus:
    """DPM-Solver++(2M): deterministic second-order multistep ODE sampler
    (Lu et al. 2022, arXiv:2211.01095, the data-prediction variant).

    ``step`` takes the step index into the inference grid and the previous
    step's x0 estimate, and returns the new sample with this step's x0
    estimate. The first step, and the last one when fewer than 15 steps are
    asked for, fall back to first order (eta-0 DDIM in x0 form). All of it
    runs in fp32.
    """

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    grid: str = "karras"  # or "linspace"
    karras_rho: float = 7.0
    dtype: torch.dtype = torch.float32

    def create_state(self, device=None) -> DPMSolverState:
        betas = make_betas(
            self.num_train_timesteps, self.beta_start, self.beta_end,
            self.beta_schedule, self.dtype, device,
        )
        empty = torch.zeros((0,), dtype=self.dtype, device=device)
        return DPMSolverState(
            alphas_cumprod=torch.cumprod(1.0 - betas, dim=0),
            timesteps=torch.arange(self.num_train_timesteps - 1, -1, -1, device=device),
            lambdas=empty,
            alphas=empty,
            sigmas=empty,
            init_noise_sigma=torch.tensor(1.0, dtype=self.dtype, device=device),
        )

    def set_timesteps(self, state: DPMSolverState, num_inference_steps: int) -> DPMSolverState:
        """The inference grid; both variants start at t = T - 1.

        ``karras`` (default): boundaries spaced in the noise-to-signal ratio
        with rho 7 (Karras et al. 2022), each model call at the nearest train
        timestep. ``linspace``: evenly spaced timesteps over [0, T - 1].
        """
        n = num_inference_steps
        ac_all = state.alphas_cumprod
        device = ac_all.device
        if self.grid == "linspace":
            grid = torch.round(_linspace(0.0, self.num_train_timesteps - 1, n + 1))
            grid = grid.to(torch.int64).flip(0).to(device)  # descending, grid[-1] == 0
            ac = ac_all[grid]
            alphas = ac**0.5
            sigmas = (1.0 - ac) ** 0.5
            lambdas = torch.log(alphas) - torch.log(sigmas)
            timesteps = grid[:-1].to(torch.int32)
        elif self.grid == "karras":
            rho = self.karras_rho
            sig_kd = ((1.0 - ac_all) / ac_all) ** 0.5
            smax, smin = sig_kd[-1], sig_kd[0]
            ramp = _linspace(0.0, 1.0, n + 1).to(device)
            s = (
                smax ** (1.0 / rho) + ramp * (smin ** (1.0 / rho) - smax ** (1.0 / rho))
            ) ** rho  # (n + 1,) descending noise-to-signal ratios
            alphas = 1.0 / (1.0 + s**2) ** 0.5
            sigmas = s * alphas
            lambdas = -torch.log(s)
            # nearest train timestep per model-call boundary (sig_kd rises
            # with t); a tie goes to the upper neighbour, as in JAX
            idx = torch.clamp(
                torch.searchsorted(sig_kd, s[:-1]), 1, self.num_train_timesteps - 1
            )
            pick_lo = (s[:-1] - sig_kd[idx - 1]) < (sig_kd[idx] - s[:-1])
            timesteps = torch.where(pick_lo, idx - 1, idx).to(torch.int32)
        else:
            raise ValueError(f"unknown grid {self.grid!r} (karras|linspace)")
        return dataclasses.replace(
            state,
            timesteps=timesteps,
            lambdas=lambdas.to(self.dtype),
            alphas=alphas.to(self.dtype),
            sigmas=sigmas.to(self.dtype),
            num_inference_steps=n,
        )

    def _pred_x0(self, model_output, sample, alpha, sigma):
        if self.prediction_type == "epsilon":
            return (sample - sigma * model_output) / alpha
        if self.prediction_type == "sample":
            return model_output
        if self.prediction_type == "v_prediction":
            return alpha * sample - sigma * model_output
        raise ValueError(f"unknown prediction_type: {self.prediction_type}")

    def step(
        self,
        state: DPMSolverState,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        prev_x0: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One solver step: ``(new_sample, x0_estimate)``.

        ``prev_x0`` is the x0 estimate the previous call returned (any value
        at step 0, where it is not used).
        """
        if state.num_inference_steps is None:
            raise ValueError("call set_timesteps before step")
        i = int(step_index)
        alpha_i, sigma_i = state.alphas[i], state.sigmas[i]
        x0 = self._pred_x0(model_output, sample, alpha_i, sigma_i)

        lam_i = state.lambdas[i]
        h = state.lambdas[i + 1] - lam_i
        h_prev = lam_i - state.lambdas[max(i - 1, 0)]
        r = torch.where(h_prev == 0.0, torch.ones_like(h_prev), h_prev / h)

        ratio = state.sigmas[i + 1] / sigma_i
        phi = torch.expm1(-h)  # exp(-h) - 1 < 0
        use_first = i == 0 or (
            state.num_inference_steps < 15 and i == state.num_inference_steps - 1
        )
        if use_first:
            return ratio * sample - state.alphas[i + 1] * phi * x0, x0
        # 2M midpoint correction: D1 = (x0 - prev_x0) / r
        d = x0 + 0.5 * (x0 - prev_x0) / r
        return ratio * sample - state.alphas[i + 1] * phi * d, x0
