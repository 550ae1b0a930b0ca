"""DDIM scheduler with differentiable per-step Gaussian log-probs.

Port of ddpo_tpu/core/scheduler.py (DDIM only; DPMSolverPlusPlus and
DDPMScheduler are not ported yet). The DDIM reverse step doubles as the DDPO
policy: ``step`` in sample mode draws x_{t-1} and returns its log-density; in
score mode it takes a stored ``prev_sample`` and scores that transition under
the current model, with gradients flowing through the mean only.

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
