"""Plain PyTorch and NumPy DDPO epoch pieces, for the check of the port.

Frozen copies of the plain semantics the port implements, written here
without importing it: the hash tokenizer of the random-weight stack, the
SD DDIM step with its Gaussian log-prob, CFG, the VAE decode, per-prompt
advantages, the PPO surrogate's gradient at the sampling parameters, the
global-norm clip with adamw's first step, and the LoRA merge.
"""

from __future__ import annotations

import hashlib
import math
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
BOS, EOS, MAX_LEN = 49406, 49407, 77
ADV_CLIP_MAX = 10.0


def hash_token_ids(texts: List[str]) -> np.ndarray:
    """The random-weight stack's tokenizer: [BOS, md5 of each word, EOS...]."""
    ids = np.full((len(texts), MAX_LEN), EOS, dtype=np.int32)
    ids[:, 0] = BOS
    for row, text in enumerate(texts):
        for col, word in enumerate(text.lower().split()[: MAX_LEN - 2], start=1):
            digest = hashlib.md5(word.encode()).digest()
            ids[row, col] = int.from_bytes(digest[:4], "little") % (BOS - 1) + 1
    return ids


class DDIM:
    """SD-1.x DDIM (scaled_linear betas, set_alpha_to_one False) from the
    scheduler config's keys, at ``steps`` inference steps, in fp32."""

    def __init__(self, cfg: dict, steps: int, device):
        n = cfg["num_train_timesteps"]
        betas = torch.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, n,
                               dtype=torch.float32, device=device) ** 2
        self.alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
        self.final = self.alphas_cumprod[0]
        self.ratio = n // steps
        self.timesteps = (torch.arange(steps - 1, -1, -1, device=device) * self.ratio
                          + cfg["steps_offset"]).to(torch.int32)

    def mean_std(self, eps, t, x, eta: float):
        t = torch.as_tensor(t, device=x.device).reshape(-1)
        prev = t - self.ratio
        a_t = self.alphas_cumprod[t.long()]
        a_prev = torch.where(prev >= 0, self.alphas_cumprod[prev.clamp(min=0).long()],
                             self.final)
        shape = (-1,) + (1,) * (x.dim() - 1)
        a_t, a_prev = a_t.reshape(shape), a_prev.reshape(shape)
        x0 = (x - (1 - a_t) ** 0.5 * eps) / a_t**0.5
        var = (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)
        std = eta * var**0.5
        return a_prev**0.5 * x0 + (1 - a_prev - std**2) ** 0.5 * eps, std

    @staticmethod
    def log_prob(sample, mean, std):
        std = std.clamp(min=1e-6)
        lp = -((sample.detach() - mean) ** 2) / (2 * std**2) - torch.log(std) - LOG_SQRT_2PI
        return lp.mean(dim=tuple(range(1, lp.dim())))


def guided_eps(unet: Callable, x, t, uncond, cond, scale: float):
    """CFG over one [uncond; cond] batch: eps_u + scale (eps_c - eps_u)."""
    t = torch.as_tensor(t, device=x.device).reshape(-1).expand(x.shape[0])
    eps = unet(torch.cat([x, x]), torch.cat([t, t]), torch.cat([uncond, cond]))
    eps_u, eps_c = eps.chunk(2)
    return eps_u + scale * (eps_c - eps_u)


def advantages(prompts: np.ndarray, rewards: np.ndarray, buffer_size: int, min_count: int,
               history: Optional[Dict[str, deque]] = None) -> np.ndarray:
    """Per-prompt normalised rewards: a prompt with ``min_count`` rewards
    in its ring buffer of ``buffer_size`` by its own statistics, else by the
    batch's (the reference implementation's stat tracker)."""
    history = {} if history is None else history
    prompts = np.asarray(prompts)
    rewards = np.asarray(rewards, dtype=np.float64)
    out = np.empty_like(rewards)
    for prompt in np.unique(prompts):
        own = rewards[prompts == prompt]
        buf = history.setdefault(prompt, deque(maxlen=buffer_size))
        buf.extend(own)
        pool = rewards if len(buf) < min_count else np.asarray(buf)
        out[prompts == prompt] = (own - np.mean(pool)) / (np.std(pool) + 1e-6)
    return out


def merge_lora(base: Dict[str, torch.Tensor], adapters: Dict[str, torch.Tensor],
               dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """weight + ((A @ B) * alpha / r)^T for each "<path>.a" / "<path>.b"
    pair (alpha = r). With ``dtype`` the delta is cast to it and added in
    it, as the program adds it to a base stored in that dtype."""
    merged = dict(base)
    for key, a in adapters.items():
        if key.endswith(".a"):
            path = key[:-2]
            delta = a @ adapters[path + ".b"]
            weight = base[path + ".weight"]
            if dtype is not None:
                merged[path + ".weight"] = weight.to(dtype) + delta.to(dtype).T
            else:
                merged[path + ".weight"] = weight + delta.T
    return merged


def policy_gradient(unet: torch.nn.Module, trained: Dict[str, torch.Tensor],
                    base: Optional[Dict[str, torch.Tensor]], batch: dict, ddim: DDIM,
                    scale: float, eta: float, clip_range: float, rows_per_call: int,
                    keep: Optional[slice] = None) -> Dict[str, float]:
    """Accumulate into ``trained``'s ``.grad`` the gradient of the fused
    PPO step's loss at the parameters that sampled the trajectory, where
    the probability ratio is 1: the mean over trained timesteps of the
    mean over rows of max(-A r, -A clip(r)), r = exp(logp - logp.detach()).

    The sampled next latents are this policy's own step from the recorded
    latents with the sampler's noise, mean + std z, so that the residual
    the gradient scales is std z, as it is in the program at its own mean;
    the recorded next latents would add the program's error in the mean,
    divided by std, to every timestep's gradient.

    ``batch``: latents / noise (B, T, 4, h, w), ts (B, T), t_perms (B, T)
    whose first ``n_train`` columns are the trained timesteps, advantages
    (B,), cond (B, 77, D), uncond (1, 77, D), n_train. With
    ``base`` (LoRA) ``trained`` are adapters merged onto it; else they are
    ``unet``'s own parameters. ``keep`` takes those rows alone (a fault's
    reading). Rows go through the model ``rows_per_call`` at a time.
    Returns the loss.
    """
    rows = torch.arange(batch["latents"].shape[0], device=batch["latents"].device)
    if keep is not None:
        rows = rows[keep]
    n_rows, n_train = rows.numel(), batch["n_train"]
    adv = batch["advantages"].clamp(-ADV_CLIP_MAX, ADV_CLIP_MAX)
    loss_sum = 0.0
    for j in range(n_train):
        for start in range(0, n_rows, rows_per_call):
            r = rows[start:start + rows_per_call]
            t_idx = batch["t_perms"][r, j]
            x = batch["latents"][r, t_idx]
            z = batch["noise"][r, t_idx]
            ts = batch["ts"][r, t_idx]
            params = merge_lora(base, trained) if base is not None else trained

            def model(*args):
                return functional_call(unet, params, args)

            eps = guided_eps(model, x, ts, batch["uncond"].expand(len(r), -1, -1),
                             batch["cond"][r], scale)
            mean, std = ddim.mean_std(eps, ts, x, eta)
            lp = ddim.log_prob(mean.detach() + std * z, mean, std)
            ratio = torch.exp(lp - lp.detach())
            a = adv[r]
            term = torch.maximum(-a * ratio, -a * ratio.clamp(1 - clip_range, 1 + clip_range))
            loss = term.sum() / (n_rows * n_train)
            loss.backward()
            loss_sum += float(loss.detach())
    return {"loss": loss_sum}


@torch.no_grad()
def clip_and_first_adamw(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                         cfg: dict) -> Dict[str, torch.Tensor]:
    """The parameters' change of adamw's first step after the global-norm
    clip: -lr (g / (|g| + eps) + wd p), the bias-corrected moments after one
    step being g and g^2."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    factor = cfg["max_grad_norm"] / norm if norm >= cfg["max_grad_norm"] else 1.0
    b1, b2 = cfg["beta1"], cfg["beta2"]
    change = {}
    for k, p in params.items():
        g = (grads[k].double() * factor).float()
        m_hat = ((1 - b1) * g) / (1 - b1)
        v_hat = ((1 - b2) * g.square()) / (1 - b2)
        update = m_hat / (v_hat.sqrt() + cfg["epsilon"]) + cfg["weight_decay"] * p.float()
        change[k] = -cfg["learning_rate"] * update
    return change
