"""The comparison that decides ``correct`` for a DDPO cell.

It judges the first epoch of the run, which set-up drives through the
window's own ``epoch`` before the window and records (drivers/ddpo.py), at
the window's sizes. The reference (plain PyTorch and NumPy in
``reference/``, importing nothing of the program) makes its own weights from
the seed and works out each stage again from the inputs the benchmark gave
both sides (prompts, the sampler's noise stream, the permutations) and from
the program's output of the stage before, so each stage is judged alone:

  text       the prompts' embeddings: worst prompt's relative L2 error
  init       the chain's first latents against the seed's noise (exact)
  eps        at sampled steps, the guided noise prediction implied by the
             program's next latents against the reference's at the
             program's latents: worst row's relative L2 error
  logp       the recorded log-prob of those steps against the reference's
             (the policy the trainer's ratio divides by)
  decode     the VAE decode of the program's final latents: worst image's
             RMS error, on the [0, 1] scale
  reward     the JPEG reward of the program's images (exact)
  advantages the per-prompt advantages of the program's rewards (exact)
  loss, approx_kl, clipfrac
             the trainer's infos; at the sampling parameters the ratio is 1,
             so the reference's loss is -mean(A) and its approx_kl and
             clipfrac are 0 (read, and compared only where a cell's limits
             name them)
  grad       the first optimizer step's gradient, by leaf: the gap between
             the program's norm (from adamw's second moment) and the
             reference's, over the larger of the reference's norm of that
             leaf and of the median leaf; worst leaf
  grad_diff  the same gradient signed, by leaf: the norm of the difference
             between the program's (adamw's first moment over 1 - b1) and
             the reference's, over the same floor; worst leaf. The norms
             above do not see a gradient's direction: a negated one reads
             2 here
  change     the parameters' change of that step, by leaf, the same way,
             leaving out leaves whose reference gradient is under a
             thousandth of the median leaf's (they move by round-off alone)
  refresh    the sampler's weights after the step against the cast (or the
             LoRA merge) of the trained values: worst relative max error

``readings`` also puts the reference in the program's place, computed at
a lower precision or with a fault (the control and the faults that set the
upper end of each limit: control.py).
"""

from __future__ import annotations

import gc
import math
from typing import Dict, Optional

import numpy as np
import torch

from h100_bench import weights
from h100_bench.reference import ddpo as ref
from h100_bench.reference import jpeg
from h100_bench.reference.models import TextEncoder, UNet, VAE, Precision, set_precision
from h100_bench.work import latent_side

ORDER = ("text", "init", "eps", "logp", "decode", "reward", "advantages", "loss",
         "approx_kl", "clipfrac", "grad", "grad_diff", "change", "refresh")


def _relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row (dim 0): ||a - b|| / ||b||."""
    diff = (a - b).flatten(1).double().norm(dim=1)
    return diff / b.flatten(1).double().norm(dim=1).clamp(min=1e-30)


def leaf_gaps(side: Dict[str, float], reference: Dict[str, float], keep=None) -> float:
    """The worst leaf's |side - reference| over max(reference, median leaf)."""
    names = [k for k in reference if keep is None or keep(k)]
    if not names:
        return 0.0
    median = float(np.median([reference[k] for k in reference]))
    return max(abs(side[k] - reference[k]) / max(reference[k], median, 1e-30) for k in names)


def leaf_diffs(side: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
               norms: Dict[str, float]) -> float:
    """The worst leaf's ||side - reference|| over max(||reference||, median
    leaf), ``norms`` being the reference's."""
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for k, r in reference.items():
        diff = float((side[k].to(r.device, torch.float64) - r.double()).norm())
        worst = max(worst, diff / max(norms[k], median, 1e-30))
    return worst


def worst_leaves(side: Dict[str, float], reference: Dict[str, float], n: int = 5) -> list:
    """The ``n`` leaves with the largest gaps, [name, gap, side norm,
    reference norm], then the median leaf's gap: where a look at a large
    ``grad`` reading starts."""
    median = float(np.median(list(reference.values())))
    gaps = {k: abs(side[k] - v) / max(v, median, 1e-30) for k, v in reference.items()}
    worst = sorted(gaps, key=gaps.get, reverse=True)[:n]
    values = list(gaps.values())
    return ([[k, gaps[k], side[k], reference[k]] for k in worst]
            + [["p90 gap", float(np.percentile(values, 90)), median, median],
               ["median gap", float(np.median(values)), median, median]])


def sampled_steps(seed: int, steps: int, count: int):
    """The first and last step and ``count - 2`` more drawn from the seed."""
    rng = np.random.default_rng([seed % 2**32, 7])
    middle = rng.choice(np.arange(1, steps - 1), size=max(0, min(count, steps) - 2), replace=False)
    return sorted({0, steps - 1, *middle.tolist()})


class Reference:
    """The reference stack of a cell at one precision, with its weights
    made from the seed."""

    def __init__(self, model: dict, traffic: dict, seed: int, device, precision: str = "fp32"):
        self.model, self.traffic, self.device = model, traffic, device
        p = Precision(precision)
        self.text = set_precision(TextEncoder(model["text_encoder"]), p).to(device)
        self.vae = set_precision(VAE(model["vae"]), p).to(device)
        self.unet = set_precision(UNet(dict(model["unet"], sample_size=latent_side(model, traffic))),
                                  p).to(device)
        for m, name in ((self.text, "text_encoder"), (self.vae, "vae"), (self.unet, "unet")):
            weights.fill_module_(m, seed, name)
            m.eval().requires_grad_(False)
        self.ddim = ref.DDIM(model["scheduler"], traffic["n_inference_steps"], device)
        self.base = None
        if model["lora_rank"] > 0:
            # the frozen base is stored in the training dtype: the configuration's
            self.base = {k: v.to(getattr(torch, model["train_dtype"])).float()
                         for k, v in self.unet.named_parameters()}

    @torch.no_grad()
    def embed(self, prompts) -> torch.Tensor:
        return self.text(torch.as_tensor(ref.hash_token_ids(prompts), device=self.device))

    def unet_params(self, adapters: Optional[dict]) -> dict:
        if self.base is None:
            return dict(self.unet.named_parameters())
        return ref.merge_lora(self.base, adapters)

    @torch.no_grad()
    def eps(self, x, t, uncond, cond, adapters=None, rows: int = 8) -> torch.Tensor:
        params = self.unet_params(adapters)
        out = []
        for i in range(0, x.shape[0], rows):
            sl = slice(i, i + rows)
            out.append(ref.guided_eps(
                lambda *a: torch.func.functional_call(self.unet, params, a),
                x[sl], t, uncond.expand(x[sl].shape[0], -1, -1), cond[sl],
                self.traffic["guidance_scale"]))
        return torch.cat(out)

    @torch.no_grad()
    def decode(self, latents, rows: int = 2) -> torch.Tensor:
        return torch.cat([self.vae.decode_images(latents[i:i + rows])
                          for i in range(0, latents.shape[0], rows)])


def initial_adapters(model: dict, seed: int, base: dict, device) -> Dict[str, torch.Tensor]:
    """LoRA's initial adapters for ``base``'s targets, as the driver makes them."""
    adapters = {}
    for key, w in sorted(base.items()):
        path, _, leaf = key.rpartition(".")
        if leaf == "weight" and w.dim() == 2 and any(
                path == t or path.endswith("." + t) for t in model["lora_targets"]):
            adapters[path + ".a"] = torch.empty(w.shape[1], model["lora_rank"], device=device)
            adapters[path + ".b"] = torch.empty(model["lora_rank"], w.shape[0], device=device)
    weights.fill_lora_(adapters, seed)
    return adapters


def readings(cell: dict, seed: int, record: dict, device, sides=("program",),
             rows_per_call: int = 4) -> Dict[str, Dict[str, float]]:
    """Every compared number for the recorded epoch, for each of ``sides``:
    "program" reads the program's record; "fp8" puts the reference at that
    precision in the program's place (the control); "half_batch" puts the
    reference there training on the first half of the rows, the mean over
    those (a fault). The fp32 reference is worked out once for all."""
    model, traffic = cell["model"], cell["traffic"]
    r32 = Reference(model, traffic, seed, device)
    stand_in = {s: Reference(model, traffic, seed, device, s) for s in sides if s == "fp8"}
    out: Dict[str, Dict[str, float]] = {s: {} for s in sides}
    lora = model["lora_rank"] > 0
    adapters0 = initial_adapters(model, seed, r32.base, device) if lora else None

    # text
    prompts = record["prompts"]
    cond = r32.embed(prompts)
    uncond = r32.embed([""])
    conds = {s: stand_in[s].embed(prompts) if s in stand_in else
             record["embeds"].to(device) if s == "program" else cond for s in sides}
    for s in sides:
        out[s]["text"] = float(_relative(conds[s], cond).max())

    # the chain: its first latents and the sampled steps
    gen = torch.Generator(device=device)
    gen.set_state(record["gen_state"])
    b = len(prompts)
    h = latent_side(model, traffic)
    lat_c = model["vae"]["latent_channels"]
    z0 = torch.randn((b, lat_c, h, h), generator=gen, device=device, dtype=torch.float32)
    noise = [torch.randn((b, lat_c, h, h), generator=gen, device=device, dtype=torch.float32)
             for _ in range(traffic["n_inference_steps"])]
    latents, nxt = record["latents"].to(device), record["next_latents"].to(device)
    for s in sides:
        out[s].update(init=float((latents[:, 0] - z0).abs().max()) if s == "program" else 0.0,
                      eps=0.0, logp=0.0)
    eta = traffic["eta"]
    for k in sampled_steps(seed, traffic["n_inference_steps"], traffic["check_steps"]):
        t = r32.ddim.timesteps[k]
        x = latents[:, k]
        eps_ref = r32.eps(x, t, uncond, cond, adapters0)
        mean_ref, std = r32.ddim.mean_std(eps_ref, t, x, eta)
        mean0, _ = r32.ddim.mean_std(torch.zeros_like(x), t, x, eta)
        coef = r32.ddim.mean_std(torch.ones_like(x[:1]), t, torch.zeros_like(x[:1]), eta)[0]
        for s in sides:
            if s == "program":
                next_side = nxt[:, k]
                logp_side = record["log_probs"][:, k].to(device)
            else:
                eps_side = (stand_in[s].eps(x, t, uncond, conds[s], adapters0)
                            if s in stand_in else eps_ref)
                mean_side, _ = r32.ddim.mean_std(eps_side, t, x, eta)
                next_side = mean_side + std * noise[k]
                logp_side = r32.ddim.log_prob(next_side, mean_side, std)
            eps_implied = (next_side - std * noise[k] - mean0) / coef
            out[s]["eps"] = max(out[s]["eps"], float(_relative(eps_implied, eps_ref).max()))
            logp_ref = r32.ddim.log_prob(next_side, mean_ref, std)
            out[s]["logp"] = max(out[s]["logp"], float((logp_side - logp_ref).abs().max()))

    # decode, reward, advantages
    final = record["final_latents"].to(device)
    images_ref = r32.decode(final)
    for s in sides:
        images = (torch.as_tensor(record["images"], device=device) if s == "program" else
                  stand_in[s].decode(final) if s in stand_in else images_ref)
        rms = ((images.double() - images_ref.double()) ** 2).flatten(1).mean(1).sqrt()
        out[s]["decode"] = float(rms.max())
        if s == "program":
            rewards = np.asarray(record["rewards"])
            rewards_ref = -jpeg.sizes(images.float().cpu().numpy()) / 1000.0
            out[s]["reward"] = float(np.abs(rewards - rewards_ref).max())
            adv_ref = ref.advantages(np.array(prompts), rewards,
                                     traffic["per_prompt_stats_bufsize"],
                                     traffic["per_prompt_stats_min_count"])
            out[s]["advantages"] = float(np.abs(np.asarray(record["advantages"]) - adv_ref).max())
        else:
            out[s].update(reward=0.0, advantages=0.0)
    if "program" not in sides:
        rewards = -jpeg.sizes(images_ref.float().cpu().numpy()) / 1000.0
        adv_ref = ref.advantages(np.array(prompts), rewards, traffic["per_prompt_stats_bufsize"],
                                 traffic["per_prompt_stats_min_count"])
    del images_ref, images

    # the trainer's first step; rebatch gives shuffled row i, the original
    # row perm[i], the timesteps t_perms[i]
    if record["opt_count"] > 1:
        raise ValueError("the check reads the first optimizer step: the recorded epoch "
                         f"took {record['opt_count']}")
    t_perms = np.empty_like(record["t_perms"])
    t_perms[record["perm"]] = record["t_perms"]
    batch = {"latents": latents, "noise": torch.stack(noise, dim=1), "ts": record["ts"].to(device),
             "t_perms": torch.as_tensor(t_perms, device=device),
             "advantages": torch.as_tensor(adv_ref, dtype=torch.float32, device=device),
             "uncond": uncond, "n_train": record["n_train"]}
    trained = adapters0 if lora else dict(r32.unet.named_parameters())

    def step(reference, cond_, keep=None):
        grads, loss = _gradients(reference, adapters0, dict(batch, cond=cond_), model, traffic,
                                 rows_per_call, keep)
        clipped = _clipped(grads, model)
        norms = {k: float(g.double().norm()) for k, g in clipped.items()}
        change = {k: float(v.double().norm()) for k, v in
                  ref.clip_and_first_adamw(trained, grads, model).items()}
        return clipped, norms, change, loss

    ref_grads, ref_norms, change_ref, loss_ref = step(r32, cond)
    median = float(np.median(list(ref_norms.values())))
    for s in sides:
        if s == "program":
            b1 = model["beta1"]
            grads = {k: v.float() / (1 - b1) for k, v in record["first_moments"].items()}
            norms, change = record["grad_norms"], record["change_norms"]
            infos = {k: float(np.mean(record["infos"][k])) for k in ("loss", "approx_kl", "clipfrac")}
        else:
            keep = slice(0, b // 2) if s == "half_batch" else None
            grads, norms, change, loss = step(stand_in.get(s, r32), conds[s], keep)
            infos = {"loss": loss, "approx_kl": 0.0, "clipfrac": 0.0}
        out[s]["loss"] = abs(infos["loss"] - loss_ref)
        out[s]["approx_kl"] = abs(infos["approx_kl"])
        out[s]["clipfrac"] = abs(infos["clipfrac"])
        out[s]["grad"] = leaf_gaps(norms, ref_norms)
        out[s]["grad_diff"] = leaf_diffs(grads, ref_grads, ref_norms)
        del grads
        out[s]["change"] = leaf_gaps(change, change_ref,
                                     keep=lambda k: ref_norms[k] >= 1e-3 * median)
        out[s]["leaves"] = worst_leaves(norms, ref_norms)
        out[s]["leaves_change"] = worst_leaves(change, change_ref)
        # the sampler's refresh after the step
        out[s]["refresh"] = _refresh_gap(record, r32, model) if s == "program" else 0.0
    del r32, stand_in
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _gradients(reference: Reference, adapters0, batch, model, traffic, rows_per_call,
               keep=None):
    """(gradient by leaf, loss) of the PPO step at the initial parameters."""
    lora = model["lora_rank"] > 0
    if lora:
        trained = {k: v.detach().clone().requires_grad_(True) for k, v in adapters0.items()}
        base = reference.base
    else:
        trained = dict(reference.unet.named_parameters())
        for p in trained.values():
            p.requires_grad_(True)
            p.grad = None
        base = None
    loss = ref.policy_gradient(reference.unet, trained, base, batch, reference.ddim,
                               traffic["guidance_scale"], traffic["eta"], model["ppo_clip_range"],
                               rows_per_call, keep)["loss"]
    grads = {}
    for k, p in trained.items():
        grads[k] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        p.requires_grad_(False)
    return grads, loss


def _clipped(grads: dict, model: dict) -> dict:
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    factor = model["max_grad_norm"] / norm if norm >= model["max_grad_norm"] else 1.0
    return {k: g * factor for k, g in grads.items()}


@torch.no_grad()
def _refresh_gap(record: dict, r32: Reference, model: dict) -> float:
    sample_dtype = getattr(torch, model["sample_dtype"])
    device = r32.ddim.timesteps.device
    gap = 0.0
    for name, w in record["sampler_weights"].items():
        w = w.to(device)
        if "masters" in record:
            expect = record["masters"][name].to(device).to(sample_dtype)
        else:
            path = name[:-len(".weight")]
            merged = ref.merge_lora({name: r32.base[name]},
                                    {k: v.to(device).float() for k, v in
                                     record["adapters"].items() if k.startswith(path + ".")},
                                    dtype=getattr(torch, model["train_dtype"]))
            expect = merged[name].to(sample_dtype)
        diff = (w.float() - expect.float()).abs().max()
        gap = max(gap, float(diff / expect.float().abs().max().clamp(min=1e-30)))
    return gap


def compare(values: Dict[str, float], limits: Dict[str, float]) -> list:
    """[(name, value, limit)] in ORDER, for each number that has a limit."""
    return [(k, values[k], limits[k]) for k in ORDER if k in limits]
