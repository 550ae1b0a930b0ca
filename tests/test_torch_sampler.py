"""The port's trajectory sampler against ddpo_tpu's, and generate end to end.

Both samplers run the debug-animals geometry (tiny stack, 64 px, 4 DDIM
steps, CFG 5.0, eta 1.0) at fp32 on the CPU with the same weights (through
``from_flax``), the same initial latents, and the same per-step noise: the
test replays JAX's key splits to get the noise JAX draws and injects it
into the port. Bounds: latents atol 2e-4 (measured 6.8e-5: fp32 UNet
differences, amplified by the guidance scale of 5); log-probs atol 1e-5
(measured 4.2e-7: in sample mode the recorded log-prob depends on the
injected noise and sigma, not on the mean, so the debug grid's small-sigma
last step does not amplify the latents' differences here).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpo_torch.core.scheduler import DDIMScheduler as TorchDDIM
from ddpo_torch.models.convert import from_flax
from ddpo_torch.pipelines import generate
from ddpo_torch.sampling import SamplerConfig as TorchSamplerConfig
from ddpo_torch.sampling import sample_images, sample_trajectories
from ddpo_torch.utils.serialization import build_models, load_stable_diffusion
from ddpo_tpu.sampling.sampler import SamplerConfig as JaxSamplerConfig
from ddpo_tpu.sampling.sampler import sample_trajectories as jax_sample_trajectories
from ddpo_tpu.utils.serialization import _tiny_stack, sd_scheduler

STEPS, BATCH, RES = 4, 2, 64


@pytest.fixture(scope="module")
def rollouts():
    _, _, j_unet = _tiny_stack(jnp.float32)
    unet_params = jax.jit(j_unet.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, 32)),
    )["params"]
    _, _, t_unet = build_models("tiny", "cpu")
    t_unet.load_state_dict(
        from_flax({"unet": jax.tree_util.tree_map(np.asarray, unet_params)})["unet"]
    )
    t_unet.eval()

    rng = np.random.default_rng(0)
    prompt = rng.standard_normal((BATCH, 77, 32)).astype(np.float32)
    uncond = rng.standard_normal((BATCH, 77, 32)).astype(np.float32)
    init = rng.standard_normal((BATCH, 4, RES // 8, RES // 8)).astype(np.float32)

    j_sched = sd_scheduler()
    key = jax.random.PRNGKey(11)
    j_traj = jax.jit(
        lambda p, pe, ue, k, init: jax_sample_trajectories(
            lambda pp, x, t, c: j_unet.apply({"params": pp}, x, t, c),
            p, j_sched, j_sched.create_state(), pe, ue, k,
            JaxSamplerConfig(num_inference_steps=STEPS, height=RES, width=RES),
            init_latents=init,
        )
    )(unet_params, prompt, uncond, key, init)
    # JAX's per-step noise: the scan carries the key and splits it once a step
    noise, carry = [], key
    for _ in range(STEPS):
        carry, step_key = jax.random.split(carry)
        noise.append(np.asarray(jax.random.normal(step_key, init.shape, jnp.float32)))
    noise = torch.from_numpy(np.stack(noise))

    t_sched = TorchDDIM()
    config = TorchSamplerConfig(num_inference_steps=STEPS, height=RES, width=RES)
    args = (t_unet, t_sched, t_sched.create_state(), torch.from_numpy(prompt),
            torch.from_numpy(uncond), config)
    t_traj = sample_trajectories(*args, init_latents=torch.from_numpy(init), noise=noise)
    t_final = sample_images(*args, init_latents=torch.from_numpy(init), noise=noise)
    j_traj = {k: np.asarray(v) for k, v in j_traj.items()}
    return j_traj, t_traj, t_final, args


def test_trajectory_matches_jax(rollouts):
    j_traj, t_traj, _, _ = rollouts
    assert t_traj["latents"].shape == (BATCH, STEPS, 4, 8, 8)
    assert t_traj["log_probs"].shape == (BATCH, STEPS)
    np.testing.assert_array_equal(t_traj["ts"].numpy(), j_traj["ts"])
    for key in ("latents", "next_latents", "final_latents"):
        np.testing.assert_allclose(t_traj[key].numpy(), j_traj[key], atol=2e-4)
    np.testing.assert_allclose(t_traj["log_probs"].numpy(), j_traj["log_probs"], atol=1e-5)


def test_sample_images_matches_trajectory_final(rollouts):
    _, t_traj, t_final, _ = rollouts
    assert torch.equal(t_final, t_traj["final_latents"])


def test_generator_stream_is_reproducible(rollouts):
    _, _, _, args = rollouts
    a = sample_trajectories(*args, generator=torch.Generator().manual_seed(5))
    b = sample_trajectories(*args, generator=torch.Generator().manual_seed(5))
    c = sample_images(*args, generator=torch.Generator().manual_seed(5))
    for key in ("latents", "next_latents", "log_probs"):
        assert torch.equal(a[key], b[key])
    assert torch.equal(c, a["final_latents"])
    assert torch.isfinite(a["log_probs"]).all()


def test_score_mode_recomputes_sampled_log_probs(rollouts):
    """The on-policy invariant at the sampling params: score mode on the
    recorded (latents, next_latents) gives the recorded log-probs."""
    _, t_traj, _, (unet, sched, state, prompt, uncond, config) = rollouts
    state = sched.set_timesteps(state, STEPS)
    context = torch.cat([uncond, prompt])
    with torch.no_grad():
        for i, t in enumerate(state.timesteps):
            x = t_traj["latents"][:, i]
            eps_u, eps_c = unet(torch.cat([x, x]), t.expand(2 * BATCH), context).chunk(2)
            eps = eps_u + config.guidance_scale * (eps_c - eps_u)
            _, logp = sched.step(state, eps, t, x, prev_sample=t_traj["next_latents"][:, i],
                                 eta=config.eta)
            assert torch.equal(logp, t_traj["log_probs"][:, i])


def test_random_init_is_seeded_and_finite():
    a = load_stable_diffusion(model_preset="tiny", device="cpu", seed=3)
    b = load_stable_diffusion(model_preset="tiny", device="cpu", seed=3)
    for ma, mb in ((a.unet, b.unet), (a.vae, b.vae), (a.text_encoder, b.text_encoder)):
        sa, sb = ma.state_dict(), mb.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert all(torch.isfinite(v).all() for v in sa.values())
    w = a.unet.conv_in.weight  # lecun normal: std 1/sqrt(fan_in), cut at 2 std
    assert w.abs().max() <= 2.0 / (w[0].numel() ** 0.5) / 0.8796 + 1e-6


def test_generate_end_to_end_debug_animals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = generate.main(["--dataset", "debug-animals", "--device", "cpu", "--seed", "0"])
    assert result.images.shape == (4, 64, 64, 3)
    assert np.isfinite(result.images).all()
    assert result.images.min() >= 0.0 and result.images.max() <= 1.0
    assert len(result.prompts) == 4
    files = set(os.listdir(result.outdir))
    assert {f"{i:05d}.png" for i in range(4)} <= files
    assert {"prompts.json", "metrics.jsonl", "grid_0.png"} <= files
    with open(os.path.join(result.outdir, "00000.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    again = generate.main(["--dataset", "debug-animals", "--device", "cpu", "--seed", "0"])
    np.testing.assert_array_equal(again.images, result.images)


SMALL = ["--dataset", "debug-animals", "--device", "cpu", "--n_samples", "2",
         "--n_samples_per_device", "2", "--resolution", "32", "--prompts", "['a dog']",
         "--seed", "3"]


@pytest.mark.parametrize("flag,value", [("--scheduler", "dpm++"), ("--quant", "int8")])
def test_generate_refuses_what_is_not_ported(tmp_path, monkeypatch, flag, value):
    """The serving extras, once refused here, are ported: generate runs with
    the value and records it; an unknown value of the flag raises."""
    monkeypatch.chdir(tmp_path)
    result = generate.main(SMALL + ["--n_inference_steps", "3", flag, value])
    assert result.images.shape == (2, 32, 32, 3) and np.isfinite(result.images).all()
    with open(os.path.join(result.outdir, "prompts.json")) as f:
        meta = json.load(f)
    assert meta["prompts"] == ["a dog", "a dog"]
    assert meta["scheduler"] == ("dpm++" if flag == "--scheduler" else "ddim")
    with pytest.raises(ValueError, match="unknown"):
        generate.main(SMALL + [flag, value + "x"])


def test_generate_dpmpp_int8_and_eta_warning(tmp_path, monkeypatch, capsys):
    """Both extras together; --eta with dpm++ warns as JAX does, and the ODE
    sampler ignores it: the images equal those without --eta."""
    monkeypatch.chdir(tmp_path)
    argv = SMALL + ["--n_inference_steps", "3", "--scheduler", "dpm++", "--quant", "int8"]
    result = generate.main(argv)
    out = capsys.readouterr().out
    assert "quant=int8" in out and "warning" not in out
    with_eta = generate.main(argv + ["--eta", "0.5"])
    assert "warning: --eta has no effect" in capsys.readouterr().out
    np.testing.assert_array_equal(with_eta.images, result.images)
    plain = generate.main(SMALL + ["--n_inference_steps", "3", "--scheduler", "dpm++"])
    assert 0 < np.abs(plain.images - result.images).max() < 0.5  # int8 moves the images a little
