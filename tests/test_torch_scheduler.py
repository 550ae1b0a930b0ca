"""The port's DDIM scheduler against ddpo_tpu's, at fp32 on the CPU.

Inputs come from a numpy seed and go through both packages. Tolerances:
both sides compute in fp32, but torch.linspace/cumprod and jnp's may differ
in the last ulp of the 1000-entry schedule, so values are compared at
rtol 1e-5 (atol 1e-6); log-probs scale with 1/sigma^2 and are compared at
rtol 1e-5 relative to their own magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpo_torch.core.scheduler import DDIMScheduler as TorchDDIM
from ddpo_tpu.core.scheduler import DDIMScheduler as JaxDDIM

SD = dict(
    num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
    beta_schedule="scaled_linear", set_alpha_to_one=False, steps_offset=1,
    prediction_type="epsilon",
)
# 4 steps: the debug-animals grid; 50: the production grid
GRIDS = (4, 50)


def _states(n):
    jsched, tsched = JaxDDIM(**SD), TorchDDIM(**SD)
    jstate = jsched.set_timesteps(jsched.create_state(), n)
    tstate = tsched.set_timesteps(tsched.create_state(), n)
    return jsched, jstate, tsched, tstate


@pytest.mark.parametrize("n", GRIDS)
def test_timesteps_and_schedule(n):
    _, jstate, _, tstate = _states(n)
    np.testing.assert_array_equal(tstate.timesteps.numpy(), np.asarray(jstate.timesteps))
    np.testing.assert_allclose(
        tstate.alphas_cumprod.numpy(), np.asarray(jstate.alphas_cumprod),
        rtol=1e-5, atol=1e-6,
    )
    assert float(tstate.final_alpha_cumprod) == pytest.approx(
        float(jstate.final_alpha_cumprod), rel=1e-6
    )


def _inputs(seed, shape=(3, 4, 8, 8)):
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal(shape).astype(np.float32)
    eps = rng.standard_normal(shape).astype(np.float32)
    prev = rng.standard_normal(shape).astype(np.float32)
    return sample, eps, prev


@pytest.mark.parametrize("n", GRIDS)
@pytest.mark.parametrize("eta", (1.0, 0.0))
def test_step_mean_std_every_timestep(n, eta):
    jsched, jstate, tsched, tstate = _states(n)
    sample, eps, _ = _inputs(0)
    for t in np.asarray(jstate.timesteps):  # includes the final prev_t < 0 step
        jm, js = jsched.step_mean_std(jstate, jnp.asarray(eps), int(t), jnp.asarray(sample), eta)
        tm, ts = tsched.step_mean_std(
            tstate, torch.from_numpy(eps), torch.tensor(int(t)), torch.from_numpy(sample), eta
        )
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            ts.numpy().reshape(-1), np.asarray(js).reshape(-1), rtol=1e-5, atol=1e-7
        )


@pytest.mark.parametrize("n", GRIDS)
@pytest.mark.parametrize("eta", (1.0, 0.0))  # eta 0: sigma clipped at 1e-6
def test_step_score_mode_every_timestep(n, eta):
    jsched, jstate, tsched, tstate = _states(n)
    sample, eps, prev = _inputs(1)
    for t in np.asarray(jstate.timesteps):
        jprev, jlogp = jsched.step(
            jstate, jnp.asarray(eps), int(t), jnp.asarray(sample),
            prev_sample=jnp.asarray(prev), eta=eta,
        )
        tprev, tlogp = tsched.step(
            tstate, torch.from_numpy(eps), torch.tensor(int(t)), torch.from_numpy(sample),
            prev_sample=torch.from_numpy(prev), eta=eta,
        )
        np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))
        np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=1e-5)


def test_step_per_sample_timesteps_and_final_step():
    """(B,) timesteps, one of them the 50-step grid's last (t=1, prev_t=-19)."""
    jsched, jstate, tsched, tstate = _states(50)
    sample, eps, prev = _inputs(2)
    t = np.array([981, 501, 1], dtype=np.int32)
    assert t[-1] - 1000 // 50 < 0
    _, jlogp = jsched.step(
        jstate, jnp.asarray(eps), jnp.asarray(t), jnp.asarray(sample),
        prev_sample=jnp.asarray(prev), eta=1.0,
    )
    _, tlogp = tsched.step(
        tstate, torch.from_numpy(eps), torch.from_numpy(t), torch.from_numpy(sample),
        prev_sample=torch.from_numpy(prev), eta=1.0,
    )
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=1e-5)


def test_sample_mode_injected_noise_and_generator():
    """Sample mode: x_{t-1} = mean + sigma * z with z injected or drawn."""
    jsched, jstate, tsched, tstate = _states(50)
    sample, eps, noise = _inputs(3)
    t = 501
    jm, js = jsched.step_mean_std(jstate, jnp.asarray(eps), t, jnp.asarray(sample), 1.0)
    tprev, tlogp = tsched.step(
        tstate, torch.from_numpy(eps), torch.tensor(t), torch.from_numpy(sample),
        noise=torch.from_numpy(noise), eta=1.0,
    )
    np.testing.assert_allclose(
        tprev.numpy(), np.asarray(jm + js * jnp.asarray(noise)), rtol=1e-5, atol=1e-6
    )
    # log-density of its own draw: -z^2/2 - log(sigma) - log(sqrt(2 pi)), averaged
    sigma = float(np.asarray(js).reshape(-1)[0])
    expect = (-(noise**2) / 2 - np.log(sigma) - 0.5 * np.log(2 * np.pi)).mean(axis=(1, 2, 3))
    np.testing.assert_allclose(tlogp.numpy(), expect, rtol=1e-5)

    a = tsched.step(tstate, torch.from_numpy(eps), torch.tensor(t), torch.from_numpy(sample),
                    generator=torch.Generator().manual_seed(7), eta=1.0)[0]
    b = tsched.step(tstate, torch.from_numpy(eps), torch.tensor(t), torch.from_numpy(sample),
                    generator=torch.Generator().manual_seed(7), eta=1.0)[0]
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tsched.step(tstate, torch.from_numpy(eps), torch.tensor(t), torch.from_numpy(sample),
                    noise=torch.from_numpy(noise), prev_sample=torch.from_numpy(sample))


def test_score_mode_gradient_flows_through_mean_only():
    _, _, tsched, tstate = _states(4)
    sample, eps, prev = _inputs(4)
    eps_t = torch.from_numpy(eps).requires_grad_(True)
    prev_t = torch.from_numpy(prev).requires_grad_(True)
    _, logp = tsched.step(tstate, eps_t, torch.tensor(501), torch.from_numpy(sample),
                          prev_sample=prev_t, eta=1.0)
    logp.sum().backward()
    assert eps_t.grad is not None and torch.isfinite(eps_t.grad).all()
    assert prev_t.grad is None  # the sample is detached (JAX stop_gradient)
