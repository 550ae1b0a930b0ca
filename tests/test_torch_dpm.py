"""The port's DPM-Solver++(2M) and its ODE sampler against ddpo_tpu's, at
fp32 on the CPU, and JAX's Gaussian-toy checks of the solver on the port.

Inputs come from numpy seeds and go through both packages. Bounds:
- the grids: timesteps equal; lambdas, alphas and sigmas within 1e-6 of
  the largest |value| (measured at most 6.1e-7: torch's and XLA's fp32
  cumprod and pow differ in the last ulps, and lambdas = log(alpha/sigma)
  cross zero, so an elementwise relative bound would be ill-conditioned
  there);
- ``step`` on a random sequence, fed JAX's state and the same inputs on
  both sides: new sample and x0 within 1e-6 of their largest |value|
  (measured at most 1.5e-7);
- ``sample_images_ode`` on the tiny stack with JAX's init latents
  injected: atol 2e-4, the DDIM sampler's parity bound
  (tests/test_torch_sampler.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpo_torch.core.scheduler import DDIMScheduler as TorchDDIM
from ddpo_torch.core.scheduler import DPMSolverPlusPlus as TorchDPM
from ddpo_torch.core.scheduler import DPMSolverState as TorchDPMState
from ddpo_torch.models.convert import from_flax
from ddpo_torch.sampling import SamplerConfig as TorchSamplerConfig
from ddpo_torch.sampling import sample_images, sample_images_ode
from ddpo_torch.utils.serialization import build_models
from ddpo_tpu.core.scheduler import DPMSolverPlusPlus as JaxDPM
from ddpo_tpu.sampling.sampler import SamplerConfig as JaxSamplerConfig
from ddpo_tpu.sampling.sampler import sample_images_ode as jax_sample_images_ode
from ddpo_tpu.utils.serialization import _tiny_stack

PREDICTIONS = ("epsilon", "sample", "v_prediction")


def _close(a, b, bound=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max()) <= bound


@pytest.mark.parametrize("grid", ["karras", "linspace"])
@pytest.mark.parametrize("prediction_type", PREDICTIONS)
@pytest.mark.parametrize("n", [8, 20, 50])
def test_state_matches_jax(grid, prediction_type, n):
    jdpm = JaxDPM(grid=grid, prediction_type=prediction_type)
    tdpm = TorchDPM(grid=grid, prediction_type=prediction_type)
    js = jdpm.set_timesteps(jdpm.create_state(), n)
    ts = tdpm.set_timesteps(tdpm.create_state(), n)
    assert ts.num_inference_steps == n and ts.timesteps.dtype == torch.int32
    np.testing.assert_array_equal(ts.timesteps.numpy(), np.asarray(js.timesteps))
    for key in ("lambdas", "alphas", "sigmas"):
        got, want = getattr(ts, key), getattr(js, key)
        assert got.shape == (n + 1,) and got.dtype == torch.float32
        assert _close(got.numpy(), want), key
    assert ts.timesteps[0] == 999 and (ts.timesteps.diff() <= 0).all()  # 50 Karras steps repeat t = 1
    assert (ts.lambdas.diff() > 0).all()  # the SNR rises to t = 0


@pytest.mark.parametrize("grid", ["karras", "linspace"])
@pytest.mark.parametrize("prediction_type", PREDICTIONS)
@pytest.mark.parametrize("n", [8, 20])
def test_step_sequence_matches_jax(grid, prediction_type, n):
    """Every step of an n-step chain (first order at 0, and at the last
    step when n < 15; 2M with r from the grid between), each side given
    the same sample, model output and previous x0."""
    jdpm = JaxDPM(grid=grid, prediction_type=prediction_type)
    tdpm = TorchDPM(grid=grid, prediction_type=prediction_type)
    js = jdpm.set_timesteps(jdpm.create_state(), n)
    # JAX's own state on both sides: the grids are held above
    ts = TorchDPMState(num_inference_steps=n, **{
        key: torch.from_numpy(np.array(getattr(js, key)))
        for key in ("alphas_cumprod", "timesteps", "lambdas", "alphas", "sigmas",
                    "init_noise_sigma")})
    rng = np.random.default_rng(n)
    sample = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    prev_x0 = np.zeros_like(sample)
    for i in range(n):
        out = rng.standard_normal(sample.shape).astype(np.float32)
        j_new, j_x0 = jdpm.step(js, jnp.asarray(out), jnp.int32(i), jnp.asarray(sample),
                                jnp.asarray(prev_x0))
        t_new, t_x0 = tdpm.step(ts, torch.from_numpy(out), i, torch.from_numpy(sample),
                                torch.from_numpy(prev_x0))
        assert _close(t_x0.numpy(), j_x0), i
        assert _close(t_new.numpy(), j_new), i
        sample, prev_x0 = np.array(j_new), np.array(j_x0)


def test_unknown_grid_and_prediction_raise():
    with pytest.raises(ValueError, match="unknown grid"):
        TorchDPM(grid="cosine").set_timesteps(TorchDPM().create_state(), 4)
    dpm = TorchDPM(prediction_type="x")
    state = dpm.set_timesteps(dpm.create_state(), 4)
    x = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError, match="unknown prediction_type"):
        dpm.step(state, x, 0, x, x)
    with pytest.raises(ValueError, match="set_timesteps"):
        dpm.step(dpm.create_state(), x, 0, x, x)


def test_sample_images_ode_matches_jax():
    """The tiny stack at 64 px, 6 DPM++ steps, CFG 5.0, fp32, the same
    weights (from_flax), prompts and JAX's init latents (JAX draws them
    from the split of its key)."""
    steps, batch, res = 6, 2, 64
    _, _, j_unet = _tiny_stack(jnp.float32)
    params = jax.jit(j_unet.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, 32)),
    )["params"]
    _, _, t_unet = build_models("tiny", "cpu")
    t_unet.load_state_dict(from_flax({"unet": jax.tree_util.tree_map(np.asarray, params)})["unet"])
    t_unet.eval()
    rng = np.random.default_rng(1)
    prompt = rng.standard_normal((batch, 77, 32)).astype(np.float32)
    uncond = rng.standard_normal((batch, 77, 32)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    dpm = JaxDPM()
    j_final = np.asarray(jax.jit(
        lambda p, pe, ue, k: jax_sample_images_ode(
            lambda pp, x, t, c: j_unet.apply({"params": pp}, x, t, c), p, dpm,
            dpm.create_state(), pe, ue, k,
            JaxSamplerConfig(num_inference_steps=steps, height=res, width=res))
    )(params, prompt, uncond, key))
    _, init_key = jax.random.split(key)
    init = np.asarray(jax.random.normal(init_key, (batch, 4, res // 8, res // 8), jnp.float32))

    tdpm = TorchDPM()
    t_final = sample_images_ode(
        t_unet, tdpm, tdpm.create_state(), torch.from_numpy(prompt), torch.from_numpy(uncond),
        TorchSamplerConfig(num_inference_steps=steps, height=res, width=res, eta=0.7),
        init_latents=torch.from_numpy(init),
    )
    assert t_final.shape == (batch, 4, 8, 8) and t_final.dtype == torch.float32
    np.testing.assert_allclose(t_final.numpy(), j_final, atol=2e-4)
    # the generator is drawn from once, for the initial latents
    gen = torch.Generator().manual_seed(4)
    a = sample_images_ode(t_unet, tdpm, tdpm.create_state(), torch.from_numpy(prompt),
                          torch.from_numpy(uncond),
                          TorchSamplerConfig(num_inference_steps=2, height=res, width=res),
                          generator=gen)
    init2 = torch.randn((batch, 4, 8, 8), generator=torch.Generator().manual_seed(4))
    b = sample_images_ode(t_unet, tdpm, tdpm.create_state(), torch.from_numpy(prompt),
                          torch.from_numpy(uncond),
                          TorchSamplerConfig(num_inference_steps=2, height=res, width=res),
                          init_latents=init2)
    assert torch.equal(a, b)


# ---- JAX's Gaussian-toy checks (tests/test_dpm.py), on the port ----

MU, STD = 0.7, 0.4  # toy data distribution N(MU, STD^2 I)


@pytest.fixture(scope="module")
def toy():
    scheduler = TorchDDIM()
    state = scheduler.create_state()
    ac = state.alphas_cumprod

    def unet(latents, t_batch, context):
        # the optimal eps-predictor for x0 ~ N(MU, STD^2 I)
        a = ac[t_batch.long()].reshape((-1,) + (1,) * (latents.dim() - 1))
        alpha, sigma = a**0.5, (1.0 - a) ** 0.5
        return sigma * (latents - alpha * MU) / (alpha**2 * STD**2 + sigma**2)

    emb = torch.zeros((4, 1, 1))  # CFG collapses: guidance is inert
    init = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 4, 2, 2)).astype(np.float32))
    acn = ac.double().numpy()
    z = (init.double().numpy() - acn[999] ** 0.5 * MU) / np.sqrt(acn[999] * STD**2 + 1 - acn[999])
    exact = acn[0] ** 0.5 * MU + np.sqrt(acn[0] * STD**2 + 1 - acn[0]) * z

    def run_ddim(steps):
        cfg = TorchSamplerConfig(num_inference_steps=steps, eta=0.0, height=16, width=16,
                                 guidance_scale=3.0)
        return sample_images(unet, scheduler, state, emb, emb, cfg, init_latents=init).numpy()

    def run_dpm(steps, grid="karras"):
        dpm = TorchDPM(grid=grid)
        cfg = TorchSamplerConfig(num_inference_steps=steps, height=16, width=16,
                                 guidance_scale=3.0)
        return sample_images_ode(unet, dpm, dpm.create_state(), emb, emb, cfg,
                                 init_latents=init).numpy()

    return run_ddim, run_dpm, exact


def test_first_order_branch_equals_ddim_eta0_closed_form():
    """Step 0 (first order) == alpha_next * x0 + sigma_next * eps."""
    dpm = TorchDPM()
    state = dpm.set_timesteps(dpm.create_state(), 20)
    rng = np.random.default_rng(1)
    sample = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    new, x0 = dpm.step(state, eps, 0, sample, torch.zeros_like(sample))
    a_i, s_i, a_n, s_n = state.alphas[0], state.sigmas[0], state.alphas[1], state.sigmas[1]
    x0_expected = (sample - s_i * eps) / a_i
    torch.testing.assert_close(x0, x0_expected, rtol=1e-5, atol=0)
    torch.testing.assert_close(new, a_n * x0_expected + s_n * eps, rtol=1e-4, atol=1e-5)


def test_2m_stepper_is_second_order():
    """Manufactured forcing: eps chosen so the x0-prediction equals a smooth
    g(lambda), whose exact solution is a quadrature; halving the step must
    cut the endpoint error about 4x (float64 state, as JAX's x64 check)."""

    def g(lam):
        return np.sin(lam) + 0.5 * lam

    lam_a, lam_b, x_a = -2.0, 1.5, 0.3
    us = np.linspace(lam_a, lam_b, 400001)
    integral = np.trapezoid(np.exp(us) * g(us), us)

    def sig(lam):
        return 1.0 / np.sqrt(1 + np.exp(2 * lam))

    target = sig(lam_b) * (x_a / sig(lam_a) + integral)
    dpm = TorchDPM(dtype=torch.float64)

    def run(n):
        lams = np.linspace(lam_a, lam_b, n + 1)
        sg = sig(lams)
        al = np.exp(lams) * sg
        state = dataclasses.replace(
            dpm.create_state(), timesteps=torch.zeros(n, dtype=torch.int32),
            lambdas=torch.from_numpy(lams), alphas=torch.from_numpy(al),
            sigmas=torch.from_numpy(sg), num_inference_steps=n,
        )
        x = torch.tensor(x_a, dtype=torch.float64)
        prev_x0 = torch.zeros((), dtype=torch.float64)
        for i in range(n):
            eps = (x - al[i] * g(lams[i])) / sg[i]
            x, prev_x0 = dpm.step(state, eps, i, x, prev_x0)
        return float(x)

    errs = [abs(run(n) - target) for n in (20, 40, 80)]
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert all(o > 1.6 for o in orders), (errs, orders)


def test_karras_dpm_beats_ddim_on_exact_endpoint(toy):
    """Karras-8 beats eta-0 DDIM at 8, 16 and 32 steps against the
    analytic probability-flow endpoint."""
    run_ddim, run_dpm, exact = toy
    err_dpm8 = np.abs(run_dpm(8) - exact).max()
    assert err_dpm8 < 0.05, err_dpm8
    for s in (8, 16, 32):
        err_ddim = np.abs(run_ddim(s) - exact).max()
        assert err_dpm8 < err_ddim, (s, err_dpm8, err_ddim)


def test_linspace_grid_also_converges(toy):
    _, run_dpm, exact = toy
    out = run_dpm(16, grid="linspace")
    assert np.isfinite(out).all() and np.abs(out - exact).max() < 0.5
