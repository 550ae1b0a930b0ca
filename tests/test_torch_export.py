"""The UNet export across the two packages, on the CPU at fp32 (tiny preset).

``to_flax`` inverts ``from_flax``; the port's ``save_unet`` writes the JAX
package's ``unet_{epoch}.pkl`` format and its ``load_unet`` reads it, so a
finetuned UNet moves from either package to the other's ``generate``. Every
comparison is bitwise: the export keeps fp32 values as they are.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpo_torch.models.convert import VAE_NOT_PORTED, from_flax, to_flax
from ddpo_torch.models.lora import init_lora, merge_lora
from ddpo_torch.utils import checkpoints
from ddpo_torch.utils.serialization import build_models, load_stable_diffusion, load_unet
from ddpo_tpu.utils import checkpoints as j_checkpoints
from ddpo_tpu.utils.serialization import _tiny_stack

from test_torch_pipeline import workdir  # noqa: F401


@pytest.fixture(scope="module")
def jax_params():
    """The JAX tiny stack's fp32 params, as numpy trees."""
    j_text, j_vae, j_unet = _tiny_stack(jnp.float32)
    k_unet, k_vae, k_text = jax.random.split(jax.random.PRNGKey(7), 3)
    params = {
        "unet": jax.jit(j_unet.init)(k_unet, jnp.zeros((1, 4, 8, 8)),
                                     jnp.zeros((1,), jnp.int32),
                                     jnp.zeros((1, 77, 32)))["params"],
        "vae": jax.jit(j_vae.init)(k_vae, jnp.zeros((1, 3, 32, 32)),
                                   jax.random.PRNGKey(0))["params"],
        "text_encoder": jax.jit(j_text.init)(k_text, jnp.zeros((1, 77), jnp.int32))["params"],
    }
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_trees_equal(a, b, path=()):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], path + (k,))
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, path + (k,)
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(path + (k,)))


@pytest.mark.parametrize("name", ["unet", "vae"])
def test_to_flax_inverts_from_flax(jax_params, name):
    _, vae, unet = build_models("tiny", "cpu")
    model = {"unet": unet, "vae": vae}[name]
    state = from_flax(jax_params)[name]
    model.load_state_dict(state)
    tree = jax_params[name]
    if name == "vae":  # the encoder is not ported: from_flax leaves it out
        tree = {k: v for k, v in tree.items() if k not in VAE_NOT_PORTED}
    _assert_trees_equal(to_flax(state, model), tree)
    # bf16 weights are written as float32, exactly
    half = {k: v.to(torch.bfloat16) for k, v in state.items()}
    back = from_flax({name: to_flax(half, model)})[name]
    assert all(torch.equal(back[k], v.float()) for k, v in half.items())


def test_jax_reads_the_ports_export(jax_params, tmp_path):
    _, _, unet = build_models("tiny", "cpu")
    unet.load_state_dict(from_flax(jax_params)["unet"])
    path = checkpoints.save_unet(str(tmp_path), unet, epoch=3)
    assert path == str(tmp_path / "unet_3.pkl")
    assert j_checkpoints.get_latest_epoch(str(tmp_path)) == 3
    _assert_trees_equal(j_checkpoints.load_unet_pickle(str(tmp_path)), jax_params["unet"])


def test_port_reads_the_jax_export(jax_params, tmp_path):
    j_checkpoints.save_unet(str(tmp_path), jax_params["unet"], epoch=0)
    j_checkpoints.save_unet(str(tmp_path), jax.tree_util.tree_map(np.zeros_like,
                                                                  jax_params["unet"]), epoch=2)
    assert checkpoints.get_latest_epoch(str(tmp_path)) == 2
    models = load_unet(str(tmp_path), epoch=0, model_preset="tiny", device="cpu", seed=1)
    want = from_flax(jax_params)["unet"]
    got = models.unet.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    # the rest of the stack is the seed's
    stack = load_stable_diffusion(model_preset="tiny", device="cpu", seed=1)
    assert all(torch.equal(p, q) for p, q in zip(models.vae.parameters(),
                                                 stack.vae.parameters()))


@pytest.mark.parametrize("what", ["full", "lora"])
def test_load_unet_reads_a_train_state(workdir, what):
    """"orbax:<savepath>" reads the port's own state.pt: the masters of a
    full finetune, or a LoRA run's adapters merged onto the seed's UNet."""
    stack = load_stable_diffusion(model_preset="tiny", device="cpu", seed=0)
    base = dict(stack.unet.named_parameters())
    if what == "full":
        params = {k: v + 0.5 for k, v in base.items()}
        want = params
    else:
        params = {k: torch.full_like(v, 0.01) for k, v in
                  init_lora(base, 2, torch.Generator().manual_seed(0)).items()}
        want = merge_lora(base, params)
    checkpoints.save_train_state("run", 4, {"state": {"params": params}, "epoch": 4})
    models = load_unet("orbax:run", model_preset="tiny", device="cpu", seed=0)
    got = dict(models.unet.named_parameters())
    assert all(torch.equal(got[k], v) for k, v in want.items())


def test_generate_serves_the_export(workdir, monkeypatch):
    """generate --iteration 1 on an exported UNet gives the images of the
    stack with those weights loaded directly."""
    from ddpo_torch.pipelines import generate

    stack = load_stable_diffusion(model_preset="tiny", device="cpu", seed=0)
    rng = np.random.default_rng(2)
    finetuned = {k: v + torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)) * 0.01
                 for k, v in stack.unet.state_dict().items()}
    checkpoints.save_unet(str(workdir / "export"), stack.unet, epoch=0, params=finetuned)
    argv = ["--dataset", "debug-animals", "--device", "cpu", "--dtype", "float32",
            "--n_inference_steps", "2", "--resolution", "32", "--n_samples", "2",
            "--n_samples_per_device", "2", "--seed", "0"]
    served = generate.main(argv + ["--iteration", "1", "--loadpath", str(workdir / "export")])

    def direct(loadpath, **kw):
        assert loadpath is None
        models = load_stable_diffusion(kw["pretrained_model"], model_preset=kw["model_preset"],
                                       device=kw["device"], dtype=kw["dtype"], seed=kw["seed"])
        models.unet.load_state_dict(finetuned)
        return models

    monkeypatch.setattr(generate, "load_unet", direct)
    reference = generate.main(argv)
    np.testing.assert_array_equal(served.images, reference.images)
    monkeypatch.setattr(generate, "load_unet", load_unet)
    plain = generate.main(argv)  # the seed's own UNet gives other images
    assert not np.array_equal(plain.images, served.images)
    with open(workdir / "export" / "unet_0.pkl", "rb") as f:
        assert "time_embedding" in pickle.load(f)
