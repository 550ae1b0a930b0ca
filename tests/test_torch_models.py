"""The port's UNet, CLIP text tower and VAE decoder against ddpo_tpu's modules.

The JAX tiny stack is initialised from a seed; ``from_flax`` carries its
parameters into the port's modules; the same numpy inputs go through both,
at fp32 on the CPU. Tolerance: atol 1e-4, rtol 1e-4 on the outputs (fp32
convs and matmuls in another summation order, through every layer).

The SD-1.4 check builds the port's full-size modules on the meta device
(no memory) and holds every path of ddpo_tpu's SD-1.4 manifest against
them through ``from_flax``'s key rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpo_torch.models.convert import (
    VAE_NOT_PORTED,
    convert_flax_tensor,
    flax_path_to_torch_key,
    from_flax,
)
from ddpo_torch.models.layers import GroupNorm
from ddpo_torch.utils.serialization import build_models
from ddpo_tpu.models.convert import torch_key_to_flax_path
from ddpo_tpu.models.manifest import count_params, sd14_manifest
from ddpo_tpu.models.tokenizer import HashTokenizer
from ddpo_tpu.utils.serialization import _tiny_stack

ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    """(jax modules, jax params, torch modules loaded through from_flax)."""
    j_text, j_vae, j_unet = _tiny_stack(jnp.float32)
    k_unet, k_vae, k_text = jax.random.split(jax.random.PRNGKey(0), 3)
    # jitted inits, as ddpo_tpu's _random_init_params: one compile each
    params = {
        "unet": jax.jit(j_unet.init)(k_unet, jnp.zeros((1, 4, 8, 8)),
                                     jnp.zeros((1,), jnp.int32),
                                     jnp.zeros((1, 77, 32)))["params"],
        "vae": jax.jit(j_vae.init)(k_vae, jnp.zeros((1, 3, 32, 32)),
                                   jax.random.PRNGKey(0))["params"],
        "text_encoder": jax.jit(j_text.init)(k_text, jnp.zeros((1, 77), jnp.int32))["params"],
    }
    params = jax.tree_util.tree_map(np.asarray, params)
    t_text, t_vae, t_unet = build_models("tiny", "cpu")
    state = from_flax(params)
    for module, name in ((t_unet, "unet"), (t_vae, "vae"), (t_text, "text_encoder")):
        module.load_state_dict(state[name], strict=True)
        module.eval()
    return (j_unet, j_vae, j_text), params, (t_unet, t_vae, t_text)


def test_unet_matches_jax(tiny):
    (j_unet, _, _), params, (t_unet, _, _) = tiny
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([999, 21], dtype=np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    ref = np.asarray(j_unet.apply({"params": params["unet"]}, x, t, ctx))
    with torch.no_grad():
        out = t_unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_vae_decoder_matches_jax(tiny):
    (_, j_vae, _), params, (_, t_vae, _) = tiny
    z = np.random.default_rng(1).standard_normal((2, 4, 8, 8)).astype(np.float32)
    ref = np.asarray(j_vae.apply({"params": params["vae"]}, z, method=j_vae.decode))
    with torch.no_grad():
        out = t_vae.decode(torch.from_numpy(z))
    assert out.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_clip_text_matches_jax(tiny):
    (_, _, j_text), params, (_, _, t_text) = tiny
    ids = HashTokenizer()(["a photo of a cat", "", "an otter on a rock"])
    ref = np.asarray(j_text.apply({"params": params["text_encoder"]}, ids))
    with torch.no_grad():
        out = t_text(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_tiny_vae_exercises_the_gcd_group_clamp(tiny):
    _, _, (_, t_vae, _) = tiny
    widths = {m.weight.shape[0] for m in t_vae.modules() if isinstance(m, GroupNorm)}
    assert 16 in widths  # 16 channels -> gcd(16, 32) = 16 groups


@pytest.mark.parametrize("name", ["unet", "text_encoder", "vae"])
def test_sd14_manifest_maps_onto_the_port(name):
    text, vae, unet = build_models("sd14", "meta")
    module = {"unet": unet, "vae": vae, "text_encoder": text}[name]
    port = {k: tuple(p.shape) for k, p in module.named_parameters()}
    manifest = sd14_manifest()[name]
    mapped = {}
    for path, shape in manifest.items():
        parts = tuple(path.split("/"))
        if name == "vae" and parts[0] in VAE_NOT_PORTED:
            continue
        key = flax_path_to_torch_key(parts)
        assert torch_key_to_flax_path(key)[0] == parts  # inverse of JAX's rule
        want = convert_flax_tensor(parts, np.empty(shape, np.uint8)).shape
        assert port.get(key) == tuple(want), (path, key, port.get(key), want)
        mapped[key] = want
    assert set(mapped) == set(port)  # nothing left over on either side
    totals = {"unet": 859_520_964, "text_encoder": 123_060_480}
    if name in totals:
        assert count_params(manifest) == totals[name]
        assert sum(int(np.prod(s)) for s in port.values()) == totals[name]
