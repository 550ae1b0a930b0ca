"""The port's CLIP vision tower, CLIP checkpoint reader and aesthetic MLP
against ddpo_tpu's, on the CPU at fp32.

The tower runs at the tiny geometry of tests/test_clip_vision.py (32 px,
patch 8, hidden 64, 2 layers, 4 heads, projection 16) with JAX's
seed-made params carried across by ``from_flax``; ViT-L/14, ViT-B/32 and
the B/32 text tower are held against JAX's parameter trees key by key and
shape by shape without computing anything (meta tensors and
``jax.eval_shape``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpo_torch.models import aesthetic as t_aesthetic
from ddpo_torch.models import clip as t_clip
from ddpo_torch.models.convert import flax_tree_to_state_dict, load_clip_checkpoint, to_flax
from ddpo_tpu.models import aesthetic as j_aesthetic
from ddpo_tpu.models import clip as j_clip
from ddpo_tpu.models.convert import load_clip_checkpoint as j_load_clip_checkpoint

TINY = dict(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, projection_dim=16)
TINY_TEXT = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_encoder_params(cfg, seed=0):
    enc = j_clip.CLIPImageEncoder(cfg)
    size = cfg.image_size
    return _numpy(jax.jit(enc.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 3, size, size)))["params"])


def _port_encoder(cfg, state):
    model = t_clip.CLIPImageEncoder(cfg)
    model.load_state_dict(state, strict=True)
    return model.eval()


def _assert_trees_equal(a, b, path=()):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], path + (k,))
        else:
            got = a[k].float().numpy() if isinstance(a[k], torch.Tensor) else np.asarray(a[k])
            assert got.shape == np.shape(b[k]), path + (k,)
            np.testing.assert_array_equal(got, np.asarray(b[k], got.dtype), err_msg=str(path + (k,)))


@pytest.mark.parametrize("what", ["pooled", "features"])
def test_vision_tower_matches_jax(what):
    j_cfg = j_clip.CLIPVisionConfig(**TINY)
    params = _jax_encoder_params(j_cfg)
    model = _port_encoder(t_clip.CLIPVisionConfig(**TINY), flax_tree_to_state_dict(params))
    pixels = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        if what == "pooled":
            got = model.vision_model(torch.from_numpy(pixels)).numpy()
            want = j_clip.CLIPVisionTransformer(j_cfg).apply(
                {"params": params["vision_model"]}, jnp.asarray(pixels))
        else:
            got = model(torch.from_numpy(pixels)).numpy()
            want = j_clip.CLIPImageEncoder(j_cfg).apply({"params": params}, jnp.asarray(pixels))
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_vision_attention_never_takes_the_flash_gate(monkeypatch):
    """S = 257 (ViT-L/14) meets the flash kernel's gate; the tower calls the
    plain product directly, as JAX's xla_attention does."""
    plain = t_clip.attention_reference
    calls = []
    monkeypatch.setattr(t_clip, "attention_reference",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    model = _port_encoder(t_clip.CLIPVisionConfig(**TINY), flax_tree_to_state_dict(
        _jax_encoder_params(j_clip.CLIPVisionConfig(**TINY))))
    with torch.no_grad():
        model(torch.zeros(1, 3, 32, 32))
    assert calls == [(1, 17, 4, 16)] * 2


def _meta_state(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _jax_shapes_as_torch(tree):
    """JAX's param tree of ShapeDtypeStructs -> {torch key: torch shape}."""
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.uint8), tree)
    return {k: tuple(v.shape) for k, v in flax_tree_to_state_dict(zeros).items()}


@pytest.mark.parametrize("name", ["VIT_L_14", "VIT_B_32", "B32_TEXT"])
def test_full_geometry_key_and_shape_map(name):
    j_cfg, t_cfg = getattr(j_clip, name), getattr(t_clip, name)
    assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)
    if name == "B32_TEXT":
        j_model, t_make = j_clip.CLIPTextModel(j_cfg), lambda: t_clip.CLIPTextModel(t_cfg)
        dummy = jnp.zeros((1, 77), jnp.int32)
    else:
        j_model, t_make = j_clip.CLIPImageEncoder(j_cfg), lambda: t_clip.CLIPImageEncoder(t_cfg)
        dummy = jnp.zeros((1, 3, j_cfg.image_size, j_cfg.image_size))
    shapes = jax.eval_shape(j_model.init, jax.random.PRNGKey(0), dummy)["params"]
    with torch.device("meta"):
        module = t_make()
    want = _jax_shapes_as_torch(shapes)
    got = _meta_state(module)
    assert got == want
    if name == "VIT_L_14":
        n = sum(int(np.prod(s)) for s in got.values())
        assert 300e6 < n < 310e6, n  # about 304M parameters


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_to_flax_gives_back_jaxs_clip_tree(tower):
    """CLIP trees keep their encoder layers under "layers" / "<i>"."""
    if tower == "vision":
        tree = _jax_encoder_params(j_clip.CLIPVisionConfig(**TINY))
        model = t_clip.CLIPImageEncoder(t_clip.CLIPVisionConfig(**TINY))
    else:
        cfg = dict(TINY_TEXT, vocab_size=49408)
        tree = _numpy(jax.jit(j_clip.CLIPTextModel(j_clip.CLIPTextConfig(**cfg)).init)(
            jax.random.PRNGKey(1), jnp.zeros((1, 77), jnp.int32))["params"])
        model = t_clip.CLIPTextModel(t_clip.CLIPTextConfig(**cfg))
    assert "0" in (tree["vision_model"] if tower == "vision" else tree["text_model"])["encoder"]["layers"]
    state = flax_tree_to_state_dict(tree)
    model.load_state_dict(state, strict=True)
    _assert_trees_equal(to_flax(state, model), tree)


def _tiny_clip_tree(seed=3):
    """A whole tiny CLIPModel tree as JAX's loader returns it."""
    v_cfg = j_clip.CLIPVisionConfig(**TINY)
    t_cfg = j_clip.CLIPTextConfig(**TINY_TEXT)
    tree = _jax_encoder_params(v_cfg, seed)
    tree["text_model"] = _numpy(jax.jit(j_clip.CLIPTextModel(t_cfg).init)(
        jax.random.PRNGKey(seed + 1), jnp.zeros((1, 77), jnp.int32))["params"]["text_model"])
    rng = np.random.default_rng(seed)
    tree["text_projection"] = {"kernel": rng.standard_normal((32, 16)).astype(np.float32)}
    tree["logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    return tree


@pytest.mark.parametrize("layout", ["flax", "safetensors"])
def test_load_clip_checkpoint_matches_jax(tmp_path, layout):
    """Both layouts through both packages' load_clip_checkpoint: every
    tensor bit for bit, the bare logit_scale kept, position_ids dropped."""
    tree = _tiny_clip_tree()
    if layout == "flax":
        from flax.serialization import msgpack_serialize

        (tmp_path / "flax_model.msgpack").write_bytes(msgpack_serialize(tree))
    else:
        import safetensors.numpy

        state = {k: v.numpy() for k, v in flax_tree_to_state_dict(tree).items()}
        for t in ("text_model", "vision_model"):
            state[f"{t}.embeddings.position_ids"] = np.arange(
                77 if t == "text_model" else 17, dtype=np.int64)[None]
        safetensors.numpy.save_file(state, str(tmp_path / "model.safetensors"))
    got = load_clip_checkpoint(str(tmp_path))
    want = flax_tree_to_state_dict(_numpy(j_load_clip_checkpoint(str(tmp_path))))
    want = {k: v for k, v in want.items() if not k.endswith("position_ids")}  # unused in JAX
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    assert got["logit_scale"].shape == () and got["logit_scale"].item() == float(tree["logit_scale"])
    with pytest.raises(FileNotFoundError, match="no flax/safetensors CLIP weights"):
        load_clip_checkpoint(str(tmp_path / "missing"))


def test_aesthetic_mlp_from_one_state_dict(tmp_path):
    """One torch state dict (layers 0/2/4/6/7 of the reference's
    nn.Sequential) through both packages' set_weights and load_weights."""
    rng = np.random.default_rng(5)
    widths = (768, 1024, 128, 64, 16, 1)
    state = {}
    for i, (a, b) in zip((0, 2, 4, 6, 7), zip(widths[:-1], widths[1:])):
        state[f"layers.{i}.weight"] = torch.from_numpy(rng.standard_normal((b, a)).astype(np.float32) / np.sqrt(a))
        state[f"layers.{i}.bias"] = torch.from_numpy(rng.standard_normal(b).astype(np.float32))
    x = rng.standard_normal((4, 768)).astype(np.float32)
    want = np.asarray(j_aesthetic.AestheticClassifier().apply(j_aesthetic.set_weights(state), x))
    with torch.no_grad():
        got = t_aesthetic.set_weights(state)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    torch.save(state, tmp_path / t_aesthetic.WEIGHTS_FNAME)
    with torch.no_grad():
        loaded = t_aesthetic.load_weights(str(tmp_path))(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(loaded, got)
    with pytest.raises(FileNotFoundError, match="no network") as err:
        t_aesthetic.load_weights(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError) as j_err:
        j_aesthetic.load_weights(str(tmp_path / "empty"), allow_download=False)
    assert str(err.value) == str(j_err.value)
    assert not os.path.exists(tmp_path / "empty")
