"""Local SD-1.4 checkpoint directories through the port, against ddpo_tpu.

JAX's tiny stack (``load_stable_diffusion(model_preset="tiny", seed=7)``)
is written in the two layouts a diffusers checkpoint comes in (torch
safetensors and the diffusers-Flax msgpack pipeline) by the writers of
tests/test_checkpoint_formats.py, then loaded through both packages'
``load_stable_diffusion``: every tensor must agree bit for bit, and the
UNet's output on one seed-made input within 1e-5 at fp32. Before the port
read these files it random-initialised the stack whatever the directory
held, which the fp32 cases catch.

The port's own export (``save_stable_diffusion_export``) and JAX's read
each other's files bit for bit, and the port writes the same bytes JAX
does.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ddpo_torch.models.convert import from_flax, load_sd_checkpoint
from ddpo_torch.utils import serialization as t_serialization
from ddpo_torch.utils import tensor_files
from ddpo_tpu.models.convert import load_sd_checkpoint as j_load_sd_checkpoint
from ddpo_tpu.utils import serialization as j_serialization

from test_checkpoint_formats import (
    _flatten,
    _write_flax_checkpoint,
    _write_safetensors_checkpoint,
)
from test_torch_pipeline import workdir  # noqa: F401

SUBS = ("unet", "vae", "text_encoder")
NP_DTYPES = {"float32": np.float32, "float16": np.float16, "bfloat16": ml_dtypes.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def tiny_reference():
    models, params = j_serialization.load_stable_diffusion(model_preset="tiny", seed=7)
    unet_apply = jax.jit(lambda p, x, t, c: models.unet.apply({"params": p}, x, t, c))
    return models, jax.tree_util.tree_map(np.asarray, params), unet_apply


def _port_load(path, dtype="float32"):
    return t_serialization.load_stable_diffusion(
        pretrained_model=str(path), model_preset="tiny", device="cpu",
        dtype=TORCH_DTYPES[dtype], seed=123)


def _jax_load(path, dtype="float32"):
    _, params = j_serialization.load_stable_diffusion(
        pretrained_model=str(path), dtype=jnp.dtype(dtype), model_preset="tiny", seed=123)
    return params


def _as_state(params):
    """JAX's trees -> the port's state_dicts (values widened to fp32 exactly)."""
    return from_flax({sub: jax.tree_util.tree_map(np.asarray, params[sub]) for sub in SUBS})


def _assert_stack_equals(models, params, dtype):
    want = _as_state(params)
    for sub in SUBS:
        got = getattr(models, sub).state_dict()
        assert set(got) == set(want[sub]), (sub, sorted(set(got) ^ set(want[sub]))[:5])
        for key, value in want[sub].items():
            assert got[key].dtype == TORCH_DTYPES[dtype], (sub, key)
            assert torch.equal(got[key].float(), value), (sub, key)


def _unet_inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((1, 4, 8, 8)).astype(np.float32), np.array([3], np.int32),
            rng.standard_normal((1, 77, 32)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,file_dtype", [
    ("safetensors", "float32"), ("safetensors", "float16"),
    ("flax", "float32"), ("flax", "float16"), ("flax", "bfloat16"),
])
def test_port_loads_a_checkpoint_as_jax_does(tmp_path, tiny_reference, layout, file_dtype, dtype):
    models, params, unet_apply = tiny_reference
    write = _write_safetensors_checkpoint if layout == "safetensors" else _write_flax_checkpoint
    write(str(tmp_path), params, dtype=NP_DTYPES[file_dtype])

    loaded = _port_load(tmp_path, dtype)
    j_params = _jax_load(tmp_path, dtype)
    _assert_stack_equals(loaded, j_params, dtype)
    if file_dtype == "float32":  # the file holds the reference stack exactly
        _assert_stack_equals(loaded, jax.tree_util.tree_map(
            lambda x: np.asarray(jnp.asarray(x, dtype)), params), dtype)
    if dtype == "float32":
        x, t, ctx = _unet_inputs()
        want = np.asarray(unet_apply(j_params["unet"], x, t, ctx))
        with torch.no_grad():
            got = loaded.unet(torch.from_numpy(x), torch.from_numpy(t).long(),
                              torch.from_numpy(ctx)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _write_state(path, sub, state, fname="model.safetensors"):
    import safetensors.numpy

    os.makedirs(path / sub, exist_ok=True)
    safetensors.numpy.save_file(state, str(path / sub / fname))


def _read_state(path, sub):
    import safetensors.numpy

    fname = "model.safetensors" if sub == "text_encoder" else "diffusion_pytorch_model.safetensors"
    return safetensors.numpy.load_file(str(path / sub / fname))


@pytest.mark.parametrize("case", ["vae_alias", "position_ids", "bare_text_keys", "chunked_leaf"])
def test_checkpoint_variants_load_as_in_jax(tmp_path, tiny_reference, monkeypatch, case):
    """What real checkpoints carry: a newer diffusers VAE's attention names
    (to_q/to_k/to_v/to_out.0), the CLIP position_ids buffer of
    transformers' text encoders, text keys without the text_model prefix,
    and flax's chunked leaves (the chunk size lowered here so that a tiny
    leaf is chunked)."""
    _, params, _ = tiny_reference
    if case == "chunked_leaf":
        import flax.serialization

        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1000)
        _write_flax_checkpoint(str(tmp_path), params)
    else:
        _write_safetensors_checkpoint(str(tmp_path), params)
    if case == "vae_alias":
        state = _read_state(tmp_path, "vae")
        renamed = {}
        for key, value in state.items():
            for old, new in ((".query.", ".to_q."), (".key.", ".to_k."), (".value.", ".to_v."),
                             (".proj_attn.", ".to_out.0.")):
                key = key.replace(old, new)
            renamed[key] = value
        assert any(".to_out.0." in k for k in renamed) and renamed.keys() != state.keys()
        _write_state(tmp_path, "vae", renamed, "diffusion_pytorch_model.safetensors")
    elif case == "position_ids":
        state = _read_state(tmp_path, "text_encoder")
        state["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
        _write_state(tmp_path, "text_encoder", state)
    elif case == "bare_text_keys":
        state = _read_state(tmp_path, "text_encoder")
        _write_state(tmp_path, "text_encoder",
                     {k[len("text_model."):]: v for k, v in state.items()})
    j_params = _jax_load(tmp_path)
    if case == "position_ids":  # JAX keeps the buffer as an unused leaf; the port drops it
        del j_params["text_encoder"]["text_model"]["embeddings"]["position_ids"]
    loaded = _port_load(tmp_path)
    _assert_stack_equals(loaded, j_params, "float32")
    _assert_stack_equals(loaded, params, "float32")


def test_bf16_safetensors_and_strict_keys(tmp_path, tiny_reference):
    """A BF16 safetensors file (which JAX's numpy reader cannot open) loads
    as the bf16 cast of the stack; a missing or an unexpected key raises,
    naming the key."""
    import safetensors.torch

    _, params, _ = tiny_reference
    _write_safetensors_checkpoint(str(tmp_path), params)
    for sub in SUBS:
        fname = "model.safetensors" if sub == "text_encoder" else "diffusion_pytorch_model.safetensors"
        state = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _read_state(tmp_path, sub).items()}
        safetensors.torch.save_file(state, str(tmp_path / sub / fname))
    bf16 = jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), params)
    _assert_stack_equals(_port_load(tmp_path, "bfloat16"), bf16, "bfloat16")
    host = load_sd_checkpoint(str(tmp_path), dtype=torch.float16)
    assert {v.dtype for state in host.values() for v in state.values()} == {torch.float16}

    unet = {k: v.float().numpy() for k, v in safetensors.torch.load_file(
        str(tmp_path / "unet" / "diffusion_pytorch_model.safetensors")).items()}
    _write_state(tmp_path, "unet", {k: v for k, v in unet.items() if k != "conv_in.weight"},
                 "diffusion_pytorch_model.safetensors")
    with pytest.raises(RuntimeError, match=r"Missing key\(s\).*conv_in\.weight"):
        _port_load(tmp_path)
    _write_state(tmp_path, "unet", dict(unet, extra_weight=np.zeros(3, np.float32)),
                 "diffusion_pytorch_model.safetensors")
    with pytest.raises(RuntimeError, match=r"Unexpected key\(s\).*extra_weight"):
        _port_load(tmp_path)
    os.remove(tmp_path / "unet" / "diffusion_pytorch_model.safetensors")
    with pytest.raises(FileNotFoundError, match="no flax/safetensors weights under"):
        _port_load(tmp_path)


def test_a_name_that_is_not_a_directory_random_initialises(tmp_path, capsys):
    """As in JAX: the message, then the seed's random stack."""
    name = "duongna/stable-diffusion-v1-4-flax"
    models = t_serialization.load_stable_diffusion(name, model_preset="tiny", device="cpu", seed=3)
    assert (f"[ serialization ] '{name}' is not a local directory; random-initializing "
            "SD-1.4 (zero-egress env)") in capsys.readouterr().out
    seeded = t_serialization.load_stable_diffusion(model_preset="tiny", device="cpu", seed=3)
    for sub in SUBS:
        a, b = getattr(models, sub).state_dict(), getattr(seeded, sub).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exports_read_each_other_bit_for_bit(tmp_path, tiny_reference, dtype):
    """The port's export loads in ddpo_tpu's load_sd_checkpoint, JAX's
    export loads in the port, and both write the same bytes."""
    _, params, _ = tiny_reference
    j_params = jax.tree_util.tree_map(lambda x: np.asarray(jnp.asarray(x, dtype)), params)
    j_serialization.save_stable_diffusion_export(str(tmp_path / "jax"), j_params)
    models = _port_load(tmp_path / "jax", dtype)
    _assert_stack_equals(models, j_params, dtype)

    t_serialization.save_stable_diffusion_export(str(tmp_path / "port"), models)
    back = j_load_sd_checkpoint(str(tmp_path / "port"))
    for sub in SUBS:
        got, want = _flatten(back[sub]), _flatten(j_params[sub])
        assert set(got) == set(want), sub
        for path, value in want.items():
            assert got[path].dtype == value.dtype and got[path].shape == value.shape, path
            np.testing.assert_array_equal(got[path].astype(np.float32), value.astype(np.float32))
        for fname in os.listdir(tmp_path / "jax" / sub):
            assert (tmp_path / "port" / sub / fname).read_bytes() == \
                (tmp_path / "jax" / sub / fname).read_bytes(), (sub, fname)


def test_chunked_export_reads_in_jax(tmp_path, tiny_reference, monkeypatch):
    """The port's writer chunks a leaf above its chunk size as flax does
    (lowered here), and JAX's reader joins it back."""
    _, params, _ = tiny_reference
    monkeypatch.setattr(tensor_files, "MAX_CHUNK_SIZE", 1000)
    models = t_serialization.load_stable_diffusion(model_preset="tiny", device="cpu", seed=5)
    t_serialization.save_stable_diffusion_export(str(tmp_path), models)
    raw = (tmp_path / "unet" / "diffusion_flax_model.msgpack").read_bytes()
    assert b"__msgpack_chunked_array__" in raw
    _, back = j_serialization.load_stable_diffusion(str(tmp_path), model_preset="tiny")
    for sub in SUBS:
        want = getattr(models, sub).state_dict()
        got = _as_state(back)[sub]
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    again = _port_load(tmp_path)
    for sub in SUBS:
        a, b = getattr(again, sub).state_dict(), getattr(models, sub).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
    shutil.rmtree(tmp_path)


def test_drivers_serve_a_local_checkpoint(workdir, monkeypatch):  # noqa: F811
    """generate --pretrained_model <dir> serves the directory's weights (the
    parent commit served the seed's random stack), and load_unet overlays a
    finetuned UNet on the loaded stack, not on a random one."""
    from ddpo_torch.pipelines import generate
    from ddpo_torch.utils import checkpoints

    tmp_path = workdir
    stack = t_serialization.load_stable_diffusion(model_preset="tiny", device="cpu", seed=5)
    t_serialization.save_stable_diffusion_export(str(tmp_path / "sd"), stack)
    argv = ["--dataset", "debug-animals", "--device", "cpu", "--dtype", "float32",
            "--n_inference_steps", "2", "--resolution", "32", "--n_samples", "2",
            "--n_samples_per_device", "2", "--seed", "0"]
    served = generate.main(argv + ["--pretrained_model", str(tmp_path / "sd")])
    monkeypatch.setattr(generate, "load_unet", lambda *a, **kw: stack)
    np.testing.assert_array_equal(served.images, generate.main(list(argv)).images)

    unet = t_serialization.load_stable_diffusion(model_preset="tiny", device="cpu", seed=9).unet
    checkpoints.save_unet(str(tmp_path / "ft"), unet, epoch=0)
    models = t_serialization.load_unet(str(tmp_path / "ft"), pretrained_model=str(tmp_path / "sd"),
                                       model_preset="tiny", device="cpu", seed=0)
    for sub, want in (("unet", unet), ("vae", stack.vae), ("text_encoder", stack.text_encoder)):
        got = getattr(models, sub).state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.state_dict().items()), sub
