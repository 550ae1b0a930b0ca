"""The port's CLIP rewards and LLaVA clients against ddpo_tpu's, on the CPU.

The CLIP features run at a tiny tower (32 px, patch 8, hidden 64, 2
layers, 4 heads; projection 768, the aesthetic MLP's input) on both sides:
the rewards build ``CLIPImageEncoder()`` and preprocess to 224 px, so the
tests patch the encoder's default geometry and the preprocessing size in
each package. No full-width tower runs here. The same seed-made params
(JAX's init, carried across by ``from_flax``) and the same images go
through both packages at fp32; scores agree within 1e-5 relative.
"""

import functools
import importlib
import pickle
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpo_torch.models import clip as t_clip
from ddpo_torch.models.convert import flax_tree_to_state_dict
from ddpo_torch.models.tokenizer import get_tokenizer
from ddpo_torch.training import callbacks as t_callbacks
from ddpo_tpu.models import clip as j_clip
from ddpo_tpu.training import callbacks as j_callbacks

from test_llava_client import stub_server  # noqa: F401

TINY = dict(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, projection_dim=768)
TINY_TEXT = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4)
RTOL = 1e-5


@pytest.fixture
def tiny_clip(monkeypatch):
    """Both packages' default CLIP tower and preprocessing at the tiny size;
    the JAX params of that tower, as a tree and as the port's state_dict."""
    j_cfg, t_cfg = j_clip.CLIPVisionConfig(**TINY), t_clip.CLIPVisionConfig(**TINY)
    monkeypatch.setattr(j_clip, "CLIPImageEncoder",
                        functools.partial(j_clip.CLIPImageEncoder, j_cfg))
    monkeypatch.setattr(t_clip, "CLIPImageEncoder",
                        functools.partial(t_clip.CLIPImageEncoder, t_cfg))
    for module in (j_callbacks, t_callbacks):
        monkeypatch.setattr(module, "clip_preprocess",
                            functools.partial(module.clip_preprocess, size=32))
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(j_clip.CLIPImageEncoder().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))["params"])
    return tree, flax_tree_to_state_dict(tree)


def _images(n=4, size=64, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.random((n, size, size, 3)).astype(np.float32)
    images[1] = np.rot90(images[0], 2)  # nearly rotation-invariant content
    images[2] = images[2].mean(axis=(0, 1), keepdims=True)  # flat
    return images


def _mlp_state(seed=5):
    rng = np.random.default_rng(seed)
    widths = (768, 1024, 128, 64, 16, 1)
    state = {}
    for i, (a, b) in zip((0, 2, 4, 6, 7), zip(widths[:-1], widths[1:])):
        state[f"layers.{i}.weight"] = torch.from_numpy(
            rng.standard_normal((b, a)).astype(np.float32) / np.sqrt(a))
        state[f"layers.{i}.bias"] = torch.from_numpy(rng.standard_normal(b).astype(np.float32))
    return state


@pytest.mark.parametrize("name", ["aesthetic", "rotational", "thumbnail"])
def test_clip_rewards_match_jax(tiny_clip, name):
    tree, state = tiny_clip
    kwargs = {}
    if name == "aesthetic":
        from ddpo_tpu.models.aesthetic import set_weights

        kwargs = {"mlp_params": set_weights(_mlp_state())}
    j_scores, j_info = j_callbacks.callback_fns[name](clip_params=tree, **kwargs)(
        _images(), ["a cat"] * 4, [{}] * 4)
    if name == "aesthetic":
        kwargs = {"mlp_params": _mlp_state()}
    t_scores, t_info = t_callbacks.callback_fns[name](clip_params=state, device="cpu", **kwargs)(
        _images(), ["a cat"] * 4, [{}] * 4)
    j_scores = np.asarray(j_scores)
    assert t_scores.shape == j_scores.shape and t_info == j_info == {}
    assert np.all(np.isfinite(t_scores)) and np.ptp(t_scores) > 0
    np.testing.assert_allclose(t_scores, j_scores, rtol=RTOL, atol=0)


def test_diversity_matches_jax(tiny_clip):
    tree, state = tiny_clip
    np.random.seed(3)
    want, _ = j_callbacks.diversity_fn(clip_params=tree)(_images(), None, None)
    np.random.seed(3)
    got, _ = t_callbacks.diversity_fn(clip_params=state, device="cpu")(_images(), None, None)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_consistency_matches_jax(monkeypatch):
    """The whole CLIP model (ViT and text tower, both projections and
    logit_scale) at tiny widths, the pooled EOT token, the hash tokenizer."""
    v_cfg, t_cfg = j_clip.CLIPVisionConfig(**dict(TINY, projection_dim=16)), \
        j_clip.CLIPTextConfig(**TINY_TEXT)
    for module in (j_callbacks, t_callbacks):
        monkeypatch.setattr(module, "clip_preprocess",
                            functools.partial(module.clip_preprocess, size=32))
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(j_clip.CLIPImageEncoder(v_cfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 3, 32, 32)))["params"])
    tree["text_model"] = jax.tree_util.tree_map(np.asarray, jax.jit(
        j_clip.CLIPTextModel(t_cfg).init)(jax.random.PRNGKey(2), jnp.zeros((1, 77), jnp.int32))
        ["params"]["text_model"])
    rng = np.random.default_rng(4)
    tree["text_projection"] = {"kernel": rng.standard_normal((32, 16)).astype(np.float32)}
    tree["logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    tokenizer = get_tokenizer(None)
    prompts = ["a cat", "a dog riding a bike", "an owl", "a cat"]

    want, _ = j_callbacks.consistency_fn(
        clip_model_params=tree, tokenizer=tokenizer, vision_config=v_cfg,
        text_config=t_cfg)(_images(), prompts, None)
    got, info = t_callbacks.consistency_fn(
        clip_model_params=flax_tree_to_state_dict(tree), tokenizer=tokenizer,
        vision_config=t_clip.CLIPVisionConfig(**dict(TINY, projection_dim=16)),
        text_config=t_clip.CLIPTextConfig(**TINY_TEXT), device="cpu")(_images(), prompts, None)
    want = np.asarray(want)
    assert got.shape == want.shape == (4, 1) and info == {}
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_clip_rewards_need_their_weights_as_in_jax():
    """Without weights every CLIP factory raises JAX's RuntimeError; vqa
    names the paths where it looked for its model."""
    for name, kwargs in (("aesthetic", {}), ("rotational", {}), ("thumbnail", {}),
                         ("consistency", {}), ("consistency", {"clip_model_params": {}})):
        with pytest.raises(RuntimeError) as t_err:
            t_callbacks.callback_fns[name](**kwargs)
        with pytest.raises(RuntimeError) as j_err:
            j_callbacks.callback_fns[name](**kwargs)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(FileNotFoundError, match="blip2-opt-2.7b.*tried"):
        t_callbacks.callback_fns["vqa"]()


def test_clip_rewards_run_on_the_card_unless_asked(tiny_clip):
    """With weights and no device, a factory asks for the card: without
    one it raises at once rather than run on the CPU."""
    _, state = tiny_clip
    if torch.cuda.is_available():
        pytest.skip("this checks a machine without a card")
    for name in ("rotational", "thumbnail"):
        with pytest.raises(RuntimeError, match="device 'cuda' was asked for"):
            t_callbacks.callback_fns[name](clip_params=state)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DDPO_BUCKET", "bucket")
    import ddpo_torch.config.base as t_base
    import ddpo_torch.config.user as t_user
    import ddpo_tpu.config.base as j_base
    import ddpo_tpu.config.user as j_user

    for module in (t_user, t_base, j_user, j_base):
        importlib.reload(module)
    yield tmp_path
    monkeypatch.undo()
    for module in (t_user, t_base, j_user, j_base):
        importlib.reload(module)


ARGV = ["--dataset", "a_animals", "--model_preset", "tiny",
        "--resolution", "32", "--n_inference_steps", "2"]


def test_drivers_with_an_aesthetic_preset_raise_as_jaxs(workdir):
    """--dataset a_animals (logdir aesthetic_simple_animals): JAX's DDPO driver passes the
    reward factory only vae/cache, so it raises for want of CLIP weights
    when it builds the reward; the port's DDPO and sample drivers raise the
    same error at the same point."""
    from ddpo_torch.pipelines import policy_gradient as t_pg
    from ddpo_torch.pipelines import sample as t_sample
    from ddpo_tpu.pipelines import policy_gradient as j_pg

    with pytest.raises(RuntimeError, match="CLIP ViT-L/14 weights unavailable") as j_err:
        j_pg.main(list(ARGV))
    for main in (t_pg.main, t_sample.main):
        with pytest.raises(RuntimeError) as t_err:
            main(ARGV + ["--device", "cpu"])
        assert str(t_err.value) == str(j_err.value)


# ------------------------------- LLaVA clients ------------------------------- #


@pytest.mark.parametrize("name", ["llava_bertscore", "llava_vqa"])
def test_llava_clients_match_jax(stub_server, name):  # noqa: F811
    images = np.random.default_rng(0).random((5, 32, 32, 3)).astype(np.float32)
    prompts = [f"a dog {i}" for i in range(5)]
    metadata = [{"questions": ["is it a dog?", "how many?"], "answers": ["yes", "two"]}] * 5
    outs = [module.callback_fns[name](url=stub_server, batch_size=2)(images, prompts, metadata)
            for module in (t_callbacks, j_callbacks)]
    (t_scores, t_info), (j_scores, j_info) = outs
    np.testing.assert_array_equal(t_scores, j_scores)
    assert set(t_info) == set(j_info)
    for key in t_info:
        assert t_info[key].tolist() == j_info[key].tolist(), key
    np.testing.assert_allclose(t_scores, 0.75 if name == "llava_bertscore" else 0.5)


class _FlakyHandler(BaseHTTPRequestHandler):
    """Answers HTTP 500 to every other request, else echoes the query count."""

    calls = 0

    def do_POST(self):
        data = pickle.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).calls += 1
        if type(self).calls % 2:
            self.send_response(500)
            self.end_headers()
            return
        payload = pickle.dumps({"outputs": [["yes"] * len(q) for q in data["queries"]]})
        self.send_response(200)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *args):
        pass


def test_llava_client_retries_http_500():
    server = HTTPServer(("127.0.0.1", 0), _FlakyHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        fn = t_callbacks.llava_vqa_satisfaction(url=f"http://127.0.0.1:{server.server_port}",
                                                batch_size=2)
        metadata = [{"questions": ["q1", "q2"], "answers": ["yes", "no"]}] * 4
        scores, _ = fn(np.zeros((4, 8, 8, 3), np.float32), None, metadata)
    finally:
        server.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert _FlakyHandler.calls == 4  # two batches, each answered at the second try
    np.testing.assert_allclose(scores, 0.5)
