"""The port's vqa reward (BLIP-2: models/blip2.py, models/opt.py,
models/gpt2_bpe.py, models/convert.py ``load_blip2``) against transformers
and against ddpo_tpu's own ``vqa_satisfaction``, on the CPU.

A tiny random BLIP-2 (tower 28 px in 14 px patches, width 32, 2 layers;
Q-Former width 32, 2 layers, cross-attention in layer 0; OPT width 32, 2
layers; 4 query tokens) is written with transformers' ``save_pretrained``
beside a processor over a small byte-level vocabulary (OPT's four
specials, the 256 byte tokens, merges of a few words, filler tokens, and
``<image>``), once with ``num_query_tokens`` in processor_config.json and
once without (the legacy layout). Every weight and image comes from numpy
seeds. Both packages load the same directory. Tolerances: pixel values
within 1e-6; ids, masks, generated ids, decoded text and scores equal;
hidden states and logits within 1e-5 relative to their largest entry
(transformers runs sdpa attention, the port the plain product).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from ddpo_torch.models import blip2 as t_blip2  # noqa: E402
from ddpo_torch.models.convert import load_blip2, resolve_pretrained  # noqa: E402
from ddpo_torch.models.opt import KVCache  # noqa: E402
from ddpo_torch.models.tokenizer import bytes_to_unicode  # noqa: E402
from ddpo_torch.training import callbacks as t_callbacks  # noqa: E402

REL = 1e-5
QUERIES = 4
MERGE_WORDS = ["Question", "Answer", ":", " the", " cat", " dog", " is", " a", " what",
               " doing", " playing", " piano", " café", " 日本"]
QUESTIONS = [
    "Question: who is playing the piano? Answer:",
    "Question: what is the cat doing? Answer:",
    "Question: is there a dog in the café near 12 trees? Answer:",
    "Question: it's   the\tdogs' ÜBER naïve 日本 x² ?! Answer:",
]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _offline_one_thread(monkeypatch):
    """Offline whatever the environment said when transformers was first
    imported (huggingface_hub reads HF_HUB_OFFLINE once; the variable is
    set too, for what a test starts), and one intra-op thread."""
    import huggingface_hub.constants
    import transformers.utils.hub

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(transformers.utils.hub, "_is_offline_mode", True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_tiny(path, legacy: bool, seed: int = 0, fillers: int = 120):
    """A tiny BLIP-2 and its processor, saved by transformers."""
    os.makedirs(path, exist_ok=True)
    b2u = bytes_to_unicode()
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for b in range(256):
        vocab[b2u[b]] = len(vocab)
    merges = []
    for word in MERGE_WORDS:
        parts = [b2u[c] for c in word.encode()]
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            if pair not in merges:
                merges.append(pair)
                vocab.setdefault(pair[0] + pair[1], len(vocab))
            parts = [pair[0] + pair[1]] + parts[2:]
    chars = [b2u[b] for b in range(256)]
    for i in range(fillers):  # tokens no merge makes: only decoding meets them
        vocab.setdefault(chars[(7 * i) % 256] + chars[(13 * i + 5) % 256] + "x", len(vocab))
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    tokenizer = transformers.GPT2Tokenizer(
        os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"),
        bos_token="</s>", eos_token="</s>", unk_token="</s>", pad_token="<pad>",
        add_bos_token=True)
    images = transformers.BlipImageProcessor(
        size={"height": 28, "width": 28}, resample=3,
        image_mean=[0.48145466, 0.4578275, 0.40821073],
        image_std=[0.26862954, 0.26130258, 0.27577711])
    processor = transformers.Blip2Processor(images, tokenizer,
                                            num_query_tokens=None if legacy else QUERIES)
    processor.save_pretrained(path)
    image_id = processor.tokenizer.convert_tokens_to_ids("<image>")
    cfg = transformers.Blip2Config(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=28, patch_size=14),
        qformer_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                            intermediate_size=64),
        text_config=dict(model_type="opt", vocab_size=len(processor.tokenizer) + 6,
                         hidden_size=32, num_hidden_layers=2, ffn_dim=64,
                         num_attention_heads=4, max_position_embeddings=96,
                         word_embed_proj_dim=32),
        num_query_tokens=QUERIES, image_token_index=image_id)
    model = transformers.Blip2ForConditionalGeneration(cfg).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            centre = 1.0 if "norm" in name.lower() and name.endswith("weight") else 0.0
            p.copy_(torch.as_tensor(centre + rng.normal(0, 0.2, p.shape), dtype=p.dtype))
    model.save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def tiny_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("blip2")
    return {"tokens": _write_tiny(str(root / "tokens"), legacy=False),
            "legacy": _write_tiny(str(root / "legacy"), legacy=True)}


@pytest.fixture(scope="module")
def loaded(tiny_dirs):
    """(transformers model, its processor, the port's model, processor and
    greedy settings) for each layout."""
    out = {}
    for layout, path in tiny_dirs.items():
        hf_proc = transformers.AutoProcessor.from_pretrained(path)
        hf = transformers.Blip2ForConditionalGeneration.from_pretrained(
            path, dtype=torch.float32).eval()
        out[layout] = (hf, hf_proc) + load_blip2(path, "cpu")
    return out


def _images(n, seed=1, size=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)]


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, f"max|d| / max|ref| = {err:.3e} > {rel:g}"


@pytest.mark.parametrize("layout", ["tokens", "legacy"])
def test_processor_matches_transformers(loaded, layout):
    """Pixel values within 1e-6, ids and mask equal, for both layouts and
    questions of unequal length (right padding)."""
    hf, hf_proc, _, proc, _ = loaded[layout]
    images = _images(4, size=37)
    want = hf_proc(images, text=QUESTIONS, return_tensors="np", padding="longest")
    got = proc(images, QUESTIONS)
    assert type(hf_proc.tokenizer).__name__ == "GPT2TokenizerFast"
    assert type(hf_proc.image_processor).__name__ == "BlipImageProcessor"
    assert np.abs(got["pixel_values"] - want["pixel_values"]).max() <= 1e-6
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])
    assert (got["attention_mask"] == 0).any()  # a padded row
    assert proc.image_tokens == (layout == "tokens")


BPE_TEXTS = [
    "Question: who is playing the piano? Answer:", "what is the cat doing?",
    "it's we're I'll they'd don't 's 'S ''", "   leading and trailing   ",
    "tabs\t\tand\n\nnewlines \n x", "naïve café ÜBER straße", "日本語のテキスト と 12",
    "x² + ½ = ٣ digits", "emoji 🐱🎹 and 👍🏽", "a b c　d\x85e\x1cf",
    "mixed123abc 4.5e-3 $100", "</s> inside <image> text <pad>", "",
]


@pytest.mark.parametrize("text", BPE_TEXTS)
def test_bpe_encode_matches_transformers(loaded, text):
    hf_tok, tok = loaded["tokens"][1].tokenizer, loaded["tokens"][3].tokenizer
    assert tok.encode_one(text) == hf_tok(text)["input_ids"]
    assert tok.encode_one(text, add_special_tokens=False) == hf_tok(
        text, add_special_tokens=False)["input_ids"]


def test_bpe_encode_random_texts_match_transformers(loaded):
    """Random strings over a mixed alphabet (letters, digits, marks,
    contractions, runs of white space of several kinds, CJK, emoji)."""
    hf_tok, tok = loaded["tokens"][1].tokenizer, loaded["tokens"][3].tokenizer
    alphabet = list("ab Z9'-. \t\n\u3000\x85éß日²½٣🐱") + ["'s", "'ll", " the", "</s>"]
    rng = np.random.default_rng(5)
    for _ in range(300):
        text = "".join(rng.choice(alphabet, rng.integers(1, 30)))
        assert tok.encode_one(text) == hf_tok(text)["input_ids"], repr(text)


def test_bpe_decode_matches_transformers(loaded):
    """Random rows over the whole id range (specials, <image>, fillers, ids
    past the vocabulary, byte tokens that make bad UTF-8), with and
    without skip_special_tokens."""
    hf, hf_proc, _, proc, _ = loaded["tokens"]
    vocab = hf.config.text_config.vocab_size
    rng = np.random.default_rng(7)
    rows = [rng.integers(0, vocab, rng.integers(1, 24)).tolist() for _ in range(200)]
    rows.append(proc.tokenizer.encode_one(QUESTIONS[3]))
    for skip in (True, False):
        assert proc.batch_decode(rows, skip) == hf_proc.batch_decode(
            rows, skip_special_tokens=skip)


def test_vision_qformer_and_projection_match_transformers(loaded):
    hf, hf_proc, model, proc, _ = loaded["tokens"]
    pixels = torch.as_tensor(proc(_images(3), ["Question: a? Answer:"] * 3)["pixel_values"])
    with torch.no_grad():
        want_image = hf.vision_model(pixels).last_hidden_state
        got_image = model.vision_model(pixels)
        queries = hf.query_tokens.expand(3, -1, -1)
        want_q = hf.qformer(query_embeds=queries, encoder_hidden_states=want_image).last_hidden_state
        got_q = model.qformer(model.query_tokens.expand(3, -1, -1), want_image)
        want_features = hf.get_image_features(pixels)
        got_features = model.image_features(pixels)
    _close(got_image, want_image)
    _close(got_q, want_q)
    _close(got_features, want_features)


def _prompt(loaded_layout, images, questions):
    hf, hf_proc, model, proc, gen = loaded_layout
    inputs = {k: torch.as_tensor(v) for k, v in proc(images, questions).items()}
    with torch.no_grad():
        features = model.image_features(inputs["pixel_values"])
        embeds, mask = model.prompt_embeds(features, inputs["input_ids"],
                                           inputs["attention_mask"], proc.image_tokens)
    positions = (mask.cumsum(-1) - 1).masked_fill(mask == 0, 1)
    return inputs, embeds, mask, positions


def test_opt_logits_match_transformers(loaded):
    """The decoder's logits at every prompt position, padded rows
    included, given the same embeddings, mask and positions."""
    hf, _, model, _, _ = loaded["tokens"]
    _, embeds, mask, positions = _prompt(loaded["tokens"], _images(4), QUESTIONS)
    with torch.no_grad():
        want = hf.language_model(inputs_embeds=embeds, attention_mask=mask,
                                 position_ids=positions).logits
        got = model.language_model(embeds, mask, positions)
    _close(got, want)


def test_kv_cache_decoding_equals_a_full_forward(loaded):
    """The prompt through the cache, then five tokens one at a time, give
    the full forward's logits at those positions."""
    _, _, model, _, _ = loaded["tokens"]
    lm = model.language_model
    _, embeds, mask, positions = _prompt(loaded["tokens"], _images(4), QUESTIONS)
    rng = np.random.default_rng(3)
    new = torch.as_tensor(rng.integers(0, lm.config.vocab_size, (4, 5)))
    full_mask = torch.cat([mask, torch.ones_like(new)], 1)
    full_pos = (full_mask.cumsum(-1) - 1).masked_fill(full_mask == 0, 1)
    with torch.no_grad():
        full = lm(torch.cat([embeds, lm.embed(new)], 1), full_mask, full_pos)
        cache = KVCache(lm.config, 4, full_mask.shape[1], "cpu")
        steps = [lm(embeds, mask, positions, cache, last_only=True)]
        for j in range(5):
            at = mask.shape[1] + j + 1
            steps.append(lm(lm.embed(new[:, j:j + 1]), full_mask[:, :at],
                            full_pos[:, at - 1:at], cache, last_only=True))
    want = full[:, mask.shape[1] - 1:]
    _close(torch.stack(steps, 1), want)


def test_generate_matches_transformers_in_both_layouts(loaded):
    """``<image>`` layout: the ids of transformers' generate, prompt and
    new tokens. Legacy layout: the new ids of transformers' OPT generate
    on the query outputs put before the text, which are also the <image>
    layout's new ids on the same weights."""
    images = _images(4)
    hf, hf_proc, model, proc, gen = loaded["tokens"]
    inputs = hf_proc(images, text=QUESTIONS, return_tensors="pt", padding="longest")
    mine = {k: torch.as_tensor(v) for k, v in proc(images, QUESTIONS).items()}
    with torch.no_grad():
        want = hf.generate(**inputs, max_new_tokens=8)
        got = model.generate(mine["pixel_values"], mine["input_ids"], mine["attention_mask"],
                             8, image_tokens=True, **gen)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.shape[1] > inputs["input_ids"].shape[1]
    new_ids = got[:, inputs["input_ids"].shape[1]:]

    hf_l, _, model_l, proc_l, gen_l = loaded["legacy"]
    legacy = {k: torch.as_tensor(v) for k, v in proc_l(images, QUESTIONS).items()}
    with torch.no_grad():
        features = hf_l.get_image_features(legacy["pixel_values"])
        embeds = torch.cat([features, hf_l.get_input_embeddings()(legacy["input_ids"])], 1)
        mask = torch.cat([torch.ones(features.shape[:2], dtype=torch.long),
                          legacy["attention_mask"]], 1)
        want_new = hf_l.language_model.generate(inputs_embeds=embeds, attention_mask=mask,
                                                max_new_tokens=8)
        got_l = model_l.generate(legacy["pixel_values"], legacy["input_ids"],
                                 legacy["attention_mask"], 8, image_tokens=False, **gen_l)
    np.testing.assert_array_equal(got_l[:, :legacy["input_ids"].shape[1]].numpy(),
                                  legacy["input_ids"].numpy())
    np.testing.assert_array_equal(got_l[:, legacy["input_ids"].shape[1]:].numpy(),
                                  want_new.numpy())
    np.testing.assert_array_equal(got_l[:, legacy["input_ids"].shape[1]:].numpy(),
                                  new_ids.numpy())
    assert proc_l.batch_decode(got_l.numpy(), True) == proc.batch_decode(got.numpy(), True)


def _metadata(questions, answers):
    return [{"questions": q, "answers": a} for q, a in zip(questions, answers)]


def test_reward_matches_ddpo_tpu(tiny_dirs):
    """callback_fns["vqa"] against ddpo_tpu's vqa_satisfaction on the same
    directory and images: the (N, 1) scores and {}. Half the answers come
    from the reference's decoded text (so some score), and "cat" is a word
    of its own question, which scores as it does in JAX (the decoded row
    holds the prompt)."""
    from ddpo_tpu.training import callbacks as j_callbacks

    path = tiny_dirs["tokens"]
    rng = np.random.default_rng(11)
    images = rng.random((4, 40, 40, 3)).astype(np.float32)
    questions = [["who is playing the piano?", "is there a dog?"],
                 ["what is the cat doing?", "who is playing the piano?"],
                 ["naïve 日本 x² ?!", "who?"], ["what is it?", "is it 12?"]]
    answers = [["a", "b"], ["cat", "zebra"], ["c", "d"], ["vv", "uu"]]
    # the reference's decoded rows; images 0 and 2 (half the answers) take
    # theirs from the start of the new text
    hf_proc = transformers.AutoProcessor.from_pretrained(path)
    hf = transformers.Blip2ForConditionalGeneration.from_pretrained(path, dtype=torch.float32)
    u8 = (np.clip(images, 0, 1) * 255).astype(np.uint8)
    rows = [f"Question: {q} Answer:" for qs in questions for q in qs]
    inputs = hf_proc([im for im in u8 for _ in range(2)], text=rows, return_tensors="pt",
                     padding="longest")
    with torch.no_grad():
        decoded = [t.strip() for t in hf_proc.batch_decode(
            hf.generate(**inputs, max_new_tokens=8), skip_special_tokens=True)]
    for i in (0, 2):
        for j in range(2):
            row = 2 * i + j
            assert decoded[row].startswith(rows[row])
            answers[i][j] = decoded[row][len(rows[row]):][:2]
    metadata = _metadata(questions, answers)
    prompts = ["p"] * 4

    want, want_info = j_callbacks.callback_fns["vqa"](model_name=path)(images, prompts, metadata)
    got, got_info = t_callbacks.callback_fns["vqa"](model_name=path, device="cpu")(
        images, prompts, metadata)
    assert got.shape == want.shape == (4, 1) and got_info == want_info == {}
    np.testing.assert_array_equal(got, want)
    assert want[0, 0] == want[2, 0] == 1 and want[1, 0] >= 0.5 and want.min() < 1


def _hub_snapshot(root, source):
    """``source``'s files as the Hub cache's snapshot of
    Salesforce/blip2-opt-2.7b under ``root`` (refs/main -> a commit)."""
    commit = "0" * 40
    repo = os.path.join(root, "hub", "models--Salesforce--blip2-opt-2.7b")
    snapshot = os.path.join(repo, "snapshots", commit)
    os.makedirs(snapshot)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(commit)
    for name in os.listdir(source):
        os.symlink(os.path.join(source, name), os.path.join(snapshot, name))
    return snapshot


JAX_HUB_SCRIPT = """
import sys
import numpy as np
from ddpo_tpu.training import callbacks
data = np.load(sys.argv[1], allow_pickle=True)
scores, info = callbacks.vqa_satisfaction()(data["images"], ["p"] * len(data["images"]),
                                           list(data["metadata"]))
np.save(sys.argv[2], scores)
"""


def test_hub_cache_resolution(tiny_dirs, tmp_path, monkeypatch):
    """The default name resolves to the Hub cache's snapshot under HF_HOME
    in both packages, which then score alike (ddpo_tpu in a process of its
    own, started offline with that HF_HOME, since huggingface_hub reads
    both once); without it the factory raises naming every path tried."""
    hf_home = tmp_path / "hf"
    monkeypatch.setenv("HF_HOME", str(hf_home))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.delenv("HUGGINGFACE_HUB_CACHE", raising=False)
    with pytest.raises(FileNotFoundError) as err:
        t_callbacks.callback_fns["vqa"]()
    assert str(hf_home / "hub" / "models--Salesforce--blip2-opt-2.7b" / "refs" / "main") \
        in str(err.value) and "Salesforce/blip2-opt-2.7b" in str(err.value)

    snapshot = _hub_snapshot(str(hf_home), tiny_dirs["tokens"])
    assert resolve_pretrained("Salesforce/blip2-opt-2.7b") == snapshot
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "elsewhere"))
    with pytest.raises(FileNotFoundError, match="elsewhere"):
        resolve_pretrained("Salesforce/blip2-opt-2.7b")
    monkeypatch.delenv("HF_HUB_CACHE")

    images = np.random.default_rng(2).random((2, 32, 32, 3)).astype(np.float32)
    metadata = _metadata([["what is the cat doing?", "who?"]] * 2, [["cat", "x"], ["dog", "y"]])
    got, _ = t_callbacks.vqa_satisfaction(device="cpu")(images, ["p"] * 2, metadata)
    np.testing.assert_array_equal(got, [[0.5], [0.0]])

    np.savez(tmp_path / "inputs.npz", images=images, metadata=np.array(metadata, dtype=object))
    env = dict(os.environ, PYTHONPATH=REPO, HF_HOME=str(hf_home), HF_HUB_OFFLINE="1",
               TRANSFORMERS_OFFLINE="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_HUB_SCRIPT, str(tmp_path / "inputs.npz"),
                           str(tmp_path / "want.npy")], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    np.testing.assert_array_equal(got, np.load(tmp_path / "want.npy"))


def test_ddpo_epoch_with_the_vqa_reward(tiny_dirs, tmp_path, monkeypatch):
    """One port DDPO epoch at the debug preset with vqa_dataset over
    assets/vqa_debug.txt and the tiny BLIP-2 in the Hub cache: the rewards
    it computed equal ddpo_tpu's vqa_satisfaction on the images the epoch
    decoded, and the epoch's mean is theirs."""
    import importlib

    import ddpo_torch.config.base as base
    import ddpo_torch.config.user as user
    from ddpo_torch import training
    from ddpo_torch.pipelines import policy_gradient
    from ddpo_tpu.training import callbacks as j_callbacks

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DDPO_BUCKET", "bucket")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.delenv("HUGGINGFACE_HUB_CACHE", raising=False)
    _hub_snapshot(str(tmp_path / "hf"), tiny_dirs["tokens"])
    importlib.reload(user)
    importlib.reload(base)

    calls = []
    real = training.callback_fns["vqa"]

    def recording(**kwargs):
        fn = real(**kwargs)

        def _fn(images, prompts, metadata):
            scores, info = fn(images, prompts, metadata)
            calls.append((np.array(images), list(prompts), list(metadata), scores))
            return scores, info

        return _fn

    monkeypatch.setitem(training.callback_fns, "vqa", recording)
    try:
        rewards = policy_gradient.main([
            "--dataset", "debug-animals", "--device", "cpu", "--n_inference_steps", "2",
            "--resolution", "32", "--sample_batch_size", "2", "--train_batch_size", "1",
            "--num_train_epochs", "1", "--prompt_fn", "vqa_dataset",
            "--prompt_kwargs", "{'loadpath': 'assets/vqa_debug.txt'}", "--filter_field", "vqa"])
    finally:
        monkeypatch.undo()
        importlib.reload(user)
        importlib.reload(base)
    assert len(rewards) == 1 and calls
    ours = []
    for images, prompts, metadata, scores in calls:
        assert all(m["questions"] for m in metadata)
        want, info = j_callbacks.vqa_satisfaction(model_name=tiny_dirs["tokens"])(
            images, prompts, metadata)
        np.testing.assert_array_equal(scores, want)
        ours.append(scores)
    np.testing.assert_allclose(float(np.mean(np.concatenate(ours))), float(rewards[0]),
                               rtol=1e-12)


def test_published_widths_on_the_meta_device():
    """BLIP2_OPT_2_7B builds on the meta device with transformers' key and
    shape map of Salesforce/blip2-opt-2.7b (its config made from the same
    numbers), the Q-Former's text FFN aside, and about 3.8 B parameters."""
    cfg = t_blip2.BLIP2_OPT_2_7B
    hf_cfg = transformers.Blip2Config(
        vision_config={}, qformer_config={},
        text_config=dict(model_type="opt", hidden_size=2560, ffn_dim=10240,
                         num_hidden_layers=32, num_attention_heads=32, word_embed_proj_dim=2560),
        num_query_tokens=32, image_token_index=50265)
    assert t_blip2.Blip2Config.from_dict(hf_cfg.to_dict()) == cfg
    with torch.device("meta"):
        ours = t_blip2.Blip2ForConditionalGeneration(cfg)
        theirs = transformers.Blip2ForConditionalGeneration(hf_cfg)
    want = {k: tuple(v.shape) for k, v in theirs.state_dict().items()
            if k != "language_model.lm_head.weight"}
    assert {k: tuple(v.shape) for k, v in ours.state_dict().items()} == want
    n = sum(p.numel() for p in ours.parameters())
    assert 3.7e9 < n < 3.9e9, n


def test_unported_settings_raise_by_name(tiny_dirs, tmp_path):
    with pytest.raises(NotImplementedError, match="do_sample"):
        t_blip2.greedy_settings({"do_sample": True})
    with pytest.raises(NotImplementedError, match="num_beams"):
        t_blip2.greedy_settings({"num_beams": 4})
    with pytest.raises(NotImplementedError, match="repetition_penalty"):
        t_blip2.greedy_settings({"repetition_penalty": 1.3})
    assert t_blip2.greedy_settings({"eos_token_id": [2, 5], "temperature": 0.7}) == {
        "eos_token_ids": [2, 5], "pad_token_id": 2}
    with pytest.raises(NotImplementedError, match="only OPT"):
        t_blip2.Blip2Config.from_dict({"text_config": {"model_type": "llama"}})
    # a checkpoint with a key the port does not know, and one missing a key
    from ddpo_torch.models.convert import blip2_state_dict, read_pretrained_weights

    state = read_pretrained_weights(tiny_dirs["tokens"])
    with torch.device("meta"):
        model = t_blip2.Blip2ForConditionalGeneration(loaded_cfg(tiny_dirs["tokens"]))
    with pytest.raises(KeyError, match="unknown.*vision_model.extra"):
        blip2_state_dict(dict(state, **{"vision_model.extra": torch.zeros(1)}), model)
    with pytest.raises(KeyError, match="missing.*query_tokens"):
        blip2_state_dict({k: v for k, v in state.items() if k != "query_tokens"}, model)
    # the separate q_bias / v_bias of older checkpoints load into qkv.bias
    prefix = "vision_model.encoder.layers.0.self_attn."
    d = state[prefix + "qkv.bias"].shape[0] // 3
    older = {k: v for k, v in state.items() if k != prefix + "qkv.bias"}
    older[prefix + "q_bias"], older[prefix + "v_bias"] = torch.ones(d), 2 * torch.ones(d)
    got = blip2_state_dict(older, model)[prefix + "qkv.bias"]
    np.testing.assert_array_equal(got.numpy(), np.repeat([1.0, 0.0, 2.0], d))
    # a pytorch_model.bin directory loads the same weights
    torch.save(dict(state), tmp_path / "pytorch_model.bin")
    np.testing.assert_array_equal(read_pretrained_weights(str(tmp_path))["query_tokens"].numpy(),
                                  state["query_tokens"].numpy())


def loaded_cfg(path):
    with open(os.path.join(path, "config.json")) as f:
        return t_blip2.Blip2Config.from_dict(json.load(f))


@pytest.mark.parametrize("where, key, value", [
    ("text_config", "do_layer_norm_before", False),
    ("text_config", "_remove_final_layer_norm", True),
    ("text_config", "word_embed_proj_dim", 16),
    ("text_config", "enable_bias", False),
    ("text_config", "layer_norm_elementwise_affine", False),
    ("text_config", "tie_word_embeddings", False),
    ("text_config", "activation_function", "gelu"),
    ("vision_config", "hidden_act", "quick_gelu"),
    ("vision_config", "qkv_bias", False),
    ("qformer_config", "hidden_act", "relu"),
    ("qformer_config", "position_embedding_type", "relative_key"),
    ("preprocessor_config.json", "do_resize", False),
    ("preprocessor_config.json", "do_rescale", False),
    ("preprocessor_config.json", "do_normalize", False),
    ("tokenizer_config.json", "padding_side", "left"),
])
def test_settings_no_blip2_opt_checkpoint_uses_raise_by_name(tiny_dirs, tmp_path, where, key,
                                                             value):
    """The tiny directory with one setting that no BLIP-2 OPT checkpoint
    has: load_blip2 refuses it, naming the key, before it reads a weight."""
    path = str(tmp_path / "blip2")
    shutil.copytree(tiny_dirs["tokens"], path)
    fname = where if where.endswith(".json") else "config.json"
    with open(os.path.join(path, fname)) as f:
        d = json.load(f)
    (d if where.endswith(".json") else d.setdefault(where, {}))[key] = value
    with open(os.path.join(path, fname), "w") as f:
        json.dump(d, f)
    with pytest.raises(NotImplementedError, match=key):
        load_blip2(path, "meta")
