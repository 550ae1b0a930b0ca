"""Reward callbacks: name-addressed factories returning score functions.

Port of ddpo_tpu/training/callbacks.py. Each factory returns fn(images,
prompts, metadata) -> (scores, info), where images are (N, H, W, 3) float
in [0, 1]. ``evaluate_callbacks`` runs every registered fn, choosing a
random training prompt per sample when prompts are lists.

Dependency-free: jpeg, neg_jpeg, arange, mirror, mirror_corr and
rotational_corr. Model-based: vae (the RWR posterior moments, on the VAE's
device), and the CLIP rewards aesthetic, rotational, thumbnail,
consistency (and the unregistered diversity), which take their weights as
arguments (a state_dict under transformers' torch keys, e.g. from
models/convert.py ``load_clip_checkpoint``; the aesthetic MLP from
``<cache>/sac+logos+ava1-l14-linearMSE.pth``) and raise ddpo_tpu's
RuntimeError without them. They run on the card unless ``device="cpu"``
is passed, in fp32. vqa runs the port's BLIP-2 (models/blip2.py, loaded
by models/convert.py ``load_blip2`` from a local directory or the Hub
cache) at fp32 on the card unless ``device="cpu"``. Server-based:
llava_vqa and llava_bertscore, pickle over HTTP POST through urllib with
the JAX client's retry on HTTP 500.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Tuple

import numpy as np

RewardFn = Callable[[np.ndarray, list, list], Tuple[np.ndarray, dict]]

# CLIP image preprocessing constants (OpenAI CLIP normalization)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def clip_preprocess(images: np.ndarray, size: int = 224) -> np.ndarray:
    """(N, H, W, 3) in [0,1] -> (N, 3, size, size) CLIP-normalized.

    Bicubic resize to size x size (prompt images are square), matching
    CLIPProcessor's resize+center-crop+normalize on square inputs.
    """
    from PIL import Image

    out = np.empty((len(images), size, size, 3), dtype=np.float32)
    for i, img in enumerate(images):
        pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        out[i] = np.asarray(pil.resize((size, size), Image.BICUBIC)) / 255.0
    out = (out - CLIP_MEAN) / CLIP_STD
    return out.transpose(0, 3, 1, 2)


def jpeg_fn(**kwargs) -> RewardFn:
    """Negative JPEG size in KB: reward for compressible images.

    Encodes the whole batch through the native multithreaded libjpeg path
    (ddpo_torch/native), which raises if the library cannot be built.
    """
    from ddpo_torch.native import jpeg_sizes

    def _fn(images, prompts, metadata):
        del prompts, metadata
        sizes_kb = jpeg_sizes(images, quality=95) / 1000.0
        return -np.asarray(sizes_kb, dtype=np.float64)[:, None], {}

    return _fn


def neg_jpeg_fn(*args, **kwargs) -> RewardFn:
    _jpeg = jpeg_fn(*args, **kwargs)

    def _fn(*a, **kw):
        scores, infos = _jpeg(*a, **kw)
        return -scores, infos

    return _fn


def arange_fn(**kwargs) -> RewardFn:
    """Debug reward: the sample index (a plumbing test)."""

    def _fn(images, prompts, metadata):
        del prompts, metadata
        return np.arange(len(images))[:, None], {}

    return _fn


def mirror_symmetry_fn(**kwargs) -> RewardFn:
    """Negative MSE between the image and its horizontal mirror."""

    def _fn(images, prompts, metadata):
        del prompts, metadata
        imgs = (np.clip(images, 0, 1) * 255).astype(np.uint8).astype(np.int64)
        mirrored = imgs[:, :, ::-1]
        scores = ((imgs - mirrored) ** 2).mean(axis=(1, 2, 3)).astype(np.float64)
        return -scores, {}

    return _fn


def _cov(X, Y):
    assert X.ndim == Y.ndim == 2
    return ((X - X.mean(-1, keepdims=True)) * (Y - Y.mean(-1, keepdims=True))).sum(-1)


def mirror_correlation_fn(**kwargs) -> RewardFn:
    """Negative Pearson correlation between image and its mirror."""

    def _fn(images, prompts, metadata):
        del prompts, metadata
        imgs = np.clip(images, 0, 1).astype(np.float32)
        mirrored = imgs[:, :, ::-1]
        flat = imgs.reshape(len(images), -1)
        mflat = mirrored.reshape(len(images), -1)
        scores = _cov(flat, mflat) / np.sqrt(_cov(flat, flat) * _cov(mflat, mflat))
        return -scores, {}

    return _fn


def rotational_correlation_fn(**kwargs) -> RewardFn:
    """Negative MSE between the image and its 180-degree rotation."""

    def _fn(images, prompts, metadata):
        del prompts, metadata
        imgs = (np.clip(images, 0, 1) * 255).astype(np.uint8).astype(np.int64)
        rotated = imgs[:, ::-1, ::-1]
        scores = ((imgs - rotated) ** 2).mean(axis=(1, 2, 3)).astype(np.float64)
        return -scores, {}

    return _fn


def vae_fn(vae=None, **kwargs) -> RewardFn:
    """Encode images to VAE posterior moments, stored for RWR training.

    The layout is the reference's: channel-last concat of (mean, logvar),
    (N, h, w, 8) fp32. The encoder runs on the VAE's device, in its dtype.
    """
    if vae is None:
        raise RuntimeError("VAE unavailable: pass vae= to the callback factory")
    import torch

    device = next(vae.parameters()).device

    def _fn(images, prompts, metadata):
        del prompts, metadata
        x = torch.as_tensor(np.asarray(images, dtype=np.float32), device=device)
        x = (x.permute(0, 3, 1, 2).contiguous() - 0.5) / 0.5
        with torch.no_grad():
            mean, logvar = vae.encode(x).chunk(2, dim=1)
            moments = torch.cat([mean.permute(0, 2, 3, 1), logvar.permute(0, 2, 3, 1)], -1)
        return moments.cpu().numpy(), {}

    return _fn


def _require(value, what: str, hint: str):
    if value is None:
        raise RuntimeError(
            f"{what} unavailable: {hint}. Model-based rewards need local "
            "weights in this zero-egress environment."
        )
    return value


def _load_module(make, state, prefixes: Tuple[str, ...], device):
    """``make()`` built without storage, then on ``device`` in fp32 with the
    entries of ``state`` under ``prefixes`` (strict: any of the module's
    keys missing there raises, naming it)."""
    import torch

    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device)
    module.load_state_dict({k: v for k, v in state.items() if k.startswith(prefixes)},
                           strict=True)
    return module.eval().requires_grad_(False)


def _clip_image_features_fn(clip_params=None, device="cuda"):
    """(N, 3, 224, 224) numpy pixels -> (N, 768) fp32 CLIP ViT-L/14 features."""
    import torch

    from ddpo_torch.models.clip import CLIPImageEncoder
    from ddpo_torch.utils.serialization import resolve_device

    _require(clip_params, "CLIP ViT-L/14 weights", "pass clip_params=")
    device = resolve_device(device)
    encoder = _load_module(CLIPImageEncoder, clip_params,
                           ("vision_model.", "visual_projection."), device)

    def _features(pixels: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return encoder(torch.as_tensor(pixels, device=device)).cpu().numpy()

    return _features


def aesthetic_fn(clip_params=None, mlp_params=None, cache="cache", device="cuda",
                 **kwargs) -> RewardFn:
    """LAION aesthetic score: CLIP ViT-L/14 features -> the 5-layer MLP
    (``mlp_params``, its torch state_dict, or
    ``<cache>/sac+logos+ava1-l14-linearMSE.pth``)."""
    import torch

    from ddpo_torch.models.aesthetic import load_weights, set_weights
    from ddpo_torch.utils.serialization import resolve_device

    features_fn = _clip_image_features_fn(clip_params, device)
    device = resolve_device(device)
    classifier = (load_weights(cache) if mlp_params is None else set_weights(mlp_params)).to(device)

    def _fn(images, prompts, metadata):
        del prompts, metadata
        feats = features_fn(clip_preprocess(images))
        feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
        with torch.no_grad():
            scores = classifier(torch.as_tensor(feats, device=device))
        return scores.cpu().numpy(), {}

    return _fn


def _multi_view_angle_fn(make_views, clip_params=None, device="cuda") -> RewardFn:
    """Shared scorer: mean CLIP-embedding angle between image and views."""
    features_fn = _clip_image_features_fn(clip_params, device)

    def _fn(images, prompts, metadata):
        del prompts, metadata
        views = make_views(images)  # list of (N,H,W,3) incl. original first
        feats = [features_fn(clip_preprocess(v)) for v in views]
        base = feats[0]
        scores = 0.0
        for f in feats[1:]:
            numer = (base * f).sum(axis=-1)
            denom = np.linalg.norm(base, axis=-1) * np.linalg.norm(f, axis=-1)
            theta = np.arccos(np.clip(numer / denom, 0, 1)) * 180 / np.pi
            scores = scores + theta
        scores = scores / (len(feats) - 1)
        return -scores, {}

    return _fn


def rotational_symmetry_fn(clip_params=None, device="cuda", **kwargs) -> RewardFn:
    """Mean CLIP angle across 90/180/270-degree rotations."""

    def make_views(images):
        views = [images]
        for k in (1, 2, 3):  # 90, 180, 270 degrees
            views.append(np.rot90(images, k=k, axes=(1, 2)))
        return views

    return _multi_view_angle_fn(make_views, clip_params, device)


def thumbnail_fn(clip_params=None, device="cuda", **kwargs) -> RewardFn:
    """Mean CLIP angle across 4x/8x/16x downsamples."""

    def make_views(images):
        from PIL import Image

        views = [images]
        h, w = images.shape[1:3]
        for d in (4, 8, 16):
            small = []
            for img in images:
                pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
                small.append(np.asarray(pil.resize((w // d, h // d))) / 255.0)
            views.append(np.stack(small).astype(np.float32))
        return views

    return _multi_view_angle_fn(make_views, clip_params, device)


def consistency_fn(clip_model_params=None, tokenizer=None, vision_config=None,
                   text_config=None, device="cuda", **kwargs) -> RewardFn:
    """CLIP image-text logit diagonal (prompt alignment).

    Needs a whole CLIP state_dict (vision and text towers, both
    projections, logit_scale) and a tokenizer. ViT-B/32 and its text tower
    by default, the reference's CLIP for this reward; pass
    vision_config/text_config for another (e.g. VIT_L_14/SD14_TEXT).
    """
    import torch

    from ddpo_torch.models.clip import B32_TEXT, VIT_B_32, CLIPImageEncoder, CLIPTextModel
    from ddpo_torch.utils.serialization import resolve_device

    params = _require(clip_model_params, "CLIP model weights", "pass clip_model_params=")
    tokenizer = _require(tokenizer, "CLIP tokenizer", "pass tokenizer=")
    device = resolve_device(device)
    image_encoder = _load_module(lambda: CLIPImageEncoder(vision_config or VIT_B_32), params,
                                 ("vision_model.", "visual_projection."), device)
    text_encoder = _load_module(lambda: CLIPTextModel(text_config or B32_TEXT), params,
                                ("text_model.",), device)
    text_projection = params["text_projection.weight"].to(device, torch.float32)
    logit_scale = torch.as_tensor(params["logit_scale"], device=device, dtype=torch.float32)

    @torch.no_grad()
    def _score(pixels, input_ids):
        img = image_encoder(pixels)
        txt_hidden = text_encoder(input_ids)
        # pooled = hidden state at the EOT token (argmax of ids per row)
        eot = input_ids.argmax(dim=-1)
        pooled = txt_hidden[torch.arange(txt_hidden.shape[0], device=device), eot]
        txt = pooled @ text_projection.T
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return logit_scale.exp() * (img * txt).sum(dim=-1)

    def _fn(images, prompts, metadata):
        del metadata
        pixels = torch.as_tensor(clip_preprocess(images), device=device)
        ids = torch.as_tensor(np.asarray(tokenizer(list(prompts))), device=device)
        return _score(pixels, ids).cpu().numpy()[:, None], {}

    return _fn


def diversity_fn(clip_params=None, device="cuda", **kwargs) -> RewardFn:
    """Mean pairwise CLIP feature distance across the batch (numpy's global
    RNG draws the pairs)."""
    features_fn = _clip_image_features_fn(clip_params, device)

    def _fn(images, prompts, metadata):
        del prompts, metadata
        feats = features_fn(clip_preprocess(images))
        n_pairs = 10000
        idx1 = np.random.randint(0, len(feats), (n_pairs,))
        idx2 = np.random.randint(0, len(feats), (n_pairs,))
        dist = np.linalg.norm(feats[idx1] - feats[idx2], axis=-1)
        return dist.mean(), {}

    return _fn


# --------------------------------- VQA rewards ------------------------------- #


def single_satisfaction(outputs, answers) -> np.ndarray:
    assert len(outputs) == len(answers)
    return np.array([ans in out for ans, out in zip(answers, outputs)], dtype=int)


def vqa_score_fn(vlm, processor, generation: dict, device, max_new_tokens: int = 8) -> RewardFn:
    """The vqa reward's scoring on a loaded BLIP-2 (models/blip2.py): each
    image repeated once per question, ``"Question: {q} Answer:"`` prompts
    padded to the longest, greedy decoding of ``max_new_tokens``, the
    decoded rows stripped, and the mean over the questions of whether the
    answer occurs in its row. The rows hold the prompt too, so an answer
    word that the question holds scores, as in JAX."""
    import torch

    def _fn(images, prompts, metadata):
        n_questions = len(metadata[0]["questions"])
        images_u8 = (np.clip(images, 0, 1) * 255).astype(np.uint8)

        questions = [
            f'Question: {m["questions"][i]} Answer:'
            for m in metadata
            for i in range(n_questions)
        ]
        answers = [m["answers"][i] for m in metadata for i in range(n_questions)]
        images_rep = [img for img in images_u8 for _ in range(n_questions)]

        inputs = processor(images_rep, questions)
        generated = vlm.generate(
            torch.as_tensor(inputs["pixel_values"], device=device),
            torch.as_tensor(inputs["input_ids"], device=device),
            torch.as_tensor(inputs["attention_mask"], device=device),
            max_new_tokens=max_new_tokens, image_tokens=processor.image_tokens, **generation)
        text = [t.strip() for t in processor.batch_decode(generated.cpu().numpy(),
                                                           skip_special_tokens=True)]

        correct = single_satisfaction(text, answers)
        scores = correct.reshape(len(images), n_questions).mean(-1, keepdims=True)
        return scores, {}

    return _fn


def vqa_satisfaction(model_name="Salesforce/blip2-opt-2.7b", jit=False, device=None,
                     vae=None, **kwargs) -> RewardFn:
    """BLIP-2 VQA scoring at fp32, on ``device``: by default the device of
    the driver's ``vae=`` (the driver's --device), else the card.
    ``model_name`` is a local directory, or a Hub name found in the Hub
    cache (models/convert.py ``resolve_pretrained``)."""
    from ddpo_torch.models.convert import load_blip2, resolve_pretrained
    from ddpo_torch.utils.serialization import resolve_device

    path = resolve_pretrained(model_name)
    if device is None:
        device = next(vae.parameters()).device if vae is not None else "cuda"
    device = resolve_device(device)
    vlm, processor, generation = load_blip2(path, device)
    return vqa_score_fn(vlm, processor, generation, device)


LLAVA_RETRIES = 1000  # the JAX client's Retry(total=1000, backoff_factor=1)


def _llava_post(url: str, payload: bytes, timeout: float = 120) -> bytes:
    """POST ``payload`` and return the response body, retrying an HTTP 500
    or a failed connection as the JAX client's requests session does: up
    to LLAVA_RETRIES times, sleeping 0 s, then 2, 4, ... up to 120 s."""
    import time
    import urllib.error
    import urllib.request

    request = urllib.request.Request(
        url, data=payload, method="POST",
        headers={"Content-Type": "application/octet-stream"})

    def post() -> bytes:
        with urllib.request.urlopen(request, timeout=timeout) as response:
            return response.read()

    for attempt in range(LLAVA_RETRIES):
        try:
            return post()
        except urllib.error.HTTPError as err:
            if err.code != 500:
                raise
        except OSError:  # refused or dropped connection, timeout
            pass
        time.sleep(0.0 if attempt == 0 else min(120.0, 2.0 ** attempt))
    return post()  # the last try raises what it meets


def _jpeg_bytes(image_batch: np.ndarray, quality: int = 80):
    import io

    from PIL import Image

    out = []
    for image in image_batch:
        buffer = io.BytesIO()
        Image.fromarray(image).save(buffer, format="JPEG", quality=quality)
        out.append(buffer.getvalue())
    return out


def llava_vqa_satisfaction(url="http://127.0.0.1:8085", batch_size=4, **kwargs) -> RewardFn:
    """Remote LLaVA VQA over HTTP and pickle."""
    import pickle

    def _fn(images, prompts, metadata):
        del prompts
        images_u8 = (np.clip(images, 0, 1) * 255).astype(np.uint8)
        n_batches = int(np.ceil(len(images_u8) / batch_size))
        images_batched = np.array_split(images_u8, n_batches)
        metadata_batched = np.array_split(np.asarray(metadata, dtype=object), n_batches)

        all_scores, all_answers = [], []
        for image_batch, metadata_batch in zip(images_batched, metadata_batched):
            data = {
                "images": _jpeg_bytes(image_batch),
                "queries": [m["questions"] for m in metadata_batch],
            }
            response_data = pickle.loads(_llava_post(url, pickle.dumps(data)))
            correct = [
                single_satisfaction(ans, m["answers"])
                for ans, m in zip(response_data["outputs"], metadata_batch)
            ]
            all_scores += np.array(correct).mean(axis=-1).tolist()
            all_answers += response_data["outputs"]

        return np.array(all_scores), {"answers": np.array(all_answers, dtype=object)}

    return _fn


def llava_bertscore(url="http://127.0.0.1:8085", batch_size=16, **kwargs) -> RewardFn:
    """Remote LLaVA captioning scored by BERTScore recall."""
    import pickle

    def _fn(images, prompts, metadata):
        del metadata
        images_u8 = (np.clip(images, 0, 1) * 255).astype(np.uint8)
        n_batches = int(np.ceil(len(images_u8) / batch_size))
        images_batched = np.array_split(images_u8, n_batches)
        prompts_batched = np.array_split(np.asarray(prompts, dtype=object), n_batches)

        all_scores = []
        all_info = {"precision": [], "f1": [], "outputs": []}
        for image_batch, prompt_batch in zip(images_batched, prompts_batched):
            data = {
                "images": _jpeg_bytes(image_batch),
                "queries": [["Answer concisely: what is going on in this image?"]]
                * len(image_batch),
                "answers": [
                    [f"The image contains {prompt}"] for prompt in prompt_batch
                ],
            }
            response_data = pickle.loads(_llava_post(url, pickle.dumps(data)))

            def _flat(x):
                # single-image batches squeeze to scalars; keep 1-d
                return np.atleast_1d(np.asarray(x).squeeze()).tolist()

            all_scores += _flat(response_data["recall"])
            all_info["precision"] += _flat(response_data["precision"])
            all_info["f1"] += _flat(response_data["f1"])
            all_info["outputs"] += _flat(response_data["outputs"])

        return np.array(all_scores), {k: np.array(v) for k, v in all_info.items()}

    return _fn


def evaluate_callbacks(fns: Dict[str, RewardFn], images, prompts, metadata):
    """Run every registered reward fn."""
    if len(prompts) and isinstance(prompts[0], (list, tuple)):
        prompts = [random.choice(p) for p in prompts]
    images = np.asarray(images, dtype=np.float32)
    return {key: fn(images, prompts, metadata) for key, fn in fns.items()}


callback_fns: Dict[str, Callable[..., RewardFn]] = {
    "vae": vae_fn,
    "aesthetic": aesthetic_fn,
    "consistency": consistency_fn,
    "jpeg": jpeg_fn,
    "neg_jpeg": neg_jpeg_fn,
    "rotational": rotational_symmetry_fn,
    "rotational_corr": rotational_correlation_fn,
    "mirror": mirror_symmetry_fn,
    "mirror_corr": mirror_correlation_fn,
    "thumbnail": thumbnail_fn,
    "arange": arange_fn,
    "vqa": vqa_satisfaction,
    "llava_vqa": llava_vqa_satisfaction,
    "llava_bertscore": llava_bertscore,
}
