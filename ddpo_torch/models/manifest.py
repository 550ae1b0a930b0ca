"""Canonical SD-1.4 parameter manifest: every HF-Flax param path + shape.

Port of ddpo_tpu/models/manifest.py, the port's own copy (it imports nothing
of the JAX package). The generator encodes the diffusers-Flax
(UNet2DConditionModel/AutoencoderKL, diffusers 0.12.1) and transformers-Flax
(CLIPTextModel) layout rules from their published architectures,
independently of the model code; assets/sd14_params.json is its output.

``flax_manifest`` maps one of the port's torch modules onto the same form:
each state-dict key through models/convert.py's key map
(``torch_key_to_flax_path``) and each shape through its layout change (conv
OIHW -> HWIO, Linear (out, in) -> (in, out)), so that the port's UNet, VAE
and CLIP text tower, built on the meta device, are held path for path and
shape for shape against the manifest, and their totals against the
published parameter counts (UNet 859,520,964; CLIP text 123,060,480;
tests/test_torch_spatial.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

Shape = Tuple[int, ...]
Manifest = Dict[str, Shape]  # "/"-joined path -> shape


def _add(man: Manifest, prefix: str, name: str, shape: Shape) -> None:
    man[f"{prefix}/{name}" if prefix else name] = tuple(shape)


def _conv(man, prefix, kh, kw, cin, cout):
    _add(man, prefix, "kernel", (kh, kw, cin, cout))
    _add(man, prefix, "bias", (cout,))


def _dense(man, prefix, cin, cout, bias=True):
    _add(man, prefix, "kernel", (cin, cout))
    if bias:
        _add(man, prefix, "bias", (cout,))


def _norm(man, prefix, c):
    _add(man, prefix, "scale", (c,))
    _add(man, prefix, "bias", (c,))


def _resnet(man, prefix, cin, cout, temb=1280):
    """diffusers FlaxResnetBlock2D: norm1/conv1/time_emb_proj/norm2/conv2
    (+conv_shortcut when cin != cout)."""
    _norm(man, f"{prefix}/norm1", cin)
    _conv(man, f"{prefix}/conv1", 3, 3, cin, cout)
    if temb:
        _dense(man, f"{prefix}/time_emb_proj", temb, cout)
    _norm(man, f"{prefix}/norm2", cout)
    _conv(man, f"{prefix}/conv2", 3, 3, cout, cout)
    if cin != cout:
        _conv(man, f"{prefix}/conv_shortcut", 1, 1, cin, cout)


def _transformer2d(man, prefix, c, heads, context_dim=768, depth=1):
    """diffusers FlaxTransformer2DModel (use_linear_projection=False):
    GN -> 1x1 conv proj_in -> BasicTransformerBlocks -> 1x1 conv proj_out."""
    _norm(man, f"{prefix}/norm", c)
    _conv(man, f"{prefix}/proj_in", 1, 1, c, c)
    for i in range(depth):
        block = f"{prefix}/transformer_blocks_{i}"
        for attn, kdim in (("attn1", c), ("attn2", context_dim)):
            _dense(man, f"{block}/{attn}/to_q", c, c, bias=False)
            _dense(man, f"{block}/{attn}/to_k", kdim, c, bias=False)
            _dense(man, f"{block}/{attn}/to_v", kdim, c, bias=False)
            _dense(man, f"{block}/{attn}/to_out_0", c, c)
        _dense(man, f"{block}/ff/net_0/proj", c, 8 * c)  # GEGLU: 2 * 4c
        _dense(man, f"{block}/ff/net_2", 4 * c, c)
        for n in ("norm1", "norm2", "norm3"):
            _norm(man, f"{block}/{n}", c)
    _conv(man, f"{prefix}/proj_out", 1, 1, c, c)


def unet_manifest() -> Manifest:
    """SD-1.4 FlaxUNet2DConditionModel: block_out_channels (320,640,1280,
    1280), layers_per_block 2, 8 heads, cross_attention_dim 768, down blocks
    CrossAttnDown x3 + Down, up blocks Up + CrossAttnUp x3."""
    man: Manifest = {}
    channels = (320, 640, 1280, 1280)
    layers = 2
    heads = 8

    _conv(man, "conv_in", 3, 3, 4, channels[0])
    _dense(man, "time_embedding/linear_1", channels[0], 1280)
    _dense(man, "time_embedding/linear_2", 1280, 1280)

    # down path; record per-resnet output channels for the skip concats
    skips = [channels[0]]  # conv_in output
    cin = channels[0]
    for b, cout in enumerate(channels):
        has_attn = b < 3
        for r in range(layers):
            _resnet(man, f"down_blocks_{b}/resnets_{r}", cin if r == 0 else cout, cout)
            if has_attn:
                _transformer2d(man, f"down_blocks_{b}/attentions_{r}", cout, heads)
            skips.append(cout)
        if b < 3:
            _conv(man, f"down_blocks_{b}/downsamplers_0/conv", 3, 3, cout, cout)
            skips.append(cout)
        cin = cout

    _resnet(man, "mid_block/resnets_0", 1280, 1280)
    _transformer2d(man, "mid_block/attentions_0", 1280, heads)
    _resnet(man, "mid_block/resnets_1", 1280, 1280)

    # up path: 3 resnets per block, input = prev output + skip (popped LIFO)
    prev = 1280
    up_channels = channels[::-1]  # (1280, 1280, 640, 320)
    for b, cout in enumerate(up_channels):
        has_attn = b > 0
        for r in range(layers + 1):
            skip = skips.pop()
            _resnet(man, f"up_blocks_{b}/resnets_{r}", prev + skip, cout)
            if has_attn:
                _transformer2d(man, f"up_blocks_{b}/attentions_{r}", cout, heads)
            prev = cout
        if b < 3:
            _conv(man, f"up_blocks_{b}/upsamplers_0/conv", 3, 3, cout, cout)

    _norm(man, "conv_norm_out", channels[0])
    _conv(man, "conv_out", 3, 3, channels[0], 4)
    return man


def _vae_attention(man, prefix, c):
    """FlaxAttentionBlock in the VAE mid block: single-head, GN +
    query/key/value/proj_attn dense layers (all with bias)."""
    _norm(man, f"{prefix}/group_norm", c)
    for n in ("query", "key", "value", "proj_attn"):
        _dense(man, f"{prefix}/{n}", c, c)


def vae_manifest() -> Manifest:
    """SD AutoencoderKL: block_out_channels (128,256,512,512),
    layers_per_block 2 (encoder) / 3 resnets per block (decoder)."""
    man: Manifest = {}
    channels = (128, 256, 512, 512)

    # encoder
    _conv(man, "encoder/conv_in", 3, 3, 3, channels[0])
    cin = channels[0]
    for b, cout in enumerate(channels):
        for r in range(2):
            _resnet(man, f"encoder/down_blocks_{b}/resnets_{r}",
                    cin if r == 0 else cout, cout, temb=0)
        if b < 3:
            _conv(man, f"encoder/down_blocks_{b}/downsamplers_0/conv",
                  3, 3, cout, cout)
        cin = cout
    _resnet(man, "encoder/mid_block/resnets_0", 512, 512, temb=0)
    _vae_attention(man, "encoder/mid_block/attentions_0", 512)
    _resnet(man, "encoder/mid_block/resnets_1", 512, 512, temb=0)
    _norm(man, "encoder/conv_norm_out", 512)
    _conv(man, "encoder/conv_out", 3, 3, 512, 8)  # 2 * latent_channels

    # decoder: reversed channels, 3 resnets per block, upsample on first 3
    _conv(man, "decoder/conv_in", 3, 3, 4, 512)
    _resnet(man, "decoder/mid_block/resnets_0", 512, 512, temb=0)
    _vae_attention(man, "decoder/mid_block/attentions_0", 512)
    _resnet(man, "decoder/mid_block/resnets_1", 512, 512, temb=0)
    prev = 512
    for b, cout in enumerate((512, 512, 256, 128)):
        for r in range(3):
            _resnet(man, f"decoder/up_blocks_{b}/resnets_{r}",
                    prev if r == 0 else cout, cout, temb=0)
            prev = cout
        if b < 3:
            _conv(man, f"decoder/up_blocks_{b}/upsamplers_0/conv",
                  3, 3, cout, cout)
    _norm(man, "decoder/conv_norm_out", 128)
    _conv(man, "decoder/conv_out", 3, 3, 128, 3)

    _conv(man, "quant_conv", 1, 1, 8, 8)
    _conv(man, "post_quant_conv", 1, 1, 4, 4)
    return man


def clip_text_manifest() -> Manifest:
    """transformers FlaxCLIPTextModel (clip-vit-large-patch14 text tower):
    12 layers, width 768, 12 heads, vocab 49408, 77 positions."""
    man: Manifest = {}
    width, layers, vocab, positions = 768, 12, 49408, 77
    base = "text_model"
    _add(man, f"{base}/embeddings/token_embedding", "embedding", (vocab, width))
    _add(man, f"{base}/embeddings/position_embedding", "embedding",
         (positions, width))
    for i in range(layers):
        p = f"{base}/encoder/layers/{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(man, f"{p}/self_attn/{proj}", width, width)
        _norm(man, f"{p}/layer_norm1", width)
        _norm(man, f"{p}/layer_norm2", width)
        _dense(man, f"{p}/mlp/fc1", width, 4 * width)
        _dense(man, f"{p}/mlp/fc2", 4 * width, width)
    _norm(man, f"{base}/final_layer_norm", width)
    return man


def sd14_manifest() -> Dict[str, Manifest]:
    return {
        "unet": unet_manifest(),
        "vae": vae_manifest(),
        "text_encoder": clip_text_manifest(),
    }


def count_params(man: Manifest) -> int:
    total = 0
    for shape in man.values():
        n = 1
        for d in shape:
            n *= d
        total += n
    return total



def flax_manifest(model) -> Manifest:
    """A torch module's parameters as manifest entries: "/"-joined Flax
    paths (models/convert.py's key map) and Flax-layout shapes."""
    from ddpo_torch.models.convert import torch_key_to_flax_path

    owners = dict(model.named_modules())
    man: Manifest = {}
    for key, value in model.state_dict().items():
        path = torch_key_to_flax_path(key, owners[key.rpartition(".")[0]])
        shape = tuple(value.shape)
        if path[-1] == "kernel":
            shape = (*shape[2:], shape[1], shape[0]) if len(shape) == 4 else shape[::-1]
        man["/".join(path)] = shape
    return man


def vendored_manifest() -> Dict[str, Manifest]:
    """assets/sd14_params.json, the JAX generator's committed output."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "sd14_params.json")
    with open(path) as f:
        return {name: {k: tuple(v) for k, v in man.items()}
                for name, man in json.load(f).items()}
