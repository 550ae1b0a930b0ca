"""work.py's counts against a count taken by forward hooks on the port's
own modules, at the tiny preset and at SD-1.4's widths on the meta device."""

import json
import os

import pytest
import torch

from h100_bench import work
from h100_bench.tests.conftest import HERE, ROOT


def hooked_ops(module: torch.nn.Module, run) -> list:
    """(kind, name, flops) of every conv, linear and attention product that
    ``run()`` makes ``module`` compute."""
    from ddpo_torch.models.clip import CLIPAttention
    from ddpo_torch.models.layers import CrossAttention, VAESelfAttention

    seen, handles = [], []

    def conv(name):
        def hook(m, inputs, out):
            k = m.weight.shape[2] * m.weight.shape[3]
            seen.append(("conv", name, 2.0 * out.numel() * m.weight.shape[1] * k))
        return hook

    def linear(name):
        def hook(m, inputs, out):
            seen.append(("linear", name, 2.0 * out.numel() * m.weight.shape[1]))
        return hook

    def attention(name, heads_of):
        def hook(m, inputs, out):
            x = inputs[0]
            if isinstance(m, VAESelfAttention):
                b, c, h, w = x.shape
                sq = sk = h * w
                heads, d = 1, c
            else:
                ctx = inputs[1] if len(inputs) > 1 and inputs[1] is not None else x
                b, sq, dim = x.shape
                sk, heads = ctx.shape[1], heads_of(m)
                d = dim // heads if isinstance(m, CLIPAttention) else m.dim_head
            seen.append(("attn", name, 4.0 * b * heads * sq * sk * d))
        return hook

    for name, m in module.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            handles.append(m.register_forward_hook(conv(name)))
        elif isinstance(m, torch.nn.Linear):
            handles.append(m.register_forward_hook(linear(name)))
        elif isinstance(m, (CrossAttention, VAESelfAttention, CLIPAttention)):
            handles.append(m.register_forward_hook(
                attention(name, lambda mod: getattr(mod, "heads", None) or mod.num_heads)))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    return seen


def by_kind(ops) -> dict:
    out = {}
    for op in ops:
        kind, f = (op[0], op[2]) if len(op) == 3 else (op[0], work.flops(op))
        out[kind] = out.get(kind, 0.0) + f
    return out


@pytest.fixture(scope="module")
def tiny():
    from h100_bench.drivers.ddpo import build_stack

    model = json.load(open(os.path.join(HERE, "tiny.json")))
    return model, build_stack(model, "cpu", seed=5)


@pytest.mark.parametrize("part", ["unet", "vae_decoder", "text_encoder"])
def test_forward_counts_match_hooks(tiny, part):
    model, (text, vae, unet) = tiny
    n, side = 4, model["unet"]["sample_size"]
    if part == "unet":
        ops = work.unet_ops(model["unet"], n)
        seen = hooked_ops(unet, lambda: unet(torch.randn(n, 4, side, side), torch.full((n,), 10),
                                             torch.randn(n, 77, model["unet"]["cross_attention_dim"])))
    elif part == "vae_decoder":
        ops = work.vae_decoder_ops(model["vae"], n, side)
        seen = hooked_ops(vae, lambda: vae.decode(torch.randn(n, 4, side, side)))
    else:
        ops = work.text_encoder_ops(model["text_encoder"], n)
        seen = hooked_ops(text, lambda: text(torch.zeros(n, 77, dtype=torch.long)))
    assert len(seen) == len(ops)
    assert by_kind(seen) == pytest.approx(by_kind(ops), rel=1e-12)
    # the names are the port's modules', in the port's order of calls
    hooked = [name for kind, name, _ in seen if kind != "attn"]
    named = [op[1] for op in ops if op[0] != "attn"]
    assert sorted(hooked) == sorted(named)


def test_unet_ops_name_the_model_inputs(tiny):
    """The ops that take a model input (no input gradient) exist, once a
    forward for conv_in and the time embedding, at every cross-attention."""
    model, _ = tiny
    ops = work.unet_ops(model["unet"], 2)
    skipped = [op[1] for op in ops if op[0] != "attn" and not work._input_grad(op)]
    crosses = sum(1 for op in ops if op[0] == "attn" and not op[7])
    assert skipped.count("conv_in") == 1
    assert skipped.count("time_embedding.linear_1") == 1
    assert len(skipped) == 2 + 2 * crosses


def test_sd14_counts():
    """At SD-1.4's widths (the configuration file): a UNet forward of
    0.803 TFLOP an image at 64 x 64 latents, 2.515 for a VAE decode to 512 px."""
    model = json.load(open(os.path.join(ROOT, "h100_bench", "configs", "sd14.json")))
    unet = work.total_flops(work.unet_ops(model["unet"], 1))
    vae = work.total_flops(work.vae_decoder_ops(model["vae"], 1, 64))
    assert unet == pytest.approx(0.80327344128e12, rel=1e-9)
    assert vae == pytest.approx(2.514518933504e12, rel=1e-9)


def test_apply_counts_full_against_lora():
    """A full finetune's apply counts the weight gradients; LoRA's the
    adapters' instead, and both the same input gradients."""
    model = json.load(open(os.path.join(ROOT, "h100_bench", "configs", "sd14.json")))
    traffic = json.load(open(os.path.join(ROOT, "h100_bench", "traffic", "ddpo_b8.json")))
    full = work.EpochWork(model, traffic, 0, model["lora_targets"], 20)
    lora = work.EpochWork(model, traffic, 8, model["lora_targets"], 20)
    ops = work.unet_ops(dict(model["unet"], sample_size=64), 16)
    weight_grads = sum(work.flops(op) for op in ops if op[0] != "attn")
    adapters = work.lora_adapter_flops(ops, 8, tuple(model["lora_targets"]))
    assert full.flops - lora.flops == pytest.approx(20 * (weight_grads - adapters), rel=1e-12)
    assert full.attn_bound_s == lora.attn_bound_s > 0
    assert full.conv_bound_s > lora.conv_bound_s > 0


def test_rooflines_count_the_remat_recompute():
    """With remat, each trainer apply's roofline time holds its forward a
    second time, in the self-attention's and in every convolution's; mfu's
    operations do not."""
    model = json.load(open(os.path.join(ROOT, "h100_bench", "configs", "sd14.json")))
    traffic = json.load(open(os.path.join(ROOT, "h100_bench", "traffic", "ddpo_b8.json")))
    remat = work.EpochWork(model, traffic, 0, model["lora_targets"], 20)
    plain = work.EpochWork(dict(model, remat=False), traffic, 0, model["lora_targets"], 20)
    ops = work.unet_ops(dict(model["unet"], sample_size=64), 16)

    def forward_s(keep):
        return sum(work.roofline_s(work.flops(op), work.fwd_bytes(op)) for op in ops if keep(op))

    assert remat.flops == plain.flops
    assert remat.attn_bound_s - plain.attn_bound_s == pytest.approx(
        20 * forward_s(work.is_self_attention), rel=1e-9)
    assert remat.conv_bound_s - plain.conv_bound_s == pytest.approx(
        20 * forward_s(lambda op: op[0] == "conv"), rel=1e-9)
