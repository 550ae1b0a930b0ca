"""Operations and bytes of the DDPO epoch's models, from their shapes.

Every count comes from the configuration's sizes and the batch shapes, never
from launches or kernel names, so the work stays the same whatever computes
it. An op is a tuple:

  ("conv", name, n, cin, h, w, cout, k, stride)   k x k convolution, padding k // 2
  ("linear", name, m, k, n)                       (m, k) @ (k, n)
  ("attn", name, b, heads, sq, sk, d, is_self)    softmax(q k^T) v over heads

Multiply-adds count 2. ``flops`` is the forward; a training apply adds the
backward: the input gradient of every op whose input is not one of the
model's inputs (the latents, the timestep features, the text context), the
weight gradient of every weighted op for a full finetune, and for LoRA the
adapters' two gradients instead of the base's; attention's backward is four
products, twice its forward. ``flops`` leaves out the remat recompute; the
roofline times count it, since its kernels are in the device time they are
set against. Bytes are each input read once and each output written once,
at ``ELEM`` bytes an element (bf16).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

ELEM = 2
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense, at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12

Op = Tuple


# ---------------------------------- the models ---------------------------------- #

def _resnet(ops: List[Op], name: str, n: int, cin: int, cout: int, hw: int,
            temb: int = 0) -> None:
    ops.append(("conv", f"{name}.conv1", n, cin, hw, hw, cout, 3, 1))
    if temb:
        ops.append(("linear", f"{name}.time_emb_proj", n, temb, cout))
    ops.append(("conv", f"{name}.conv2", n, cout, hw, hw, cout, 3, 1))
    if cin != cout:
        ops.append(("conv", f"{name}.conv_shortcut", n, cin, hw, hw, cout, 1, 1))


def _transformer(ops: List[Op], name: str, n: int, c: int, hw: int, heads: int,
                 ctx_len: int, ctx_dim: int) -> None:
    s, blk = hw * hw, f"{name}.transformer_blocks.0"
    ops.append(("conv", f"{name}.proj_in", n, c, hw, hw, c, 1, 1))
    for proj in ("to_q", "to_k", "to_v"):
        ops.append(("linear", f"{blk}.attn1.{proj}", n * s, c, c))
    ops.append(("attn", f"{blk}.attn1", n, heads, s, s, c // heads, True))
    ops.append(("linear", f"{blk}.attn1.to_out.0", n * s, c, c))
    ops.append(("linear", f"{blk}.attn2.to_q", n * s, c, c))
    for proj in ("to_k", "to_v"):
        ops.append(("linear", f"{blk}.attn2.{proj}", n * ctx_len, ctx_dim, c))
    ops.append(("attn", f"{blk}.attn2", n, heads, s, ctx_len, c // heads, False))
    ops.append(("linear", f"{blk}.attn2.to_out.0", n * s, c, c))
    ops.append(("linear", f"{blk}.ff.net.0.proj", n * s, c, 8 * c))
    ops.append(("linear", f"{blk}.ff.net.2", n * s, 4 * c, c))
    ops.append(("conv", f"{name}.proj_out", n, c, hw, hw, c, 1, 1))


def unet_ops(cfg: dict, n: int, ctx_len: int = 77) -> List[Op]:
    """One UNet forward over a batch of ``n`` latents (diffusers' unet keys)."""
    ch = list(cfg["block_out_channels"])
    heads, ctx, lpb = cfg["attention_head_dim"], cfg["cross_attention_dim"], cfg["layers_per_block"]
    down_attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
    up_attn = [t.startswith("CrossAttn") for t in cfg["up_block_types"]]
    temb, hw = 4 * ch[0], cfg["sample_size"]
    ops: List[Op] = [("linear", "time_embedding.linear_1", n, ch[0], temb),
                     ("linear", "time_embedding.linear_2", n, temb, temb),
                     ("conv", "conv_in", n, cfg["in_channels"], hw, hw, ch[0], 3, 1)]
    skips, cin = [ch[0]], ch[0]
    for i, cout in enumerate(ch):
        for j in range(lpb):
            _resnet(ops, f"down_blocks.{i}.resnets.{j}", n, cin if j == 0 else cout, cout, hw, temb)
            if down_attn[i]:
                _transformer(ops, f"down_blocks.{i}.attentions.{j}", n, cout, hw, heads, ctx_len, ctx)
            skips.append(cout)
        if i < len(ch) - 1:
            ops.append(("conv", f"down_blocks.{i}.downsamplers.0.conv", n, cout, hw, hw, cout, 3, 2))
            hw //= 2
            skips.append(cout)
        cin = cout
    _resnet(ops, "mid_block.resnets.0", n, ch[-1], ch[-1], hw, temb)
    _transformer(ops, "mid_block.attentions.0", n, ch[-1], hw, heads, ctx_len, ctx)
    _resnet(ops, "mid_block.resnets.1", n, ch[-1], ch[-1], hw, temb)
    prev = ch[-1]
    for i, cout in enumerate(reversed(ch)):
        for j in range(lpb + 1):
            c_in = (prev if j == 0 else cout) + skips.pop()
            _resnet(ops, f"up_blocks.{i}.resnets.{j}", n, c_in, cout, hw, temb)
            if up_attn[i]:
                _transformer(ops, f"up_blocks.{i}.attentions.{j}", n, cout, hw, heads, ctx_len, ctx)
        if i < len(ch) - 1:
            hw *= 2
            ops.append(("conv", f"up_blocks.{i}.upsamplers.0.conv", n, cout, hw, hw, cout, 3, 1))
        prev = cout
    ops.append(("conv", "conv_out", n, ch[0], hw, hw, cfg["out_channels"], 3, 1))
    return ops


def vae_decoder_ops(cfg: dict, n: int, latent_hw: int) -> List[Op]:
    """One VAE decode of ``n`` latents of side ``latent_hw`` (post_quant_conv
    and the decoder; diffusers' vae keys)."""
    rch, lpb, lat = list(reversed(cfg["block_out_channels"])), cfg["layers_per_block"], cfg["latent_channels"]
    hw = latent_hw
    ops: List[Op] = [("conv", "post_quant_conv", n, lat, hw, hw, lat, 1, 1),
                     ("conv", "decoder.conv_in", n, lat, hw, hw, rch[0], 3, 1)]
    c = rch[0]
    _resnet(ops, "decoder.mid_block.resnets.0", n, c, c, hw)
    for proj in ("query", "key", "value"):
        ops.append(("linear", f"decoder.mid_block.attentions.0.{proj}", n * hw * hw, c, c))
    ops.append(("attn", "decoder.mid_block.attentions.0", n, 1, hw * hw, hw * hw, c, True))
    ops.append(("linear", "decoder.mid_block.attentions.0.proj_attn", n * hw * hw, c, c))
    _resnet(ops, "decoder.mid_block.resnets.1", n, c, c, hw)
    prev = c
    for i, cout in enumerate(rch):
        for j in range(lpb + 1):
            _resnet(ops, f"decoder.up_blocks.{i}.resnets.{j}", n, prev if j == 0 else cout, cout, hw)
        if i < len(rch) - 1:
            hw *= 2
            ops.append(("conv", f"decoder.up_blocks.{i}.upsamplers.0.conv", n, cout, hw, hw, cout, 3, 1))
        prev = cout
    ops.append(("conv", "decoder.conv_out", n, rch[-1], hw, hw, cfg["out_channels"], 3, 1))
    return ops


def text_encoder_ops(cfg: dict, n: int) -> List[Op]:
    """One CLIP text forward over ``n`` prompts (transformers' keys)."""
    s, d, inner = cfg["max_position_embeddings"], cfg["hidden_size"], cfg["intermediate_size"]
    heads = cfg["num_attention_heads"]
    ops: List[Op] = []
    for i in range(cfg["num_hidden_layers"]):
        name = f"text_model.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj"):
            ops.append(("linear", f"{name}.self_attn.{proj}", n * s, d, d))
        ops.append(("attn", f"{name}.self_attn", n, heads, s, s, d // heads, True))
        ops.append(("linear", f"{name}.self_attn.out_proj", n * s, d, d))
        ops.append(("linear", f"{name}.mlp.fc1", n * s, d, inner))
        ops.append(("linear", f"{name}.mlp.fc2", n * s, inner, d))
    return ops


# ----------------------------------- counting ----------------------------------- #

def latent_side(model: dict, traffic: dict) -> int:
    """The latents' side: the image's over the VAE's 2^(levels - 1)."""
    return traffic["resolution"] // 2 ** (len(model["vae"]["block_out_channels"]) - 1)


def flops(op: Op) -> float:
    """Forward operations of one op."""
    if op[0] == "conv":
        _, _, n, cin, h, w, cout, k, stride = op
        return 2.0 * n * (h // stride) * (w // stride) * cout * cin * k * k
    if op[0] == "linear":
        _, _, m, k, n = op
        return 2.0 * m * k * n
    _, _, b, heads, sq, sk, d, _ = op
    return 4.0 * b * heads * sq * sk * d


def fwd_bytes(op: Op) -> float:
    if op[0] == "conv":
        _, _, n, cin, h, w, cout, k, stride = op
        return ELEM * (n * cin * h * w + cout * cin * k * k + n * cout * (h // stride) * (w // stride))
    if op[0] == "linear":
        _, _, m, k, n = op
        return ELEM * (m * k + k * n + m * n)
    _, _, b, heads, sq, sk, d, _ = op
    return ELEM * b * heads * d * (2 * sq + 2 * sk)


# ops whose input is one of the UNet's inputs: no input gradient
MODEL_INPUTS = ("conv_in", "time_embedding.linear_1", "attn2.to_k", "attn2.to_v")


def _input_grad(op: Op) -> bool:
    return op[0] == "attn" or not op[1].endswith(MODEL_INPUTS)


def backward(op: Op, weights: bool) -> Tuple[float, float]:
    """(operations, bytes) of one op's backward: the input gradient where
    needed, and with ``weights`` the weight gradient. The bytes read the
    output's gradient and the other operand, and write the gradient."""
    if op[0] == "attn":
        _, _, b, heads, sq, sk, d, _ = op
        return 2 * flops(op), ELEM * b * heads * d * (5 * sq + 3 * sk)
    f, b = 0.0, 0.0
    if op[0] == "conv":
        _, _, n, cin, h, w, cout, k, stride = op
        x, wt, y = n * cin * h * w, cout * cin * k * k, n * cout * (h // stride) * (w // stride)
    else:
        _, _, m, k, n = op
        x, wt, y = m * k, k * n, m * n
    if _input_grad(op):
        f, b = f + flops(op), b + ELEM * (y + wt + x)
    if weights:
        f, b = f + flops(op), b + ELEM * (x + y + wt)
    return f, b


def lora_adapter_flops(ops: Iterable[Op], rank: int, targets: Tuple[str, ...]) -> float:
    """The adapters' gradients, dA and dB, of each targeted linear: x^T (dy B^T)
    and (x A)^T dy, three rank-r products a token."""
    total = 0.0
    for op in ops:
        if op[0] == "linear" and any(op[1].endswith(t) for t in targets):
            _, _, m, k, n = op
            total += 2.0 * m * rank * (k + 2 * n)
    return total


def total_flops(ops: Iterable[Op]) -> float:
    """Forward operations over ``ops``."""
    return sum(flops(op) for op in ops)


def roofline_s(f: float, b: float) -> float:
    """The least time the card could take: operations over the bf16 peak or
    bytes over the memory rate, whichever is larger."""
    return max(f / PEAK_BF16_FLOPS, b / PEAK_BYTES_PER_S)


def is_self_attention(op: Op) -> bool:
    return op[0] == "attn" and op[7]


class EpochWork:
    """The operations of one DDPO epoch and the roofline time of its UNet
    self-attention and of all its convolutions, from the configuration and
    traffic. A trainer apply's roofline time is its forward, the remat
    recompute of that forward where the configuration sets ``remat``, and
    its backward."""

    def __init__(self, model: dict, traffic: dict, lora_rank: int, lora_targets, train_ts: int):
        b, batches = traffic["sample_batch_size"], traffic["num_sample_batches_per_epoch"]
        steps = batches * traffic["n_inference_steps"]
        latent = latent_side(model, traffic)
        unet_cfg = dict(model["unet"], sample_size=latent)
        sampler = unet_ops(unet_cfg, 2 * b)  # CFG: one 2B forward a step
        applies = (b * batches // traffic["train_batch_size"] * train_ts
                   * traffic["num_inner_epochs"])
        apply_ops = unet_ops(unet_cfg, 2 * traffic["train_batch_size"])
        decode = vae_decoder_ops(model["vae"], b, latent)
        text = text_encoder_ops(model["text_encoder"], b)
        full = lora_rank == 0

        self.flops = (steps * total_flops(sampler)
                      + batches * (total_flops(decode) + total_flops(text)))
        apply_f = total_flops(apply_ops) + sum(backward(op, full)[0] for op in apply_ops)
        if not full:
            apply_f += lora_adapter_flops(apply_ops, lora_rank, tuple(lora_targets))
        self.flops += applies * apply_f
        self.sampler_steps, self.applies = steps, applies

        forwards = 2 if model["remat"] else 1

        def bound(ops, calls, train):
            s = 0.0
            for op in ops:
                s += calls * roofline_s(flops(op), fwd_bytes(op)) * (forwards if train else 1)
                if train:
                    s += calls * roofline_s(*backward(op, full))
            return s

        attn = [op for op in sampler if is_self_attention(op)]
        attn_train = [op for op in apply_ops if is_self_attention(op)]
        self.attn_bound_s = bound(attn, steps, False) + bound(attn_train, applies, True)
        convs = [op for op in sampler if op[0] == "conv"]
        convs_train = [op for op in apply_ops if op[0] == "conv"]
        self.conv_bound_s = (bound(convs, steps, False) + bound(convs_train, applies, True)
                             + bound([op for op in decode if op[0] == "conv"], batches, False))
