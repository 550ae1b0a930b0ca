"""Times the tap-GEMM kernels on the card: the direct conv
(ops.conv.conv3x3_direct, its weight operand made once per weight; bf16 on
the wgmma kernel, fp32 on its 3xTF32 one) and the W8A8 s8 conv
(ops.quant.tap_gemm_s8) alone and with the quantize work each call needs
before it, beside F.conv2d (cuDNN).

It times whatever ``ddpo_torch`` is first on the path, so the same file
times another checkout's kernels, e.g. the parent commit's unpacked with
``git archive``; from that checkout's root:

    PYTHONPATH=. python /path/to/ddpo_torch/bench/tap_gemm.py [shapes.json]

shapes.json: {"bf16": [[N, Cin, H, W, Cout], ...], "fp32": [...], "s8":
[...]}; by default the headline shapes of chip_smoke.py. Prints one JSON
line: the device, and per shape the median ms of CUDA events after
warm-up. chip_smoke.py --parent DIR runs it for DIR and this checkout in
turns (parent, this, this, parent).
"""

from __future__ import annotations

import json
import statistics
import sys

import torch
import torch.nn.functional as F

BF16_SHAPES = [(8, 320, 64, 64, 320), (8, 2560, 8, 8, 1280), (4, 128, 512, 512, 128)]
# the UNet's fp32 conv widths (the DDPO pipeline's fp32 path runs every
# stride-1 3x3 conv here inside batch_invariant())
FP32_SHAPES = [(8, 320, 64, 64, 320), (8, 640, 32, 32, 640), (8, 1280, 16, 16, 1280),
               (8, 2560, 8, 8, 1280)]
S8_SHAPES = [(8, 320, 64, 64, 320), (8, 640, 32, 32, 640), (8, 1920, 16, 16, 1280),
             (8, 2560, 8, 8, 1280)]


def median_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_conv(shape, gen, dtype=torch.bfloat16):
    from ddpo_torch.ops.conv import conv3x3_direct

    n, cin, h, w, cout = shape
    x = torch.randn((n, cin, h, w), generator=gen, device="cuda").to(dtype)
    weight = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
              * (9 * cin) ** -0.5).to(dtype)
    iters = 3 if n * h * w * cin * cout > 2 ** 34 else 10
    return {"ms": median_ms(lambda: conv3x3_direct(x, weight), iters),
            "cudnn_ms": median_ms(lambda: F.conv2d(x, weight, padding=1), iters)}


def time_s8(shape, gen):
    """The kernel alone, and with what a call does before it: this
    checkout's one scale reduction (activation_scale) with the quantize
    fused into the kernel, or an earlier one's quantize pass over x."""
    from ddpo_torch.ops import quant

    n, cin, h, w, cout = shape
    x = torch.randn((n, cin, h, w), generator=gen, device="cuda").to(torch.bfloat16)
    weight = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
              * (9 * cin) ** -0.5).to(torch.bfloat16)
    bias = torch.randn(cout, generator=gen, device="cuda")
    wq, sw = quant.weight_codes(weight)
    out = {"cudnn_ms": median_ms(lambda: F.conv2d(x, weight, bias.to(torch.bfloat16),
                                                  padding=1))}
    if hasattr(quant, "activation_scale"):  # the fused quantize
        sx = quant.activation_scale(x)
        out["ms"] = median_ms(lambda: quant.tap_gemm_s8(x, wq, sx, sw, bias, torch.bfloat16))
        out["quantize_ms"] = median_ms(lambda: quant.activation_scale(x))
        out["with_quantize_ms"] = median_ms(lambda: quant.tap_gemm_s8(
            x, wq, quant.activation_scale(x), sw, bias, torch.bfloat16))
    else:  # a quantize pass, then the kernel on the int8 codes
        xq, sx = quant.quantize_symmetric(x, (1, 2, 3))
        sx = sx.reshape(-1)
        out["ms"] = median_ms(lambda: quant.tap_gemm_s8(xq, wq, sx, sw, bias, torch.bfloat16))
        out["quantize_ms"] = median_ms(lambda: quant.quantize_symmetric(x, (1, 2, 3)))

        def both():
            codes, scale = quant.quantize_symmetric(x, (1, 2, 3))
            return quant.tap_gemm_s8(codes, wq, scale.reshape(-1), sw, bias, torch.bfloat16)

        out["with_quantize_ms"] = median_ms(both)
    return out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("the tap-GEMM bench times the CUDA card, and torch finds none")
    shapes = {"bf16": BF16_SHAPES, "fp32": FP32_SHAPES, "s8": S8_SHAPES}
    if argv:
        with open(argv[0]) as f:
            shapes.update(json.load(f))
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(13)
    result = {"device": torch.cuda.get_device_name(0),
              "bf16": {str(list(s)): time_conv(s, gen) for s in shapes["bf16"]},
              "fp32": {str(list(s)): time_conv(s, gen, torch.float32) for s in shapes["fp32"]},
              "s8": {str(list(s)): time_s8(s, gen) for s in shapes["s8"]}}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
