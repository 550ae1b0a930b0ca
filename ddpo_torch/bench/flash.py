"""Times the flash kernels on the card: the bf16 forward
(ops.attention.flash_attention_fwd) and the two backward kernels
(flash_bwd_dq, flash_bwd_dkv) at the UNet's self-attention shapes, and the
fp32 forward there and at RWR's batch 1, beside one PyTorch call for the
same work, scaled_dot_product_attention (its forward, and its whole
backward for dq, dk and dv).

It times whatever ``ddpo_torch`` is first on the path, so the same file
times another checkout's kernels, e.g. the parent commit's unpacked with
``git archive``; from that checkout's root:

    PYTHONPATH=. python /path/to/ddpo_torch/bench/flash.py [shapes.json]

shapes.json: {"fwd": [[B, Sq, Sk, H, D], ...], "bwd": [...], "fwd_fp32":
[...]}; by default the 2B = 8 sampler's and the 2B = 4 trainer's shapes of
chip_smoke.py, and at fp32 the sampler's and RWR's batch-1 shapes.
Prints one JSON line: the device, and per shape the median ms of CUDA
events after warm-up. chip_smoke.py --parent DIR runs it for DIR and this
checkout in turns (parent, this, this, parent).
"""

from __future__ import annotations

import json
import statistics
import sys

import torch
import torch.nn.functional as F

FWD_SHAPES = [(8, 4096, 4096, 8, 40), (8, 1024, 1024, 8, 80), (8, 256, 256, 8, 160)]
BWD_SHAPES = [(4, 4096, 4096, 8, 40), (4, 1024, 1024, 8, 80), (4, 256, 256, 8, 160)]
FWD_FP32_SHAPES = FWD_SHAPES + [(1, 4096, 4096, 8, 40), (1, 1024, 1024, 8, 80),
                                (1, 256, 256, 8, 160)]


def median_ms(fn, iters: int) -> float:
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


def inputs(shape, gen, grad: bool = False, dtype=torch.bfloat16):
    b, sq, sk, h, d = shape
    sizes = [(b, sq, h, d), (b, sk, h, d), (b, sk, h, d)] + ([(b, sq, h, d)] if grad else [])
    return [torch.randn(s, generator=gen, device="cuda").to(dtype) for s in sizes]


def time_fwd(shape, gen, dtype=torch.bfloat16):
    from ddpo_torch.ops.attention import flash_attention_fwd

    q, k, v = inputs(shape, gen, dtype=dtype)
    iters = 10 if shape[1] >= 4096 else 30
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return {"ms": median_ms(lambda: flash_attention_fwd(q, k, v), iters),
            "sdpa_ms": median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)}


def time_bwd(shape, gen):
    from ddpo_torch.ops.attention import _delta, flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq

    q, k, v, do = inputs(shape, gen, grad=True)
    scale = shape[-1] ** -0.5
    out, lse = flash_attention_fwd(q, k, v)
    delta = _delta(out, do)
    iters = 5 if shape[1] >= 4096 else 20
    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)
    do_t = do.transpose(1, 2)
    return {
        "dq_ms": median_ms(lambda: flash_bwd_dq(q, k, v, do, lse, delta, scale), iters),
        "dkv_ms": median_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, scale), iters),
        "sdpa_bwd_ms": median_ms(
            lambda: torch.autograd.grad(sdpa_out, leaves, do_t, retain_graph=True), iters),
    }


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("the flash bench times the CUDA card, and torch finds none")
    shapes = {"fwd": FWD_SHAPES, "bwd": BWD_SHAPES, "fwd_fp32": FWD_FP32_SHAPES}
    if argv:
        with open(argv[0]) as f:
            shapes.update(json.load(f))
    # SDPA's fp32 yardstick in fp32, as the port's device setup leaves it
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(14)
    result = {"device": torch.cuda.get_device_name(0),
              "fwd": {str(list(s)): time_fwd(s, gen) for s in shapes["fwd"]},
              "bwd": {str(list(s)): time_bwd(s, gen) for s in shapes["bwd"]},
              "fwd_fp32": {str(list(s)): time_fwd(s, gen, torch.float32)
                           for s in shapes["fwd_fp32"]}}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
