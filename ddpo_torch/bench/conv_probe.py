"""Where a direct 3x3 conv's time goes on the card: the conv probes.

Port of bench_conv_probe.py (its ``main`` and ``main2``). At JAX's shape by
default (B16, 64x64, 320 -> 320, bf16) ``main`` times, with CUDA events:

  p0  torch.einsum("bhwc,kcd->bhwd") on NHWC x (JAX's XLA einsum probe);
  p1  the tap-GEMM kernel: 9 accumulated products on the same unshifted x;
  p2  p1 with each tap's row shift (dy);
  p3  the direct conv kernel (ops.conv.conv3x3_direct);
  p4  one 8192^3 torch.matmul;
  p5  im2col + one torch.matmul at K = 9 * Cin;
  p6  the conv with dx folded into K = 3 * Cin (JAX's p6_kernel);
  p7  the conv with all taps folded into K = 9 * Cin (JAX's p7_kernel);
  and F.conv2d (cuDNN).

p1, p2, p6 and p7 are csrc/conv3x3.cu over three tap maps. On the card the
kernel has one K order, (dy, dx, cin), so p6 and p7 differ from the conv
only in their weight's shape: JAX grouped K that way for the TPU's MXU. Each
probe has its own wrapper, plain version and launch counter. The probes take
x unpadded: the kernel masks the padding, and nothing is built in device
memory that it does not read.

Layouts: x (B, Cin, H, W); p1 and p2 take w9 (9, Cin, Cout), p6 w3
(3, 3 * Cin, Cout) and p7 w2 (9 * Cin, Cout), JAX's weights, all in
(tap, cin, cout) order.

Run on a machine with a CUDA card: python -m ddpo_torch.bench.conv_probe
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch
import torch.nn.functional as F

from ddpo_torch.ops.conv import conv3x3_direct, tap_gemm, tap_operand_kn

B, H, W, CIN, COUT = 16, 64, 64, 320, 320
ITERS = 10


def _product(a: torch.Tensor, w_kn: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) x (K, Cout) -> (B, Cout, H, W), fp32."""
    return torch.einsum("bkhw,kd->bdhw", a, w_kn.float())


def _sum(terms):
    acc = None
    for term in terms:
        acc = term if acc is None else acc + term
    return acc


def p1_reference(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return _sum(_product(xf, w9[t]) for t in range(9)).to(x.dtype)


def p2_reference(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    h = x.shape[2]
    xp = F.pad(x.float(), (0, 0, 1, 1))
    return _sum(_product(xp[:, :, dy:dy + h], w9[3 * dy + i])
                for dy in range(3) for i in range(3)).to(x.dtype)


def _windows(x: torch.Tensor, dys):
    """The zero-padded (dy, dx) windows of x in fp32, dx inner."""
    h, w = x.shape[2:]
    xp = F.pad(x.float(), (1, 1, 1, 1))
    return [xp[:, :, dy:dy + h, dx:dx + w] for dy in dys for dx in range(3)]


def p6_reference(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    return _sum(_product(torch.cat(_windows(x, [dy]), dim=1), w3[dy])
                for dy in range(3)).to(x.dtype)


def p7_reference(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    return _product(torch.cat(_windows(x, range(3)), dim=1), w2).to(x.dtype)


def _probe(reference, tap_map, counter):
    def probe(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return reference(x, w)
        if w.shape[-1] * x.shape[1] * 9 != w.numel():
            raise ValueError(f"weight {tuple(w.shape)} does not fit x {tuple(x.shape)}")
        return tap_gemm(x, tap_operand_kn(w), w.shape[-1], tap_map, counter)

    probe.__doc__ = (f"{counter}: x (B, Cin, H, W) -> (B, Cout, H, W) in x's dtype; the "
                     f"kernel on a CUDA tensor, {reference.__name__} on a CPU tensor.")
    return probe


p1 = _probe(p1_reference, "none", "conv_probe_p1")
p2 = _probe(p2_reference, "rows", "conv_probe_p2")
p6 = _probe(p6_reference, "shift3x3", "conv_probe_p6")
p7 = _probe(p7_reference, "shift3x3", "conv_probe_p7")


def p0_einsum(x_nhwc: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """JAX's p0 in torch: the same einsum on NHWC x."""
    return torch.einsum("bhwc,kcd->bhwd", x_nhwc, w9)


def p5_im2col(x_nhwc: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """JAX's p5 in torch: im2col in device memory, then one K = 9 * Cin matmul."""
    b, h, w, c = x_nhwc.shape
    xp = F.pad(x_nhwc, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]
    return torch.matmul(torch.cat(cols, dim=-1).reshape(b * h * w, 9 * c), w2)


def time_ms(fn, iters: int) -> float:
    """Median of per-call CUDA-event times, after two warm-up calls."""
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> Dict[str, float]:
    """Time every probe at JAX's shape, in bf16; returns {probe: ms}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the conv probes time the CUDA card, and torch finds none")
    b, h, w, cin, cout = B, H, W, CIN, COUT
    dtype = torch.bfloat16
    print(f"device: {torch.cuda.get_device_name(0)}; x ({b}, {cin}, {h}, {w}) -> {cout} "
          f"channels, bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((b, cin, h, w), generator=gen, device="cuda").to(dtype)
    w9 = (torch.randn((9, cin, cout), generator=gen, device="cuda") * 0.02).to(dtype)
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    w_oihw = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous()
    # the probes' weights, made once: the kernels' layout of each is then made once
    w3, w2 = w9.reshape(3, 3 * cin, cout), w9.reshape(9 * cin, cout)
    flops = 2.0 * b * h * w * 9 * cin * cout
    a = torch.randn((8192, 8192), generator=gen, device="cuda").to(dtype)

    probes = [
        ("p0", "torch.einsum 9K-dot", lambda: p0_einsum(x_nhwc, w9), flops),
        ("p1", "tap-GEMM 9 taps, no shift", lambda: p1(x, w9), flops),
        ("p2", "+ dy row shifts", lambda: p2(x, w9), flops),
        ("p3", "direct conv kernel", lambda: conv3x3_direct(x, w_oihw), flops),
        ("p4", "torch.matmul 8192^3", lambda: torch.matmul(a, a), 2.0 * 8192**3),
        ("p5", "im2col + matmul K=9Cin", lambda: p5_im2col(x_nhwc, w2),
         flops),
        ("p6", "dx folded, K=3Cin", lambda: p6(x, w3), flops),
        ("p7", "full fold, K=9Cin", lambda: p7(x, w2), flops),
        ("conv2d", "F.conv2d (cuDNN)", lambda: F.conv2d(x, w_oihw, padding=1), flops),
    ]
    results = {}
    for name, what, fn, n_flops in probes:
        ms = time_ms(fn, ITERS)
        results[name] = ms
        print(f"{name:>6} {what:<28} {ms:8.3f} ms ({n_flops / ms / 1e9:6.1f} TFLOP/s)",
              flush=True)
    return results


if __name__ == "__main__":
    main()
