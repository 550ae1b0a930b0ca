"""W8A8 dynamic-quantized 3x3 conv for inference sampling, and the s8
tap-GEMM kernel behind it.

Port of ddpo_tpu/ops/quant.py, where the int8 conv is an XLA op. The
scheme is JAX's, inference only:
  - weights: symmetric per-output-channel int8, scale = absmax / 127 over
    (Cin, 3, 3), computed from the weight as it is (a finetuned or merged
    checkpoint quantizes with no calibration pass);
  - activations: symmetric per-sample int8, scale = absmax / 127 over
    (C, H, W), computed at each call;
  - the int32 sum of the codes' products, then JAX's epilogue in JAX's
    order: float(acc) * (sx * sw), then + bias, then x's dtype.

``conv3x3_w8a8`` is the op. On a CUDA tensor its product runs the s8
tap-GEMM kernel (csrc/conv3x3_s8.cu, ``tap_gemm_s8``); on a CPU tensor the
plain version, ``tap_gemm_s8_reference``, which sums the codes exactly in
float64 (|sum| <= 9 * Cin * 127^2, about 3.7e8 at Cin 2560, far under
2^53). Both consume the same codes, so the kernel and the plain version
agree bit for bit. The quantize pass over x runs in plain torch ops, as in
JAX's XLA: five elementwise passes and a reduction a call (ROADMAP.md
Queue 2 fuses it into the kernel's staging). The weight's codes are
computed once per weight and kept while the weight lives and is not
written to (keyed on its ``data_ptr()`` and ``_version``): JAX's scan
hoists the same quantize out of the sampler's loop.

The op's backward raises (JAX's custom_vjp does the same): the int8
round/clip has no gradient, and training always runs the float convs.
Only the UNet's stride-1 resnet and upsampler convs take it
(models/unet.py ``set_quant``).
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import torch

from ddpo_torch.ops import _build

_EPS = 1e-12  # guards all-zero slices; the scale stays positive

# id(weight) -> (weakref to it, data_ptr, _version, codes, scales)
_WEIGHT_CODES: Dict[int, tuple] = {}


def quantize_symmetric(
    x: torch.Tensor, dims, bound: int = 127
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over ``dims``: (q int8, scale fp32) with
    x ~= q * scale; the scale keeps the reduced dims as size 1. round() is
    half to even, as jnp.round."""
    # abs and max are exact in x's dtype, so reducing before the fp32 cast
    # gives JAX's fp32 absmax
    scale = torch.clamp(x.abs().amax(dim=dims, keepdim=True).float() / bound, min=_EPS)
    q = torch.round(x / scale).clamp_(-bound, bound).to(torch.int8)  # x / scale is fp32
    return q, scale


def weight_codes(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The OIHW weight quantized per output channel: codes (Cout, 9 * Cin)
    in (tap, cin) order, the s8 kernel's operand, and scales (Cout,) fp32.
    Computed once while the weight lives unchanged."""
    key = (weight.data_ptr(), weight._version)
    entry = _WEIGHT_CODES.get(id(weight))
    if entry is not None and entry[0]() is weight and entry[1:3] == key:
        return entry[3], entry[4]
    wq, sw = quantize_symmetric(weight, (1, 2, 3))
    codes = wq.permute(0, 2, 3, 1).reshape(weight.shape[0], -1).contiguous()
    scales = sw.reshape(-1)
    ident = id(weight)
    ref = weakref.ref(weight, lambda _: _WEIGHT_CODES.pop(ident, None))
    _WEIGHT_CODES[ident] = (ref, *key, codes, scales)
    return codes, scales


def _check_operands(xq, wq, sx, sw, bias):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.dim() != 4:
        raise TypeError("the s8 conv takes NCHW int8 codes and an int8 weight")
    b, cin = xq.shape[:2]
    if wq.shape != (wq.shape[0], 9 * cin):
        raise ValueError(f"weight {tuple(wq.shape)} is not (Cout, 9 * {cin})")
    cout = wq.shape[0]
    for name, t, n in (("sx", sx, b), ("sw", sw, cout), ("bias", bias, cout)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (n,)):
            raise ValueError(f"{name} must be fp32 of shape ({n},), got {t.dtype} {tuple(t.shape)}")


def tap_gemm_s8(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """The s8 kernel: out[b, co] = float(sum over taps and cin of xq * wq)
    * (sx[b] * sw[co]) + bias[co], SAME zero padding, in ``out_dtype``
    (float32 or bfloat16); on CUDA tensors only.

    xq: contiguous (B, Cin, H, W) int8; wq: contiguous (Cout, 9 * Cin) int8
    in (tap, cin) order; sx (B,), sw (Cout,), bias (Cout,) or None, fp32.
    """
    _check_operands(xq, wq, sx, sw, bias)
    tensors = [t for t in (xq, wq, sx, sw, bias) if t is not None]
    if not all(t.is_cuda and t.device == xq.device and t.is_contiguous() for t in tensors):
        raise ValueError("tap_gemm_s8 takes contiguous tensors on one CUDA device")
    code = _build.dtype_code(out_dtype)
    b, cin, h, w = xq.shape
    cout = wq.shape[0]
    out = torch.empty((b, cout, h, w), dtype=out_dtype, device=xq.device)
    kl = _build.load_library()
    err = kl.lib.ddpo_tap_gemm_s8(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), code,
        b, cin, h, w, cout, _build.stream_handle(xq.device),
    )
    kl.check(err, "conv3x3_s8 launch")
    _build.launches["conv3x3_s8"] += 1
    return out


def tap_gemm_s8_reference(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                          sw: torch.Tensor, bias: Optional[torch.Tensor],
                          out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's plain version: the 9-tap sum of the codes in float64,
    exact (every partial sum is an integer under 2^53), then the epilogue
    in JAX's order, each step rounded to fp32 on its own."""
    _check_operands(xq, wq, sx, sw, bias)
    b, cin, h, w = xq.shape
    cout = wq.shape[0]
    xp = torch.nn.functional.pad(xq.double(), (1, 1, 1, 1))
    wt = wq.view(cout, 3, 3, cin).double()
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = torch.einsum("bchw,oc->bohw", xp[:, :, dy:dy + h, dx:dx + w], wt[:, dy, dx])
            acc = term if acc is None else acc + term
    out = acc.float() * (sx[:, None, None, None] * sw[None, :, None, None])
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out.to(out_dtype)


def _w8a8_forward(x, codes, scales, bias, plain=False):
    """Quantize x, then the s8 product and epilogue: the kernel on a CUDA
    tensor, the plain version on a CPU one or when asked for."""
    xq, sx = quantize_symmetric(x, (1, 2, 3))
    b = None if bias is None else bias.float()
    product = tap_gemm_s8_reference if plain or x.device.type == "cpu" else tap_gemm_s8
    return product(xq, codes, sx.reshape(-1), scales, b, x.dtype)


class _Conv3x3W8A8(torch.autograd.Function):
    """The quantized conv under autograd: the backward raises, as JAX's
    custom_vjp does."""

    @staticmethod
    def forward(ctx, x, weight, bias, codes, scales):
        return _w8a8_forward(x, codes, scales, bias)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "conv3x3_w8a8 is an inference-only op: the int8 round/clip is "
            "non-differentiable. Train with quant disabled (the default); "
            "quantize only the sampling/inference UNet."
        )


def conv3x3_w8a8(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv on int8 codes: x (N, Cin, H, W) in any float
    dtype, weight OIHW (Cout, Cin, 3, 3) and bias (Cout,) in any float dtype
    (the model's layers hold them in x's, as JAX promotes them); returns
    x's dtype."""
    if weight.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x {tuple(x.shape)}")
    codes, scales = weight_codes(weight)
    return _Conv3x3W8A8.apply(x, weight, bias, codes, scales)


def conv3x3_w8a8_reference(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv3x3_w8a8`` with the plain version on any device."""
    return _w8a8_forward(x, *weight_codes(weight), bias, plain=True)
