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

``conv3x3_w8a8`` is the op. Its activation scale is one reduction,
``activation_scale`` (the infinity norm over (C, H, W): the absmax
exactly, in one read of x). On a CUDA tensor the s8 tap-GEMM kernel
(csrc/conv3x3_s8.cu, ``tap_gemm_s8``) then takes x itself and that scale:
it makes the codes while it stages x, so x is read once and no int8 copy
is written. On a CPU tensor the plain version, ``tap_gemm_s8_plain``, makes
the codes in torch (``quantize_with_scale``, the expression of
``quantize_symmetric``) and sums them exactly in float64 in
``tap_gemm_s8_reference`` (|sum| <= 9 * Cin * 127^2, about 3.7e8 at Cin
2560, far under 2^53). Both round the same fp32 quotients half to even, so
the kernel and the plain version agree bit for bit. The weight's codes are
computed once per weight and kept while the weight lives and is not
written to (keyed on its ``data_ptr()`` and ``_version``): JAX's scan
hoists the same quantize out of the sampler's loop.

``padding`` is JAX's, for the spatial path (ops/spatial.py): with
((0, 0), (1, 1)) the shard has fetched its halo rows and the conv is
VALID over H. The activation scale is then taken over the halo'd shard,
as JAX's is (activation scales become shard-local), and the product runs
the kernel's SAME map on the halo'd frame with its first and last output
rows dropped: the kept rows read only the frame, so the integer sums, and
the outputs, are the VALID conv's.

The op's backward raises (JAX's custom_vjp does the same): the int8
round/clip has no gradient, and training always runs the float convs.
Only the UNet's stride-1 resnet and upsampler convs take it
(models/unet.py ``set_quant``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ddpo_torch.ops import _build
from ddpo_torch.ops.conv import cached_per_version

_EPS = 1e-12  # guards all-zero slices; the scale stays positive

# id(weight) -> (weakref to it, data_ptr, _version, (codes, scales))
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


def activation_scale(x: torch.Tensor, bound: int = 127) -> torch.Tensor:
    """The per-sample activation scale (N,) fp32 of ``quantize_symmetric(x,
    (1, 2, 3))``: one reduction over (C, H, W), the infinity norm, which is
    x.abs().amax() exactly (in fp32, where x's values are exact)."""
    absmax = torch.linalg.vector_norm(x.reshape(x.shape[0], -1), ord=math.inf, dim=1,
                                      dtype=torch.float32)
    return absmax.div_(bound).clamp_(min=_EPS)


def quantize_with_scale(x: torch.Tensor, sx: torch.Tensor, bound: int = 127) -> torch.Tensor:
    """x's int8 codes at the per-sample scales sx (N,): quantize_symmetric's
    rounding (fp32 quotient, half to even, clamp)."""
    return torch.round(x / sx.reshape(-1, 1, 1, 1)).clamp_(-bound, bound).to(torch.int8)


def weight_codes(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The OIHW weight quantized per output channel: codes (Cout, 9 * Cin)
    in (tap, cin) order, the s8 kernel's operand, and scales (Cout,) fp32.
    Computed once while the weight lives unchanged."""
    def make():
        wq, sw = quantize_symmetric(weight, (1, 2, 3))
        return wq.permute(0, 2, 3, 1).reshape(weight.shape[0], -1).contiguous(), sw.reshape(-1)

    return cached_per_version(_WEIGHT_CODES, weight, make)


def _check_operands(x, wq, sx, sw, bias, codes: bool):
    if codes and x.dtype != torch.int8:
        raise TypeError("the s8 conv's plain sums take NCHW int8 codes")
    if not codes and not x.is_floating_point():
        raise TypeError(f"the s8 conv quantizes a float x, not {x.dtype}")
    if wq.dtype != torch.int8 or x.dim() != 4:
        raise TypeError("the s8 conv takes an NCHW x and an int8 weight")
    b, cin = x.shape[:2]
    if wq.shape != (wq.shape[0], 9 * cin):
        raise ValueError(f"weight {tuple(wq.shape)} is not (Cout, 9 * {cin})")
    cout = wq.shape[0]
    for name, t, n in (("sx", sx, b), ("sw", sw, cout)):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{name} must be fp32 of shape ({n},), got {t.dtype} {tuple(t.shape)}")
    if bias is not None and (bias.dtype not in (torch.float32, torch.bfloat16)
                             or bias.shape != (cout,)):
        raise ValueError(f"bias must be fp32 or bf16 of shape ({cout},), got {bias.dtype} "
                         f"{tuple(bias.shape)}")


def tap_gemm_s8(x: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """The s8 kernel: the codes xq = clamp(rint(x / sx[b]), -127, 127), made
    as x is staged, then out[b, co] = float(sum over taps and cin of xq * wq)
    * (sx[b] * sw[co]) + bias[co], SAME zero padding, in ``out_dtype``
    (float32 or bfloat16); on CUDA tensors only.

    x: contiguous (B, Cin, H, W) float32 or bfloat16; wq: contiguous
    (Cout, 9 * Cin) int8 in (tap, cin) order; sx (B,) and sw (Cout,) fp32;
    bias (Cout,) fp32 or bf16 (added as its fp32 value), or None. Where Cin
    is not a multiple of 16 (16-byte rows for the kernel's TMA), wq is
    padded with zero codes at each call.
    """
    _check_operands(x, wq, sx, sw, bias, codes=False)
    tensors = [t for t in (x, wq, sx, sw, bias) if t is not None]
    if not all(t.is_cuda and t.device == x.device and t.is_contiguous() for t in tensors):
        raise ValueError("tap_gemm_s8 takes contiguous tensors on one CUDA device")
    b, cin, h, w = x.shape
    cout = wq.shape[0]
    if cin % 16:
        wq = F.pad(wq.view(cout, 9, cin), (0, 16 - cin % 16)).contiguous()
    out = torch.empty((b, cout, h, w), dtype=out_dtype, device=x.device)
    kl = _build.load_library()
    err = kl.lib.ddpo_tap_gemm_s8(
        x.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), _build.dtype_code(x.dtype),
        0 if bias is None else _build.dtype_code(bias.dtype), _build.dtype_code(out_dtype),
        b, cin, h, w, cout, _build.stream_handle(x.device),
    )
    kl.check(err, "conv3x3_s8 launch")
    _build.launches["conv3x3_s8"] += 1
    return out


def tap_gemm_s8_plain(x: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                      bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """``tap_gemm_s8``'s plain version, with its signature: the codes in
    torch (``quantize_with_scale``), then ``tap_gemm_s8_reference``."""
    _check_operands(x, wq, sx, sw, bias, codes=False)
    return tap_gemm_s8_reference(quantize_with_scale(x, sx), wq, sx, sw, bias, out_dtype)


def tap_gemm_s8_reference(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                          sw: torch.Tensor, bias: Optional[torch.Tensor],
                          out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's plain version: the 9-tap sum of the codes in float64,
    exact (every partial sum is an integer under 2^53), then the epilogue
    in JAX's order, each step rounded to fp32 on its own."""
    _check_operands(xq, wq, sx, sw, bias, codes=True)
    b, cin, h, w = xq.shape
    cout = wq.shape[0]
    xp = F.pad(xq.double(), (1, 1, 1, 1))
    wt = wq.view(cout, 3, 3, cin).double()
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = torch.einsum("bchw,oc->bohw", xp[:, :, dy:dy + h, dx:dx + w], wt[:, dy, dx])
            acc = term if acc is None else acc + term
    out = acc.float() * (sx[:, None, None, None] * sw[None, :, None, None])
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(out_dtype)


SAME = ((1, 1), (1, 1))
VALID_ROWS = ((0, 0), (1, 1))


def _w8a8_forward(x, codes, scales, bias, padding=SAME, plain=False):
    """x's scale, then the quantize, the s8 product and epilogue: the kernel
    on a CUDA tensor, the plain version on a CPU one or when asked for;
    VALID_ROWS drops the SAME map's first and last rows."""
    x = x.contiguous()
    if bias is not None and bias.dtype not in (torch.float32, torch.bfloat16):
        bias = bias.float()
    product = tap_gemm_s8_plain if plain or x.device.type == "cpu" else tap_gemm_s8
    out = product(x, codes, activation_scale(x), scales, bias, x.dtype)
    return out[:, :, 1:-1].contiguous() if padding == VALID_ROWS else out


def _check_padding(padding) -> tuple:
    padding = tuple(tuple(p) for p in padding)
    if padding not in (SAME, VALID_ROWS):
        raise ValueError(f"conv3x3_w8a8 takes padding {SAME} or {VALID_ROWS}, got {padding}")
    return padding


class _Conv3x3W8A8(torch.autograd.Function):
    """The quantized conv under autograd: the backward raises, as JAX's
    custom_vjp does."""

    @staticmethod
    def forward(ctx, x, weight, bias, codes, scales, padding):
        return _w8a8_forward(x, codes, scales, bias, padding)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "conv3x3_w8a8 is an inference-only op: the int8 round/clip is "
            "non-differentiable. Train with quant disabled (the default); "
            "quantize only the sampling/inference UNet."
        )


def conv3x3_w8a8(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, padding=SAME) -> torch.Tensor:
    """Stride-1 3x3 conv on int8 codes, SAME or (``padding`` VALID_ROWS)
    VALID over H: x (N, Cin, H, W) in any float dtype, weight OIHW
    (Cout, Cin, 3, 3) and bias (Cout,) in any float dtype (the model's
    layers hold them in x's, as JAX promotes them); returns x's dtype."""
    if weight.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x {tuple(x.shape)}")
    codes, scales = weight_codes(weight)
    padding = _check_padding(padding)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weight, bias)):
        return _Conv3x3W8A8.apply(x, weight, bias, codes, scales, padding)
    return _w8a8_forward(x, codes, scales, bias, padding)  # no graph: skip the Function's cost


def conv3x3_w8a8_reference(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor] = None, padding=SAME) -> torch.Tensor:
    """``conv3x3_w8a8`` with the plain version on any device."""
    return _w8a8_forward(x, *weight_codes(weight), bias, _check_padding(padding), plain=True)
