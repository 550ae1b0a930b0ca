"""3x3 stride-1 SAME convolution, and the tap-GEMM kernel behind it.

Port of ddpo_tpu/ops/conv.py's dispatch. ``set_conv_kernel_enabled``
forces (True), forbids (False) or restores the automatic choice (None) of
the direct kernel. Automatic never picks it, since JAX's
``_kernel_profitable`` returns False, so by default the product is a library
call, as XLA's conv emitter did it there: ``F.conv2d`` on NCHW/OIHW.

With the switch on, ``conv3x3`` runs ``conv3x3_direct``: on a CUDA tensor
the tap-GEMM kernel (csrc/conv3x3.cu, replacing the Pallas
``_conv3x3_kernel``), on a CPU tensor its plain version,
``conv3x3_reference``. The bias is added after the product is rounded to
x's dtype, as JAX adds it. Under autograd the product goes through
``Conv3x3Direct``, whose backward is the library conv's gradient, as JAX
differentiates its XLA conv.

``tap_gemm`` launches the kernel for ``conv3x3_direct`` and for the conv
probes of ddpo_torch/bench/conv_probe.py, on the operand ``tap_operand``
(``tap_operand_kn`` for the probes) makes once per weight version: the
layout below, or at fp32, where the kernel runs 3xTF32 products on the
tensor cores, the layout split into its tf32 hi and lo values by a split
kernel (``tf32_split_reference``'s order: the hi rows, then the lo rows).
At fp32 only the split is kept, so a weight has two copies beside it, not
three. ``tap_weight`` lays the OIHW weight out: (Cout, 9, Cin), K = (tap,
cin) contiguous for each output (the weight tile a TMA load brings in),
Cout and Cin padded with zeros to multiples of 8 (16-byte rows), on the
card with a layout kernel of its own. The operand is made once per weight
and kept while the weight lives and is not written to (keyed on its
``data_ptr()`` and ``_version``, as ops/quant.py keeps the int8 codes): the
sampler's 50 steps lay each conv's weight out once, not 50 times. The
trainer's convs see a fresh bf16 cast of the fp32 masters at every call, so
they lay it out at every call, as before; at fp32 they see the masters
themselves, so each optimizer step, which writes every master, costs one
layout and one split launch a conv weight at the next call. Both kernels
count their launches (``_build.launches``: ``tap_layout``, ``tf32_split``).

``library_conv`` is the library branch of every 3x3 conv of the models,
stride 1 and 2. cuDNN gives an image other bits in another batch: on the
H100, 38 of the UNet's 49 stride-1 3x3 convs and one of its 3 stride-2 ones
differ between N = 16 (the DDPO sampler's 2B) and N = 4 (the trainer's),
and at one N, 22 of them with the image's position in the batch
(ddpo_torch/bench/batch_invariance.py, ``--variants``). So inside
``invariance.batch_invariant()`` a stride-1 conv on the card takes the
tap-GEMM kernel, which computes each image alone, and ``library_conv``'s
forward makes one cuDNN call an image (its backward stays one call over the
batch, as ``Conv3x3Direct``'s).

``conv3x3(..., quant=True)`` runs the W8A8 int8 conv of ops/quant.py
instead, whatever the switch and the mode.

``conv3x3(..., spatial=axis)`` is JAX's ``spatial_axis``: x is this rank's
rows of a map whose H is sharded over the axis (ops/spatial.py). The shard
takes one halo row from each neighbour, then convolves VALID over H and
SAME over W: the library conv with padding (0, 1), or the kernels' SAME
map on the (H_local + 2)-row frame with the first and last output rows
dropped. Each kept pixel reads the same nine taps in the same order, so
that is the VALID conv bit for bit, at the cost of two rows a shard
computed and dropped (6% at 32 local rows, 50% at 4). The backward is the
library conv's gradient, with zero cotangent on the dropped rows.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ddpo_torch.ops import _build, invariance
from ddpo_torch.ops.spatial import halo_exchange_rows

Padding = Union[int, Tuple[int, int]]

# offsets of the 9 taps in csrc/conv3x3.cu: (dy - 1, dx - 1), (dy - 1, 0), (0, 0)
TAP_MAPS = {"shift3x3": 0, "rows": 1, "none": 2}

_CONV_OVERRIDE: Optional[bool] = None

# id(source weight) -> (weakref to it, data_ptr, _version, its tap_weight layout)
_TAP_WEIGHTS: Dict[int, tuple] = {}
# id(fp32 source weight) -> (weakref, data_ptr, _version, its layout's tf32 split)
_TF32_SPLITS: Dict[int, tuple] = {}


def set_conv_kernel_enabled(value: Optional[bool]) -> None:
    """Force (True) or forbid (False) the direct kernel, or restore the
    automatic choice (None), which is the library conv. Read at each call."""
    global _CONV_OVERRIDE
    _CONV_OVERRIDE = value


def padded(n: int) -> int:
    """Cin and Cout of the laid-out weight: multiples of 8."""
    return (n + 7) // 8 * 8


def tap_gemm(x: torch.Tensor, w_nk: torch.Tensor, cout: int, tap_map: str,
             counter: str) -> torch.Tensor:
    """out[b, co, p] = sum over the 9 taps t and cin of x[b, cin, p + offset_t]
    * w_nk[co, t * padded(Cin) + cin], zero outside the map; on CUDA tensors
    only.

    x: contiguous (B, Cin, H, W); w_nk: ``tap_operand``'s contiguous
    (padded(cout), 9 * padded(Cin)) in x's dtype, twice the rows at fp32 (the
    split); the result (B, cout, H, W) has x's dtype. ``counter`` names the
    entry of ``_build.launches`` this launch adds to.
    """
    if not (x.is_cuda and w_nk.device == x.device):
        raise ValueError(f"tap_gemm runs on one CUDA device, got {x.device} and {w_nk.device}")
    if w_nk.dtype != x.dtype:
        raise TypeError(f"x is {x.dtype} but the weight is {w_nk.dtype}")
    code = _build.dtype_code(x.dtype)
    if x.dim() != 4 or not x.is_contiguous() or not w_nk.is_contiguous():
        raise ValueError("tap_gemm needs a contiguous NCHW x and a contiguous weight")
    b, cin, h, w = x.shape
    rows = padded(cout) * (2 if x.dtype == torch.float32 else 1)
    if tuple(w_nk.shape) != (rows, 9 * padded(cin)):
        raise ValueError(f"weight {tuple(w_nk.shape)} is not ({rows}, 9 * {padded(cin)})")
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    kl = _build.load_library()
    err = kl.lib.ddpo_tap_gemm(
        x.data_ptr(), w_nk.data_ptr(), out.data_ptr(), code, TAP_MAPS[tap_map],
        b, cin, h, w, cout, _build.stream_handle(x.device),
    )
    kl.check(err, f"{counter} launch")
    _build.launches[counter] += 1
    return out


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to tf32 (10 mantissa bits, to nearest, ties away
    from zero), as fp32: the card's ``cvt.rna.tf32.f32``, on the bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split_reference(w: torch.Tensor) -> torch.Tensor:
    """The split kernel's plain version: (hi, lo) of fp32 ``w`` stacked on
    dim 0, hi = tf32(w), lo = tf32(w - hi) (w - hi is exact in fp32)."""
    hi = tf32_round(w)
    return torch.cat([hi, tf32_round(w - hi)])


def _tf32_split(w: torch.Tensor) -> torch.Tensor:
    """The split kernel on a contiguous fp32 CUDA tensor."""
    out = torch.empty((2 * w.shape[0], *w.shape[1:]), dtype=w.dtype, device=w.device)
    kl = _build.load_library()
    kl.check(kl.lib.ddpo_tf32_split(w.data_ptr(), out.data_ptr(), w.numel(),
                                    _build.stream_handle(w.device)), "tf32 split launch")
    _build.launches["tf32_split"] += 1
    return out


def tap_weight_reference(weight: torch.Tensor) -> torch.Tensor:
    """The layout's plain version: OIHW (Cout, Cin, 3, 3) -> (padded(Cout),
    9 * padded(Cin)), row co holding taps (dy, dx) in order, each its Cin
    values then zeros; rows past Cout are zeros."""
    cout, cin = weight.shape[:2]
    w = F.pad(weight.permute(0, 2, 3, 1), (0, padded(cin) - cin, 0, 0, 0, 0, 0,
                                            padded(cout) - cout))
    return w.reshape(padded(cout), -1).contiguous()


def cached_per_version(store: Dict[int, tuple], source: torch.Tensor, make: Callable):
    """``make()``, computed once while ``source`` lives and is not written to:
    kept in ``store`` under id(source) with a weak reference to it and its
    ``data_ptr()`` and ``_version``, dropped when it dies."""
    key = (source.data_ptr(), source._version)
    entry = store.get(id(source))
    if entry is not None and entry[0]() is source and entry[1:3] == key:
        return entry[3]
    value = make()
    ident = id(source)
    store[ident] = (weakref.ref(source, lambda _: store.pop(ident, None)), *key, value)
    return value


def _lay_out(w: torch.Tensor, cout: int, cin: int, strides) -> torch.Tensor:
    """The layout kernel on ``w``, whose element (co, tap, ci) sits at the
    element strides (s_co, s_tap, s_ci)."""
    out = torch.empty((padded(cout), 9 * padded(cin)), dtype=w.dtype, device=w.device)
    kl = _build.load_library()
    kl.check(kl.lib.ddpo_conv_tap_weight(w.data_ptr(), out.data_ptr(), _build.dtype_code(w.dtype),
                                         cout, cin, *strides, _build.stream_handle(w.device)),
             "conv weight layout launch")
    _build.launches["tap_layout"] += 1
    return out


def tap_weight(weight: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> the layout (padded(Cout), 9 * padded(Cin)),
    made anew at each call: on a CUDA tensor by the layout kernel, on a CPU
    tensor ``tap_weight_reference``. ``tap_gemm`` takes ``tap_operand``'s
    operand, which is this layout (its tf32 split at fp32) kept per weight
    version."""
    if weight.device.type == "cpu":
        return tap_weight_reference(weight.detach())
    if weight.device.type != "cuda" or weight.dim() != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"tap_weight takes a CUDA OIHW 3x3 weight, got {tuple(weight.shape)} "
                         f"on {weight.device}")
    cout, cin = weight.shape[:2]
    return _lay_out(weight.detach().contiguous(), cout, cin, (9 * cin, 1, 9))


def tap_weight_kn(w_kn: torch.Tensor) -> torch.Tensor:
    """``tap_weight``'s layout from a (9, Cin, Cout)-ordered weight of 9 * Cin
    * Cout values, (tap, cin) major, as the conv probes take theirs (any
    shape that reshapes to (9 * Cin, Cout) with Cout last)."""
    cout = w_kn.shape[-1]
    cin = w_kn.numel() // (9 * cout)
    if w_kn.device.type == "cpu":
        return tap_weight_reference(w_kn.detach().reshape(3, 3, cin, cout).permute(3, 2, 0, 1))
    return _lay_out(w_kn.detach().contiguous(), cout, cin, (1, cin * cout, cout))


def _operand(source: torch.Tensor, lay_out: Callable) -> torch.Tensor:
    """``tap_gemm``'s operand from a CUDA weight, once per version of it:
    ``lay_out()``, or at fp32 its tf32 split alone."""
    if source.dtype == torch.float32:
        return cached_per_version(_TF32_SPLITS, source, lambda: _tf32_split(lay_out()))
    return cached_per_version(_TAP_WEIGHTS, source, lay_out)


def tap_operand(weight: torch.Tensor) -> torch.Tensor:
    """The tap-GEMM's weight operand from a CUDA OIHW 3x3 weight: ``tap_weight``'s
    layout, or at fp32 its tf32 split (twice the rows), made once per weight
    version."""
    return _operand(weight, lambda: tap_weight(weight))


def tap_operand_kn(w_kn: torch.Tensor) -> torch.Tensor:
    """``tap_operand`` from a (9, Cin, Cout)-ordered CUDA weight, as the conv
    probes take theirs (``tap_weight_kn``)."""
    return _operand(w_kn, lambda: tap_weight_kn(w_kn))


def conv3x3_reference(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version, written out as the 9-tap sum: zero-padded
    shifted windows, one product over Cin per tap, summed in (dy, dx)
    order in fp32; the result has x's dtype."""
    h, w = x.shape[2:]
    xp = F.pad(x.float(), (1, 1, 1, 1))
    wf = weight.float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = torch.einsum("bchw,oc->bohw", xp[:, :, dy:dy + h, dx:dx + w],
                                wf[:, :, dy, dx])
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def conv3x3_direct(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The product of JAX's ``conv3x3_direct`` without its bias: x
    (N, Cin, H, W), weight (Cout, Cin, 3, 3) -> (N, Cout, H, W) in x's dtype.

    CUDA tensors run the kernel; CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return conv3x3_reference(x, weight)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3x3 kernel for device {x.device}")
    if weight.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x {tuple(x.shape)}")
    return tap_gemm(x.contiguous(), tap_operand(weight), weight.shape[0], "shift3x3",
                    "conv3x3")


def _library_grads(ctx, x, weight, g, stride: int, padding: Padding):
    """The library conv's input and weight gradients, where asked for."""
    gx = gw = None
    if ctx.needs_input_grad[0]:
        gx = torch.nn.grad.conv2d_input(x.shape, weight, g, stride=stride, padding=padding)
    if ctx.needs_input_grad[1]:
        gw = torch.nn.grad.conv2d_weight(x, weight.shape, g, stride=stride, padding=padding)
    return gx, gw


class Conv3x3Direct(torch.autograd.Function):
    """``conv3x3_direct`` under autograd (JAX's ``_conv3x3_pallas_op``): the
    backward is the library conv's input and weight gradients."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return conv3x3_direct(x, weight)

    @staticmethod
    def backward(ctx, g):
        # read once: under a non-reentrant checkpoint a second read raises
        x, weight = ctx.saved_tensors
        return _library_grads(ctx, x, weight, g, 1, 1)


def library_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 stride: int = 1, padding: Padding = 1) -> torch.Tensor:
    """``F.conv2d`` (``padding`` an int or (H, W)); inside ``batch_invariant()``
    on the card its forward makes one cuDNN call an image."""
    if x.is_cuda and invariance.enabled() and x.shape[0] > 1:
        return ConvPerImage.apply(x, weight, bias, stride, padding)
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)


class ConvPerImage(torch.autograd.Function):
    """``F.conv2d`` one image a call; the backward is the library conv's
    gradients over the whole batch, one call each."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, bias is not None)
        return invariance.in_pieces(
            lambda part: F.conv2d(part, weight, bias, stride=stride, padding=padding), [x], 1)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors  # read once, as in Conv3x3Direct
        stride, padding, has_bias = ctx.conv
        gx, gw = _library_grads(ctx, x, weight, g, stride, padding)
        gb = g.sum((0, 2, 3)) if has_bias and ctx.needs_input_grad[2] else None
        return gx, gw, gb, None, None


def conv3x3(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
    quant: bool = False, spatial=None,
) -> torch.Tensor:
    """x (N, Cin, H, W), weight (Cout, Cin, 3, 3) -> (N, Cout, H, W).

    ``quant``: the W8A8 int8 conv of ops/quant.py, for inference sampling;
    it takes precedence over ``set_conv_kernel_enabled`` and
    ``batch_invariant()``, as in JAX (the s8 kernel has no float variant to
    switch to, and its integer sums are batch invariant already).

    ``spatial``: an ops.spatial.Axis over which x's H is sharded (module
    docstring).
    """
    rows = 1  # padding over H: SAME, or VALID over a halo'd shard
    if spatial is not None:
        x = halo_exchange_rows(x, spatial)
        rows = 0
    if quant:
        from ddpo_torch.ops.quant import conv3x3_w8a8

        return conv3x3_w8a8(x, weight, bias, padding=((rows, rows), (1, 1)))
    use_kernel = _CONV_OVERRIDE or (
        _CONV_OVERRIDE is None and x.is_cuda and invariance.enabled())
    if not use_kernel:
        return library_conv(x, weight, bias, padding=(rows, 1))
    out = Conv3x3Direct.apply(x, weight.to(x.dtype))
    if not rows:  # the SAME map's first and last rows read the zero pad: drop them
        out = out[:, :, 1:-1].contiguous()
    if bias is not None:
        out = out + bias.to(out.dtype)[:, None, None]
    return out
