// s8 tap-GEMM for sm_90a: the W8A8 3x3 convolution of the quantized UNet,
// with the activations' quantize pass fused into its staging.
//
// Replaces: the int8 convolution inside ddpo_tpu/ops/quant.py::conv3x3_w8a8,
// an XLA op there (lax.conv_general_dilated over int8 codes with an int32
// accumulator, then the fp32 rescale), not a Pallas kernel. PyTorch has no
// int8 convolution on CUDA, and an im2col + torch._int_mm would move nine
// times the activation bytes. For a stride-1 SAME 3x3 conv it computes
//   xq[b, cin, p] = clamp(rint(x[b, cin, p] / sx[b]), -127, 127)
//   acc[b, co, p] = sum over taps t and cin of xq[b, cin, p + off_t] * wq[co, t, cin]
// exactly in int32, then JAX's epilogue in JAX's order,
//   out = (float(acc) * (sx[b] * sw[co])) + bias[co]
// with __int2float_rn, __fmul_rn and __fadd_rn (nvcc would otherwise
// contract the multiply and the add into an FMA, which rounds once where
// the plain version rounds twice), rounded to the output dtype (bf16 or
// fp32); a bf16 bias is read as its exact fp32 value. x is NCHW bf16 or fp32 and is read once: each code is made while x
// is staged (__fdiv_rn, then __float2int_rn, half to even as torch.round),
// and no int8 copy of x is written. wq is (Cout, 9, Cin16) int8 codes in
// (tap, cin) order, K-contiguous, Cin padded with zero codes to a multiple
// of 16 (16-byte rows for TMA); sx is (B,) and sw (Cout,), fp32; bias
// (Cout,) is fp32 or bf16.
//
// What bounds it on this card: 2*B*H*W*9*Cin*Cout integer operations over
// 1979 TOPS (int8 dense), above the bytes (bf16 x in, bf16 out) at every
// UNet shape: 0.031 ms at (8, 320, 64, 64) -> 320; 0.015 ms at (8, 2560, 8, 8)
// -> 1280, where the 29.5 MB of int8 weight take 0.009 ms.
//
// Design: the Hopper tap-GEMM of tap_tiles.cuh with int8 operands on
// wgmma.m64nNk32 (s8 x s8 -> s32), A from registers: a staged row is 128
// codes of one position, so a chunk is 128 input channels and four k32
// steps a tap, and the weight's (tap, 128 channels, N outputs) tile comes
// by TMA as it is stored. Integer sums are exact in any order, so the bits
// depend neither on the batch nor on the tile: image i alone gives its
// slice.

#include "tap_tiles.cuh"

namespace {

// XF32: x is fp32 (else bf16)
template <int N, bool XF32>
__global__ void __launch_bounds__(3 * ddpo::tap::WG, 1)
    tap_gemm_s8_wgmma_kernel(const __grid_constant__ CUtensorMap wmap, const ddpo::tap::Args a) {
  ddpo::tap::tap_gemm_block<true, N, XF32>(&wmap, a);
}

template <int N>
cudaError_t launch_s8_n(const ddpo::tap::Args& a, bool x_f32, const void* w,
                        cudaStream_t stream) {
  const int kpad = (a.Cin + 15) / 16 * 16;
  if (x_f32)
    return ddpo::tap::launch_n<N>(tap_gemm_s8_wgmma_kernel<N, true>, a, w, 1, a.Cout, kpad,
                                  stream);
  return ddpo::tap::launch_n<N>(tap_gemm_s8_wgmma_kernel<N, false>, a, w, 1, a.Cout, kpad,
                                stream);
}

}  // namespace

// x: contiguous NCHW (B, Cin, H, W), x_dtype float32 or bfloat16; w:
// contiguous int8 (Cout, 9, Cin16) in (tap, cin) order, Cin16 = Cin rounded
// up to 16 with zero codes; sx (B,) and sw (Cout,) fp32; bias (Cout,) in
// bias_dtype (float32 or bfloat16) or null; out: contiguous (B, Cout, H, W)
// in out_dtype (float32 or bfloat16). Returns cudaGetLastError() (0 on
// success).
extern "C" int ddpo_tap_gemm_s8(const void* x, const void* w, const void* sx, const void* sw,
                                const void* bias, void* out, int x_dtype, int bias_dtype,
                                int out_dtype, int B, int Cin, int H, int W, int Cout,
                                void* stream) {
  const int64_t hw = int64_t(H) * W;
  if (B < 1 || Cin < 1 || H < 1 || W < 1 || Cout < 1 || int64_t(Cin) * hw > 0x7fffffff ||
      int64_t(Cout) * hw > 0x7fffffff || int64_t(9) * (Cin + 15) * Cout > 0x7fffffff ||
      int64_t(B) * (H + 2) * (W + 2) >= (int64_t(1) << 31) ||
      (x_dtype != ddpo::kFloat32 && x_dtype != ddpo::kBFloat16) ||
      (bias_dtype != ddpo::kFloat32 && bias_dtype != ddpo::kBFloat16) ||
      (out_dtype != ddpo::kFloat32 && out_dtype != ddpo::kBFloat16))
    return int(cudaErrorInvalidValue);
  ddpo::tap::Args a{};
  a.x = x, a.out = out, a.B = B, a.Cin = Cin, a.H = H, a.W = W, a.Cout = Cout;
  a.sx = static_cast<const float*>(sx), a.sw = static_cast<const float*>(sw);
  a.bias = bias, a.bias_bf16 = bias_dtype == ddpo::kBFloat16;
  a.out_f32 = out_dtype == ddpo::kFloat32;
  const bool x_f32 = x_dtype == ddpo::kFloat32;
  a.vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ddpo::tap::pick_n(Cout)) {
    case 160: return int(launch_s8_n<160>(a, x_f32, w, s));
    case 128: return int(launch_s8_n<128>(a, x_f32, w, s));
    case 64: return int(launch_s8_n<64>(a, x_f32, w, s));
    case 32: return int(launch_s8_n<32>(a, x_f32, w, s));
    default: return int(launch_s8_n<8>(a, x_f32, w, s));
  }
}
