// Tap-GEMM for sm_90a: the direct 3x3 convolution and the conv probes.
//
// Replaces: ddpo_tpu/ops/conv.py::_conv3x3_kernel (stride-1 SAME 3x3 conv,
// the Pallas kernel behind conv3x3 with set_conv_kernel_enabled(True)) and
// the four Pallas probes of bench_conv_probe.py: p1_kernel, p2_kernel,
// p6_kernel and p7_kernel. All five compute, per image, a sum over 9 taps of
// (pixels x Cin) x (Cin x Cout) products, each tap reading x at an offset:
//   TapMap 0 (conv3x3, p6, p7): (dy - 1, dx - 1) for tap = 3 * dy + dx;
//   TapMap 1 (p2): (dy - 1, 0), the row shift only;
//   TapMap 2 (p1): (0, 0), no shift.
// It is one implicit GEMM per image: M = H*W pixels, N = Cout, K = 9*Cin in
// (tap, cin) order, which is the (dy, dx, cin) order of JAX's kfold; p6 and
// p7 group the same K differently for the TPU's MXU, which the card does not
// need.
//
// What bounds it on this card: 2*B*H*W*9*Cin*Cout flops against a few MB of
// maps, so the operations. This first version runs on the CUDA cores in fp32
// FMA (67 TFLOP/s), not the tensor cores (989 TFLOP/s in bf16), so the FMA
// rate and the shared-memory loads that feed it are the limit.
//
// What the design does about it: a block computes a 128-pixel x 64-channel
// output tile with 256 threads, each owning 8 pixels x 4 channels, so three
// 16-byte shared-memory loads feed 32 FMAs. K streams through two shared
// buffers in stages of 16: each thread gathers its part of the next stage
// into registers (A straight from NCHW x, with the zero padding done by
// masks: there are no padded or shifted copies in device memory; B from the
// (9*Cin, Cout) weight) while the current stage is multiplied. Sums are fp32
// and each output element has one owner that adds its K terms in order: no
// split K and no atomics, so the same inputs give the same bits. Ragged
// pixel counts, Cin (K = 36 at the UNet's conv_in) and Cout (4 at its
// conv_out) are masked in the kernel. mma.sync / wgmma tiles are later work.

#include "common.cuh"

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // K values (tap, cin) per stage
constexpr int NT = 256;  // threads: 16 (pixels) x 16 (channels)
constexpr int kTaps = 9;

template <int MAP>
__device__ __forceinline__ void tap_offset(int tap, int& oy, int& ox) {
  if constexpr (MAP == 2) {
    oy = 0;
    ox = 0;
  } else {
    oy = tap >= 6 ? 1 : (tap >= 3 ? 0 : -1);
    ox = MAP == 0 ? tap - 3 * (oy + 1) - 1 : 0;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c, float d);
template <>
__device__ __forceinline__ void store4<float>(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float a, float b,
                                                      float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// advance (tap, ci) by `step` values of K = (tap, cin)
__device__ __forceinline__ void advance(int& tap, int& ci, int step, int Cin) {
  ci += step;
  while (ci >= Cin) {
    ci -= Cin;
    ++tap;
  }
}

template <typename T, int MAP>
__global__ void __launch_bounds__(NT) tap_gemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int Cin,
    int H, int W, int Cout) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int K = kTaps * Cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int64_t img = blockIdx.z;
  const T* xb = x + img * int64_t(Cin) * HW;
  T* ob = out + img * int64_t(Cout) * HW;

  // A loader: pixel m0 + a_m, K rows a_k + 2 j of each stage (j < 8)
  const int a_m = tid % BM;
  const int a_k = tid / BM;
  const int pix = m0 + a_m;
  const bool pix_ok = pix < HW;
  const int ph = pix_ok ? pix / W : 0;
  const int pw = pix_ok ? pix - ph * W : 0;
  // B loader: channel n0 + b_n, K rows b_k + 4 j of each stage (j < 4)
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  const bool n_ok = n0 + b_n < Cout;

  float a_reg[8], b_reg[4];
  // (tap, ci) of the K row a_k of the next stage to load
  int tap = 0, ci = 0;
  advance(tap, ci, a_k, Cin);

  auto load = [&](int k0) {
    int t = tap, c = ci;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = 0.f;
      if (pix_ok && t < kTaps) {
        int oy, ox;
        tap_offset<MAP>(t, oy, ox);
        const int hh = ph + oy, ww = pw + ox;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W) v = ddpo::to_float(xb[c * HW + hh * W + ww]);
      }
      a_reg[j] = v;
      advance(t, c, 2, Cin);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + b_k + 4 * j;
      b_reg[j] = (n_ok && k < K) ? ddpo::to_float(w[int64_t(k) * Cout + n0 + b_n]) : 0.f;
    }
    advance(tap, ci, BK, Cin);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) As[buf][a_k + 2 * j][a_m] = a_reg[j];
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[buf][b_k + 4 * j][b_n] = b_reg[j];
  };

  // compute: pixels tx*4 .. +3 and 64 + tx*4 .. +3, channels ty*4 .. +3
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load((kt + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][tx * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + tx * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][k][ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    // the other buffer was last read before the barrier that ended stage kt-1
    if (more) store(buf ^ 1);
    __syncthreads();
  }

  // epilogue: 4 consecutive pixels of one channel per store where they are
  // all inside the map and H*W keeps them aligned; single stores elsewhere
  const bool vec = HW % 4 == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = n0 + ty * 4 + j;
    if (co >= Cout) continue;
    T* orow = ob + int64_t(co) * HW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + half * 64 + tx * 4;
      const float* r = &acc[half * 4][0];
      if (vec && p + 3 < HW) {
        store4<T>(orow + p, r[0 * 4 + j], r[1 * 4 + j], r[2 * 4 + j], r[3 * 4 + j]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (p + i < HW) orow[p + i] = ddpo::from_float<T>(r[i * 4 + j]);
      }
    }
  }
}

template <typename T, int MAP>
cudaError_t launch(const void* x, const void* w, void* out, int B, int Cin, int H, int W,
                   int Cout, cudaStream_t stream) {
  const dim3 grid((H * W + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  tap_gemm_kernel<T, MAP><<<grid, NT, 0, stream>>>(static_cast<const T*>(x),
                                                   static_cast<const T*>(w),
                                                   static_cast<T*>(out), Cin, H, W, Cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_map(int map, const void* x, const void* w, void* out, int B, int Cin,
                         int H, int W, int Cout, cudaStream_t stream) {
  switch (map) {
    case 0:
      return launch<T, 0>(x, w, out, B, Cin, H, W, Cout, stream);
    case 1:
      return launch<T, 1>(x, w, out, B, Cin, H, W, Cout, stream);
    case 2:
      return launch<T, 2>(x, w, out, B, Cin, H, W, Cout, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: contiguous NCHW (B, Cin, H, W); w: contiguous (9 * Cin, Cout), K in
// (tap, cin) order (HWIO for a 3x3 filter); out: contiguous (B, Cout, H, W),
// all in the dtype given. map: 0 shifted 3x3 (SAME zero padding), 1 row
// shift only, 2 no shift. Returns cudaGetLastError() (0 on success).
extern "C" int ddpo_tap_gemm(const void* x, const void* w, void* out, int dtype, int map,
                             int B, int Cin, int H, int W, int Cout, void* stream) {
  const int64_t hw = int64_t(H) * W;
  if (B < 1 || B > 65535 || Cin < 1 || H < 1 || W < 1 || Cout < 1 ||
      (Cout + BN - 1) / BN > 65535 || int64_t(Cin) * hw > 0x7fffffff ||
      int64_t(Cout) * hw > 0x7fffffff || int64_t(kTaps) * Cin * Cout > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ddpo::kFloat32)
    return int(dispatch_map<float>(map, x, w, out, B, Cin, H, W, Cout, s));
  if (dtype == ddpo::kBFloat16)
    return int(dispatch_map<__nv_bfloat16>(map, x, w, out, B, Cin, H, W, Cout, s));
  return int(cudaErrorInvalidValue);
}
