// Tap-GEMM for sm_90a: the direct 3x3 convolution and the conv probes.
//
// Replaces: ddpo_tpu/ops/conv.py::_conv3x3_kernel (stride-1 SAME 3x3 conv,
// the Pallas kernel behind conv3x3 with set_conv_kernel_enabled(True)) and
// the four Pallas probes of bench_conv_probe.py: p1_kernel, p2_kernel,
// p6_kernel and p7_kernel. All five compute a sum over 9 taps of
// (pixels x Cin) x (Cin x Cout) products, each tap reading x at an offset:
//   TapMap 0 (conv3x3, p6, p7): (dy - 1, dx - 1) for tap = 3 * dy + dx;
//   TapMap 1 (p2): (dy - 1, 0), the row shift only;
//   TapMap 2 (p1): (0, 0), no shift.
// The weight is laid out once per weight by tap_weight_kernel as
// (Cout, 9, Cin) padded to multiples of 8, K = (tap, cin) contiguous for
// each output: JAX's kfold (dy, dx, cin) order, transposed. p6 and p7 group
// the same K differently for the TPU's MXU, which the card does not need.
// x and out are NCHW.
//
// What bounds it on this card: 2*B*H*W*9*Cin*Cout flops against a few MB of
// maps, so the operations: 0.061 ms at (8, 320, 64, 64) -> 320 on the bf16
// tensor cores, against 13 us for the bytes.
//
// bf16 (tap_gemm_wgmma_kernel): the Hopper tap-GEMM of tap_tiles.cuh, bf16
// in and fp32 sums on wgmma.m64nNk16 with A from registers, the weight by
// TMA through a 4-deep ring of mbarrier-paced tiles, x staged by the
// producer warpgroup a 64-channel chunk at a time. The epilogue rounds to
// bf16 and writes NCHW, masking pixels past the tile and channels past Cout.
// Every output element has one owner that adds its terms in one fixed order
// (chunk, tap, k step), with the wgmma's N a function of Cout alone, so two
// calls give the same bits and image i alone gives the bits it gets inside
// a batch. It is not JAX's (dy, dx, cin) order, which only moves the fp32
// rounding.
//
// fp32 (tap_gemm_tf32_kernel): the same tap-GEMM on the tensor cores as
// 3xTF32 products (wgmma.cuh): x and each weight value split into two tf32
// values, three wgmma.m64nNk8 products into fp32 sums, the two small ones
// first. A staged row holds 32 fp32 channels, so a chunk is 32 channels and
// four k8 steps a tap; ldmatrix gives the tf32 A fragments at the bf16
// addresses, and the consumers split them in registers. The weight comes
// split once per weight version (tf32_split_kernel: its hi rows, then its lo
// rows), a ring stage holding the hi and the lo tile of a (chunk, tap). The
// tensor cores round their sums toward zero, so each tap's 12 products are
// a fresh sum, added into the running ones in registers with Kahan's
// compensation; the three sets of sums take N / 2 registers each, so N is
// at most 64 (tap_tiles.cuh pick_n_tf32). The summation order is fixed as
// in bf16: (chunk, tap, k step, the three products). Bound: the
// 3xTF32 products, 3 * 2*B*H*W*9*Cin*Cout over 494.7 TFLOP/s: 0.366 ms at
// (8, 320, 64, 64) -> 320 (0.902 ms for the plain flops at the 67 TFLOP/s
// of the CUDA cores). Ragged pixel counts, Cin (K = 36 at the UNet's
// conv_in) and Cout (4 at its conv_out) are masked in the kernel on both
// paths.

#include "common.cuh"
#include "mma.cuh"
#include "tap_tiles.cuh"

namespace {

constexpr int kTaps = 9;

// Cin and Cout of the laid-out weight: multiples of 8 (16-byte rows for TMA)
__host__ __device__ constexpr int padded(int n) { return (n + 7) / 8 * 8; }

// ---- bf16 on the tensor cores: the Hopper tap-GEMM of tap_tiles.cuh ----

template <int N>
__global__ void __launch_bounds__(3 * ddpo::tap::WG, 1)
    tap_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap wmap, const ddpo::tap::Args a) {
  ddpo::tap::tap_gemm_block<false, N>(&wmap, a);
}

template <int N>
cudaError_t launch_wgmma_n(const ddpo::tap::Args& a, const void* w, cudaStream_t stream) {
  return ddpo::tap::launch_n<N>(tap_gemm_wgmma_kernel<N>, a, w, 2, padded(a.Cout), padded(a.Cin),
                                stream);
}

cudaError_t launch_wgmma(int map, const void* x, const void* w, void* out, int B, int Cin, int H,
                         int W, int Cout, cudaStream_t stream) {
  if (int64_t(B) * (H + 2) * (W + 2) >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  ddpo::tap::Args a{};
  a.x = x, a.out = out, a.B = B, a.Cin = Cin, a.H = H, a.W = W, a.Cout = Cout, a.map = map;
  a.vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch (ddpo::tap::pick_n(Cout)) {
    case 160: return launch_wgmma_n<160>(a, w, stream);
    case 128: return launch_wgmma_n<128>(a, w, stream);
    case 64: return launch_wgmma_n<64>(a, w, stream);
    case 32: return launch_wgmma_n<32>(a, w, stream);
    default: return launch_wgmma_n<8>(a, w, stream);
  }
}

// ---- fp32 on the tensor cores: 3xTF32 ----

template <int N>
__global__ void __launch_bounds__(3 * ddpo::tap::WG, 1)
    tap_gemm_tf32_kernel(const __grid_constant__ CUtensorMap wmap, const ddpo::tap::Args a) {
  ddpo::tap::tap_gemm_block<false, N, true, true>(&wmap, a);
}

template <int N>
cudaError_t launch_tf32_n(const ddpo::tap::Args& a, const void* w, cudaStream_t stream) {
  return ddpo::tap::launch_n<N>(tap_gemm_tf32_kernel<N>, a, w, 4, 2 * padded(a.Cout),
                                padded(a.Cin), stream, true);
}

// w: the split weight, (2 padded(Cout), 9, padded(Cin)) fp32, hi rows then lo
cudaError_t launch_tf32(int map, const void* x, const void* w, void* out, int B, int Cin, int H,
                        int W, int Cout, cudaStream_t stream) {
  if (int64_t(B) * (H + 2) * (W + 2) >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  ddpo::tap::Args a{};
  a.x = x, a.out = out, a.B = B, a.Cin = Cin, a.H = H, a.W = W, a.Cout = Cout, a.map = map;
  a.wlo = padded(Cout);
  a.vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch (ddpo::tap::pick_n_tf32(Cout)) {
    case 64: return launch_tf32_n<64>(a, w, stream);
    case 32: return launch_tf32_n<32>(a, w, stream);
    default: return launch_tf32_n<8>(a, w, stream);
  }
}

// out[i] = tf32(w[i]) and out[n + i] = tf32(w[i] - out[i]): the split of an
// fp32 weight into its hi and lo halves (wgmma.cuh tf32_split)
__global__ void __launch_bounds__(256) tf32_split_kernel(const float* __restrict__ w,
                                                         uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x;
  if (i < n) ddpo::tf32_split(w[i], out[i], out[n + i]);
}

// (co, tap, ci) of a weight at element strides (s_co, s_tap, s_ci) ->
// (padded(Cout), 9, padded(Cin)), the tap-GEMMs' K-major operand, zeros in
// the pads: one thread a (co, ci), reading its 9 taps and writing each
// along ci, so a warp writes 64 contiguous bytes a tap.
template <typename T>
__global__ void __launch_bounds__(256) tap_weight_kernel(const T* __restrict__ w,
                                                         T* __restrict__ out, int Cout, int Cin,
                                                         int64_t s_co, int64_t s_tap,
                                                         int64_t s_ci) {
  const int cin_p = padded(Cin);
  const int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x;
  if (i >= int64_t(padded(Cout)) * cin_p) return;
  const int co = int(i / cin_p), ci = int(i - int64_t(co) * cin_p);
  const bool ok = co < Cout && ci < Cin;
#pragma unroll
  for (int tap = 0; tap < kTaps; ++tap)
    out[(int64_t(co) * kTaps + tap) * cin_p + ci] =
        ok ? w[co * s_co + tap * s_tap + ci * s_ci] : T(0);
}

}  // namespace

// x: contiguous NCHW (B, Cin, H, W); w: contiguous (padded(Cout), 9,
// padded(Cin)), output-major with K in (tap, cin) order and zeros in the
// pads (ddpo_conv_tap_weight lays it out), and at fp32 its split, twice as
// many rows: the hi rows, then the lo rows (ddpo_tf32_split); out:
// contiguous (B, Cout, H, W), all in the dtype given. map: 0 shifted 3x3
// (SAME zero padding), 1 row shift only, 2 no shift. Returns
// cudaGetLastError() (0 on success).
extern "C" int ddpo_tap_gemm(const void* x, const void* w, void* out, int dtype, int map,
                             int B, int Cin, int H, int W, int Cout, void* stream) {
  const int64_t hw = int64_t(H) * W;
  if (B < 1 || B > 65535 || Cin < 1 || H < 1 || W < 1 || Cout < 1 || map < 0 || map > 2 ||
      int64_t(Cin) * hw > 0x7fffffff || int64_t(Cout) * hw > 0x7fffffff ||
      int64_t(2 * kTaps) * padded(Cin) * padded(Cout) > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ddpo::kFloat32)
    return int(launch_tf32(map, x, w, out, B, Cin, H, W, Cout, s));
  if (dtype == ddpo::kBFloat16)
    return int(launch_wgmma(map, x, w, out, B, Cin, H, W, Cout, s));
  return int(cudaErrorInvalidValue);
}

// w: a weight of `dtype` whose element (co, tap, ci) sits at
// co * s_co + tap * s_tap + ci * s_ci (OIHW: 9 Cin, 1, 9; a (9 Cin, Cout)
// matrix: 1, Cin Cout, Cout); out: contiguous (padded(Cout), 9,
// padded(Cin)), the layout ddpo_tap_gemm reads. Returns cudaGetLastError().
extern "C" int ddpo_conv_tap_weight(const void* w, void* out, int dtype, int Cout, int Cin,
                                    int64_t s_co, int64_t s_tap, int64_t s_ci, void* stream) {
  if (Cout < 1 || Cin < 1 || int64_t(kTaps) * padded(Cin) * padded(Cout) > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = unsigned((int64_t(padded(Cout)) * padded(Cin) + 255) / 256);
  // a copy: moved as raw 4- or 2-byte words
  if (dtype == ddpo::kFloat32)
    tap_weight_kernel<uint32_t><<<blocks, 256, 0, s>>>(static_cast<const uint32_t*>(w),
                                                       static_cast<uint32_t*>(out), Cout, Cin,
                                                       s_co, s_tap, s_ci);
  else if (dtype == ddpo::kBFloat16)
    tap_weight_kernel<uint16_t><<<blocks, 256, 0, s>>>(static_cast<const uint16_t*>(w),
                                                       static_cast<uint16_t*>(out), Cout, Cin,
                                                       s_co, s_tap, s_ci);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// w: n fp32 values; out: 2 n, the tf32 hi of each value, then its lo (what
// ddpo_tap_gemm reads at fp32). Returns cudaGetLastError().
extern "C" int ddpo_tf32_split(const void* w, void* out, int64_t n, void* stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  tf32_split_kernel<<<unsigned((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<uint32_t*>(out), n);
  return int(cudaGetLastError());
}
