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
// fp32 (tap_gemm_kernel) stays on the CUDA cores in FMA: TF32 tensor cores
// keep 10 mantissa bits and would break the 1e-4 bounds against the fp32
// plain version. A block computes a 128-pixel x 64-channel tile of one
// image with 256 threads, each owning 8 pixels x 4 channels; K streams
// through two shared buffers in stages of 16, gathered per tap straight
// from NCHW x with masks (no padded copies in device memory). Ragged pixel
// counts, Cin (K = 36 at the UNet's conv_in) and Cout (4 at its conv_out)
// are masked in the kernel on both paths.

#include "common.cuh"
#include "mma.cuh"
#include "tap_tiles.cuh"

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // K values (tap, cin) per stage
constexpr int NT = 256;  // threads: 16 (pixels) x 16 (channels)
constexpr int kTaps = 9;

// Cin and Cout of the laid-out weight: multiples of 8 (16-byte rows for TMA)
__host__ __device__ constexpr int padded(int n) { return (n + 7) / 8 * 8; }

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

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
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
  const int cin_p = padded(Cin);
  __shared__ __align__(16) float Bs[2][BK][BN + 4];  // + 4: the K-major loads' stores spread

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
  // B loader: K row b_k of each stage, channels n0 + b_n + 16 j (j < 4);
  // 16 neighbouring threads read 16 neighbouring K values of one channel
  const int b_k = tid % BK;
  const int b_n = tid / BK;

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
    const int k = k0 + b_k, kt = k / Cin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + b_n + 16 * j;
      b_reg[j] = (n < Cout && k < K)
                     ? ddpo::to_float(w[(int64_t(n) * kTaps + kt) * cin_p + (k - kt * Cin)])
                     : 0.f;
    }
    advance(tap, ci, BK, Cin);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) As[buf][a_k + 2 * j][a_m] = a_reg[j];
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[buf][b_k][b_n + 16 * j] = b_reg[j];
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
        store4(orow + p, r[0 * 4 + j], r[1 * 4 + j], r[2 * 4 + j], r[3 * 4 + j]);
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
// pads (ddpo_conv_tap_weight lays it out); out: contiguous (B, Cout, H, W),
// all in the dtype given. map: 0 shifted 3x3 (SAME zero padding), 1 row
// shift only, 2 no shift. Returns cudaGetLastError() (0 on success).
extern "C" int ddpo_tap_gemm(const void* x, const void* w, void* out, int dtype, int map,
                             int B, int Cin, int H, int W, int Cout, void* stream) {
  const int64_t hw = int64_t(H) * W;
  if (B < 1 || B > 65535 || Cin < 1 || H < 1 || W < 1 || Cout < 1 || map < 0 || map > 2 ||
      (Cout + BN - 1) / BN > 65535 || int64_t(Cin) * hw > 0x7fffffff ||
      int64_t(Cout) * hw > 0x7fffffff ||
      int64_t(kTaps) * padded(Cin) * padded(Cout) > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ddpo::kFloat32)
    return int(dispatch_map<float>(map, x, w, out, B, Cin, H, W, Cout, s));
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
