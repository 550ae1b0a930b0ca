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
// The weight is (9*Cin, Cout) in (tap, cin) order, JAX's kfold (dy, dx, cin)
// for the conv; p6 and p7 group the same K differently for the TPU's MXU,
// which the card does not need. x and out are NCHW.
//
// What bounds it on this card: 2*B*H*W*9*Cin*Cout flops against a few MB of
// maps, so the operations: 0.061 ms at (8, 320, 64, 64) -> 320 on the bf16
// tensor cores, against 13 us for the bytes.
//
// bf16, on the tensor cores (tap_gemm_mma_kernel): an implicit GEMM with
// M = B*H*W output pixels flattened over (image, pixel), N = Cout and
// K = 9*Cin, run with mma.sync.m16n8k16 (bf16 in, fp32 accumulate).
//   - Tile: 128 pixels x 64 channels, 4 warps of 64 x 32; 64 or 32 pixels
//     (warps of 32 or 16 x 32) where 128 would give fewer than two blocks
//     per SM, as at the 8x8 bottom. Maps of at least the tile's pixels are
//     cut into tiles image by image; smaller maps pack whole images (two
//     8x8 maps to a 128-pixel tile), so no tile is half masked.
//   - K is consumed in chunks of 16 input channels. Per chunk the block
//     stages the haloed input once: the tile's pixels and their neighbours
//     in a padded (H+2) x (W+2) frame, one shared row of 16 bf16 channels
//     per padded position, zeros where the frame pads the image. Each tap
//     is then an ldmatrix whose row addresses are the tile's rows shifted by
//     dy*(W+2) + dx, so x is read from device memory once per chunk and not
//     nine times, and every 16-byte row stays aligned. Narrow maps (up to
//     128 wide) stage the contiguous run of padded positions; wide ones (the
//     VAE's 256 and 512) stage three row segments, one per dy, since a
//     contiguous run would span three 514-wide rows. Tiles of tiny maps are
//     cut until the staged rows fit in 448.
//   - The staging transposes NCHW to [position][channel] in registers:
//     a thread loads 8 channels of one position (32 lanes read 32 neighbouring
//     positions of a channel) and stores 16 bytes. It is spread over the 9
//     taps of the previous chunk: a thread's k-th item is loaded in tap
//     slot k and stored in slot k + 2, so its loads fly during two taps of
//     mma.
//     A 1-bit XOR swizzle of the two 16-byte halves keeps ldmatrix and the
//     stores free of bank conflicts.
//   - The weight's (tap, 16 channels, 64 outputs) tile comes with cp.async
//     (element-wise loads when Cout is not a multiple of 8) into the other of
//     two buffers while the current chunk is multiplied; ldmatrix.trans
//     reads its B fragments, its 128-byte rows XOR-swizzled by row.
//   - The epilogue rounds to bf16 and writes NCHW; pixels past the tile's
//     count and channels past Cout are masked.
//   - weight_kn_kernel lays the model's OIHW weight out as (9*Cin, Cout) for
//     conv3x3_direct, a shared-memory transpose: torch's strided copy of
//     the same permute took as long as the 8x8 conv itself.
// Summation order: every output element has one owner (one lane) that adds
// its terms in one fixed order, (cin chunk, tap, 16 channels of the chunk in
// the mma's own order). No split K and no atomics; the order depends neither
// on the batch nor on the pixel's place in its tile, so two calls give the
// same bits and image i alone gives the bits it gets inside a batch. It is
// not JAX's (dy, dx, cin) order, which only moves the fp32 rounding.
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

#include <type_traits>

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

// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;
using ddpo::tap::ROWS_MAX;
using ddpo::tap::TN;
using ddpo::tap::TT;
using ddpo::tap::a_offset;
using ddpo::tap::tap_shift;
constexpr int CK = 16;  // input channels per chunk: one k16 step per tap
constexpr int B_TILE = kTaps * CK * TN;  // weight elements per chunk
static_assert(CK * sizeof(bf16) == ddpo::tap::ROW_BYTES, "a staged row is 32 bytes");
// A [2][ROWS_MAX][CK] + B [2][9][CK][TN] bf16, then the row table int64 [ROWS_MAX]
constexpr size_t MMA_SMEM = sizeof(bf16) * (2 * ROWS_MAX * CK + 2 * B_TILE) +
                            sizeof(int64_t) * ROWS_MAX;
// staging items (position, 8-channel half) per thread, one per tap slot
// (each is loaded in tap slot k and stored in slot k + 2)
static_assert((2 * ROWS_MAX + TT - 1) / TT <= kTaps - 2, "staging must fit the tap slots");

// element offset of channels 8u .. 8u+7 of weight row kk of tap `tap`; the
// 8 units of a 128-byte row are XOR-ed with the row's low 3 bits
__device__ __forceinline__ int b_offset(int tap, int kk, int u) {
  return (tap * CK + kk) * TN + ((u ^ (kk & 7)) << 3);
}

// MI m16 tiles per warp (4, 2 or 1): a tile of 32 * MI pixels x 64 channels
template <int MAP, int MI>
__global__ void __launch_bounds__(TT) tap_gemm_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out, int B,
    int Cin, int H, int W, int Cout, int ipg, int mpb, int tiles, int span, bool perdy,
    bool bvec) {
  extern __shared__ uint4 smem_u4[];
  bf16* As = reinterpret_cast<bf16*>(smem_u4);
  bf16* Bs = As + 2 * ROWS_MAX * CK;
  int64_t* tbl = reinterpret_cast<int64_t*>(Bs + 2 * B_TILE);
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int HW = H * W, WP = W + 2, HP = H + 2;
  // the tile: pixels m0 .. m0+cnt-1 of the group of ipg images it lies in
  const int group = blockIdx.x / tiles, tile = blockIdx.x - group * tiles;
  const int g_img = group * ipg;
  const int m0 = g_img * HW + tile * mpb;
  const int cnt = min(mpb, min(ipg, B - g_img) * HW - tile * mpb);
  const int n0 = blockIdx.y * TN;

  // position of pixel m in the padded frame of the whole batch
  auto ppad = [&](int m) {
    const int img = m / HW, pix = m - img * HW, y = pix / W;
    return (img * HP + y + 1) * WP + (pix - y * W) + 1;
  };
  const int p0 = ppad(m0);
  // staged row s holds padded position p0 - WP - 1 + (s / seg) * WP + s % seg;
  // pixel m's tap (dy, dx) reads row (ppad(m) - p0) + dy * taprow + dx
  const int nrows = perdy ? 3 * span : ppad(m0 + cnt - 1) - p0 + 2 * WP + 3;
  const int seg = perdy ? span : nrows;
  const int taprow = perdy ? span : WP;
  for (int r = tid; r < nrows; r += TT) {
    const int sg = r / seg;
    const int P = p0 - WP - 1 + sg * WP + (r - sg * seg);
    const int img = P / (HP * WP);
    const int q = P - img * HP * WP;
    const int py = q / WP, px = q - py * WP;
    tbl[r] = (img < B && py >= 1 && py <= H && px >= 1 && px <= W)
                 ? int64_t(img) * Cin * HW + (py - 1) * W + (px - 1)
                 : -1;
  }

  // the weight tile of chunk c -> buffer buf
  auto stage_b = [&](int c, int buf) {
    bf16* dst = Bs + buf * B_TILE;
    const int c0 = c * CK;
    if (bvec) {
      for (int it = tid; it < kTaps * CK * (TN / 8); it += TT) {
        const int u = it & 7, kk = (it >> 3) & (CK - 1), tap = it >> 7;
        const int ci = c0 + kk, co = n0 + u * 8;
        const bool ok = ci < Cin && co < Cout;
        ddpo::cp_async16(ddpo::smem_addr(dst + b_offset(tap, kk, u)),
                         ok ? w + (int64_t(tap) * Cin + ci) * Cout + co : w, ok);
      }
    } else {
      for (int it = tid; it < B_TILE; it += TT) {
        const int n = it % TN, kk = (it / TN) % CK, tap = it / (TN * CK);
        const int ci = c0 + kk, co = n0 + n;
        dst[b_offset(tap, kk, n >> 3) + (n & 7)] =
            ci < Cin && co < Cout ? w[(int64_t(tap) * Cin + ci) * Cout + co]
                                  : __float2bfloat16(0.f);
      }
    }
  };
  // staging item k of this thread: row r, half u, or none
  auto item = [&](int k, int& r, int& u) {
    const int it = tid + k * TT;
    u = it >= nrows;
    r = it - u * nrows;
    return it < 2 * nrows;
  };
  auto load_item = [&](uint32_t (&v)[8], int r, int u, int c) {
    const int64_t off = tbl[r];
    const int ch0 = c * CK + u * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = off >= 0 && ch0 + i < Cin ? xs[off + int64_t(ch0 + i) * HW] : 0u;
  };
  auto store_item = [&](const uint32_t (&v)[8], int r, int u, int buf) {
    *reinterpret_cast<uint4*>(reinterpret_cast<char*>(As + buf * ROWS_MAX * CK) +
                              a_offset(r, u)) =
        make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16), v[4] | (v[5] << 16),
                   v[6] | (v[7] << 16));
  };

  // rows of this lane's ldmatrix addresses in the 4 m16 tiles (masked: row 0)
  int a_row[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int mr = wm * 16 * MI + i * 16 + (lane & 15);
    a_row[i] = mr < cnt ? ppad(m0 + mr) - p0 : 0;
  }
  const int a_half = lane >> 4;
  const int b_kk = (lane & 7) + (((lane >> 3) & 1) << 3);

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nchunks = (Cin + CK - 1) / CK;
  __syncthreads();  // the row table is written
  stage_b(0, 0);
  ddpo::cp_async_commit();
  for (int k = 0; k < kTaps; ++k) {
    int r, u;
    uint32_t v[8];
    if (item(k, r, u)) {
      load_item(v, r, u, 0);
      store_item(v, r, u, 0);
    }
  }
  ddpo::cp_async_wait<0>();
  __syncthreads();

  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    const bool more = c + 1 < nchunks;
    // the other buffers' readers passed the barrier that ended chunk c-1
    if (more) stage_b(c + 1, buf ^ 1);
    ddpo::cp_async_commit();
    const uint32_t a_base = ddpo::smem_addr(As + buf * ROWS_MAX * CK);
    const bf16* bt = Bs + buf * B_TILE;
    // staging of chunk c+1: item k is loaded in tap slot k and stored in
    // slot k + 2, so its loads have two taps of mma to arrive
    uint32_t raw[3][8];
    int rr[3], ru[3];
    bool rs[3] = {false, false, false};
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      if (tap >= 2 && rs[(tap - 2) % 3])
        store_item(raw[(tap - 2) % 3], rr[(tap - 2) % 3], ru[(tap - 2) % 3], buf ^ 1);
      rs[tap % 3] = more && item(tap, rr[tap % 3], ru[tap % 3]);
      if (rs[tap % 3]) load_item(raw[tap % 3], rr[tap % 3], ru[tap % 3], c + 1);

      const int sh = tap_shift<MAP>(tap, taprow);
      uint32_t a[MI][4], b[2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ddpo::ldmatrix_x4(a[i], a_base + a_offset(a_row[i] + sh, a_half));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ddpo::ldmatrix_x4_trans(
            b[jp], ddpo::smem_addr(bt + b_offset(tap, b_kk, wn * 4 + jp * 2 + a_half)));
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          ddpo::mma_bf16(acc[i][2 * jp], a[i], b[jp][0], b[jp][1]);
          ddpo::mma_bf16(acc[i][2 * jp + 1], a[i], b[jp][2], b[jp][3]);
        }
    }
    ddpo::cp_async_wait<0>();
    __syncthreads();
  }

  // epilogue: lane holds rows g, g+8 of each m16 tile and columns 2t, 2t+1
  // of each n8 tile
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int mr = wm * 16 * MI + i * 16 + g + 8 * hr;
      if (mr >= cnt) continue;
      const int m = m0 + mr, img = m / HW, pix = m - img * HW;
      bf16* ob = out + int64_t(img) * Cout * HW + pix;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn * 32 + j * 8 + 2 * tq + e;
          if (co < Cout) ob[int64_t(co) * HW] = __float2bfloat16(acc[i][j][2 * hr + e]);
        }
    }
}

template <int MAP, int MI>
cudaError_t launch_tiles(const void* x, const void* w, void* out, int B, int Cin, int H, int W,
                         int Cout, int ipg, int mpb, int span, bool perdy, cudaStream_t stream) {
  const int tiles = int((int64_t(ipg) * H * W + mpb - 1) / mpb);
  const int64_t groups = (B + ipg - 1) / ipg;
  if (groups * tiles > 0x7fffffff || (Cout + TN - 1) / TN > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(tap_gemm_mma_kernel<MAP, MI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(MMA_SMEM));
  if (e != cudaSuccess) return e;
  const bool bvec = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(unsigned(groups * tiles), (Cout + TN - 1) / TN);
  tap_gemm_mma_kernel<MAP, MI><<<grid, TT, MMA_SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), B,
      Cin, H, W, Cout, ipg, mpb, tiles, span, perdy, bvec);
  return cudaGetLastError();
}

template <int MAP>
cudaError_t launch_mma(const void* x, const void* w, void* out, int B, int Cin, int H, int W,
                       int Cout, cudaStream_t stream) {
  if (int64_t(B) * (H + 2) * (W + 2) >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  int ipg, mpb, span;
  bool perdy;
  switch (ddpo::tap::plan_launch(B, H, W, Cout, ipg, mpb, span, perdy)) {
    case 4:
      return launch_tiles<MAP, 4>(x, w, out, B, Cin, H, W, Cout, ipg, mpb, span, perdy, stream);
    case 2:
      return launch_tiles<MAP, 2>(x, w, out, B, Cin, H, W, Cout, ipg, mpb, span, perdy, stream);
    case 1:
      return launch_tiles<MAP, 1>(x, w, out, B, Cin, H, W, Cout, ipg, mpb, span, perdy, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 takes the tensor-core kernel, fp32 the FMA kernel
template <typename T, int MAP>
cudaError_t launch_for(const void* x, const void* w, void* out, int B, int Cin, int H, int W,
                       int Cout, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>)
    return launch_mma<MAP>(x, w, out, B, Cin, H, W, Cout, stream);
  else
    return launch<T, MAP>(x, w, out, B, Cin, H, W, Cout, stream);
}

template <typename T>
cudaError_t dispatch_map(int map, const void* x, const void* w, void* out, int B, int Cin,
                         int H, int W, int Cout, cudaStream_t stream) {
  switch (map) {
    case 0:
      return launch_for<T, 0>(x, w, out, B, Cin, H, W, Cout, stream);
    case 1:
      return launch_for<T, 1>(x, w, out, B, Cin, H, W, Cout, stream);
    case 2:
      return launch_for<T, 2>(x, w, out, B, Cin, H, W, Cout, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// OIHW (Cout, Cin, 3, 3) -> (3, 3, Cin, Cout), the tap-GEMM's (K, N) weight:
// a transpose of the (Cout, 9*Cin) matrix through a shared 32 x 32 tile, so
// that reads run along (cin, tap) and writes along Cout, 64 bytes a warp.
template <typename T>
__global__ void __launch_bounds__(256) weight_kn_kernel(const T* __restrict__ w,
                                                        T* __restrict__ out, int Cout, int Cin) {
  __shared__ T tile[32][33];
  const int K = kTaps * Cin;
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int co = n0 + r, k = k0 + tx;
    if (co < Cout && k < K) tile[r][tx] = w[int64_t(co) * K + k];
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int k = k0 + r, co = n0 + tx;
    if (co < Cout && k < K) {
      const int ci = k / kTaps, tap = k - ci * kTaps;
      out[(int64_t(tap) * Cin + ci) * Cout + co] = tile[tx][r];
    }
  }
}

template <typename T>
cudaError_t launch_weight_kn(const void* w, void* out, int Cout, int Cin, cudaStream_t stream) {
  const dim3 grid((kTaps * Cin + 31) / 32, (Cout + 31) / 32);
  weight_kn_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(w), static_cast<T*>(out),
                                                Cout, Cin);
  return cudaGetLastError();
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

// w: contiguous OIHW (Cout, Cin, 3, 3); out: contiguous (9 * Cin, Cout) in
// (tap, cin) order, the layout ddpo_tap_gemm reads. Returns cudaGetLastError().
extern "C" int ddpo_conv_weight_kn(const void* w, void* out, int dtype, int Cout, int Cin,
                                   void* stream) {
  if (Cout < 1 || Cin < 1 || (Cout + 31) / 32 > 65535 ||
      int64_t(kTaps) * Cin * Cout > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a copy: moved as raw 4- or 2-byte words
  if (dtype == ddpo::kFloat32) return int(launch_weight_kn<uint32_t>(w, out, Cout, Cin, s));
  if (dtype == ddpo::kBFloat16) return int(launch_weight_kn<uint16_t>(w, out, Cout, Cin, s));
  return int(cudaErrorInvalidValue);
}
