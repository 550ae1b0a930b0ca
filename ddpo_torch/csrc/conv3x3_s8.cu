// s8 tap-GEMM for sm_90a: the W8A8 3x3 convolution of the quantized UNet.
//
// Replaces: the int8 convolution inside ddpo_tpu/ops/quant.py::conv3x3_w8a8,
// an XLA op there (lax.conv_general_dilated over int8 codes with an int32
// accumulator, then the fp32 rescale), not a Pallas kernel. PyTorch has no
// int8 convolution on CUDA, and an im2col + torch._int_mm would move nine
// times the activation bytes. It computes, for a stride-1 SAME 3x3 conv,
//   acc[b, co, p] = sum over taps t and cin of xq[b, cin, p + off_t] * wq[co, t, cin]
// exactly in int32, then JAX's epilogue in JAX's order,
//   out = (float(acc) * (sx[b] * sw[co])) + bias[co]
// with __int2float_rn, __fmul_rn and __fadd_rn (nvcc would otherwise
// contract the multiply and the add into an FMA, which rounds once where
// the plain version rounds twice), rounded to the output dtype (bf16 or
// fp32). xq is NCHW int8, wq is (Cout, 9 * Cin) in (tap, cin) order,
// K-contiguous: ldmatrix has no 8-bit .trans form, so B is stored as the
// mma's "col" operand, n rows of k. sx is (B,), sw and bias (Cout,), fp32.
//
// What bounds it on this card: 2*B*H*W*9*Cin*Cout integer operations over
// 1979 TOPS (int8 dense), above the bytes (int8 in, bf16 out) at every UNet
// shape: 0.031 ms at (8, 320, 64, 64) -> 320; 0.015 ms at (8, 2560, 8, 8)
// -> 1280, where the 29.5 MB of int8 weight take 0.009 ms.
//
// Design: the bf16 tap-GEMM of conv3x3.cu (tap_gemm_mma_kernel) with int8
// operands, on mma.sync.m16n8k32 (s8 x s8 -> s32). A staged row is still
// 32 bytes, now 32 input channels, so one chunk is one k32 step per tap,
// and the tile plan, the row table, the XOR swizzle and the ldmatrix
// addressing of A are the bf16 kernel's (tap_tiles.cuh). The staging loads
// 16 channels of one position as bytes (32 lanes read 32 neighbouring
// positions of a channel) and packs them into one 16-byte store, loaded in
// tap slot k and stored in slot k + 2 as there. The weight tile of a chunk,
// [tap][64 outputs][32 channels], comes with cp.async 16 bytes at a time
// (element-wise where Cin is not a multiple of 16) into the other of two
// buffers, its 32-byte rows swizzled as A's, and plain ldmatrix reads its
// B fragments. Integer sums are exact in any order, so the bits depend
// neither on the batch nor on the tile: image i alone gives its slice.
// Not yet: wgmma, TMA, and fusing the activation quantize pass into the
// staging (ROADMAP.md Queue 2).

#include "common.cuh"
#include "mma.cuh"
#include "tap_tiles.cuh"

namespace {

using ddpo::tap::ROW_BYTES;
using ddpo::tap::ROWS_MAX;
using ddpo::tap::TN;
using ddpo::tap::TT;
using ddpo::tap::a_offset;
using ddpo::tap::tap_shift;
using bf16 = __nv_bfloat16;

constexpr int kTaps = 9;
constexpr int CK = 32;  // input channels per chunk: one k32 step per tap
static_assert(CK == ROW_BYTES, "a staged row is 32 int8 channels");
constexpr int A_BUF = ROWS_MAX * ROW_BYTES;    // bytes of one A buffer
constexpr int B_BUF = kTaps * TN * ROW_BYTES;  // bytes of one B buffer
// A [2][ROWS_MAX][32] + B [2][9][TN][32] int8, then the row table int64 [ROWS_MAX]
constexpr size_t S8_SMEM = 2 * A_BUF + 2 * B_BUF + sizeof(int64_t) * ROWS_MAX;
// staging items (position, 16-channel half) per thread, one per tap slot
static_assert((2 * ROWS_MAX + TT - 1) / TT <= kTaps - 2, "staging must fit the tap slots");

// byte offset of channels 16u .. 16u+15 of output n's weight row of tap
// `tap`: [tap][n][32 bytes], the halves swizzled by n as A's rows are
__device__ __forceinline__ uint32_t b_offset(int tap, int n, int u) {
  return uint32_t(tap * TN) * ROW_BYTES + a_offset(n, u);
}

__device__ __forceinline__ uint32_t pack4(const uint32_t* v) {
  return v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
}

// MI m16 tiles per warp (4, 2 or 1): a tile of 32 * MI pixels x 64 channels
template <typename OUT, int MI>
__global__ void __launch_bounds__(TT) tap_gemm_s8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias, OUT* __restrict__ out, int B,
    int Cin, int H, int W, int Cout, int ipg, int mpb, int tiles, int span, bool perdy,
    bool bvec) {
  extern __shared__ uint4 smem_u4[];
  char* As = reinterpret_cast<char*>(smem_u4);
  char* Bs = As + 2 * A_BUF;
  int64_t* tbl = reinterpret_cast<int64_t*>(Bs + 2 * B_BUF);
  const uint8_t* xs = reinterpret_cast<const uint8_t*>(x);
  const uint8_t* ws = reinterpret_cast<const uint8_t*>(w);
  const int64_t K = int64_t(kTaps) * Cin;  // length of a weight row

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
    char* dst = Bs + buf * B_BUF;
    const int c0 = c * CK;
    if (bvec) {
      for (int it = tid; it < kTaps * TN * 2; it += TT) {
        const int u = it & 1, n = (it >> 1) & (TN - 1), tap = it >> 7;
        const int ci = c0 + u * 16, co = n0 + n;
        const bool ok = ci < Cin && co < Cout;
        ddpo::cp_async16(ddpo::smem_addr(dst + b_offset(tap, n, u)),
                         ok ? ws + co * K + tap * Cin + ci : ws, ok);
      }
    } else {
      for (int it = tid; it < kTaps * TN * CK; it += TT) {
        const int k = it & (CK - 1), n = (it >> 5) & (TN - 1), tap = it >> 11;
        const int ci = c0 + k, co = n0 + n;
        dst[b_offset(tap, n, k >> 4) + (k & 15)] =
            ci < Cin && co < Cout ? char(ws[co * K + tap * Cin + ci]) : char(0);
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
  auto load_item = [&](uint32_t (&v)[16], int r, int u, int c) {
    const int64_t off = tbl[r];
    const int ch0 = c * CK + u * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = off >= 0 && ch0 + i < Cin ? uint32_t(xs[off + int64_t(ch0 + i) * HW]) : 0u;
  };
  auto store_item = [&](const uint32_t (&v)[16], int r, int u, int buf) {
    *reinterpret_cast<uint4*>(As + buf * A_BUF + a_offset(r, u)) =
        make_uint4(pack4(v), pack4(v + 4), pack4(v + 8), pack4(v + 12));
  };

  // rows of this lane's ldmatrix addresses in the MI m16 tiles (masked: row 0)
  int a_row[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int mr = wm * 16 * MI + i * 16 + (lane & 15);
    a_row[i] = mr < cnt ? ppad(m0 + mr) - p0 : 0;
  }
  const int a_half = lane >> 4;
  // B: lanes 8i..8i+7 address matrix i = (n 0-7, k 0-15), (n 0-7, k 16-31),
  // (n 8-15, k 0-15), (n 8-15, k 16-31) of a pair of n8 tiles
  const int b_n = (lane & 7) + ((lane >> 4) << 3);
  const int b_u = (lane >> 3) & 1;

  int acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int nchunks = (Cin + CK - 1) / CK;
  __syncthreads();  // the row table is written
  stage_b(0, 0);
  ddpo::cp_async_commit();
  for (int k = 0; k < kTaps; ++k) {
    int r, u;
    uint32_t v[16];
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
    const uint32_t a_base = ddpo::smem_addr(As + buf * A_BUF);
    const uint32_t b_base = ddpo::smem_addr(Bs + buf * B_BUF);
    // staging of chunk c+1: item k is loaded in tap slot k and stored in
    // slot k + 2, so its loads have two taps of mma to arrive
    uint32_t raw[3][16];
    int rr[3], ru[3];
    bool rs[3] = {false, false, false};
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      if (tap >= 2 && rs[(tap - 2) % 3])
        store_item(raw[(tap - 2) % 3], rr[(tap - 2) % 3], ru[(tap - 2) % 3], buf ^ 1);
      rs[tap % 3] = more && item(tap, rr[tap % 3], ru[tap % 3]);
      if (rs[tap % 3]) load_item(raw[tap % 3], rr[tap % 3], ru[tap % 3], c + 1);

      const int sh = tap_shift<0>(tap, taprow);
      uint32_t a[MI][4], b[2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ddpo::ldmatrix_x4(a[i], a_base + a_offset(a_row[i] + sh, a_half));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ddpo::ldmatrix_x4(b[jp], b_base + b_offset(tap, wn * 32 + jp * 16 + b_n, b_u));
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          ddpo::mma_s8(acc[i][2 * jp], a[i], b[jp][0], b[jp][1]);
          ddpo::mma_s8(acc[i][2 * jp + 1], a[i], b[jp][2], b[jp][3]);
        }
    }
    ddpo::cp_async_wait<0>();
    __syncthreads();
  }

  // epilogue: lane holds rows g, g+8 of each m16 tile and columns 2t, 2t+1
  // of each n8 tile; JAX's rescale, each operation rounded on its own
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int mr = wm * 16 * MI + i * 16 + g + 8 * hr;
      if (mr >= cnt) continue;
      const int m = m0 + mr, img = m / HW, pix = m - img * HW;
      const float s_img = sx[img];
      OUT* ob = out + int64_t(img) * Cout * HW + pix;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn * 32 + j * 8 + 2 * tq + e;
          if (co >= Cout) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][2 * hr + e]), __fmul_rn(s_img, sw[co]));
          if (bias != nullptr) v = __fadd_rn(v, bias[co]);
          ob[int64_t(co) * HW] = ddpo::from_float<OUT>(v);
        }
    }
}

template <typename OUT, int MI>
cudaError_t launch_tiles(const void* x, const void* w, const float* sx, const float* sw,
                         const float* bias, void* out, int B, int Cin, int H, int W, int Cout,
                         int ipg, int mpb, int span, bool perdy, cudaStream_t stream) {
  const int tiles = int((int64_t(ipg) * H * W + mpb - 1) / mpb);
  const int64_t groups = (B + ipg - 1) / ipg;
  if (groups * tiles > 0x7fffffff || (Cout + TN - 1) / TN > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(tap_gemm_s8_kernel<OUT, MI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(S8_SMEM));
  if (e != cudaSuccess) return e;
  const bool bvec = Cin % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(unsigned(groups * tiles), (Cout + TN - 1) / TN);
  tap_gemm_s8_kernel<OUT, MI><<<grid, TT, S8_SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), sx, sw, bias,
      static_cast<OUT*>(out), B, Cin, H, W, Cout, ipg, mpb, tiles, span, perdy, bvec);
  return cudaGetLastError();
}

template <typename OUT>
cudaError_t launch(const void* x, const void* w, const float* sx, const float* sw,
                   const float* bias, void* out, int B, int Cin, int H, int W, int Cout,
                   cudaStream_t stream) {
  if (int64_t(B) * (H + 2) * (W + 2) >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  int ipg, mpb, span;
  bool perdy;
  switch (ddpo::tap::plan_launch(B, H, W, Cout, ipg, mpb, span, perdy)) {
    case 4:
      return launch_tiles<OUT, 4>(x, w, sx, sw, bias, out, B, Cin, H, W, Cout, ipg, mpb, span,
                                  perdy, stream);
    case 2:
      return launch_tiles<OUT, 2>(x, w, sx, sw, bias, out, B, Cin, H, W, Cout, ipg, mpb, span,
                                  perdy, stream);
    case 1:
      return launch_tiles<OUT, 1>(x, w, sx, sw, bias, out, B, Cin, H, W, Cout, ipg, mpb, span,
                                  perdy, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: contiguous NCHW int8 (B, Cin, H, W); w: contiguous int8 (Cout, 9 * Cin)
// in (tap, cin) order; sx (B,), sw (Cout,) and bias (Cout,) or null, fp32;
// out: contiguous (B, Cout, H, W) in out_dtype (float32 or bfloat16).
// Returns cudaGetLastError() (0 on success).
extern "C" int ddpo_tap_gemm_s8(const void* x, const void* w, const void* sx, const void* sw,
                                const void* bias, void* out, int out_dtype, int B, int Cin,
                                int H, int W, int Cout, void* stream) {
  const int64_t hw = int64_t(H) * W;
  if (B < 1 || Cin < 1 || H < 1 || W < 1 || Cout < 1 || int64_t(Cin) * hw > 0x7fffffff ||
      int64_t(Cout) * hw > 0x7fffffff || int64_t(kTaps) * Cin * Cout > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fsx = static_cast<const float*>(sx);
  const float* fsw = static_cast<const float*>(sw);
  const float* fb = static_cast<const float*>(bias);
  if (out_dtype == ddpo::kFloat32)
    return int(launch<float>(x, w, fsx, fsw, fb, out, B, Cin, H, W, Cout, s));
  if (out_dtype == ddpo::kBFloat16)
    return int(launch<bf16>(x, w, fsx, fsw, fb, out, B, Cin, H, W, Cout, s));
  return int(cudaErrorInvalidValue);
}
