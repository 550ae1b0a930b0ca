// Flash-attention backward for sm_90a: flash_bwd_dq and flash_bwd_dkv.
//
// Replace: ddpo_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (the Pallas TPU kernels behind _flash_backward). Same
// function: P = exp(s - lse) is recomputed tile by tile from the forward's
// row logsumexp, never stored; with delta = rowsum(dO * O) computed by the
// caller, dS = P * (dO V^T - delta), dQ = scale * dS K, dK = scale * dS^T Q
// and dV = P^T dO. Padded keys and query rows past Sq contribute nothing.
//
// What bounds them on this card: at the UNet's training shapes (2B = 4,
// H = 8, S = 4096/1024/256, D = 40/80/160) the backward is compute-bound:
// flash_bwd_dq runs three (S, S, D) products per (batch, head) and
// flash_bwd_dkv four, against two in the forward, while the inputs are a
// few MB that sit in the 50 MB L2. The exponentials (one per score, in each
// kernel) weigh less than in the forward, against three or four products.
//
// bf16, on the tensor cores (bf16 in, fp32 accumulate), one owner per
// output row as in the fp32 kernels:
//   - flash_bwd_dq_wgmma_kernel (Hopper: wgmma + TMA, flash_tiles.cuh, on
//     the dK/dV kernel's helpers): two consumer warpgroups own 64 query
//     rows each (one above D = 192, where two stages of K and V no longer
//     fit beside two warpgroups' Q and dO), and a producer warp loads the
//     block's Q and dO once by TMA, with their rows' lse and delta by
//     4-byte cp.async arriving on the same full mbarrier, then streams
//     64-key tiles of K and V into a ring of 2-4 stages. Per key tile: S =
//     Q K^T and dP = dO V^T with Q and dO as the A operands from shared
//     memory (SS), K and V K-major B; then P = exp2(s*scale*log2(e) -
//     lse*log2(e)) and dS = P (dP - delta) in registers, the scale applied
//     to the fp32 scores and not folded into a bf16 Q; dS sits in the C
//     layout that is the A layout of dQ += dS K, so it is rounded to bf16 in
//     registers (RS) with K as the MN-major B (tnspB = 1). Keys past Sk
//     give P = 0. The scale multiplies dQ in fp32 at the end. The two
//     warpgroups take turns to issue their products, as in dK/dV. dQ (D / 2
//     fp32 a thread) is split into column groups of two 64-column atoms (a
//     grid dimension), each recomputing S and dP: one group up to D = 128,
//     two above, so that dQ, S, dP and dS fit in 168 registers.
//   - flash_bwd_dkv_wgmma_kernel (Hopper: wgmma + TMA, flash_tiles.cuh): two
//     consumer warpgroups own 64 keys each (the wgmma M tile; one above
//     D = 192, where two stages of Q and dO no longer fit beside two
//     warpgroups' K and V), and a producer warp streams 64-query
//     tiles of Q and dO by TMA into a ring of 2-4 stages, with each tile's
//     lse and delta (64 fp32 each) copied beside them by 4-byte cp.async
//     that arrive on the same full mbarrier. Per query tile (in halves of
//     32 above D = 64): S^T = K Q^T and dP^T = V dO^T with K and V as the A
//     operands from shared memory (SS), Q and dO as K-major B; then P^T =
//     exp2(s*scale*log2(e) - lse*log2(e)) and dS^T = P^T (dP^T - delta) in
//     registers, which sit in the C layout that is the A layout of dV +=
//     P^T dO and dK += dS^T Q, so they are rounded to bf16 in registers
//     (RS) with dO and Q as MN-major B (tnspB = 1). Query rows past Sq give
//     P = 0 by an explicit select, not through a padded lse (0 * inf and
//     -inf - -inf are NaN). Keys past Sk are never written. The two
//     warpgroups take turns to issue their products (FlashAttention-3's
//     ping-pong), so one's exponentials run while the other's products do.
//   - Registers: a thread of the 288-thread block may hold 168. dK and dV
//     for 64 keys are D fp32 a thread, S^T and dP^T QH/2 each (QH = 64
//     queries up to D = 64, 32 above). So dK and dV are split into column
//     groups (a grid dimension) of two 64-column atoms up to D = 96 and of
//     one above, each group recomputing S^T and dP^T: one group up to
//     D = 96 (ptxas: D = 40 at 148 registers, D = 80 at 153, no spills),
//     two up to D = 128, three at D = 160 (168 registers, 16 bytes of
//     spills; 64-208 bytes at D = 161-192), four above (one consumer
//     warpgroup, 188-209 registers, none). No instantiation's wgmma is
//     serialized.
//   - The only new roundings against the fp32 kernels are P (for dV) and dS
//     (for dQ and dK) to bf16 as A operands; S and dP are exact bf16
//     products summed in fp32. tests/test_torch_flash_numerics.py emulates
//     this arithmetic on the CPU against JAX's kernels.
// Summation order: each output element has one owner (a lane of the warp
// that owns its row) and adds its terms in a fixed order: tiles in order,
// 16 rows at a time, the k16 steps in order. No split over keys (dq) or
// queries (dkv) and no atomics; tile sizes depend on D alone, and nothing
// on the batch, the head or the row's place in the block, so two calls
// give the same bits and image i alone gives the bits it gets inside a
// batch.
//
// fp32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel) stays on the CUDA cores
// in FMA: TF32 keeps 10 mantissa bits and would break the 1e-4 bounds. The
// forward's scheme: one block owns a tile of rows (queries for dq, keys for
// dkv) and streams 64-row tiles of the other side; each thread owns a 4x4
// tile of scores, so every pair of 16-byte shared-memory loads feeds 16
// FMAs, and the S and dP products share one loop over D. The block's output
// rows stay in fp32 registers, with ceil(D/16) strided columns per thread.
// Every tile sits in shared memory as fp32; five of them at 64 rows need
// 191 KB at D = 160, so above D = 160 a block owns 32 rows with 128 threads
// (222 KB at D = 256). All kernels read Q, K, V and dO through their
// (B, S, H) strides, so the caller neither pads nor transposes.
//
// Two translation units: this file builds the dQ half (ddpo_flash_bwd_dq,
// and ddpo_flash_tma_ok), flash_bwd_dkv.cu includes it with
// DDPO_FLASH_BWD_DKV defined and builds the dK/dV half, so that their nvcc
// runs go in parallel (the whole file was the build's slowest by ~2x).

#include "common.cuh"
#include "flash_tiles.cuh"
#include "mma.cuh"

#include <type_traits>

namespace {

constexpr int BS = 64;  // rows of a streamed tile: keys in dq, queries in dkv
constexpr float kLog2e = 1.4426950408889634f;

// rows a block owns: 64 while five fp32 tiles fit in shared memory
template <int NC>
__host__ __device__ constexpr int own_rows() { return NC <= 10 ? 64 : 32; }

template <int NC>
constexpr size_t smem_bytes(int d) {
  constexpr int LR = own_rows<NC>() + 4;  // row strides keep rows 16-byte aligned
  constexpr int LS = BS + 4;
  // two own-row tiles [d][LR], two streamed tiles [d][LS], P/dS [BS][LR],
  // and the streamed rows' lse and delta
  return sizeof(float) *
         (size_t(2) * d * LR + size_t(2) * d * LS + size_t(BS) * LR + 2 * BS);
}

struct Strides {  // in elements; the d stride is 1
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h;
};

__device__ __forceinline__ void load4(const float* p, float (&r)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
}

// dQ for one (BR-query tile, head, batch): streams K/V tiles.
template <typename T, int NC>
__global__ void __launch_bounds__(4 * own_rows<NC>()) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int Sq, int Sk,
    int D, Strides st, float scale) {
  constexpr int BR = own_rows<NC>();
  constexpr int NT = 4 * BR;
  constexpr int LR = BR + 4;
  constexpr int LS = BS + 4;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][LR], Q * scale * log2(e)
  float* doT = qT + D * LR;                      // [D][LR]
  float* kT = doT + D * LR;                      // [D][LS]
  float* vT = kT + D * LS;                       // [D][LS]
  float* dsT = vT + D * LS;                      // [BS][LR]: dS, key-major

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // keys tx*4 .. tx*4+3; output columns tx + 16*c
  const int ty = tid >> 4;  // own rows ty*4 .. ty*4+3
  const int r0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + h * st.k_h;
  const T* vb = v + b * st.v_b + h * st.v_h;
  const T* gb = dout + b * st.do_b + h * st.do_h;
  const float scale_log2 = scale * kLog2e;

  for (int idx = tid; idx < BR * D; idx += NT) {
    const int r = idx / D, d = idx - r * D;
    const int row = r0 + r;
    const bool ok = row < Sq;
    qT[d * LR + r] = ok ? ddpo::to_float(qb[row * st.q_s + d]) * scale_log2 : 0.f;
    doT[d * LR + r] = ok ? ddpo::to_float(gb[row * st.do_s + d]) : 0.f;
  }
  float lse2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    const int64_t at = (int64_t(b) * H + h) * Sq + row;
    lse2[i] = row < Sq ? lse[at] * kLog2e : 0.f;
    dl[i] = row < Sq ? delta[at] : 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BS) {
    __syncthreads();  // the previous tile's readers of kT/vT/dsT are done
    for (int idx = tid; idx < BS * D; idx += NT) {
      const int j = idx / D, d = idx - j * D;
      const int key = k0 + j;
      const bool ok = key < Sk;
      kT[d * LS + j] = ok ? ddpo::to_float(kb[key * st.k_s + d]) : 0.f;
      vT[d * LS + j] = ok ? ddpo::to_float(vb[key * st.v_s + d]) : 0.f;
    }
    __syncthreads();

    // s = Q K^T (log2 domain) and dP = dO V^T for rows ty*4+i, keys tx*4+j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], kk[4], vv[4];
      load4(qT + d * LR + ty * 4, a);
      load4(doT + d * LR + ty * 4, g);
      load4(kT + d * LS + tx * 4, kk);
      load4(vT + d * LS + tx * 4, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }
    // dS = P * (dP - delta), P = exp(s - lse); padded keys give P = 0
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key_ok = k0 + tx * 4 + j < Sk;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = key_ok ? exp2f(s[i][j] - lse2[i]) : 0.f;
        ds[i] = p * (dp[i][j] - dl[i]);
      }
      *reinterpret_cast<float4*>(dsT + (tx * 4 + j) * LR + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ += dS K for rows ty*4+i, columns tx + 16*c (K read from its transpose)
#pragma unroll 4
    for (int j = 0; j < BS; ++j) {
      float p[4];
      load4(dsT + j * LR + ty * 4, p);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = kT[min(tx + 16 * c, D - 1) * LS + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= Sq) continue;
    T* orow = dq + ((int64_t(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) orow[col] = ddpo::from_float<T>(acc[i][c] * scale);
    }
  }
}

// dK and dV for one (BR-key tile, head, batch): streams Q/dO tiles.
template <typename T, int NC>
__global__ void __launch_bounds__(4 * own_rows<NC>()) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int Sq, int Sk, int D, Strides st, float scale) {
  constexpr int BR = own_rows<NC>();
  constexpr int NT = 4 * BR;
  constexpr int LR = BR + 4;
  constexpr int LS = BS + 4;
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);  // [D][LR], K * scale * log2(e)
  float* vT = kT + D * LR;                       // [D][LR]
  float* qT = vT + D * LR;                       // [D][LS]
  float* doT = qT + D * LS;                      // [D][LS]
  float* pS = doT + D * LS;                      // [BS][LR]: P, then dS, query-major
  float* lse_s = pS + BS * LR;                   // [BS], log2 domain
  float* dl_s = lse_s + BS;                      // [BS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // queries tx*4 .. tx*4+3; output columns tx + 16*c
  const int ty = tid >> 4;  // own keys ty*4 .. ty*4+3
  const int r0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + h * st.k_h;
  const T* vb = v + b * st.v_b + h * st.v_h;
  const T* gb = dout + b * st.do_b + h * st.do_h;
  const float* lse_bh = lse + (int64_t(b) * H + h) * Sq;
  const float* dl_bh = delta + (int64_t(b) * H + h) * Sq;
  const float scale_log2 = scale * kLog2e;

  for (int idx = tid; idx < BR * D; idx += NT) {
    const int r = idx / D, d = idx - r * D;
    const int key = r0 + r;
    const bool ok = key < Sk;
    kT[d * LR + r] = ok ? ddpo::to_float(kb[key * st.k_s + d]) * scale_log2 : 0.f;
    vT[d * LR + r] = ok ? ddpo::to_float(vb[key * st.v_s + d]) : 0.f;
  }

  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[j][c] = adv[j][c] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += BS) {
    __syncthreads();  // the previous tile's readers of qT/doT/pS are done
    for (int idx = tid; idx < BS * D; idx += NT) {
      const int i = idx / D, d = idx - i * D;
      const int row = q0 + i;
      const bool ok = row < Sq;
      qT[d * LS + i] = ok ? ddpo::to_float(qb[row * st.q_s + d]) : 0.f;
      doT[d * LS + i] = ok ? ddpo::to_float(gb[row * st.do_s + d]) : 0.f;
    }
    for (int i = tid; i < BS; i += NT) {
      const int row = q0 + i;
      lse_s[i] = row < Sq ? lse_bh[row] * kLog2e : 0.f;
      dl_s[i] = row < Sq ? dl_bh[row] : 0.f;
    }
    __syncthreads();

    // s^T = K Q^T (log2 domain) and dP^T = V dO^T for keys ty*4+j, queries tx*4+i
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kk[4], vv[4], a[4], g[4];
      load4(kT + d * LR + ty * 4, kk);
      load4(vT + d * LR + ty * 4, vv);
      load4(qT + d * LS + tx * 4, a);
      load4(doT + d * LS + tx * 4, g);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = fmaf(kk[j], a[i], s[j][i]);
          dp[j][i] = fmaf(vv[j], g[i], dp[j][i]);
        }
    }
    // P = exp(s - lse), 0 for query rows >= Sq; dS = P * (dP - delta)
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool row_ok = q0 + tx * 4 + i < Sq;
      const float l = lse_s[tx * 4 + i], dl = dl_s[tx * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = row_ok ? exp2f(s[j][i] - l) : 0.f;
        s[j][i] = p;
        ds[j][i] = p * (dp[j][i] - dl);
      }
      *reinterpret_cast<float4*>(pS + (tx * 4 + i) * LR + ty * 4) =
          make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
    }
    __syncthreads();

    // dV += P^T dO for keys ty*4+j, columns tx + 16*c (dO read from its transpose)
#pragma unroll 4
    for (int i = 0; i < BS; ++i) {
      float p[4];
      load4(pS + i * LR + ty * 4, p);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float g = doT[min(tx + 16 * c, D - 1) * LS + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) adv[j][c] = fmaf(p[j], g, adv[j][c]);
      }
    }
    __syncthreads();  // all readers of P are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(pS + (tx * 4 + i) * LR + ty * 4) =
          make_float4(ds[0][i], ds[1][i], ds[2][i], ds[3][i]);
    __syncthreads();

    // dK += dS^T Q (unscaled Q; the scale is applied at the end)
#pragma unroll 4
    for (int i = 0; i < BS; ++i) {
      float p[4];
      load4(pS + i * LR + ty * 4, p);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float a = qT[min(tx + 16 * c, D - 1) * LS + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) adk[j][c] = fmaf(p[j], a, adk[j][c]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = r0 + ty * 4 + j;
    if (key >= Sk) continue;
    const int64_t at = ((int64_t(b) * Sk + key) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dk[at + col] = ddpo::from_float<T>(adk[j][c] * scale);
        dv[at + col] = ddpo::from_float<T>(adv[j][c]);
      }
    }
  }
}

// ---- bf16 on Hopper: wgmma + TMA ----

using bf16 = __nv_bfloat16;
namespace fl = ddpo::flash;

// ---- dK/dV ----

// Tiles of the bf16 dkv kernel for D padded to 16 * NC, functions of D
// alone: a consumer warpgroup owns 64 keys; two run in a block where their
// K and V and two stages of Q and dO fit in shared memory (up to D = 192),
// else one. Above D = 64 a 64-query tile is taken in halves of 32, so that
// S^T and dP^T (16 fp32 a thread each) and dK and dV (D fp32) fit in the
// 168 registers a thread of 288 may hold: dK and dV are split into column
// groups (grid dimension z) of two atoms up to D = 96 and of one above,
// each group recomputing S^T and dP^T.
template <int NC>
struct DkvTile {
  static constexpr int NA = fl::atoms<NC>();
  static constexpr int NCW = NA <= 3 ? 2 : 1;          // consumer warpgroups
  static constexpr int GA = NC <= 6 ? 2 : 1;           // atoms of dK and dV a group
  static constexpr int QH = NC <= 4 ? 64 : 32;         // queries a product takes
  static constexpr int GROUPS = (NA + GA - 1) / GA;    // column groups
  static constexpr int TILE = NA * 64 * fl::ROW_BYTES;  // 64 rows of one array
  static constexpr size_t smem(int stages) {
    // K and V [NCW][NA][64][128], then per stage Q and dO [NA][64][128] and
    // lse, delta [2][64] fp32; the barriers
    return 1024 + size_t(2) * NCW * TILE + size_t(stages) * (2 * TILE + 2 * 64 * 4) +
           8 * (1 + 2 * stages);
  }
};

// the arguments of both bf16 backward kernels
struct WgArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int H, Sq, Sk, D;
  Strides st;
  float scale;
  int tma;     // 1: the producer loads by TMA; 0: by plain loads
  int stages;  // dK/dV: Q/dO tiles in flight
};

// One consumer warpgroup's dK and dV over the atoms GRP * GA .. of D, for
// the 64 keys whose K and V tiles sit at k_base and v_base
template <int NC, int GRP>
__device__ __forceinline__ void dkv_consumer(const WgArgs& a, uint32_t k_base, uint32_t v_base,
                                             const uint8_t* qs, const uint8_t* gs,
                                             const float* stats, uint32_t bars, int key0, int b,
                                             int h) {
  using Tile = DkvTile<NC>;
  constexpr int NA = Tile::NA, A0 = Tile::GA * GRP, QH = Tile::QH, KQ = QH / 16;
  constexpr int GN = NA - A0 < Tile::GA ? NA - A0 : Tile::GA;  // atoms of this group
  constexpr int N0 = fl::atom_n<NC>(A0), N1 = fl::atom_n<NC>(A0 + GN - 1);
  const int ST = a.stages;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3, g = lane >> 2, tq = lane & 3;
  const float scale_log2 = a.scale * kLog2e;
  const fl::Turns turns{int(threadIdx.x) / fl::WG, Tile::NCW};

  float dk[GN][32], dv[GN][32], s[QH / 2], dp[QH / 2];
  uint32_t pa[KQ][4], da[KQ][4];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int c = 0; c < GN; ++c) dk[c][i] = dv[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < QH / 2; ++i) s[i] = dp[i] = 0.f;

  turns.start();
  ddpo::mbar_wait(bars, 0);  // K and V
  const int nt = (a.Sq + 63) / 64;
  for (int t = 0; t < nt; ++t) {
    const int st = t % ST;
    ddpo::mbar_wait(full(st), (t / ST) & 1);
    const uint32_t qt = ddpo::smem_addr(qs + st * Tile::TILE);
    const uint32_t gt = ddpo::smem_addr(gs + st * Tile::TILE);
#pragma unroll 1
    for (int hq = 0; hq < 64 / QH; ++hq) {  // queries QH hq .. QH hq + QH - 1 of the tile
      // S^T = K Q^T and dP^T = V dO^T over all of D (K and V the A operands)
      turns.take();
      ddpo::fence_operands(s);
      ddpo::fence_operands(dp);
      ddpo::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NC; ++kk)
        ddpo::wgmma_ss<QH>(s, fl::k_desc(k_base, 64, kk),
                           fl::k_desc(qt + QH * hq * fl::ROW_BYTES, 64, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < NC; ++kk)
        ddpo::wgmma_ss<QH>(dp, fl::k_desc(v_base, 64, kk),
                           fl::k_desc(gt + QH * hq * fl::ROW_BYTES, 64, kk), kk > 0);
      ddpo::wgmma_commit();
      ddpo::fence_operands(s);
      ddpo::fence_operands(dp);
      turns.pass(false);
      ddpo::wgmma_wait<0>();
      ddpo::fence_operands(s);
      ddpo::fence_operands(dp);

      // P^T = exp2(S^T scale log2(e) - lse log2(e)), dS^T = P^T (dP^T - delta);
      // the lane holds keys g + 8r and queries QH hq + 8j + 2tq + e of the
      // tile. Query rows past Sq give P = 0 by this select, not through lse.
      const float* lse_t = stats + st * 128 + QH * hq;
      const float* dl_t = lse_t + 64;
      const int rows_left = a.Sq - t * 64 - QH * hq;
#pragma unroll
      for (int j = 0; j < QH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * tq + e;
          const float l2 = lse_t[col] * kLog2e, dlv = dl_t[col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p = ddpo::exp2_ftz(fmaf(s[4 * j + 2 * r + e], scale_log2, -l2));
            if (col >= rows_left) p = 0.f;
            dp[4 * j + 2 * r + e] = p * (dp[4 * j + 2 * r + e] - dlv);
            s[4 * j + 2 * r + e] = p;
          }
        }
      fl::pack_a(pa, s);
      fl::pack_a(da, dp);

      // dV += P^T dO and dK += dS^T Q over this group's atoms (dO and Q
      // MN-major), k steps KQ hq .. KQ hq + KQ - 1 of the tile's four
      const bool last = t == nt - 1 && hq == 64 / QH - 1;
      turns.take();
      ddpo::wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        ddpo::wgmma_rs_mn<N0>(dv[0], pa[kq], fl::mn_desc(gt, 64, A0, KQ * hq + kq));
        if constexpr (GN > 1)
          ddpo::wgmma_rs_mn<N1>(dv[1], pa[kq], fl::mn_desc(gt, 64, A0 + 1, KQ * hq + kq));
      }
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        ddpo::wgmma_rs_mn<N0>(dk[0], da[kq], fl::mn_desc(qt, 64, A0, KQ * hq + kq));
        if constexpr (GN > 1)
          ddpo::wgmma_rs_mn<N1>(dk[1], da[kq], fl::mn_desc(qt, 64, A0 + 1, KQ * hq + kq));
      }
      ddpo::wgmma_commit();
#pragma unroll
      for (int c = 0; c < GN; ++c) {
        ddpo::fence_operands(dk[c]);
        ddpo::fence_operands(dv[c]);
      }
      turns.pass(last);
      ddpo::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < GN; ++c) {
        ddpo::fence_operands(dk[c]);
        ddpo::fence_operands(dv[c]);
      }
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        ddpo::fence_operands(pa[kq]);
        ddpo::fence_operands(da[kq]);
      }
    }
    ddpo::mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 16 * wq + g + 8 * r;
    if (key >= a.Sk) continue;
    const int64_t at = ((int64_t(b) * a.Sk + key) * a.H + h) * a.D;
#pragma unroll
    for (int c = 0; c < GN; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c < GN - 1 ? j < N0 / 8 : j < N1 / 8) {
          const int col = (A0 + c) * fl::ATOM + 8 * j + 2 * tq;
          ddpo::store_pair(a.dk + at, col, a.D, dk[c][4 * j + 2 * r] * a.scale,
                           dk[c][4 * j + 2 * r + 1] * a.scale);
          ddpo::store_pair(a.dv + at, col, a.D, dv[c][4 * j + 2 * r], dv[c][4 * j + 2 * r + 1]);
        }
  }
}

// dK and dV for 64 * NCW keys of one (head, batch) and one column group:
// grid (key tiles, H, B * GROUPS)
template <int NC>
__global__ void __launch_bounds__(fl::block_threads(DkvTile<NC>::NCW), 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const WgArgs a) {
  using Tile = DkvTile<NC>;
  constexpr int NA = Tile::NA, NCW = Tile::NCW, TILE = Tile::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = smem_raw + ((1024 - (ddpo::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* vs = ks + NCW * TILE;    // K and V: [NCW][NA][64][128]
  uint8_t* qs = vs + NCW * TILE;    // Q: [stages][NA][64][128]
  const int ST = a.stages;
  uint8_t* gs = qs + ST * TILE;     // dO: [stages][NA][64][128]
  float* stats = reinterpret_cast<float*>(gs + ST * TILE);  // [stages][lse 64, delta 64]
  const uint32_t bars = ddpo::smem_addr(stats + ST * 128);
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * 64 * NCW, h = blockIdx.y;
  const int b = blockIdx.z / Tile::GROUPS, grp = blockIdx.z - b * Tile::GROUPS;
  const int nt = (a.Sq + 63) / 64;

  if (tid == 0) {
    ddpo::mbar_init(kv_full, a.tma ? 1 : 32);
    for (int s = 0; s < ST; ++s) {
      ddpo::mbar_init(full(s), 32);  // the producer warp's lanes
      ddpo::mbar_init(empty(s), NCW * fl::WG);
    }
    ddpo::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NCW) {  // the producer warp
    const float* lse_bh = a.lse + (int64_t(b) * a.H + h) * a.Sq;
    const float* dl_bh = a.delta + (int64_t(b) * a.H + h) * a.Sq;
    // lse and delta of query rows row0 .. row0 + 63 (0 past Sq) into stage
    // s by cp.async, 4 bytes each, the lane's share
    auto stage_stats = [&](int s, int row0) {
      for (int i = lane; i < 128; i += 32) {
        const int row = row0 + (i & 63);
        const float* src = i < 64 ? lse_bh : dl_bh;
        ddpo::cp_async4(ddpo::smem_addr(stats + s * 128 + i), row < a.Sq ? src + row : src,
                        row < a.Sq);
      }
    };
    if (a.tma) {
      if (lane == 0) {
        ddpo::mbar_arrive_expect_tx(kv_full, 2 * NCW * TILE);
        for (int c = 0; c < NCW; ++c) {
          fl::load_tile(ddpo::smem_addr(ks + c * TILE), &kmap, kv_full, b, h, k0 + 64 * c, 64, NA);
          fl::load_tile(ddpo::smem_addr(vs + c * TILE), &vmap, kv_full, b, h, k0 + 64 * c, 64, NA);
        }
      }
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST, use = t / ST;
        if (use > 0) ddpo::mbar_wait(empty(s), (use - 1) & 1);
        if (lane == 0) {
          ddpo::mbar_expect_tx(full(s), 2 * TILE);
          fl::load_tile(ddpo::smem_addr(qs + s * TILE), &qmap, full(s), b, h, t * 64, 64, NA);
          fl::load_tile(ddpo::smem_addr(gs + s * TILE), &gmap, full(s), b, h, t * 64, 64, NA);
        }
        stage_stats(s, t * 64);
        ddpo::cp_async_mbar_arrive(full(s));  // once the lane's lse and delta land
      }
    } else {
      const bf16* qb = a.q + b * a.st.q_b + h * a.st.q_h;
      const bf16* kb = a.k + b * a.st.k_b + h * a.st.k_h;
      const bf16* vb = a.v + b * a.st.v_b + h * a.st.v_h;
      const bf16* gb = a.dout + b * a.st.do_b + h * a.st.do_h;
      for (int c = 0; c < NCW; ++c) {
        fl::stage_tile(ks + c * TILE, kb, a.st.k_s, k0 + 64 * c, 64, a.Sk, a.D, NA, lane, 32);
        fl::stage_tile(vs + c * TILE, vb, a.st.v_s, k0 + 64 * c, 64, a.Sk, a.D, NA, lane, 32);
      }
      ddpo::fence_proxy_async();
      ddpo::mbar_arrive(kv_full);
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST, use = t / ST;
        if (use > 0) ddpo::mbar_wait(empty(s), (use - 1) & 1);
        fl::stage_tile(qs + s * TILE, qb, a.st.q_s, t * 64, 64, a.Sq, a.D, NA, lane, 32);
        fl::stage_tile(gs + s * TILE, gb, a.st.do_s, t * 64, 64, a.Sq, a.D, NA, lane, 32);
        stage_stats(s, t * 64);
        ddpo::fence_proxy_async();
        ddpo::cp_async_mbar_arrive(full(s));
      }
    }
    return;
  }

  const int cw = warp / 4;
  const uint32_t k_base = ddpo::smem_addr(ks + cw * TILE), v_base = ddpo::smem_addr(vs + cw * TILE);
  const int key0 = k0 + 64 * cw;
  if (grp == 0) dkv_consumer<NC, 0>(a, k_base, v_base, qs, gs, stats, bars, key0, b, h);
  if constexpr (Tile::GROUPS > 1)
    if (grp == 1) dkv_consumer<NC, 1>(a, k_base, v_base, qs, gs, stats, bars, key0, b, h);
  if constexpr (Tile::GROUPS > 2)
    if (grp == 2) dkv_consumer<NC, 2>(a, k_base, v_base, qs, gs, stats, bars, key0, b, h);
  if constexpr (Tile::GROUPS > 3)
    if (grp == 3) dkv_consumer<NC, 3>(a, k_base, v_base, qs, gs, stats, bars, key0, b, h);
}

// ---- dQ ----

// Tiles of the bf16 dq kernel for D padded to 16 * NC, functions of D
// alone: a consumer warpgroup owns 64 query rows; two run in a block where
// their Q and dO and two stages of K and V fit in shared memory (up to
// D = 192), else one. K and V tiles hold 64 keys. dQ for 64 rows is D / 2
// fp32 a thread beside S and dP (32 each) and dS (16 registers), so dQ is
// split into column groups (grid dimension z) of two 64-column atoms, each
// group recomputing S and dP: one group up to D = 128, two above.
template <int NC>
struct DqTile {
  static constexpr int NA = fl::atoms<NC>();
  static constexpr int NCW = NA <= 3 ? 2 : 1;           // consumer warpgroups
  static constexpr int GA = 2;                          // atoms of dQ a group
  static constexpr int GROUPS = (NA + GA - 1) / GA;     // column groups
  static constexpr int TILE = NA * 64 * fl::ROW_BYTES;  // 64 rows of one array
  __host__ __device__ static constexpr size_t smem(int stages) {
    // Q and dO [NCW][NA][64][128], lse and delta [NCW][2][64] fp32, then
    // per stage K and V [NA][64][128]; the barriers
    return 1024 + size_t(2) * NCW * TILE + size_t(NCW) * 2 * 64 * 4 +
           size_t(stages) * 2 * TILE + 8 * (1 + 2 * stages);
  }
  __host__ __device__ static constexpr int stages() {
    int st = 4;
    while (st > 2 && smem(st) > size_t(fl::SMEM_MAX)) --st;
    return st;
  }
};

// One consumer warpgroup's dQ over the atoms GRP * GA .. of D, for the 64
// query rows from row0 whose Q and dO tiles sit at q_base and g_base and
// whose lse and delta sit at stats
template <int NC, int GRP>
__device__ __forceinline__ void dq_consumer(const WgArgs& a, uint32_t q_base, uint32_t g_base,
                                            const float* stats, uint32_t ks, uint32_t vs,
                                            uint32_t bars, int row0, int b, int h) {
  using Tile = DqTile<NC>;
  constexpr int NA = Tile::NA, A0 = Tile::GA * GRP, ST = Tile::stages();
  constexpr int GN = NA - A0 < Tile::GA ? NA - A0 : Tile::GA;  // atoms of this group
  constexpr int N0 = fl::atom_n<NC>(A0), N1 = fl::atom_n<NC>(A0 + GN - 1);
  auto kv_full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3, g = lane >> 2, tq = lane & 3;
  const float scale_log2 = a.scale * kLog2e;
  const fl::Turns turns{int(threadIdx.x) / fl::WG, Tile::NCW};

  float dq[GN][32], s[32], dp[32];
  uint32_t da[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = dp[i] = 0.f;
#pragma unroll
    for (int c = 0; c < GN; ++c) dq[c][i] = 0.f;
  }
  auto fence_dq = [&]() {
    fl::fence_first<N0 / 2>(dq[0]);
    if constexpr (GN > 1) fl::fence_first<N1 / 2>(dq[1]);
  };

  turns.start();
  ddpo::mbar_wait(bars, 0);  // Q, dO, lse and delta
  // lse (base 2) and delta of the lane's rows g and g + 8 (0 past Sq)
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = 16 * wq + g + 8 * r;
    lse2[r] = stats[i] * kLog2e;
    dl[r] = stats[64 + i];
  }
  const int nt = (a.Sk + 63) / 64;
#pragma unroll 1
  for (int t = 0; t < nt; ++t) {
    const int st = t % ST;
    ddpo::mbar_wait(kv_full(st), (t / ST) & 1);
    const uint32_t k_base = ks + uint32_t(st) * Tile::TILE;
    const uint32_t v_base = vs + uint32_t(st) * Tile::TILE;

    // S = Q K^T and dP = dO V^T over all of D (Q and dO the A operands)
    turns.take();
    ddpo::fence_operands(s);
    ddpo::fence_operands(dp);
    ddpo::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NC; ++kk)
      ddpo::wgmma_ss<64>(s, fl::k_desc(q_base, 64, kk), fl::k_desc(k_base, 64, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < NC; ++kk)
      ddpo::wgmma_ss<64>(dp, fl::k_desc(g_base, 64, kk), fl::k_desc(v_base, 64, kk), kk > 0);
    ddpo::wgmma_commit();
    ddpo::fence_operands(s);
    ddpo::fence_operands(dp);
    turns.pass(false);
    ddpo::wgmma_wait<0>();
    ddpo::fence_operands(s);
    ddpo::fence_operands(dp);

    // P = exp2(S scale log2(e) - lse log2(e)), dS = P (dP - delta); the lane
    // holds rows g + 8r and keys 8j + 2tq + e of the tile. Keys past Sk give
    // P = 0.
    const int keys_left = a.Sk - t * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float p = ddpo::exp2_ftz(fmaf(s[i], scale_log2, -lse2[r]));
          if (8 * j + 2 * tq + e >= keys_left) p = 0.f;
          s[i] = p * (dp[i] - dl[r]);
        }
    fl::pack_a(da, s);

    // dQ += dS K over this group's atoms (K MN-major), the tile's four k
    // steps of 16 keys in order
    turns.take();
    ddpo::wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      ddpo::wgmma_rs_mn<N0>(dq[0], da[kq], fl::mn_desc(k_base, 64, A0, kq));
      if constexpr (GN > 1)
        ddpo::wgmma_rs_mn<N1>(dq[1], da[kq], fl::mn_desc(k_base, 64, A0 + 1, kq));
    }
    ddpo::wgmma_commit();
    fence_dq();
    turns.pass(t == nt - 1);
    ddpo::wgmma_wait<0>();
    fence_dq();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) ddpo::fence_operands(da[kq]);
    ddpo::mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * wq + g + 8 * r;
    if (row >= a.Sq) continue;
    bf16* orow = a.dq + ((int64_t(b) * a.Sq + row) * a.H + h) * a.D;
#pragma unroll
    for (int c = 0; c < GN; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c < GN - 1 ? j < N0 / 8 : j < N1 / 8)
          ddpo::store_pair(orow, (A0 + c) * fl::ATOM + 8 * j + 2 * tq, a.D,
                           dq[c][4 * j + 2 * r] * a.scale, dq[c][4 * j + 2 * r + 1] * a.scale);
  }
}

// dQ for 64 * NCW query rows of one (head, batch) and one column group:
// grid (query tiles, H, B * GROUPS)
template <int NC>
__global__ void __launch_bounds__(fl::block_threads(DqTile<NC>::NCW), 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
    const WgArgs a) {
  using Tile = DqTile<NC>;
  constexpr int NA = Tile::NA, NCW = Tile::NCW, TILE = Tile::TILE, ST = Tile::stages();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (ddpo::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* gs = qs + NCW * TILE;  // dO: [NCW][NA][64][128]
  uint8_t* ks = gs + NCW * TILE;  // K: [ST][NA][64][128]
  uint8_t* vs = ks + ST * TILE;   // V: [ST][NA][64][128]
  float* stats = reinterpret_cast<float*>(vs + ST * TILE);  // [NCW][lse 64, delta 64]
  const uint32_t bars = ddpo::smem_addr(stats + NCW * 128);
  const uint32_t q_full = bars;
  auto kv_full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * 64 * NCW, h = blockIdx.y;
  const int b = blockIdx.z / Tile::GROUPS, grp = blockIdx.z - b * Tile::GROUPS;
  const int nt = (a.Sk + 63) / 64;

  if (tid == 0) {
    ddpo::mbar_init(q_full, 32);  // the producer warp's lanes
    for (int s = 0; s < ST; ++s) {
      ddpo::mbar_init(kv_full(s), a.tma ? 1 : 32);
      ddpo::mbar_init(empty(s), NCW * fl::WG);
    }
    ddpo::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NCW) {  // the producer warp
    const float* lse_bh = a.lse + (int64_t(b) * a.H + h) * a.Sq;
    const float* dl_bh = a.delta + (int64_t(b) * a.H + h) * a.Sq;
    // lse and delta of the block's query rows (0 past Sq) by cp.async, 4
    // bytes each, the lane's share, arriving on q_full once they land
    auto stage_stats = [&]() {
      for (int i = lane; i < NCW * 128; i += 32) {
        const int row = q0 + 64 * (i >> 7) + (i & 63);
        const float* src = (i & 127) < 64 ? lse_bh : dl_bh;
        ddpo::cp_async4(ddpo::smem_addr(stats + i), row < a.Sq ? src + row : src, row < a.Sq);
      }
    };
    if (a.tma) {
      if (lane == 0) {
        ddpo::mbar_expect_tx(q_full, 2 * NCW * TILE);
        for (int c = 0; c < NCW; ++c) {
          fl::load_tile(ddpo::smem_addr(qs + c * TILE), &qmap, q_full, b, h, q0 + 64 * c, 64, NA);
          fl::load_tile(ddpo::smem_addr(gs + c * TILE), &gmap, q_full, b, h, q0 + 64 * c, 64, NA);
        }
      }
      stage_stats();
      ddpo::cp_async_mbar_arrive(q_full);
      if (lane == 0) {
        for (int t = 0; t < nt; ++t) {
          const int s = t % ST, use = t / ST;
          if (use > 0) ddpo::mbar_wait(empty(s), (use - 1) & 1);
          ddpo::mbar_arrive_expect_tx(kv_full(s), 2 * TILE);
          fl::load_tile(ddpo::smem_addr(ks + s * TILE), &kmap, kv_full(s), b, h, t * 64, 64, NA);
          fl::load_tile(ddpo::smem_addr(vs + s * TILE), &vmap, kv_full(s), b, h, t * 64, 64, NA);
        }
      }
    } else {
      const bf16* qb = a.q + b * a.st.q_b + h * a.st.q_h;
      const bf16* kb = a.k + b * a.st.k_b + h * a.st.k_h;
      const bf16* vb = a.v + b * a.st.v_b + h * a.st.v_h;
      const bf16* gb = a.dout + b * a.st.do_b + h * a.st.do_h;
      for (int c = 0; c < NCW; ++c) {
        fl::stage_tile(qs + c * TILE, qb, a.st.q_s, q0 + 64 * c, 64, a.Sq, a.D, NA, lane, 32);
        fl::stage_tile(gs + c * TILE, gb, a.st.do_s, q0 + 64 * c, 64, a.Sq, a.D, NA, lane, 32);
      }
      stage_stats();
      ddpo::fence_proxy_async();
      ddpo::cp_async_mbar_arrive(q_full);
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST, use = t / ST;
        if (use > 0) ddpo::mbar_wait(empty(s), (use - 1) & 1);
        fl::stage_tile(ks + s * TILE, kb, a.st.k_s, t * 64, 64, a.Sk, a.D, NA, lane, 32);
        fl::stage_tile(vs + s * TILE, vb, a.st.v_s, t * 64, 64, a.Sk, a.D, NA, lane, 32);
        ddpo::fence_proxy_async();
        ddpo::mbar_arrive(kv_full(s));
      }
    }
    return;
  }

  const int cw = warp / 4;
  const uint32_t q_base = ddpo::smem_addr(qs + cw * TILE), g_base = ddpo::smem_addr(gs + cw * TILE);
  const float* st_cw = stats + cw * 128;
  const uint32_t k_s = ddpo::smem_addr(ks), v_s = ddpo::smem_addr(vs);
  const int row0 = q0 + 64 * cw;
  if (grp == 0) dq_consumer<NC, 0>(a, q_base, g_base, st_cw, k_s, v_s, bars, row0, b, h);
  if constexpr (Tile::GROUPS > 1)
    if (grp == 1) dq_consumer<NC, 1>(a, q_base, g_base, st_cw, k_s, v_s, bars, row0, b, h);
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Sq, Sk, D;
  Strides st;
  float scale;
};

template <typename T, int NC>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr int BR = own_rows<NC>();
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem_bytes<NC>(16 * NC)));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + BR - 1) / BR, a.H, a.B);
  flash_bwd_dq_kernel<T, NC><<<grid, 4 * BR, smem_bytes<NC>(a.D), stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.Sq,
      a.Sk, a.D, a.st, a.scale);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  constexpr int BR = own_rows<NC>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem_bytes<NC>(16 * NC)));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sk + BR - 1) / BR, a.H, a.B);
  flash_bwd_dkv_kernel<T, NC><<<grid, 4 * BR, smem_bytes<NC>(a.D), stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.Sq, a.Sk, a.D, a.st, a.scale);
  return cudaGetLastError();
}

// Both bf16 kernels' arguments, and the tensor maps of Q, K, V and dO
// (tiles of 64 rows): a.tma says whether TMA takes all four
WgArgs wg_args(const BwdArgs& args, CUtensorMap (&maps)[4]) {
  WgArgs a{};
  a.q = static_cast<const bf16*>(args.q);
  a.k = static_cast<const bf16*>(args.k);
  a.v = static_cast<const bf16*>(args.v);
  a.dout = static_cast<const bf16*>(args.dout);
  a.lse = args.lse;
  a.delta = args.delta;
  a.dq = static_cast<bf16*>(args.dq);
  a.dk = static_cast<bf16*>(args.dk);
  a.dv = static_cast<bf16*>(args.dv);
  a.H = args.H, a.Sq = args.Sq, a.Sk = args.Sk, a.D = args.D;
  a.st = args.st;
  a.scale = args.scale;
  const Strides& st = args.st;
  const int64_t strides[12] = {st.q_b, st.q_s, st.q_h, st.k_b, st.k_s, st.k_h,
                               st.v_b, st.v_s, st.v_h, st.do_b, st.do_s, st.do_h};
  const void* bases[4] = {args.q, args.k, args.v, args.dout};
  const int rows[4] = {64, 64, 64, 64}, lens[4] = {args.Sq, args.Sk, args.Sk, args.Sq};
  a.tma = fl::tensor_maps(maps, bases, strides, 4, args.B, lens, args.H, args.D, rows);
  return a;
}

template <int NC>
cudaError_t launch_dq_wgmma(const BwdArgs& args, cudaStream_t stream) {
  using Tile = DqTile<NC>;
  CUtensorMap maps[4] = {};
  const WgArgs a = wg_args(args, maps);
  const size_t smem = Tile::smem(Tile::stages());
  // above 48 KB a block's dynamic shared memory must be allowed, once
  static const cudaError_t allowed = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (allowed != cudaSuccess) return allowed;
  constexpr int rows = 64 * Tile::NCW;
  const dim3 grid((args.Sq + rows - 1) / rows, args.H, args.B * Tile::GROUPS);
  flash_bwd_dq_wgmma_kernel<NC><<<grid, fl::block_threads(Tile::NCW), smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_dkv_wgmma(const BwdArgs& args, cudaStream_t stream) {
  using Tile = DkvTile<NC>;
  CUtensorMap maps[4] = {};
  WgArgs a = wg_args(args, maps);
  a.stages = 4;
  while (a.stages > 2 && Tile::smem(a.stages) > size_t(fl::SMEM_MAX)) --a.stages;
  const size_t smem = Tile::smem(a.stages);
  // above 48 KB a block's dynamic shared memory must be allowed, once
  static const cudaError_t allowed = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (allowed != cudaSuccess) return allowed;
  constexpr int keys = 64 * Tile::NCW;
  const dim3 grid((args.Sk + keys - 1) / keys, args.H, args.B * Tile::GROUPS);
  flash_bwd_dkv_wgmma_kernel<NC><<<grid, fl::block_threads(Tile::NCW), smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

// bf16 takes the wgmma kernels, fp32 the FMA kernels
// (if constexpr: a translation unit instantiates only its half's kernels)
template <typename T, bool DQ, int NC>
cudaError_t launch_for(const BwdArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    if constexpr (DQ) return launch_dq_wgmma<NC>(a, stream);
    else return launch_dkv_wgmma<NC>(a, stream);
  } else {
    if constexpr (DQ) return launch_dq<T, NC>(a, stream);
    else return launch_dkv<T, NC>(a, stream);
  }
}

template <typename T, bool DQ>
cudaError_t dispatch_nc(const BwdArgs& a, cudaStream_t stream) {
  switch ((a.D + 15) / 16) {
#define DDPO_NC(n) \
  case n:          \
    return launch_for<T, DQ, n>(a, stream);
    DDPO_NC(1) DDPO_NC(2) DDPO_NC(3) DDPO_NC(4) DDPO_NC(5) DDPO_NC(6) DDPO_NC(7)
    DDPO_NC(8) DDPO_NC(9) DDPO_NC(10) DDPO_NC(11) DDPO_NC(12) DDPO_NC(13)
    DDPO_NC(14) DDPO_NC(15) DDPO_NC(16)
#undef DDPO_NC
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int run(const BwdArgs& a, int dtype, void* stream) {
  if (a.D < 1 || a.D > 256 || a.Sq < 1 || a.Sk < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ddpo::kFloat32) return int(dispatch_nc<float, DQ>(a, s));
  if (dtype == ddpo::kBFloat16) return int(dispatch_nc<__nv_bfloat16, DQ>(a, s));
  return int(cudaErrorInvalidValue);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, int B, int H, int Sq, int Sk,
                  int D, const int64_t* strides, float scale) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D;
  a.st = Strides{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                 strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  a.scale = scale;
  return a;
}

}  // namespace

#ifndef DDPO_FLASH_BWD_DKV  // the dQ half (flash_bwd_dkv.cu builds the other)

// q/dout: (B, Sq, H, D), k/v: (B, Sk, H, D), read through the (b, s, h)
// strides in elements given as 12 int64 in the order q, k, v, dout (the d
// stride must be 1). lse (the forward's) and delta = rowsum(dout * out):
// contiguous (B, H, Sq) fp32. dq: contiguous (B, Sq, H, D) in the input
// dtype. 1 <= D <= 256. Returns cudaGetLastError() after the launch.
extern "C" int ddpo_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int dtype, int B, int H, int Sq, int Sk, int D,
                                 const int64_t* strides, float scale, void* stream) {
  BwdArgs a = make_args(q, k, v, dout, lse, delta, B, H, Sq, Sk, D, strides, scale);
  a.dq = dq;
  return run<true>(a, dtype, stream);
}

// 1 where the flash kernels' producers (the bf16 forward's, dQ's and
// dK/dV's; elem_bytes 4: the fp32 forward's Q and K) load the (B, S, H, D)
// array at base with these element strides by TMA, 0 where they stage it
// by plain loads
extern "C" int ddpo_flash_tma_ok(const void* base, int B, int S, int H, int D, int64_t sb,
                                 int64_t ss, int64_t sh, int elem_bytes) {
  CUtensorMap map;
  return ddpo::bshd_tensor_map(&map, base, B, S, H, D, sb, ss, sh, 64, elem_bytes) == cudaSuccess;
}

#else  // the dK/dV half

// As ddpo_flash_bwd_dq; dk, dv: contiguous (B, Sk, H, D) in the input dtype.
extern "C" int ddpo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int dtype, int B, int H, int Sq,
                                  int Sk, int D, const int64_t* strides, float scale,
                                  void* stream) {
  BwdArgs a = make_args(q, k, v, dout, lse, delta, B, H, Sq, Sk, D, strides, scale);
  a.dk = dk;
  a.dv = dv;
  return run<false>(a, dtype, stream);
}

#endif  // DDPO_FLASH_BWD_DKV
