// Flash-attention forward for sm_90a.
//
// Replaces: ddpo_tpu/ops/attention.py::_flash_kernel (the Pallas TPU kernel
// behind flash_attention / _flash_forward). Same function: online softmax in
// fp32 over K/V tiles, padded keys masked, writes out (input dtype) and the
// natural-log row logsumexp (fp32) that the flash backward reads.
//
// What bounds it on this card: at the UNet's shapes (S = 4096/1024/256,
// D = 40/80/160, B*H = 64) attention is compute-bound, 4*Sq*Sk*D flops per
// (batch, head) against a few MB of Q/K/V/O that sit in the 50 MB L2. At
// D = 40 the exponentials weigh as much as the products: 64 x 64 exp2f a
// tile against 2 x 64 x 64 x 48 multiply-adds, and the SFU does 16 a clock
// per SM, so below D = 64 the softmax, not the tensor cores, sets the pace.
//
// bf16, on the tensor cores (flash_fwd_mma_kernel), FlashAttention-2's shape:
//   - A block of 4 warps owns 64 query rows, 16 per warp; from Sq = 1024
//     up and for D <= 80, 128 rows, 32 per warp in two m16 tiles that share
//     every K and V fragment. Grid (query tiles, H, B). Q is staged once and
//     its A fragments loaded once with ldmatrix (kept in registers up to
//     D = 160, read from shared memory per tile above, where the O
//     accumulators take the registers).
//   - K and V tiles of 64 keys are staged with cp.async (16 bytes a thread)
//     into two buffers: tile t+1 loads while tile t is multiplied. Rows are
//     D padded to 16*NC with zeros, plus 8 more so that ldmatrix's eight row
//     addresses fall in eight distinct bank groups. The zero padding lives in
//     shared memory only (D = 40 runs three k16 steps over 48 columns).
//     Rows past Sk are zero-filled by cp.async; D not a multiple of 8, or
//     strides that are not, take element-wise loads instead.
//   - S = Q K^T with mma.sync.m16n8k16 (bf16 in, fp32 accumulate), K's B
//     fragments by ldmatrix; each lane holds 2 rows x 16 keys of S.
//   - Online softmax on those registers: row max and sum across the lane
//     quad by shuffles, exp2f(s * scale*log2(e) - m). The scale is applied to
//     the fp32 scores, not folded into a bf16 Q, which would round it.
//   - P is rounded to bf16 in registers and used directly as the A fragments
//     of O += P V; V's B fragments come by ldmatrix.trans from the same
//     [key][d] tile. This rounding is the one numerical change against the
//     fp32 path; JAX's xla_attention rounds its weights to v's dtype too.
//     The row sum l is taken over the fp32 P, so the LSE does not see it.
//   - out = O / l in bf16 and lse = (m + log2 l) * ln 2, as before.
// Summation order: each output element has one owner (a lane of the warp
// that owns its row) and adds its terms in a fixed order: key tiles in
// order, the mma's k16 steps in order, a fixed butterfly over the quad. No
// split over keys and no atomics, and nothing depends on the batch, the
// head or the row's place in the tile, so two calls give the same bits and
// image i alone gives the bits it gets inside a batch.
//
// fp32 (flash_fwd_kernel) stays on the CUDA cores in FMA: TF32 tensor cores
// keep 10 mantissa bits and would break the 1e-4 bounds against the fp32
// plain version. One block per (64-query tile, head, batch) with 256
// threads; each thread owns a 4x4 tile of scores, so every pair of 16-byte
// shared-memory loads feeds 16 FMAs. Q is staged once, pre-scaled by
// scale*log2(e); K (transposed) and V tiles of 64 keys are staged per step,
// and P goes through shared memory for the PV product. Both paths mask
// ragged Sq and Sk here and read Q/K/V through their (B, S, H) strides, so
// the caller neither pads nor transposes.

#include "common.cuh"
#include "mma.cuh"

#include <type_traits>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int NT = 256;       // threads per block: 16 x 16, 4x4 scores each
constexpr int LDT = BQ + 4;   // row stride (floats) of qT/kT/pT: 16-byte rows

template <int NC>
constexpr size_t smem_bytes(int d) {
  // qT [d][LDT] + kT [d][LDT] + vs [BK][16*NC] + pT [BK][LDT]
  return sizeof(float) * (size_t(2) * d * LDT + size_t(BK) * 16 * NC + size_t(BK) * LDT);
}

template <typename T, int NC>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale_log2) {
  constexpr int DP = 16 * NC;  // V tile row width: D padded with zeros
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* kT = qT + D * LDT;
  float* vs = kT + D * LDT;
  float* pT = vs + BK * DP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key group (scores) / column group (output)
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx - r * D;
    const int row = q0 + r;
    qT[d * LDT + r] =
        row < Sq ? ddpo::to_float(qb[row * q_ss + d]) * scale_log2 : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // previous tile's readers of kT/vs/pT are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx - j * D;
      const int key = k0 + j;
      kT[d * LDT + j] = key < Sk ? ddpo::to_float(kb[key * k_ss + d]) : 0.f;
    }
    for (int idx = tid; idx < BK * DP; idx += NT) {
      const int j = idx / DP, c = idx - j * DP;
      const int key = k0 + j;
      vs[idx] = (key < Sk && c < D) ? ddpo::to_float(vb[key * v_ss + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty*4+i, keys tx*4+j (log2 domain)
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * LDT + ty * 4);
      const float4 bb = *reinterpret_cast<const float4*>(kT + d * LDT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx * 4 + j >= Sk)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;

    // online softmax; the 16 lanes sharing ty hold one row between them
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: each tile has a valid key
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * LDT + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // O += P V for rows ty*4+i, columns tx + 16*c
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pT + j * LDT + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[j * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  const float kLn2 = 0.69314718055994531f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = 1.f / l[i];
    T* orow = out + ((int64_t(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) orow[col] = ddpo::from_float<T>(acc[i][c] * inv);
    }
    if (tx == 0) lse[(int64_t(b) * H + h) * Sq + row] = (m[i] + log2f(l[i])) * kLn2;
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int H, int Sq, int Sk, int D, const int64_t* st,
                   float scale, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem_bytes<NC>(16 * NC)));
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const float kLog2e = 1.4426950408889634f;
  flash_fwd_kernel<T, NC><<<grid, NT, smem_bytes<NC>(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, H, Sq, Sk, D, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale * kLog2e);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;

using ddpo::mma_ld;
using ddpo::stage_rows;

constexpr int kWarps = 4;  // warps per block of the tensor-core kernel

// Q [64 * MI][LD] + K [2][BK][LD] + V [2][BK][LD], bf16
template <int NC, int MI>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * size_t(16 * kWarps * MI + 4 * BK) * mma_ld<NC>();
}

// 4 warps of 16 * MI query rows each (the MI m16 tiles of a warp share
// each K and V fragment)
template <int NC, int MI>
__global__ void __launch_bounds__(32 * kWarps) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale_log2, bool vec) {
  constexpr int LD = mma_ld<NC>();
  constexpr int MQ = 16 * MI * kWarps, MT = 32 * kWarps;
  constexpr bool kQRegs = NC * MI <= 10;  // Q's fragments in registers up to D = 160
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* ks = qs + MQ * LD;
  bf16* vs = ks + 2 * BK * LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * MQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < (MQ + 4 * BK) * LD / 8; i += MT) smem_u4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  stage_rows(qs, qb, q_ss, q0, MQ, Sq, D, LD, vec, tid, MT);
  stage_rows(ks, kb, k_ss, 0, BK, Sk, D, LD, vec, tid, MT);
  stage_rows(vs, vb, v_ss, 0, BK, Sk, D, LD, vec, tid, MT);
  ddpo::cp_async_commit();
  ddpo::cp_async_wait<0>();
  __syncthreads();

  // A fragments of Q
  const uint32_t q_addr = ddpo::smem_addr(qs + warp * 16 * MI * LD + ddpo::a_frag_off(lane, LD));
  uint32_t qf[kQRegs ? MI : 1][kQRegs ? NC : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int kk = 0; kk < NC; ++kk)
        ddpo::ldmatrix_x4(qf[mi][kk], q_addr + (mi * 16 * LD + kk * 16) * 2);
  }
  // B fragments: K (non-trans, [key][d]) two key tiles of 8 per x4; V
  // (trans, [key][d]) two d tiles of 8 per x4
  const int k_off = ddpo::b_frag_off(lane, LD), v_off = ddpo::bt_frag_off(lane, LD);

  float o[MI][2 * NC][4];
  float m[MI][2], l[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n) o[mi][n][0] = o[mi][n][1] = o[mi][n][2] = o[mi][n][3] = 0.f;
    m[mi][0] = m[mi][1] = -INFINITY;
    l[mi][0] = l[mi][1] = 0.f;
  }

  const int ntiles = (Sk + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntiles) {  // the other buffer's readers passed the barrier ending tile t-1
      stage_rows(ks + (cur ^ 1) * BK * LD, kb, k_ss, (t + 1) * BK, BK, Sk, D, LD, vec, tid, MT);
      stage_rows(vs + (cur ^ 1) * BK * LD, vb, v_ss, (t + 1) * BK, BK, Sk, D, LD, vec, tid, MT);
    }
    ddpo::cp_async_commit();
    ddpo::cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const uint32_t k_addr = ddpo::smem_addr(ks + cur * BK * LD + k_off);
    const uint32_t v_addr = ddpo::smem_addr(vs + cur * BK * LD + v_off);

    // S = Q K^T: 16 MI rows x 64 keys per warp, 2 MI rows x 16 keys per lane
    float s[MI][8][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[mi][j][0] = s[mi][j][1] = s[mi][j][2] = s[mi][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if constexpr (kQRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[mi][i] = qf[mi][kk][i];
        } else {
          ddpo::ldmatrix_x4(a[mi], q_addr + (mi * 16 * LD + kk * 16) * 2);
        }
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bb[4];
        ddpo::ldmatrix_x4(bb, k_addr + (jp * 16 * LD + kk * 16) * 2);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          ddpo::mma_bf16(s[mi][2 * jp], a[mi], bb[0], bb[1]);
          ddpo::mma_bf16(s[mi][2 * jp + 1], a[mi], bb[2], bb[3]);
        }
      }
    }
    if ((t + 1) * BK > Sk) {  // keys past Sk
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (t * BK + j * 8 + 2 * (lane & 3) + e >= Sk)
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) s[mi][j][e] = s[mi][j][2 + e] = -INFINITY;
    }

    // online softmax; row r of the lane in m16 tile mi is g + 8r, its other
    // 48 keys are held by the three lanes of its quad
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[mi][j][2 * r], s[mi][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mi][r], mx * scale_log2);  // finite: each tile has a key
        const float corr = ddpo::exp2_ftz(m[mi][r] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ddpo::exp2_ftz(fmaf(s[mi][j][2 * r + e], scale_log2, -m_new));
            s[mi][j][2 * r + e] = p;
            rs += p;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[mi][r] = l[mi][r] * corr + rs;
        m[mi][r] = m_new;
#pragma unroll
        for (int n = 0; n < 2 * NC; ++n) {
          o[mi][n][2 * r] *= corr;
          o[mi][n][2 * r + 1] *= corr;
        }
      }

    // O += P V, P rounded to bf16 as the A fragments (keys 16kk .. 16kk+15)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        a[mi][0] = ddpo::pack_bf16(s[mi][2 * kk][0], s[mi][2 * kk][1]);
        a[mi][1] = ddpo::pack_bf16(s[mi][2 * kk][2], s[mi][2 * kk][3]);
        a[mi][2] = ddpo::pack_bf16(s[mi][2 * kk + 1][0], s[mi][2 * kk + 1][1]);
        a[mi][3] = ddpo::pack_bf16(s[mi][2 * kk + 1][2], s[mi][2 * kk + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < NC; ++np) {
        uint32_t bb[4];
        ddpo::ldmatrix_x4_trans(bb, v_addr + (kk * 16 * LD + np * 16) * 2);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          ddpo::mma_bf16(o[mi][2 * np], a[mi], bb[0], bb[1]);
          ddpo::mma_bf16(o[mi][2 * np + 1], a[mi], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this tile's buffers may be refilled
  }

  const float kLn2 = 0.69314718055994531f;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + (warp * MI + mi) * 16 + g + 8 * r;
      if (row >= Sq) continue;
      const float inv = 1.f / l[mi][r];
      bf16* orow = out + ((int64_t(b) * Sq + row) * H + h) * D;
#pragma unroll
      for (int n = 0; n < 2 * NC; ++n) {
        const int col = n * 8 + 2 * tq;
        ddpo::store_pair(orow, col, D, o[mi][n][2 * r] * inv, o[mi][n][2 * r + 1] * inv);
      }
      if (tq == 0) lse[(int64_t(b) * H + h) * Sq + row] = (m[mi][r] + log2f(l[mi][r])) * kLn2;
    }
}

template <int NC, int MI>
cudaError_t launch_tiles(const void* q, const void* k, const void* v, void* out, float* lse,
                         int B, int H, int Sq, int Sk, int D, const int64_t* st, float scale,
                         cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<NC, MI>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<NC, MI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const bool vec = ddpo::rows_vectorizable(D, st, 9, {q, k, v});
  constexpr int rows = 16 * kWarps * MI;
  const dim3 grid((Sq + rows - 1) / rows, H, B);
  const float kLog2e = 1.4426950408889634f;
  flash_fwd_mma_kernel<NC, MI><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, H, Sq, Sk, D, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale * kLog2e, vec);
  return cudaGetLastError();
}

// Two m16 tiles a warp (128 rows a block) up to D = 80 from Sq = 1024 up:
// half the K/V fragment loads per product, and faster than one tile at
// the UNet's S = 4096 and 1024 (PERF.md), with the same bits. Not above
// D = 80 (the accumulators would pass 255 registers) nor below Sq = 1024,
// where 128-row blocks leave SMs idle (S = 256 at 2B = 8: 128 blocks).
template <int NC>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                       int B, int H, int Sq, int Sk, int D, const int64_t* st, float scale,
                       cudaStream_t stream) {
  if constexpr (NC <= 5) {
    if (Sq >= 1024)
      return launch_tiles<NC, 2>(q, k, v, out, lse, B, H, Sq, Sk, D, st, scale, stream);
  }
  return launch_tiles<NC, 1>(q, k, v, out, lse, B, H, Sq, Sk, D, st, scale, stream);
}

// bf16 takes the tensor-core kernel, fp32 the FMA kernel
template <typename T, int NC>
cudaError_t launch_for(const void* q, const void* k, const void* v, void* out, float* lse,
                       int B, int H, int Sq, int Sk, int D, const int64_t* st, float scale,
                       cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>)
    return launch_mma<NC>(q, k, v, out, lse, B, H, Sq, Sk, D, st, scale, stream);
  else
    return launch<T, NC>(q, k, v, out, lse, B, H, Sq, Sk, D, st, scale, stream);
}

template <typename T>
cudaError_t dispatch_nc(const void* q, const void* k, const void* v, void* out,
                        float* lse, int B, int H, int Sq, int Sk, int D,
                        const int64_t* st, float scale, cudaStream_t stream) {
  switch ((D + 15) / 16) {
#define DDPO_NC(n) \
  case n:          \
    return launch_for<T, n>(q, k, v, out, lse, B, H, Sq, Sk, D, st, scale, stream);
    DDPO_NC(1) DDPO_NC(2) DDPO_NC(3) DDPO_NC(4) DDPO_NC(5) DDPO_NC(6) DDPO_NC(7)
    DDPO_NC(8) DDPO_NC(9) DDPO_NC(10) DDPO_NC(11) DDPO_NC(12) DDPO_NC(13)
    DDPO_NC(14) DDPO_NC(15) DDPO_NC(16)
#undef DDPO_NC
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), read through the (b, s, h) strides in
// elements (the d stride must be 1); out: contiguous (B, Sq, H, D) in the
// input dtype; lse: contiguous (B, H, Sq) fp32. 1 <= D <= 256.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ddpo_flash_fwd(const void* q, const void* k, const void* v, void* out,
                              void* lse, int dtype, int B, int H, int Sq, int Sk,
                              int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                              int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                              int64_t v_ss, int64_t v_sh, float scale, void* stream) {
  if (D < 1 || D > 256 || Sq < 1 || Sk < 1) return int(cudaErrorInvalidValue);
  const int64_t st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == ddpo::kFloat32)
    return int(dispatch_nc<float>(q, k, v, out, l, B, H, Sq, Sk, D, st, scale, s));
  if (dtype == ddpo::kBFloat16)
    return int(dispatch_nc<__nv_bfloat16>(q, k, v, out, l, B, H, Sq, Sk, D, st, scale, s));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* ddpo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
