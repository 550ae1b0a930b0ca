// Flash-attention forward for sm_90a.
//
// Replaces: ddpo_tpu/ops/attention.py::_flash_kernel (the Pallas TPU kernel
// behind flash_attention / _flash_forward). Same function: online softmax in
// fp32 over K/V tiles, padded keys masked, writes out (input dtype) and the
// row logsumexp (fp32) that the flash backward reads.
//
// What bounds it on this card: at the UNet's shapes (S = 4096/1024/256,
// D = 40/80/160, B*H = 64) attention is compute-bound, about 4*S*S*D flops
// per (batch, head), while Q/K/V/O are a few MB that sit in the 50 MB L2.
// This first version runs the two products on the CUDA cores in fp32 FMA
// (no tensor cores), so the FMA rate and the shared-memory loads that feed
// it are the limit.
//
// What the design does about it: one block per (64-query tile, head, batch)
// with 256 threads; each thread owns a 4x4 tile of scores, so every pair of
// 16-byte shared-memory loads feeds 16 FMAs. Q is staged once, pre-scaled
// by scale*log2(e) so the softmax uses exp2f; K (transposed) and V tiles of
// 64 keys are staged per step, and P goes through shared memory for the PV
// product, where each thread owns 4 rows and ceil(D/16) strided columns of
// the fp32 accumulator. The (S, S) scores never reach device memory. Ragged
// Sq and Sk are masked here, and Q/K/V are read through their (B, S, H)
// strides, so the caller neither pads nor transposes. tensor-core mma/wgmma
// and TMA pipelining are later work.

#include "common.cuh"

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

template <typename T>
cudaError_t dispatch_nc(const void* q, const void* k, const void* v, void* out,
                        float* lse, int B, int H, int Sq, int Sk, int D,
                        const int64_t* st, float scale, cudaStream_t stream) {
  switch ((D + 15) / 16) {
#define DDPO_NC(n) \
  case n:          \
    return launch<T, n>(q, k, v, out, lse, B, H, Sq, Sk, D, st, scale, stream);
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
