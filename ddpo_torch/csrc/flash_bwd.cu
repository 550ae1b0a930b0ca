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
// few MB that sit in the 50 MB L2. Like the forward, this first version runs
// every product on the CUDA cores in fp32 FMA, so the FMA rate and the
// shared-memory loads that feed it are the limit.
//
// What the design does about it: the forward's scheme. One block owns a tile
// of rows (queries for dq, keys for dkv) and streams 64-row tiles of the
// other side; each thread owns a 4x4 tile of scores, so every pair of
// 16-byte shared-memory loads feeds 16 FMAs, and the S and dP products share
// one loop over D. The block's output rows stay in fp32 registers, with
// ceil(D/16) strided columns per thread, so no float atomics are needed and
// a recompute gives the same bits. Every tile sits in shared memory as fp32;
// five of them at 64 rows need 191 KB at D = 160, so above D = 160 a block
// owns 32 rows with 128 threads (222 KB at D = 256). Q, K, V and dO are read
// through their (B, S, H) strides, so the caller neither pads nor
// transposes. Tensor-core mma/wgmma and TMA pipelining are later work.

#include "common.cuh"

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

template <typename T, bool DQ>
cudaError_t dispatch_nc(const BwdArgs& a, cudaStream_t stream) {
  switch ((a.D + 15) / 16) {
#define DDPO_NC(n) \
  case n:          \
    return DQ ? launch_dq<T, n>(a, stream) : launch_dkv<T, n>(a, stream);
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
