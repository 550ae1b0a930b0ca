// Fused GroupNorm + affine + SiLU forward for sm_90a.
//
// Replaces: ddpo_tpu/ops/groupnorm.py::_gn_silu_kernel (the Pallas TPU
// kernel behind group_norm_silu(use_kernel=True)). Same function: fp32
// statistics per (n, group), var = E[x^2] - E[x]^2, rsqrt(var + eps), then
// (x - mean) * rstd * scale + bias, then y * sigmoid(y), stored in x's dtype.
// Forward only, as in JAX.
//
// What bounds it on this card: a few flops per element, so device-memory
// bandwidth (3.35 TB/s): at least one read of x and one write of the output.
//
// What the design does about it: in NCHW each (n, group) is one contiguous
// run of (C/G)*H*W elements, and one block owns one run. Pass 1 reads the
// run with 16-byte loads (scalar loads where H*W is not a multiple of the
// vector or the map is not 16-byte aligned), sums x and x^2 in fp32, and
// keeps the raw run in shared memory where it fits (every UNet map at
// 512 px up to 224 KB a run). Pass 2 normalizes from shared memory, or reads
// the run a second time where it does not fit (the VAE decoder's 2 MB
// runs). The block reduction adds in a fixed order with no float atomics,
// so two calls on one input give the same bits.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCacheBytes = 224 * 1024;  // of the 227 KB a block may use

template <typename T>
__device__ __forceinline__ float gn_silu_value(T raw, float mean, float rstd, float sc,
                                               float bi) {
  const float y = (ddpo::to_float(raw) - mean) * rstd * sc + bi;
  return y / (1.f + expf(-y));
}

template <typename T, bool kCache, bool kVec>
__global__ void __launch_bounds__(kThreads) gn_silu_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ out, int num_groups, int cpg,
    int hw, float eps) {
  constexpr int V = kVec ? 16 / sizeof(T) : 1;
  extern __shared__ uint4 cache4[];
  __shared__ float red[2][kThreads / 32];
  __shared__ float stats[2];

  const int64_t run = blockIdx.x;  // n * num_groups + g
  const int run_len = cpg * hw;
  const int c0 = int(run % num_groups) * cpg;
  const T* base = x + run * run_len;
  T* obase = out + run * run_len;
  const int nvec = run_len / V;
  const int hwv = hw / V;  // vectors per channel

  // pass 1: sums, and the raw run into shared memory where it fits
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    alignas(16) T e[V];
    if constexpr (kVec) {
      const uint4 raw = reinterpret_cast<const uint4*>(base)[i];
      if constexpr (kCache) cache4[i] = raw;
      *reinterpret_cast<uint4*>(e) = raw;
    } else {
      e[0] = base[i];
      if constexpr (kCache) reinterpret_cast<T*>(cache4)[i] = e[0];
    }
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const float v = ddpo::to_float(e[t]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  s = ddpo::warp_sum(s);
  ss = ddpo::warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tss = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      ts += red[0][w];
      tss += red[1][w];
    }
    const float count = float(run_len);
    const float mean = ts / count;
    stats[0] = mean;
    stats[1] = rsqrtf(tss / count - mean * mean + eps);
  }
  __syncthreads();
  const float mean = stats[0], rstd = stats[1];

  // pass 2: normalize, affine, SiLU; a vector never spans two channels
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const int c = c0 + i / hwv;
    const float sc = __ldg(scale + c), bi = __ldg(bias + c);
    alignas(16) T e[V];
    if constexpr (kVec) {
      *reinterpret_cast<uint4*>(e) =
          kCache ? cache4[i] : reinterpret_cast<const uint4*>(base)[i];
    } else {
      e[0] = kCache ? reinterpret_cast<const T*>(cache4)[i] : base[i];
    }
#pragma unroll
    for (int t = 0; t < V; ++t) e[t] = ddpo::from_float<T>(gn_silu_value(e[t], mean, rstd, sc, bi));
    if constexpr (kVec)
      reinterpret_cast<uint4*>(obase)[i] = *reinterpret_cast<const uint4*>(e);
    else
      obase[i] = e[0];
  }
}

template <typename T, bool kCache, bool kVec>
cudaError_t launch_one(const void* x, const float* scale, const float* bias, void* out,
                       int64_t n_runs, int num_groups, int cpg, int hw, float eps,
                       cudaStream_t stream) {
  const size_t smem = kCache ? size_t(cpg) * hw * sizeof(T) : 0;
  if constexpr (kCache) {
    cudaError_t e = cudaFuncSetAttribute(gn_silu_kernel<T, kCache, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxCacheBytes);
    if (e != cudaSuccess) return e;
  }
  gn_silu_kernel<T, kCache, kVec><<<unsigned(n_runs), kThreads, smem, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), num_groups, cpg, hw,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* out,
                   int64_t n_runs, int num_groups, int cpg, int hw, float eps,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = hw % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool cache = int64_t(cpg) * hw * int64_t(sizeof(T)) <= kMaxCacheBytes;
  if (cache && vec)
    return launch_one<T, true, true>(x, scale, bias, out, n_runs, num_groups, cpg, hw, eps, stream);
  if (cache)
    return launch_one<T, true, false>(x, scale, bias, out, n_runs, num_groups, cpg, hw, eps, stream);
  if (vec)
    return launch_one<T, false, true>(x, scale, bias, out, n_runs, num_groups, cpg, hw, eps, stream);
  return launch_one<T, false, false>(x, scale, bias, out, n_runs, num_groups, cpg, hw, eps, stream);
}

}  // namespace

// x, out: contiguous (N, C, *spatial) in the dtype given, hw = the product of
// the spatial sizes; C = num_groups * cpg, n_runs = N * num_groups. scale,
// bias: C fp32 values each. Returns cudaGetLastError() (0 on success).
extern "C" int ddpo_gn_silu(const void* x, const void* scale, const void* bias, void* out,
                            int dtype, int64_t n_runs, int num_groups, int cpg, int64_t hw,
                            float eps, void* stream) {
  if (n_runs < 1 || n_runs > 0x7fffffff || num_groups < 1 || cpg < 1 || hw < 1 ||
      int64_t(cpg) * hw > 0x7fffffff)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == ddpo::kFloat32)
    return int(launch<float>(x, sc, bi, out, n_runs, num_groups, cpg, int(hw), eps, s));
  if (dtype == ddpo::kBFloat16)
    return int(launch<__nv_bfloat16>(x, sc, bi, out, n_runs, num_groups, cpg, int(hw), eps, s));
  return int(cudaErrorInvalidValue);
}
