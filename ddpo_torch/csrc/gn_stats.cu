// GroupNorm statistics for sm_90a: per-(batch, group) sum and sum of squares.
//
// Replaces: ddpo_tpu/ops/groupnorm.py::_gn_stats_kernel (the Pallas TPU
// kernel behind _group_stats / _moments / group_norm). Same function: one
// read of the feature map, fp32 sums per (n, group).
//
// What bounds it on this card: a streaming reduction, about 2 flops per
// element read, so device-memory bandwidth (3.35 TB/s) is the limit, from
// 2 MB UNet maps up to the VAE decoder's 268 MB (4, 128, 512, 512) bf16 map.
//
// What the design does about it: the port keeps PyTorch's contiguous NCHW
// maps, where each (n, group) is one contiguous run of (C/G)*H*W elements,
// so a block reads its part of a run with fully coalesced 16-byte loads
// (scalar loads where the run is not 16-byte aligned). Pass 1 gives each
// block a fixed chunk of one run and writes that chunk's partial sums;
// pass 2 reduces the partials of each run with one warp. The order of every
// addition depends only on the shape, with no float atomics, so the same
// input gives the same bits on every call: the DDPO on-policy check needs
// the trainer's recompute of the sampler's forward to match it exactly.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;  // elements of one run reduced by one block

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) gn_partial_kernel(
    const T* __restrict__ x, float* __restrict__ partials, int64_t run_len,
    int nchunks) {
  const int64_t run = blockIdx.y;
  const T* base = x + run * run_len;
  const int64_t start = int64_t(blockIdx.x) * kChunk;
  const int64_t end = run_len < start + kChunk ? run_len : start + kChunk;
  float s = 0.f, ss = 0.f;
  if (kVec) {  // 16-byte loads; start, end and the run base are aligned
    constexpr int V = 16 / sizeof(T);
    const uint4* vbase = reinterpret_cast<const uint4*>(base);
    for (int64_t i = start / V + threadIdx.x; i < end / V; i += kThreads) {
      const uint4 raw = vbase[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const float val = ddpo::to_float(e[t]);
        s += val;
        ss = fmaf(val, val, ss);
      }
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
      const float val = ddpo::to_float(base[i]);
      s += val;
      ss = fmaf(val, val, ss);
    }
  }
  s = ddpo::warp_sum(s);
  ss = ddpo::warp_sum(ss);
  __shared__ float red[2][kThreads / 32];
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
    float* p = partials + 2 * (run * nchunks + blockIdx.x);
    p[0] = ts;
    p[1] = tss;
  }
}

__global__ void gn_finalize_kernel(const float* __restrict__ partials,
                                   float* __restrict__ sums,
                                   float* __restrict__ sq_sums, int nchunks) {
  const int64_t run = blockIdx.x;
  const float* p = partials + 2 * run * nchunks;
  float s = 0.f, ss = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += 32) {
    s += p[2 * c];
    ss += p[2 * c + 1];
  }
  s = ddpo::warp_sum(s);
  ss = ddpo::warp_sum(ss);
  if (threadIdx.x == 0) {
    sums[run] = s;
    sq_sums[run] = ss;
  }
}

template <typename T>
cudaError_t launch(const void* x, float* partials, float* sums, float* sq_sums,
                   int64_t n_runs, int64_t run_len, int nchunks, cudaStream_t stream) {
  const dim3 grid(nchunks, unsigned(n_runs));
  const T* xt = static_cast<const T*>(x);
  constexpr int V = 16 / sizeof(T);
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (run_len % V == 0);
  if (vec)
    gn_partial_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, partials, run_len, nchunks);
  else
    gn_partial_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, partials, run_len, nchunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gn_finalize_kernel<<<unsigned(n_runs), 32, 0, stream>>>(partials, sums, sq_sums, nchunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ddpo_gn_stats_chunk() { return kChunk; }

// x: contiguous, n_runs runs of run_len elements each (NCHW with the groups
// of C/G channels: n_runs = N*G, run_len = (C/G)*H*W). partials: 2*n_runs*
// nchunks fp32 scratch with nchunks = ceil(run_len / ddpo_gn_stats_chunk()).
// sums, sq_sums: n_runs fp32 each. Returns cudaGetLastError() (0 on success).
extern "C" int ddpo_gn_stats(const void* x, void* partials, void* sums, void* sq_sums,
                             int dtype, int64_t n_runs, int64_t run_len, int nchunks,
                             void* stream) {
  if (n_runs < 1 || n_runs > 65535 || run_len < 1 ||
      int64_t(nchunks) * kChunk < run_len || int64_t(nchunks - 1) * kChunk >= run_len)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  float* su = static_cast<float*>(sums);
  float* sq = static_cast<float*>(sq_sums);
  if (dtype == ddpo::kFloat32)
    return int(launch<float>(x, p, su, sq, n_runs, run_len, nchunks, s));
  if (dtype == ddpo::kBFloat16)
    return int(launch<__nv_bfloat16>(x, p, su, sq, n_runs, run_len, nchunks, s));
  return int(cudaErrorInvalidValue);
}
