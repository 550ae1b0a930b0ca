// GroupNorm statistics for sm_90a: per-(batch, group) sum and sum of squares.
//
// Replaces: ddpo_tpu/ops/groupnorm.py::_gn_stats_kernel (the Pallas TPU
// kernel behind _group_stats / _moments / group_norm). Same function: one
// read of the feature map, fp32 sums per (n, group).
//
// What bounds it on this card: a streaming reduction, about 2 flops per
// element read, so device-memory bandwidth (3.35 TB/s) is the limit, from
// 2 MB UNet maps up to the VAE decoder's 268 MB (4, 256, 512, 512) bf16 map.
// At the UNet's sizes the launch and the host around it cost more than the
// read, so a call is one launch and allocates nothing but its output.
//
// What the design does about it: in PyTorch's contiguous NCHW each (n, group)
// is one contiguous run of (C/G)*H*W elements. One thread-block cluster of k
// blocks owns a run, k from the run length alone (ddpo_gn_cluster_size): 1
// for runs of up to three chunks (the UNet's maps up to (8, 320, 64, 64)), 2
// from four chunks on (the larger UNet maps, the VAE's 64K- to 2M-element
// runs). A chunk is kThreads x kUnroll vectors of 16 bytes; rank r reduces
// chunks r, r + k, r + 2k, ..., thread t loading vector u * kThreads + t of
// each chunk into its own (s, ss) pair u, with the next chunk's kUnroll
// loads in flight while the current one is added (the same element ->
// thread map with element loads where the run is not 16-byte aligned;
// vectors past the end read as 0). Clusters of 4 and 8 were slower on the
// card at the VAE's maps: more concurrent streams, fewer bytes in flight
// each. A thread adds its kUnroll pairs in order, a warp by a shuffle
// butterfly, a block in warp order into one shared (s, ss) pair. After
// cluster.sync() rank 0 reads the k pairs through distributed shared memory
// in rank order and writes the run's sums; a second cluster.sync() keeps
// every block's shared memory alive until it has. No scratch, no second
// kernel and no float atomics: the order of every addition depends on the
// run length only, so two calls give the same bits, and image 0 alone gives
// the bits of its slice of a batch.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;      // 16-byte loads a thread and chunk, each with its own pair
constexpr int kMaxCluster = 2;  // measured best of 1-8 with the pipelined loop

template <typename T>
__host__ __device__ constexpr int64_t chunk_elems() {
  return int64_t(kThreads) * kUnroll * (16 / sizeof(T));
}

// The largest power of two up to kMaxCluster that leaves each block at least
// two chunks: 1 where the run is three chunks or fewer.
template <typename T>
int cluster_size(int64_t run_len) {
  const int64_t nchunks = (run_len + chunk_elems<T>() - 1) / chunk_elems<T>();
  int k = 1;
  while (k < kMaxCluster && 4 * int64_t(k) <= nchunks) k *= 2;
  return k;
}

// kUnroll vectors of V elements of one chunk, thread t's slots, as raw 16-byte
// words; vectors past the end of the run read as 0 (run_len % V == 0 where
// kVec, so a vector lies wholly in or out).
template <typename T, bool kVec>
__device__ __forceinline__ void load_chunk(const T* __restrict__ base, int64_t c,
                                           int64_t run_len, uint4 (&raw)[kUnroll]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i0 = c * chunk_elems<T>() + (int64_t(u) * kThreads + threadIdx.x) * V;
    if constexpr (kVec) {
      raw[u] = i0 < run_len ? __ldg(reinterpret_cast<const uint4*>(base + i0))
                            : make_uint4(0u, 0u, 0u, 0u);
    } else {
      T* e = reinterpret_cast<T*>(&raw[u]);
#pragma unroll
      for (int t = 0; t < V; ++t) e[t] = i0 + t < run_len ? base[i0 + t] : ddpo::from_float<T>(0.f);
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) gn_stats_kernel(const T* __restrict__ x,
                                                            float* __restrict__ out,
                                                            int64_t n_runs, int64_t run_len,
                                                            int k) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[2][kThreads / 32];
  __shared__ float pair[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int64_t run = blockIdx.x / k;
  const T* base = x + run * run_len;
  const int64_t nchunks = (run_len + chunk_elems<T>() - 1) / chunk_elems<T>();

  float s[kUnroll], ss[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) s[u] = ss[u] = 0.f;
  // software pipeline: the next chunk's loads are in flight while this one is added
  uint4 cur[kUnroll], next[kUnroll];
  if (rank < nchunks) load_chunk<T, kVec>(base, rank, run_len, cur);
  for (int64_t c = rank; c < nchunks; c += k) {
    if (c + k < nchunks) load_chunk<T, kVec>(base, c + k, run_len, next);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* e = reinterpret_cast<const T*>(&cur[u]);
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const float v = ddpo::to_float(e[t]);
        s[u] += v;
        ss[u] = fmaf(v, v, ss[u]);
      }
      cur[u] = next[u];
    }
  }
  float ts = s[0], tss = ss[0];
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) {
    ts += s[u];
    tss += ss[u];
  }
  ts = ddpo::warp_sum(ts);
  tss = ddpo::warp_sum(tss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = ts;
    red[1][warp] = tss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bs = 0.f, bss = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      bs += red[0][w];
      bss += red[1][w];
    }
    pair[0] = bs;
    pair[1] = bss;
  }
  if (k > 1) cluster.sync();  // every rank's pair is written and visible
  if (rank == 0 && threadIdx.x == 0) {
    float rs = 0.f, rss = 0.f;
    for (int r = 0; r < k; ++r) {
      const float* p = cluster.map_shared_rank(pair, r);
      rs += p[0];
      rss += p[1];
    }
    out[run] = rs;
    out[n_runs + run] = rss;
  }
  if (k > 1) cluster.sync();  // no block leaves before rank 0 has read its pair
}

template <typename T>
cudaError_t launch(const void* x, float* out, int64_t n_runs, int64_t run_len,
                   cudaStream_t stream) {
  const int k = cluster_size<T>(run_len);
  if (n_runs * k > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && run_len % V == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(n_runs * k));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const T* xt = static_cast<const T*>(x);
  cudaError_t e = vec ? cudaLaunchKernelEx(&cfg, gn_stats_kernel<T, true>, xt, out, n_runs,
                                           run_len, k)
                      : cudaLaunchKernelEx(&cfg, gn_stats_kernel<T, false>, xt, out, n_runs,
                                           run_len, k);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace

// The cluster size a run of run_len elements of the dtype given launches with.
extern "C" int ddpo_gn_cluster_size(int64_t run_len, int dtype) {
  if (dtype == ddpo::kFloat32) return cluster_size<float>(run_len);
  if (dtype == ddpo::kBFloat16) return cluster_size<__nv_bfloat16>(run_len);
  return 0;
}

// x: contiguous, n_runs runs of run_len elements each (NCHW with the groups
// of C/G channels: n_runs = N*G, run_len = (C/G)*H*W). out: 2*n_runs fp32,
// the sums then the sums of squares ((2, N, G) row-major). One launch.
// Returns the launch's CUDA error (0 on success).
extern "C" int ddpo_gn_stats(const void* x, void* out, int dtype, int64_t n_runs,
                             int64_t run_len, void* stream) {
  if (n_runs < 1 || run_len < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == ddpo::kFloat32) return int(launch<float>(x, o, n_runs, run_len, s));
  if (dtype == ddpo::kBFloat16) return int(launch<__nv_bfloat16>(x, o, n_runs, run_len, s));
  return int(cudaErrorInvalidValue);
}
