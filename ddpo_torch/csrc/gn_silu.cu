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
// run of (C/G)*H*W elements, owned by one thread-block cluster of k blocks;
// rank r owns the contiguous slice r of the run (slices of a whole number of
// kThreads 16-byte vectors). Three ways through, chosen on the host from the
// run's shape alone (ddpo_gn_silu_plan):
//  - cached, wherever a slice fits 112 KB with k = 1, 2, 4, 8 or 16 (every
//    UNet map; the VAE's runs up to 1 MB in bf16): the slice is copied into
//    shared memory by TMA bulk copies (cp.async.bulk, 16 KB pieces, each
//    completing on its own mbarrier), reduced from shared memory piece by
//    piece as the pieces land, then normalized from shared memory and
//    written: one read and one write of the map. k is the smallest that fits,
//    so two blocks share an SM; k = 16 (non-portable) only where the card
//    says 16-block clusters with that shared memory can be resident.
//  - streamed (longer runs: the VAE's 2 MB and 4 MB bf16 runs): k = 8, the
//    slice read twice with 16-byte loads, four in flight a thread. Caching a
//    2 MB run takes 16 blocks of 128 KB, one an SM and few such clusters
//    resident on an H100, where each SM loads, then computes (the exact
//    expf and division), then stores, with nothing to overlap; many small
//    streamed blocks overlap all three, and were faster on the card despite
//    the second read.
//  - scalar (a map whose H*W is not a multiple of the vector, or unaligned
//    pointers): the streamed way with element loads.
// Every block reduces its slice (thread t: vectors t, t + kThreads, ..., in
// order; a warp by a shuffle butterfly; a block in warp order) into a shared
// (s, ss) pair. After cluster.sync() each rank reads the k pairs through
// distributed shared memory in rank order, so all ranks hold the same mean
// and rstd bits, and a cluster barrier before exit keeps every pair alive
// until all ranks have read it. No float atomics, and k and the slices depend
// on the shape alone: two calls give the same bits, and so does image 0
// alone against its slice of a batch. Scale and bias are read in their own
// dtype (fp32 or bf16).

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kPieceVecs = 2 * kThreads;               // 16 KB a TMA piece
constexpr int kMaxPieces = 7;
constexpr int kMaxSliceVecs = kMaxPieces * kPieceVecs;  // 112 KB: two blocks an SM
constexpr int kUnroll = 4;                              // loads in flight (streamed)

enum Mode { kCached = 0, kStreamed = 1, kScalar = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of TMA traffic, then the bulk copy
// of those bytes from global to shared memory, completing on the barrier.
__device__ __forceinline__ void tma_load(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float affine_at(const void* p, int bf16, int c) {
  return bf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p) + c))
              : __ldg(static_cast<const float*>(p) + c);
}

template <typename T>
__device__ __forceinline__ float gn_silu_value(T raw, float mean, float rstd, float sc,
                                               float bi) {
  const float y = (ddpo::to_float(raw) - mean) * rstd * sc + bi;
  return y / (1.f + expf(-y));
}

template <typename T, int V>
__device__ __forceinline__ void accumulate(const T* e, float& s, float& ss) {
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const float v = ddpo::to_float(e[t]);
    s += v;
    ss = fmaf(v, v, ss);
  }
}

// Normalize, affine and SiLU of V elements of one channel, in place.
template <typename T, int V>
__device__ __forceinline__ void transform(T* e, float mean, float rstd, float sc, float bi) {
#pragma unroll
  for (int t = 0; t < V; ++t) e[t] = ddpo::from_float<T>(gn_silu_value(e[t], mean, rstd, sc, bi));
}

// x, out: n_runs runs of cpg * hw elements; the cluster of k blocks
// blockIdx.x / k owns run blockIdx.x / k; rank r owns the `slice` vectors
// (of V elements, V = 1 in kScalar) from r * slice on.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads) gn_silu_kernel(
    const T* __restrict__ x, const void* __restrict__ scale, const void* __restrict__ bias,
    T* __restrict__ out, int scale_bf16, int bias_bf16, int num_groups, int cpg, int hw,
    int k, int slice, float eps) {
  constexpr int V = kMode == kScalar ? 1 : 16 / sizeof(T);
  using Vec = typename std::conditional<kMode == kScalar, T, uint4>::type;
  extern __shared__ __align__(128) uint4 cache[];
  __shared__ __align__(8) uint64_t bars[kMaxPieces];
  __shared__ float red[2][kThreads / 32];
  __shared__ float pair[2];
  __shared__ float stats[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int64_t run = blockIdx.x / k;
  const int run_len = cpg * hw;
  const int nvec = run_len / V;
  const int v0 = rank * slice;  // first vector of this block's slice
  const int count = max(0, min(slice, nvec - v0));
  const Vec* src = reinterpret_cast<const Vec*>(x + run * run_len) + v0;
  Vec* dst = reinterpret_cast<Vec*>(out + run * run_len) + v0;
  const int c0 = int(run % num_groups) * cpg;

  // statistics of the slice: thread t adds vectors t, t + kThreads, ... in order
  float s = 0.f, ss = 0.f;
  if constexpr (kMode == kCached) {
    const int npieces = (count + kPieceVecs - 1) / kPieceVecs;
    if (threadIdx.x == 0) {
      for (int p = 0; p < npieces; ++p) mbar_init(&bars[p], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < npieces) {
      const int p = threadIdx.x;
      const int n = min(kPieceVecs, count - p * kPieceVecs);
      tma_load(cache + p * kPieceVecs, src + p * kPieceVecs, uint32_t(n) * 16u, &bars[p]);
    }
    for (int p = 0; p < npieces; ++p) {
      mbar_wait(&bars[p], 0);
#pragma unroll
      for (int j = 0; j < kPieceVecs / kThreads; ++j) {
        const int i = p * kPieceVecs + j * kThreads + threadIdx.x;
        if (i < count) {
          const uint4 raw = cache[i];
          accumulate<T, V>(reinterpret_cast<const T*>(&raw), s, ss);
        }
      }
    }
  } else {
    for (int i0 = threadIdx.x; i0 < count; i0 += kUnroll * kThreads) {
      Vec raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < count) raw[u] = src[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i0 + u * kThreads < count) accumulate<T, V>(reinterpret_cast<const T*>(&raw[u]), s, ss);
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
  if (threadIdx.x == 0) {
    float rs = 0.f, rss = 0.f;
    for (int r = 0; r < k; ++r) {  // rank order, the same on every rank
      const float* p = cluster.map_shared_rank(pair, r);
      rs += p[0];
      rss += p[1];
    }
    const float n = float(run_len);
    const float mean = rs / n;
    stats[0] = mean;
    stats[1] = rsqrtf(rss / n - mean * mean + eps);
  }
  if (k > 1) cluster_arrive();  // this rank has read every pair it needs
  __syncthreads();
  const float mean = stats[0], rstd = stats[1];

  // normalize, affine, SiLU; a vector never spans two channels (hw % V == 0)
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int c = c0 + (v0 + i) * V / hw;
    const float sc = affine_at(scale, scale_bf16, c), bi = affine_at(bias, bias_bf16, c);
    alignas(16) Vec raw = kMode == kCached ? reinterpret_cast<const Vec*>(cache)[i] : src[i];
    transform<T, V>(reinterpret_cast<T*>(&raw), mean, rstd, sc, bi);
    dst[i] = raw;
  }
  if (k > 1) cluster_wait();  // no block leaves while another may read its pair
}

struct Plan {
  int k, mode, slice;  // cluster size, Mode, vectors (elements in kScalar) a rank
};

int ceil_div(int64_t a, int64_t b) { return int((a + b - 1) / b); }

int slice_for(int64_t nvec, int k) {
  return ceil_div(ceil_div(nvec, k), kThreads) * kThreads;
}

template <typename T, int kMode>
cudaError_t prepare_once() {
  static cudaError_t state = [] {
    auto kernel = gn_silu_kernel<T, kMode>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess && kMode == kCached)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSliceVecs * 16);
    return e;
  }();
  return state;
}

// Whether 16-block clusters of the cached kernel with the largest slice can
// be resident on this card (asked once).
template <typename T>
bool cluster16_ok() {
  static const bool ok = [] {
    if (prepare_once<T, kCached>() != cudaSuccess) return false;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(16);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = size_t(kMaxSliceVecs) * 16;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 16;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&clusters, gn_silu_kernel<T, kCached>, &cfg);
    cudaGetLastError();  // a refused query leaves no error behind
    return e == cudaSuccess && clusters >= 1;
  }();
  return ok;
}

template <typename T>
Plan make_plan(int64_t cpg, int64_t hw, bool aligned) {
  constexpr int V = 16 / sizeof(T);
  const int64_t run_len = cpg * hw;
  if (!aligned || hw % V != 0) {
    int k = 1;
    while (k < 8 && slice_for(run_len, k) * int64_t(sizeof(T)) > kMaxSliceVecs * 16) k *= 2;
    return {k, kScalar, slice_for(run_len, k)};
  }
  const int64_t nvec = run_len / V;
  for (int k = 1; k <= 16; k *= 2) {
    if (k == 16 && !cluster16_ok<T>()) break;
    if (slice_for(nvec, k) <= kMaxSliceVecs) return {k, kCached, slice_for(nvec, k)};
  }
  return {8, kStreamed, slice_for(nvec, 8)};
}

template <typename T, int kMode>
cudaError_t launch_mode(const Plan& plan, const void* x, const void* scale, const void* bias,
                        void* out, int scale_bf16, int bias_bf16, int64_t n_runs,
                        int num_groups, int cpg, int hw, float eps, cudaStream_t stream) {
  cudaError_t e = prepare_once<T, kMode>();
  if (e != cudaSuccess) return e;
  constexpr int V = kMode == kScalar ? 1 : 16 / sizeof(T);
  const int nvec = cpg * hw / V;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(n_runs * plan.k));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kMode == kCached ? size_t(std::min(plan.slice, nvec)) * 16 : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(plan.k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gn_silu_kernel<T, kMode>, static_cast<const T*>(x), scale, bias,
                         static_cast<T*>(out), scale_bf16, bias_bf16, num_groups, cpg, hw,
                         plan.k, plan.slice, eps);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* out, int scale_bf16,
                   int bias_bf16, int64_t n_runs, int num_groups, int cpg, int hw, float eps,
                   cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const Plan plan = make_plan<T>(cpg, hw, aligned);
  if (n_runs * plan.k > 0x7fffffff) return cudaErrorInvalidValue;
  if (plan.mode == kCached)
    return launch_mode<T, kCached>(plan, x, scale, bias, out, scale_bf16, bias_bf16, n_runs,
                                   num_groups, cpg, hw, eps, stream);
  if (plan.mode == kStreamed)
    return launch_mode<T, kStreamed>(plan, x, scale, bias, out, scale_bf16, bias_bf16, n_runs,
                                     num_groups, cpg, hw, eps, stream);
  return launch_mode<T, kScalar>(plan, x, scale, bias, out, scale_bf16, bias_bf16, n_runs,
                                 num_groups, cpg, hw, eps, stream);
}

bool affine_code(int dtype, int* bf16) {
  *bf16 = dtype == ddpo::kBFloat16;
  return dtype == ddpo::kFloat32 || dtype == ddpo::kBFloat16;
}

}  // namespace

// The plan a 16-byte-aligned map of cpg * hw elements a run takes: *k the
// cluster size, *mode 0 cached (one read, TMA), 1 streamed (two reads),
// 2 scalar. Returns 0, or cudaErrorInvalidValue for an unknown dtype.
extern "C" int ddpo_gn_silu_plan(int64_t cpg, int64_t hw, int dtype, int* k, int* mode) {
  Plan plan;
  if (dtype == ddpo::kFloat32)
    plan = make_plan<float>(cpg, hw, true);
  else if (dtype == ddpo::kBFloat16)
    plan = make_plan<__nv_bfloat16>(cpg, hw, true);
  else
    return int(cudaErrorInvalidValue);
  *k = plan.k;
  *mode = plan.mode;
  return 0;
}

// x, out: contiguous (N, C, *spatial) in the dtype given, hw = the product of
// the spatial sizes; C = num_groups * cpg, n_runs = N * num_groups. scale,
// bias: C values each, in their own dtypes (codes of common.cuh). One
// launch. Returns the launch's CUDA error (0 on success).
extern "C" int ddpo_gn_silu(const void* x, const void* scale, const void* bias, void* out,
                            int dtype, int scale_dtype, int bias_dtype, int64_t n_runs,
                            int num_groups, int cpg, int64_t hw, float eps, void* stream) {
  int scale_bf16 = 0, bias_bf16 = 0;
  if (n_runs < 1 || num_groups < 1 || cpg < 1 || hw < 1 || int64_t(cpg) * hw > 0x7fffffff ||
      !affine_code(scale_dtype, &scale_bf16) || !affine_code(bias_dtype, &bias_bf16))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ddpo::kFloat32)
    return int(launch<float>(x, scale, bias, out, scale_bf16, bias_bf16, n_runs, num_groups, cpg,
                             int(hw), eps, s));
  if (dtype == ddpo::kBFloat16)
    return int(launch<__nv_bfloat16>(x, scale, bias, out, scale_bf16, bias_bf16, n_runs,
                                      num_groups, cpg, int(hw), eps, s));
  return int(cudaErrorInvalidValue);
}
