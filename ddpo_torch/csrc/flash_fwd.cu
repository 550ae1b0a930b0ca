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
// bf16 on Hopper (flash_fwd_wgmma_kernel: wgmma + TMA, flash_tiles.cuh),
// FlashAttention-3's shape:
//   - A block holds two consumer warpgroups of 64 query rows each (one above
//     D = 160, where O alone takes up to 128 registers a thread) and a
//     producer warp: 288 threads, so a thread may hold 168 registers. Grid
//     (query tiles, H, B).
//   - The producer loads the block's Q once, then streams K and V tiles of
//     BK keys (128 up to D = 80, 64 above) into a ring of 2-4 stages, K and
//     V each on a full mbarrier of its own and the stage on one empty
//     mbarrier, by TMA where the arrays allow it (contiguous views: base
//     16-byte aligned, (b, s, h) strides multiples of 8 elements), else by
//     plain loads into the same swizzled bytes (fused-qkv slices at an odd
//     element offset, D not a multiple of 8). Columns past D and rows past
//     S are zeros in shared memory only (D = 40 runs three k16 steps over
//     48 columns).
//   - S = Q K^T is an SS wgmma (Q the A operand, K K-major B, N = BK).
//     The online softmax runs on S's fp32 accumulators: row max and sum
//     across the lane quad by shuffles, exp2(s * scale*log2(e) - m). The
//     scale is applied to the fp32 scores, not folded into a bf16 Q.
//   - P is rounded to bf16 in registers and is the A operand of O += P V
//     (RS), with V as the MN-major B (tnspB). This rounding is the one
//     numerical change against the fp32 path; JAX's xla_attention rounds
//     its weights to v's dtype too. The row sum l is taken over the fp32 P,
//     so the LSE does not see it.
//   - The first tile is peeled. Then, per tile, S(t) and O += P(t-1) V(t-1)
//     are issued back to back as two commit groups; the softmax of S(t)
//     runs while P(t-1) V(t-1) does, and O takes S(t)'s correction once
//     that product is done (without the peel ptxas serialized the
//     wgmma). The two consumer warpgroups take turns to issue their
//     products on named barriers (the ping-pong), so that one's
//     exponentials run while the other's products do.
//   - out = O / l in bf16 and lse = (m + log2 l) * ln 2, as before.
// Summation order: each output element has one owner (a lane of the
// warpgroup that owns its row) and adds its terms in a fixed order: key
// tiles in order, the k16 steps in order, a fixed butterfly over the quad.
// No split over keys and no atomics; tile sizes depend on D alone, and
// nothing on the batch, the head or the row's place in the block, so two
// calls give the same bits and image i alone gives the bits it gets inside
// a batch.
//
// fp32 runs on Hopper's tensor cores too, as 3xTF32 products (each operand
// split into two tf32 values, three products into fp32 sums) on wgmma fed by
// TMA: flash_fwd_tf32.cu, to which the fp32 dispatch below hands over. Both
// paths mask ragged Sq and Sk themselves and read Q/K/V through their
// (B, S, H) strides, so the caller neither pads nor transposes.

#include "common.cuh"
#include "flash_tiles.cuh"
#include "mma.cuh"

namespace {

// ---- bf16 on Hopper: wgmma + TMA ----

using bf16 = __nv_bfloat16;
namespace fl = ddpo::flash;

// Tiles of the bf16 forward for D padded to 16 * NC, functions of D alone:
// a consumer warpgroup owns 64 query rows; two run in a block up to D = 160,
// one above, where O alone takes up to 128 registers a thread. K and V
// tiles hold 128 keys up to D = 80 and 64 above (S is BK / 2 fp32 a thread
// beside O's 8 NC and P's BK / 4).
template <int NC>
struct FwdTile {
  static constexpr int NA = fl::atoms<NC>();
  static constexpr int NCW = NC <= 10 ? 2 : 1;                // consumer warpgroups
  static constexpr int BK = NC <= 5 ? 128 : 64;               // keys a K or V tile
  static constexpr int QTILE = NA * 64 * fl::ROW_BYTES;       // 64 query rows
  static constexpr int KTILE = NA * BK * fl::ROW_BYTES;       // BK keys of K or V
  __host__ __device__ static constexpr size_t smem(int stages) {
    // Q [NCW][NA][64][128], K and V [stages][NA][BK][128]; the barriers
    return 1024 + size_t(NCW) * QTILE + size_t(stages) * 2 * KTILE + 8 * (1 + 3 * stages);
  }
  __host__ __device__ static constexpr int stages() {
    int st = 4;
    while (st > 2 && smem(st) > size_t(fl::SMEM_MAX)) --st;
    return st;
  }
};

struct FwdArgs {
  const bf16 *q, *k, *v;
  bf16* out;
  float* lse;
  int H, Sq, Sk, D;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale_log2;
  int tma;  // 1: the producer loads by TMA; 0: by plain loads
};

// One consumer warpgroup's 64 query rows from row0: Q's tile at q_base,
// the K and V stages at ks and vs, the barriers at bars
template <int NC>
__device__ __forceinline__ void fwd_consumer(const FwdArgs& a, uint32_t q_base, uint32_t ks,
                                             uint32_t vs, uint32_t bars, int row0, int b, int h) {
  using Tile = FwdTile<NC>;
  constexpr int NA = Tile::NA, BK = Tile::BK, KS = BK / 16, ST = Tile::stages();
  constexpr int NL = fl::atom_n<NC>(NA - 1);  // columns of the last atom
  auto kfull = [&](int s) { return bars + 8 * (1 + s); };
  auto vfull = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3, g = lane >> 2, tq = lane & 3;
  const fl::Turns turns{int(threadIdx.x) / fl::WG, Tile::NCW};

  // O by 64-column atom (the last atom's first NL / 2), S of one tile, and
  // the previous tile's P as the A fragments of O += P V
  float o[NA][32], s[BK / 2];
  uint32_t pa[KS][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[at][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

  auto fence_o = [&]() {
#pragma unroll
    for (int at = 0; at < NA - 1; ++at) ddpo::fence_operands(o[at]);
    fl::fence_first<NL / 2>(o[NA - 1]);
  };
  auto fence_p = [&]() {
#pragma unroll
    for (int kq = 0; kq < KS; ++kq) ddpo::fence_operands(pa[kq]);
  };
  // S = Q K^T over all of D (both K-major in shared memory)
  auto issue_qk = [&](int st) {
    const uint32_t k_base = ks + uint32_t(st) * Tile::KTILE;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk)
      ddpo::wgmma_ss<BK>(s, fl::k_desc(q_base, 64, kk), fl::k_desc(k_base, BK, kk), kk > 0);
  };
  // O += P V, P from registers, V MN-major: k steps of 16 keys in order
  auto issue_pv = [&](int st) {
    const uint32_t v_base = vs + uint32_t(st) * Tile::KTILE;
#pragma unroll
    for (int kq = 0; kq < KS; ++kq) {
#pragma unroll
      for (int at = 0; at < NA - 1; ++at)
        ddpo::wgmma_rs_mn<64>(o[at], pa[kq], fl::mn_desc(v_base, BK, at, kq));
      ddpo::wgmma_rs_mn<NL>(o[NA - 1], pa[kq], fl::mn_desc(v_base, BK, NA - 1, kq));
    }
  };
  // the online softmax of tile t's S in place (P in fp32), in base 2 with
  // the scale on the fp32 scores; the lane holds rows g + 8r and keys
  // 8j + 2tq + e, the three lanes of its quad the rest
  auto softmax = [&](int t) {
    const int keys_left = a.Sk - t * BK;
    if (keys_left < BK) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (8 * (i >> 2) + 2 * tq + (i & 1) >= keys_left) s[i] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * a.scale_log2);  // finite: each tile has a key
      corr[r] = ddpo::exp2_ftz(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ddpo::exp2_ftz(fmaf(s[4 * j + 2 * r + e], a.scale_log2, -m_new));
          s[4 * j + 2 * r + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * corr[r] + rs;
      m[r] = m_new;
    }
  };

  turns.start();
  ddpo::mbar_wait(bars, 0);  // Q
  const int nt = (a.Sk + BK - 1) / BK;

  // tile 0, peeled: S(0) alone
  ddpo::mbar_wait(kfull(0), 0);
  turns.take();
  ddpo::fence_operands(s);
  ddpo::wgmma_fence();
  issue_qk(0);
  ddpo::wgmma_commit();
  ddpo::fence_operands(s);
  turns.pass(false);
  ddpo::wgmma_wait<0>();
  ddpo::fence_operands(s);
  softmax(0);  // O is 0: no correction
  fl::pack_a(pa, s);

  // then S(t) and O = O corr + P(t-1) V(t-1) issued back to back; the
  // softmax of S(t) runs while P(t-1) V(t-1) does
#pragma unroll 1
  for (int t = 1; t < nt; ++t) {
    const int st = t % ST, sp = (t - 1) % ST;
    ddpo::mbar_wait(kfull(st), (t / ST) & 1);
    ddpo::mbar_wait(vfull(sp), ((t - 1) / ST) & 1);
    turns.take();
    ddpo::fence_operands(s);
    fence_o();
    ddpo::wgmma_fence();
    issue_qk(st);
    ddpo::wgmma_commit();
    issue_pv(sp);
    ddpo::wgmma_commit();
    ddpo::fence_operands(s);
    fence_o();
    turns.pass(false);
    ddpo::wgmma_wait<1>();  // S(t)
    ddpo::fence_operands(s);
    softmax(t);
    ddpo::wgmma_wait<0>();  // P(t-1) V(t-1)
    fence_o();
    fence_p();
    ddpo::mbar_arrive(empty(sp));
#pragma unroll
    for (int at = 0; at < NA; ++at)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (at < NA - 1 || i < NL / 2) o[at][i] *= corr[(i >> 1) & 1];
    fl::pack_a(pa, s);
  }

  // the last tile's P V
  const int sp = (nt - 1) % ST;
  ddpo::mbar_wait(vfull(sp), ((nt - 1) / ST) & 1);
  turns.take();
  fence_o();
  ddpo::wgmma_fence();
  issue_pv(sp);
  ddpo::wgmma_commit();
  fence_o();
  turns.pass(true);
  ddpo::wgmma_wait<0>();
  fence_o();
  fence_p();

  const float kLn2 = 0.69314718055994531f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * wq + g + 8 * r;
    if (row >= a.Sq) continue;
    const float inv = 1.f / l[r];
    bf16* orow = a.out + ((int64_t(b) * a.Sq + row) * a.H + h) * a.D;
#pragma unroll
    for (int at = 0; at < NA; ++at)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (at < NA - 1 || j < NL / 8)
          ddpo::store_pair(orow, at * fl::ATOM + 8 * j + 2 * tq, a.D, o[at][4 * j + 2 * r] * inv,
                           o[at][4 * j + 2 * r + 1] * inv);
    if (tq == 0) a.lse[(int64_t(b) * a.H + h) * a.Sq + row] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// out and lse for 64 * NCW query rows of one (head, batch): grid (query
// tiles, H, B), NCW consumer warpgroups and the producer warp
template <int NC>
__global__ void __launch_bounds__(fl::block_threads(FwdTile<NC>::NCW), 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const FwdArgs a) {
  using Tile = FwdTile<NC>;
  constexpr int NA = Tile::NA, NCW = Tile::NCW, BK = Tile::BK, ST = Tile::stages();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (ddpo::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + NCW * Tile::QTILE;  // K: [ST][NA][BK][128]
  uint8_t* vs = ks + ST * Tile::KTILE;   // V: [ST][NA][BK][128]
  const uint32_t bars = ddpo::smem_addr(vs + ST * Tile::KTILE);
  const uint32_t q_full = bars;
  auto kfull = [&](int s) { return bars + 8 * (1 + s); };
  auto vfull = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * 64 * NCW, h = blockIdx.y, b = blockIdx.z;
  const int nt = (a.Sk + BK - 1) / BK;

  if (tid == 0) {
    const uint32_t arrivals = a.tma ? 1 : 32;  // lane 0's expect_tx, or the warp's lanes
    ddpo::mbar_init(q_full, arrivals);
    for (int s = 0; s < ST; ++s) {
      ddpo::mbar_init(kfull(s), arrivals);
      ddpo::mbar_init(vfull(s), arrivals);
      ddpo::mbar_init(empty(s), NCW * fl::WG);
    }
    ddpo::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NCW) {  // the producer warp
    if (a.tma) {
      if (lane == 0) {
        ddpo::mbar_arrive_expect_tx(q_full, NCW * Tile::QTILE);
        for (int c = 0; c < NCW; ++c)
          fl::load_tile(ddpo::smem_addr(qs + c * Tile::QTILE), &qmap, q_full, b, h, q0 + 64 * c,
                        64, NA);
        for (int t = 0; t < nt; ++t) {
          const int s = t % ST, use = t / ST;
          if (use > 0) ddpo::mbar_wait(empty(s), (use - 1) & 1);
          ddpo::mbar_arrive_expect_tx(kfull(s), Tile::KTILE);
          fl::load_tile(ddpo::smem_addr(ks + s * Tile::KTILE), &kmap, kfull(s), b, h, t * BK, BK,
                        NA);
          ddpo::mbar_arrive_expect_tx(vfull(s), Tile::KTILE);
          fl::load_tile(ddpo::smem_addr(vs + s * Tile::KTILE), &vmap, vfull(s), b, h, t * BK, BK,
                        NA);
        }
      }
    } else {
      const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
      const bf16* kb = a.k + b * a.k_sb + h * a.k_sh;
      const bf16* vb = a.v + b * a.v_sb + h * a.v_sh;
      for (int c = 0; c < NCW; ++c)
        fl::stage_tile(qs + c * Tile::QTILE, qb, a.q_ss, q0 + 64 * c, 64, a.Sq, a.D, NA, lane, 32);
      ddpo::fence_proxy_async();
      ddpo::mbar_arrive(q_full);
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST, use = t / ST;
        if (use > 0) ddpo::mbar_wait(empty(s), (use - 1) & 1);
        fl::stage_tile(ks + s * Tile::KTILE, kb, a.k_ss, t * BK, BK, a.Sk, a.D, NA, lane, 32);
        ddpo::fence_proxy_async();
        ddpo::mbar_arrive(kfull(s));
        fl::stage_tile(vs + s * Tile::KTILE, vb, a.v_ss, t * BK, BK, a.Sk, a.D, NA, lane, 32);
        ddpo::fence_proxy_async();
        ddpo::mbar_arrive(vfull(s));
      }
    }
    return;
  }

  const int cw = warp / 4;
  fwd_consumer<NC>(a, ddpo::smem_addr(qs + cw * Tile::QTILE), ddpo::smem_addr(ks),
                   ddpo::smem_addr(vs), bars, q0 + 64 * cw, b, h);
}

template <int NC>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                         int B, int H, int Sq, int Sk, int D, const int64_t* st, float scale,
                         cudaStream_t stream) {
  using Tile = FwdTile<NC>;
  FwdArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.lse = lse;
  a.H = H, a.Sq = Sq, a.Sk = Sk, a.D = D;
  a.q_sb = st[0], a.q_ss = st[1], a.q_sh = st[2];
  a.k_sb = st[3], a.k_ss = st[4], a.k_sh = st[5];
  a.v_sb = st[6], a.v_ss = st[7], a.v_sh = st[8];
  a.scale_log2 = scale * 1.4426950408889634f;
  CUtensorMap maps[3] = {};
  const void* bases[3] = {q, k, v};
  const int rows[3] = {64, Tile::BK, Tile::BK}, lens[3] = {Sq, Sk, Sk};
  a.tma = fl::tensor_maps(maps, bases, st, 3, B, lens, H, D, rows);
  const size_t smem = Tile::smem(Tile::stages());
  // above 48 KB a block's dynamic shared memory must be allowed, once
  static const cudaError_t allowed = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (allowed != cudaSuccess) return allowed;
  constexpr int rows_a_block = 64 * Tile::NCW;
  const dim3 grid((Sq + rows_a_block - 1) / rows_a_block, H, B);
  flash_fwd_wgmma_kernel<NC><<<grid, fl::block_threads(Tile::NCW), smem, stream>>>(
      maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

cudaError_t dispatch_nc(const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int H, int Sq, int Sk, int D, const int64_t* st, float scale,
                        cudaStream_t stream) {
  switch ((D + 15) / 16) {
#define DDPO_NC(n) \
  case n:          \
    return launch_wgmma<n>(q, k, v, out, lse, B, H, Sq, Sk, D, st, scale, stream);
    DDPO_NC(1) DDPO_NC(2) DDPO_NC(3) DDPO_NC(4) DDPO_NC(5) DDPO_NC(6) DDPO_NC(7)
    DDPO_NC(8) DDPO_NC(9) DDPO_NC(10) DDPO_NC(11) DDPO_NC(12) DDPO_NC(13)
    DDPO_NC(14) DDPO_NC(15) DDPO_NC(16)
#undef DDPO_NC
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace ddpo {
// flash_fwd_tf32.cu: the fp32 forward
cudaError_t flash_fwd_tf32(const void* q, const void* k, const void* v, void* out, float* lse,
                           int B, int H, int Sq, int Sk, int D, const int64_t* st, float scale,
                           cudaStream_t stream);
}  // namespace ddpo

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
    return int(ddpo::flash_fwd_tf32(q, k, v, out, l, B, H, Sq, Sk, D, st, scale, s));
  if (dtype == ddpo::kBFloat16)
    return int(dispatch_nc(q, k, v, out, l, B, H, Sq, Sk, D, st, scale, s));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* ddpo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
