// The Hopper flash kernels' shared pieces (flash_fwd.cu's forward,
// flash_bwd.cu's dQ and dK/dV kernels): tiles of (B, S, H, D) bf16 rows in
// shared memory as wgmma reads them, the producer's two ways of filling
// them, and the block's shape.
//
// A tile is `rows` rows of one (b, h) slice, cut along D into 64-column
// atoms ([atom][rows][128 bytes], each atom 1024-byte aligned), 128-byte
// swizzled as TMA writes it (16-byte unit u of row r at u ^ (r % 8)).
// Columns past D and rows past S are zeros, so a product runs over D padded
// to a multiple of 16 (NC k16 steps: D = 40 takes 3, over 48 columns) with
// nothing padded in device memory.
//
// The producer fills a tile one of two ways, and only the producer's path
// depends on it: TMA, where the array's base is 16-byte aligned and its
// (b, s, h) strides are multiples of 8 elements (a 4-d tensor map, reads
// past D or S filling zeros), or plain loads by the producer warp's 32
// lanes into the same swizzled bytes, then a proxy fence (D not a multiple
// of 8, a view at an odd element offset). The consumers read the
// same bytes either way, so their arithmetic and their bits do not change.
//
// A block is NCW consumer warpgroups of 64 rows each (the wgmma M tile;
// warps 0 .. 4 NCW - 1) and one producer warp after them. An SM
// sub-partition holds every fourth warp, so with two consumers (288
// threads) a thread may hold 168 registers. setmaxnreg, which lends a
// producer warpgroup's registers to the consumers in FlashAttention-3, did
// not raise ptxas's allocation above 168 here (tried with 384 threads: the
// consumers spilled).
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace ddpo {
namespace flash {

constexpr int WG = 128;            // threads of a warpgroup
constexpr int ATOM = 64;           // bf16 columns of an atom (one 128-byte row)
constexpr int ROW_BYTES = 128;
constexpr int SMEM_MAX = 232448;   // a block's shared memory on the H100

// threads of a block of ncw consumer warpgroups and the producer warp
__host__ __device__ constexpr int block_threads(int ncw) { return ncw * WG + 32; }

// 64-column atoms of D (padded to 16 * NC)
template <int NC>
__host__ __device__ constexpr int atoms() { return (NC + 3) / 4; }
// columns of a product's N in atom A: 64, or the last atom's share of
// 16 * NC (a multiple of 16, so N is 16, 32, 48 or 64)
template <int NC>
__host__ __device__ constexpr int atom_n(int a) {
  return a < atoms<NC>() - 1 ? ATOM : 16 * (NC - 4 * (atoms<NC>() - 1));
}

// byte offset of 16-byte unit u of row r in an atom
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return uint32_t(r) * ROW_BYTES + uint32_t((u ^ (r & 7)) << 4);
}

// Rows row0 .. row0+n-1 of one (b, h) slice (row stride ss elements, unit d
// stride) into the tile dst ([na][n][128 bytes]), by threads tid of nt,
// with plain 2-byte loads: any alignment. Zeros past S and past D.
__device__ __forceinline__ void stage_tile(uint8_t* dst, const __nv_bfloat16* src, int64_t ss,
                                           int row0, int n, int S, int D, int na, int tid,
                                           int nt) {
  const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
  for (int i = tid; i < na * n * 8; i += nt) {
    const int u = i & 7, r = (i >> 3) % n, at = (i >> 3) / n;
    const int row = row0 + r, d0 = at * ATOM + 8 * u;
    const uint16_t* p = s16 + int64_t(row) * ss;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + 2 * e;
      const uint32_t lo = row < S && d < D ? uint32_t(p[d]) : 0u;
      const uint32_t hi = row < S && d + 1 < D ? uint32_t(p[d + 1]) : 0u;
      w[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst + size_t(at) * n * ROW_BYTES + swz(r, u)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The same tile by TMA: na boxes of 64 columns x n rows into dst, completing
// on bar (the caller accounts for the bytes, na * n * 128)
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int b,
                                          int h, int row0, int n, int na) {
  for (int at = 0; at < na; ++at)
    tma_load_4d(dst + uint32_t(at) * n * ROW_BYTES, map, bar, at * ATOM, h, row0, b);
}

// The K-major descriptor of k step kk of a tile of `rows` rows at shared
// address base: atom kk / 4, 32 bytes a step within it
__device__ __forceinline__ uint64_t k_desc(uint32_t base, int rows, int kk) {
  return b_desc_sw128(base + uint32_t(kk >> 2) * rows * ROW_BYTES) + 2 * (kk & 3);
}

// The MN-major descriptor of atom at and k step kq (16 rows) of a tile of
// `rows` rows at shared address base
__device__ __forceinline__ uint64_t mn_desc(uint32_t base, int rows, int at, int kq) {
  return desc_sw128_mn(base + uint32_t(at) * rows * ROW_BYTES + uint32_t(kq) * 16 * ROW_BYTES);
}

// keeps the compiler from moving the first M accumulators of d across the
// async mma (the used part of an array sized for a whole atom)
template <int M, int R>
__device__ __forceinline__ void fence_first(float (&d)[R]) {
  static_assert(M <= R, "fence_first: M past the array");
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// P (or dS) from an accumulator of N = 16 * NK columns into the A
// fragments of NK k16 steps, rounded to bf16: step kk takes columns
// 16 kk .. 16 kk + 15 (accumulators 8 kk .. 8 kk + 7)
template <int NK, int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NK][4], const float (&c)[R]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(c[8 * kk + 2 * i], c[8 * kk + 2 * i + 1]);
}

// Two consumer warpgroups take turns to issue their products (the
// ping-pong of FlashAttention-3): warpgroup w waits for its turn on named
// barrier 1 + w and, once its products are issued, hands the turn to the
// other on 2 - w, so that one's exponentials run while the other's products
// do. Warpgroup 1 gives warpgroup 0 the first turn, and both take the same
// number of turns; the last hand-over, by warpgroup 1, is left out so that
// every barrier phase completes.
struct Turns {
  int cw, ncw;
  __device__ __forceinline__ void start() const {
    if (ncw == 2 && cw == 1) named_arrive(1, 2 * WG);
  }
  __device__ __forceinline__ void take() const {
    if (ncw == 2) named_sync(1 + cw, 2 * WG);
  }
  __device__ __forceinline__ void pass(bool last) const {
    if (ncw == 2 && !(last && cw == 1)) named_arrive(2 - cw, 2 * WG);
  }
};

// the host's choice of producer path: TMA for every array, or none
// (elem_bytes 4: fp32 arrays, 32 values a 128-byte row)
inline bool tensor_maps(CUtensorMap* maps, const void* const* base, const int64_t* strides, int n,
                        int B, const int* S, int H, int D, const int* rows, int elem_bytes = 2) {
  for (int i = 0; i < n; ++i)
    if (bshd_tensor_map(&maps[i], base[i], B, S[i], H, D, strides[3 * i], strides[3 * i + 1],
                        strides[3 * i + 2], rows[i], elem_bytes) != cudaSuccess)
      return false;
  return true;
}

}  // namespace flash
}  // namespace ddpo
