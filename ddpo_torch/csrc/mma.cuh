// Tensor-core building blocks of the bf16 flash kernels and the tap-GEMMs
// (sm_80 and up): cp.async staging, ldmatrix fragment loads (the tap-GEMMs'
// wgmma A fragments too: see wgmma.cuh), the m16n8k16 bf16 mma with fp32
// accumulators.
//
// Fragment layout of mma.sync.m16n8k16 for lane l, g = l / 4, t = l % 4:
//   A (16 x 16, row-major) a0..a3: (g, 2t..2t+1), (g+8, 2t..), (g, 8+2t..),
//     (g+8, 8+2t..), two bf16 each, the lower index in the lower half;
//   B (16 x 8, k x n) b0, b1: (2t..2t+1, g), (8+2t.., g);
//   C (16 x 8, fp32) c0..c3: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// ldmatrix.x4 reads four 8 x 8 b16 matrices; lanes 8i..8i+7 give the 16-byte
// row addresses of matrix i, and register i of every lane holds matrix i.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace ddpo {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; valid == false writes 16 zero
// bytes and reads nothing (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous (.ca: the only path for fewer than
// 16 bytes); valid == false writes 4 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a * b, one 16 x 8 x 16 bf16 product with fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU, flushing denormal results to 0 (2^-inf = 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- attention tiles: [row][d] in shared memory, d padded for ldmatrix ----

// row stride in elements of a [row][d] tile: D padded to 16*NC, plus 8 so
// that the 16-byte units of eight consecutive rows sit in eight bank groups
template <int NC>
__host__ __device__ constexpr int mma_ld() { return 16 * NC + 8; }

// lane offsets (elements) into a [row][d] tile of row stride ld for
// ldmatrix.x4: A fragments of an m16 tile, row (lane & 15), k half (lane >> 4)
__device__ __forceinline__ int a_frag_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
// B fragments with the tile's rows as n (plain ldmatrix): two n8 tiles of
// rows, one k16 step of d
__device__ __forceinline__ int b_frag_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
// B fragments with the tile's rows as k (ldmatrix.trans): 16 rows, two n8
// tiles of d
__device__ __forceinline__ int bt_frag_off(int lane, int ld) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8;
}

// Whether stage_rows may use cp.async: D, each of the n (b, s, h) strides
// and each base address a multiple of 8 elements (16 bytes)
inline bool rows_vectorizable(int D, const int64_t* strides, int n,
                              std::initializer_list<const void*> bases) {
  bool vec = D % 8 == 0;
  for (int i = 0; i < n; ++i) vec = vec && strides[i] % 8 == 0;
  for (const void* p : bases) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return vec;
}

// rows row0 .. row0+n-1 of one (b, h) slice into dst [n][ld], by nt threads.
// vec: cp.async 16 bytes at a time (D, the row stride and src multiples of
// 8 elements); else element-wise stores. Rows past S are zeros; columns past
// D are not written (the caller zeroes them once).
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t stride, int row0, int n, int S, int D, int ld,
                                           bool vec, int tid, int nt) {
  if (vec) {
    const int cpr = D >> 3;  // 16-byte units per row
    for (int idx = tid; idx < n * cpr; idx += nt) {
      const int r = idx / cpr, c = idx - r * cpr;
      const bool ok = row0 + r < S;
      cp_async16(smem_addr(dst + r * ld + c * 8), ok ? src + (row0 + r) * stride + c * 8 : src,
                 ok);
    }
  } else {
    for (int idx = tid; idx < n * D; idx += nt) {
      const int r = idx / D, c = idx - r * D;
      dst[r * ld + c] =
          row0 + r < S ? src[(row0 + r) * stride + c] : __float2bfloat16(0.f);
    }
  }
}

// columns col, col+1 (those below D) of one bf16 output row: a lane's pair
// of a C fragment
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col, int D, float x0,
                                           float x1) {
  if ((D & 1) == 0 && col + 1 < D) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < D) row[col] = __float2bfloat16(x0);
    if (col + 1 < D) row[col + 1] = __float2bfloat16(x1);
  }
}

}  // namespace ddpo
