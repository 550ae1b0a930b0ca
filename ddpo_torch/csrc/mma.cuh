// Register-level pieces of the bf16 flash kernels and the tap-GEMMs:
// 4-byte cp.async, ldmatrix fragment loads (the tap-GEMMs' wgmma A
// fragments: see wgmma.cuh), exp2 on the SFU, bf16 packing and the paired
// bf16 stores of an accumulator row.
//
// Fragment layout of mma.sync.m16n8k16, which a wgmma A fragment and a
// wgmma accumulator's rows share (wgmma.cuh), for lane l, g = l / 4,
// t = l % 4:
//   A (16 x 16, row-major) a0..a3: (g, 2t..2t+1), (g+8, 2t..), (g, 8+2t..),
//     (g+8, 8+2t..), two bf16 each, the lower index in the lower half;
//   B (16 x 8, k x n) b0, b1: (2t..2t+1, g), (8+2t.., g);
//   C (16 x 8, fp32) c0..c3: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// ldmatrix.x4 reads four 8 x 8 b16 matrices; lanes 8i..8i+7 give the 16-byte
// row addresses of matrix i, and register i of every lane holds matrix i.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ddpo {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronous (.ca: the only path for fewer than
// 16 bytes); valid == false writes 4 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
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
