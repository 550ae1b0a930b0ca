// fp32 flash-attention forward for sm_90a: 3xTF32 on wgmma, fed by TMA.
//
// Replaces: ddpo_tpu/ops/attention.py::_flash_kernel at fp32 (flash_fwd.cu
// holds the bf16 kernel and the entry point that dispatches here). Same
// function: out = softmax(Q K^T scale) V with the softmax in fp32 over key
// tiles, padded keys masked, and the natural-log row logsumexp (fp32).
//
// What bounds it on this card: the products, 4 Sq Sk D flops per (batch,
// head). On the CUDA cores that is 67 TFLOP/s; the tensor cores take tf32
// (494.7 TFLOP/s dense), whose 10 mantissa bits alone would break the
// fp32 bounds, so every product is the 3xTF32 sum of wgmma.cuh (x = hi +
// lo, a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b): 165 TFLOP/s of fp32-grade
// products. At D = 40 the exponentials (one a score, 16 a clock per SM on
// the SFUs) weigh about as much.
//
// Design (tiles a function of D alone: Tile<NK>, NK = ceil(D / 8) k8 steps):
//   - A block is NCW consumer warpgroups of 64 query rows each (two up to
//     D = 96, one above) and a producer warpgroup: grid (query tiles, H, B).
//   - tf32 wgmma reads both shared-memory operands K-major only, and every
//     operand must be split. The producer writes each operand as a hi and a
//     lo tile of the same layout (128-byte rows of 32 fp32, TMA's 128-byte
//     swizzle): Q once (64 rows x D a consumer), then K and V tiles of BK
//     keys (64 up to D = 64, 32 above) through a ring of slots that K(0),
//     V(0), K(1), V(1), ... take in turn, each on a full and an empty
//     mbarrier. Q and K come by TMA where the arrays allow it (a 16-byte
//     aligned base, strides of whole 16 bytes), the raw fp32 rows landing in
//     the hi tile and split in place by the producer's 128 threads; else
//     by plain loads. K's TMA load runs a tile ahead. V is MN-major for
//     O += P V, and
//     TMA does not transpose: the producer loads it with plain loads, one
//     tile ahead in registers, and writes V^T (rows of D, keys along K)
//     split into its hi and lo tiles.
//   - S = Q K^T is three SS wgmmas a k8 step (Q_lo K_hi, Q_hi K_lo, Q_hi
//     K_hi, in that order), N = BK. The tensor cores round into their
//     accumulators toward zero (wgmma.cuh), so each 32 columns of D are
//     summed in a fresh accumulator and the groups added in registers; a
//     tile's P V likewise, one fresh sum a 64-column chunk of O, added as
//     O = O corr + (P V) with one rounding. The online softmax runs in
//     base 2 on S's fp32 sums as in the bf16 kernel, with the scale on the
//     fp32 scores and exp2 on the SFU.
//   - O += P V takes P from registers (RS), split there. A tf32 A fragment
//     holds columns t and t + 4 of a k8 step where S's accumulator gives a
//     lane keys 2t and 2t + 1, so within each 8 keys V^T's columns are
//     permuted to match (key 2t at column t, key 2t + 1 at column t + 4):
//     the same products, in a fixed order. O sits in 64-column chunks.
//   - The two consumer warpgroups take turns to issue their products (the
//     ping-pong of flash_tiles.cuh), so that one's softmax runs while the
//     other's products do; within a warpgroup a tile's S, softmax and P V
//     run in order.
//
// Three translation units: this file builds D <= 128 (ddpo::flash_fwd_tf32,
// which flash_fwd.cu calls); flash_fwd_tf32_wide.cu and
// flash_fwd_tf32_wider.cu include it with DDPO_FLASH_FWD_TF32_WIDE defined
// as 1 and 2 and build 128 < D <= 192 and D > 192, so that their nvcc runs
// go in parallel.
//
// Summation order: each output element has one owner (a lane of the
// warpgroup that owns its row) and adds its terms in a fixed order: key
// tiles in order, within a tile the k8 steps in order, the three products
// in order, in the fixed groups above. No split over keys and no atomics;
// nothing depends on the batch, the head or the row's place in the block,
// so image i alone gives the bits it gets inside a batch.

#include "common.cuh"
#include "flash_tiles.cuh"

namespace {

namespace fl = ddpo::flash;

constexpr int ROW = fl::ROW_BYTES;  // 128 bytes: 32 fp32
constexpr int WG = fl::WG;

// Tiles for D padded to 8 NK, functions of D alone
template <int NK>
struct Tile {
  static constexpr int A = (NK + 3) / 4;          // 128-byte atoms of a row of D
  static constexpr int NCW = A <= 3 ? 2 : 1;      // consumer warpgroups
  static constexpr int BK = A <= 2 ? 64 : 32;     // keys a K or V tile
  static constexpr int NR = 8 * NK;               // rows of V^T: D padded to 8
  static constexpr int NOC = (NR + 63) / 64;      // O's 64-column chunks
  static constexpr int NL = NR - 64 * (NOC - 1);  // columns of the last chunk
  static constexpr int QTILE = A * 64 * ROW;      // Q's hi or lo tile
  static constexpr int KTILE = A * BK * ROW;      // K's hi or lo tile (V^T's fits)
  static constexpr int SLOT = 2 * KTILE;          // hi, then lo
  static_assert((BK / 32) * NR <= A * BK, "V^T's tile must fit in K's");
  __host__ __device__ static constexpr size_t smem(int slots) {
    // Q [NCW][hi, lo][A][64][128], the slots, then q_full, tma, full[], empty[]
    return 1024 + size_t(NCW) * 2 * QTILE + size_t(slots) * SLOT + 8 * (2 + 2 * slots);
  }
  __host__ __device__ static constexpr int slots() {
    int s = 6;
    while (s > 1 && smem(s) > size_t(fl::SMEM_MAX)) --s;
    return s;
  }
};

struct Args {
  const float *q, *k, *v;
  float* out;
  float* lse;
  int H, Sq, Sk, D;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale_log2;
  int tma;  // 1: Q and K by TMA; 0: by plain loads
  int vec;  // bit i set: array i of (q, k, v) takes 16-byte plain loads
};

// named barrier of the producer warpgroup (1 and 2 are the consumers' turns)
constexpr int kProducerBar = 3;

// columns d0 .. d0+3 of row `row` of a (b, h) slice, zeros past S or D
__device__ __forceinline__ float4 load4(const float* base, int64_t ss, int row, int S, int d0,
                                        int D, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= S || d0 >= D) return v;
  const float* p = base + int64_t(row) * ss + d0;
  if (vec && d0 + 3 < D) return __ldg(reinterpret_cast<const float4*>(p));
  v.x = __ldg(p);
  if (d0 + 1 < D) v.y = __ldg(p + 1);
  if (d0 + 2 < D) v.z = __ldg(p + 2);
  if (d0 + 3 < D) v.w = __ldg(p + 3);
  return v;
}

// the split of 4 values to the same 16 bytes of the hi and the lo tile
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, uint32_t off, float4 v) {
  uint4 h, l;
  ddpo::tf32_split(v.x, h.x, l.x);
  ddpo::tf32_split(v.y, h.y, l.y);
  ddpo::tf32_split(v.z, h.z, l.z);
  ddpo::tf32_split(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// raw fp32 in the hi tile (TMA's) -> its hi in place, its lo beside
__device__ __forceinline__ void split_in_place(uint8_t* hi, uint8_t* lo, int bytes, int p) {
  for (int off = 16 * p; off < bytes; off += 16 * WG) {
    const uint4 raw = *reinterpret_cast<const uint4*>(hi + off);
    store_split(hi, lo, off,
                make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                            __uint_as_float(raw.z), __uint_as_float(raw.w)));
  }
}

// rows row0 .. row0+n-1 of one (b, h) slice into the split tiles
// ([A][n][128], swizzled) by plain loads: zeros past S and past D
__device__ __forceinline__ void stage_split(uint8_t* hi, uint8_t* lo, const float* src, int64_t ss,
                                            int row0, int n, int S, int D, int na, int p,
                                            bool vec) {
  for (int i = p; i < na * n * 8; i += WG) {
    const int u = i & 7, r = (i >> 3) % n, at = (i >> 3) / n;
    const float4 v = load4(src, ss, row0 + r, S, at * 32 + 4 * u, D, vec);
    store_split(hi, lo, uint32_t(at) * n * ROW + fl::swz(r, u), v);
  }
}

// V's keys k0 .. k0+BK-1 for stage_v: a thread's items (a key and 4
// columns of D; neighbouring threads take neighbouring keys), loaded into
// registers, all issued at once so that their latencies overlap
template <int BK, int NR>
struct VTile {
  static constexpr int N = BK * (NR / 4);          // items
  static constexpr int ITEMS = (N + WG - 1) / WG;  // a thread's
  float4 v[ITEMS];
  __device__ __forceinline__ void load(const float* src, int64_t ss, int k0, int S, int D, int p,
                                       bool vec) {
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = p + it * WG;
      v[it] = i < N ? load4(src, ss, k0 + i % BK, S, 4 * (i / BK), D, vec)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

// the loaded V tile transposed into the split V^T tiles ([BK / 32][NR]
// [128]: row d, 32 keys along K). Key j of each 8 goes to column
// (j % 2) * 4 + j / 2 of its k8 step, so that the columns line up with the
// keys of P's A fragment; a warp's 4-byte stores fill one 128-byte row.
template <int BK, int NR>
__device__ __forceinline__ void stage_v(uint8_t* hi, uint8_t* lo, const VTile<BK, NR>& t, int p) {
#pragma unroll
  for (int it = 0; it < VTile<BK, NR>::ITEMS; ++it) {
    const int i = p + it * WG;
    if (i >= VTile<BK, NR>::N) break;
    const int j = i % BK, q = i / BK;
    const float vals[4] = {t.v[it].x, t.v[it].y, t.v[it].z, t.v[it].w};
    const int c = (j & 24) | ((j & 1) << 2) | ((j >> 1) & 3);
    const uint32_t base = uint32_t(j >> 5) * NR * ROW + uint32_t(c & 3) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * q + e;
      const uint32_t off = base + uint32_t(d) * ROW + uint32_t(((c >> 2) ^ (d & 7)) << 4);
      uint32_t h, l;
      ddpo::tf32_split(vals[e], h, l);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) = l;
    }
  }
}

// columns col, col+1 (those below D) of one fp32 output row
__device__ __forceinline__ void store_pair(float* row, int col, int D, float x0, float x1) {
  if ((D & 1) == 0 && col + 1 < D) {
    *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
  } else {
    if (col < D) row[col] = x0;
    if (col + 1 < D) row[col + 1] = x1;
  }
}

// One consumer warpgroup's 64 query rows from row0: Q's hi and lo tiles at
// qh and ql, the ring at slots, the barriers at bars
template <int NK>
__device__ __forceinline__ void consumer(const Args& a, uint32_t qh, uint32_t ql, uint32_t slots,
                                         uint32_t bars, int row0, int b, int h) {
  using T = Tile<NK>;
  constexpr int BK = T::BK, KQ = BK / 8, NS = T::slots(), NOC = T::NOC, NL = T::NL;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + NS + s); };
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3, g = lane >> 2, tq = lane & 3;
  const fl::Turns turns{int(threadIdx.x) / WG, T::NCW};

  // O by 64-column chunk (the last chunk's first NL / 2), S of one tile,
  // its P as the hi and lo A fragments of O += P V, and the fresh sums of
  // a 32-column group of S (sb) or a chunk of a tile's P V (ob)
  // the fresh sums' buffers: two in turns, or (for registers) one, waited
  // for at once: S's groups with one consumer warpgroup (D > 96), P V's
  // chunks above D = 128
  constexpr int SB = T::NCW == 2 ? 2 : 1, OB = NOC <= 2 ? 2 : 1;
  float o[NOC][32], s[BK / 2], sb[SB][BK / 2], ob[OB][32];
  uint32_t ph[KQ][4], pl[KQ][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int c = 0; c < NOC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) ob[j][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int j = 0; j < SB; ++j) sb[j][i] = 0.f;
  }

  auto fence_s = [&]() {
    ddpo::fence_operands(s);
#pragma unroll
    for (int j = 0; j < SB; ++j) ddpo::fence_operands(sb[j]);
  };
  auto fence_ob = [&]() {
#pragma unroll
    for (int j = 0; j < OB; ++j) ddpo::fence_operands(ob[j]);
  };
  auto fence_p = [&]() {
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      ddpo::fence_operands(ph[kq]);
      ddpo::fence_operands(pl[kq]);
    }
  };
  // the online softmax of tile t's S in place (P in fp32); the lane holds
  // rows g + 8r and keys 8j + 2tq + e, the three lanes of its quad the rest
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

  // S's k8 steps from kk0: four (32 columns of D) or to the end, the three
  // products each, into d from 0
  auto issue_qk = [&](float (&d)[BK / 2], uint32_t kh, uint32_t kl, int kk0) {
#pragma unroll
    for (int kk = kk0; kk < kk0 + 4 && kk < NK; ++kk) {
      ddpo::wgmma_tf32_ss<BK>(d, fl::k_desc(ql, 64, kk), fl::k_desc(kh, BK, kk), kk > kk0);
      ddpo::wgmma_tf32_ss<BK>(d, fl::k_desc(qh, 64, kk), fl::k_desc(kl, BK, kk), 1);
      ddpo::wgmma_tf32_ss<BK>(d, fl::k_desc(qh, 64, kk), fl::k_desc(kh, BK, kk), 1);
    }
  };
  auto add_s = [&](const float (&d)[BK / 2]) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] += d[i];
  };
  // one 64-column chunk c of the tile's P V, its k8 steps in order, from 0
  auto issue_pv = [&](float (&d)[32], uint32_t vh, uint32_t vl, int c) {
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      const uint32_t at = uint32_t(kq >> 2) * T::NR * ROW + uint32_t(c) * 64 * ROW;
      const uint64_t dh = ddpo::b_desc_sw128(vh + at) + 2 * (kq & 3);
      const uint64_t dl = ddpo::b_desc_sw128(vl + at) + 2 * (kq & 3);
      if (c < NOC - 1) {
        ddpo::wgmma_tf32_rs<64>(d, pl[kq], dh, kq > 0);
        ddpo::wgmma_tf32_rs<64>(d, ph[kq], dl);
        ddpo::wgmma_tf32_rs<64>(d, ph[kq], dh);
      } else {
        ddpo::wgmma_tf32_rs<NL>(d, pl[kq], dh, kq > 0);
        ddpo::wgmma_tf32_rs<NL>(d, ph[kq], dl);
        ddpo::wgmma_tf32_rs<NL>(d, ph[kq], dh);
      }
    }
  };
  // O = O corr + chunk c's P V (fp32, rounded once)
  auto add_o = [&](int c, const float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (c < NOC - 1 || i < NL / 2) o[c][i] = fmaf(o[c][i], corr[(i >> 1) & 1], d[i]);
  };

  turns.start();
  ddpo::mbar_wait(bars, 0);  // Q
  const int nt = (a.Sk + BK - 1) / BK;
  constexpr int G = (NK + 3) / 4;  // 32-column groups of S
#pragma unroll 1
  for (int t = 0; t < nt; ++t) {
    // S = Q K^T: each 32 columns of D a fresh sum (group 0 in s, then sb),
    // the groups added into s in order
    const int sk = (2 * t) % NS, sv = (2 * t + 1) % NS;
    const uint32_t kh = slots + uint32_t(sk) * T::SLOT, kl = kh + T::KTILE;
    ddpo::mbar_wait(full(sk), ((2 * t) / NS) & 1);
    turns.take();
#pragma unroll
    for (int gr = 0; gr < G; ++gr) {
      fence_s();
      ddpo::wgmma_fence();
      if (gr == 0)
        issue_qk(s, kh, kl, 0);
      else
        issue_qk(sb[(gr - 1) % SB], kh, kl, 4 * gr);
      ddpo::wgmma_commit();
      fence_s();
      if (SB == 1 && gr >= 1) {
        ddpo::wgmma_wait<0>();
        fence_s();
        add_s(sb[0]);
      } else if (SB == 2 && gr >= 2) {
        ddpo::wgmma_wait<1>();  // groups to gr - 1
        fence_s();
        add_s(sb[(gr - 2) % SB]);
      }
    }
    turns.pass(false);
    ddpo::wgmma_wait<0>();
    fence_s();
    if (SB == 2 && G >= 2) add_s(sb[(G - 2) % SB]);
    ddpo::mbar_arrive(empty(sk));

    softmax(t);
    // P's A fragments: a0..a3 = (row g, key 2tq), (g + 8, 2tq), (g, 2tq + 1),
    // (g + 8, 2tq + 1) of each 8 keys, columns tq, tq, tq + 4, tq + 4 of the
    // permuted step
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      ddpo::tf32_split(s[4 * kq + 0], ph[kq][0], pl[kq][0]);
      ddpo::tf32_split(s[4 * kq + 2], ph[kq][1], pl[kq][1]);
      ddpo::tf32_split(s[4 * kq + 1], ph[kq][2], pl[kq][2]);
      ddpo::tf32_split(s[4 * kq + 3], ph[kq][3], pl[kq][3]);
    }

    // O = O corr + P V: each 64-column chunk of the tile's P V a fresh sum
    // (ob in turns, or the one ob, waited for at once), added into O in
    // order
    const uint32_t vh = slots + uint32_t(sv) * T::SLOT, vl = vh + T::KTILE;
    ddpo::mbar_wait(full(sv), ((2 * t + 1) / NS) & 1);
    turns.take();
#pragma unroll
    for (int c = 0; c < NOC; ++c) {
      fence_ob();
      fence_p();
      ddpo::wgmma_fence();
      issue_pv(ob[c % OB], vh, vl, c);
      ddpo::wgmma_commit();
      fence_ob();
      if (OB == 1 && c < NOC - 1) {
        ddpo::wgmma_wait<0>();
        fence_ob();
        add_o(c, ob[0]);
      } else if (OB == 2 && c >= 1) {
        ddpo::wgmma_wait<1>();  // chunk c - 1
        fence_ob();
        add_o(c - 1, ob[(c - 1) % OB]);
      }
    }
    turns.pass(t == nt - 1);
    ddpo::wgmma_wait<0>();
    fence_ob();
    fence_p();
    add_o(NOC - 1, ob[(NOC - 1) % OB]);
    ddpo::mbar_arrive(empty(sv));
  }

  const float kLn2 = 0.69314718055994531f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * wq + g + 8 * r;
    if (row >= a.Sq) continue;
    const float inv = 1.f / l[r];
    float* orow = a.out + ((int64_t(b) * a.Sq + row) * a.H + h) * a.D;
#pragma unroll
    for (int c = 0; c < NOC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c < NOC - 1 || j < NL / 8)
          store_pair(orow, c * 64 + 8 * j + 2 * tq, a.D, o[c][4 * j + 2 * r] * inv,
                     o[c][4 * j + 2 * r + 1] * inv);
    if (tq == 0) a.lse[(int64_t(b) * a.H + h) * a.Sq + row] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// out and lse for 64 * NCW query rows of one (head, batch): grid (query
// tiles, H, B), NCW consumer warpgroups and the producer warpgroup
template <int NK>
__global__ void __launch_bounds__((Tile<NK>::NCW + 1) * WG, 1) flash_fwd_tf32_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const Args a) {
  using T = Tile<NK>;
  constexpr int A = T::A, NCW = T::NCW, BK = T::BK, NS = T::slots();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (ddpo::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = qs + NCW * 2 * T::QTILE;  // [NS][hi, lo]
  const uint32_t bars = ddpo::smem_addr(ring + NS * T::SLOT);
  const uint32_t q_full = bars, tma = bars + 8;  // tma: Q's loads, then K(t)'s
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + NS + s); };

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * 64 * NCW, h = blockIdx.y, b = blockIdx.z;
  const int nt = (a.Sk + BK - 1) / BK;

  if (tid == 0) {
    ddpo::mbar_init(q_full, WG);
    ddpo::mbar_init(tma, 1);
    for (int s = 0; s < NS; ++s) {
      ddpo::mbar_init(full(s), WG);
      ddpo::mbar_init(empty(s), NCW * WG);
    }
    ddpo::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCW * WG) {  // the producer warpgroup
    const int p = tid - NCW * WG;
    const float* qb = a.q + b * a.q_sb + h * a.q_sh;
    const float* kb = a.k + b * a.k_sb + h * a.k_sh;
    const float* vb = a.v + b * a.v_sb + h * a.v_sh;
    // TMA load i (Q's for i = 0 .. NCW - 1, then K(t)'s) of `rows` rows on
    // tma, issued once every producer thread has seen load i - 1 land; and
    // the wait for it
    auto tma_issue = [&](uint8_t* dst, const CUtensorMap* map, int row0, int rows, int bytes) {
      ddpo::named_sync(kProducerBar, WG);
      if (p == 0) {
        ddpo::mbar_arrive_expect_tx(tma, bytes);
        for (int at = 0; at < A; ++at)
          ddpo::tma_load_4d(ddpo::smem_addr(dst) + uint32_t(at) * rows * ROW, map, tma, at * 32,
                            h, row0, b);
      }
    };
    auto tma_wait = [&](int i) { ddpo::mbar_wait(tma, i & 1); };
    // item it of the ring (K(it / 2) or V(it / 2)) at its slot, once free
    auto slot = [&](int it) {
      const int s = it % NS, use = it / NS;
      if (use > 0) ddpo::mbar_wait(empty(s), (use - 1) & 1);
      return ring + s * T::SLOT;
    };
    for (int c = 0; c < NCW; ++c) {
      uint8_t* hi = qs + c * 2 * T::QTILE;
      if (a.tma) {
        tma_issue(hi, &qmap, q0 + 64 * c, 64, T::QTILE);
        tma_wait(c);
        split_in_place(hi, hi + T::QTILE, T::QTILE, p);
      } else {
        stage_split(hi, hi + T::QTILE, qb, a.q_ss, q0 + 64 * c, 64, a.Sq, a.D, A, p, a.vec & 1);
      }
    }
    ddpo::fence_proxy_async();
    ddpo::mbar_arrive(q_full);
    // K(t + 1) by TMA is issued once K(t) is split, so that it lands while
    // V(t) is staged (with one slot, V(t) holds it until the consumers are
    // done: no lookahead); V(t + 1)'s loads are in flight while V(t) is
    // stored
    constexpr bool ahead = NS > 1;
    auto issue_k = [&](int t) { tma_issue(slot(2 * t), &kmap, t * BK, BK, T::KTILE); };
    if (a.tma) issue_k(0);
    VTile<BK, T::NR> v_cur, v_next;
    v_next.load(vb, a.v_ss, 0, a.Sk, a.D, p, a.vec & 4);
    for (int t = 0; t < nt; ++t) {
      uint8_t* hi = ring + ((2 * t) % NS) * T::SLOT;
      if (a.tma) {
        if (!ahead && t > 0) issue_k(t);
        tma_wait(NCW + t);
        split_in_place(hi, hi + T::KTILE, T::KTILE, p);
      } else {
        hi = slot(2 * t);
        stage_split(hi, hi + T::KTILE, kb, a.k_ss, t * BK, BK, a.Sk, a.D, A, p, a.vec & 2);
      }
      ddpo::fence_proxy_async();
      ddpo::mbar_arrive(full((2 * t) % NS));
      if (a.tma && ahead && t + 1 < nt) issue_k(t + 1);
      v_cur = v_next;
      if (t + 1 < nt) v_next.load(vb, a.v_ss, (t + 1) * BK, a.Sk, a.D, p, a.vec & 4);
      hi = slot(2 * t + 1);
      stage_v(hi, hi + T::KTILE, v_cur, p);
      ddpo::fence_proxy_async();
      ddpo::mbar_arrive(full((2 * t + 1) % NS));
    }
    return;
  }

  const int cw = tid / WG;
  const uint32_t qh = ddpo::smem_addr(qs + cw * 2 * T::QTILE);
  consumer<NK>(a, qh, qh + T::QTILE, ddpo::smem_addr(ring), bars, q0 + 64 * cw, b, h);
}

bool vec_ok(const void* base, const int64_t* st) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && st[0] % 4 == 0 && st[1] % 4 == 0 &&
         st[2] % 4 == 0;
}

template <int NK>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int H, int Sq, int Sk, int D, const int64_t* st, float scale,
                   cudaStream_t stream) {
  using T = Tile<NK>;
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.lse = lse;
  a.H = H, a.Sq = Sq, a.Sk = Sk, a.D = D;
  a.q_sb = st[0], a.q_ss = st[1], a.q_sh = st[2];
  a.k_sb = st[3], a.k_ss = st[4], a.k_sh = st[5];
  a.v_sb = st[6], a.v_ss = st[7], a.v_sh = st[8];
  a.scale_log2 = scale * 1.4426950408889634f;
  a.vec = int(vec_ok(q, st)) | int(vec_ok(k, st + 3)) << 1 | int(vec_ok(v, st + 6)) << 2;
  CUtensorMap maps[2] = {};
  const void* bases[2] = {q, k};
  const int rows[2] = {64, T::BK}, lens[2] = {Sq, Sk};
  a.tma = fl::tensor_maps(maps, bases, st, 2, B, lens, H, D, rows, 4);
  const size_t smem = T::smem(T::slots());
  // above 48 KB a block's dynamic shared memory must be allowed, once
  static const cudaError_t allowed = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (allowed != cudaSuccess) return allowed;
  constexpr int rows_a_block = 64 * T::NCW;
  const dim3 grid((Sq + rows_a_block - 1) / rows_a_block, H, B);
  flash_fwd_tf32_kernel<NK><<<grid, (T::NCW + 1) * WG, smem, stream>>>(maps[0], maps[1], a);
  return cudaGetLastError();
}

}  // namespace

#define DDPO_NK(n) \
  case n:          \
    return launch<n>(q, k, v, out, lse, B, H, Sq, Sk, D, st, scale, stream);

namespace ddpo {

#ifndef DDPO_FLASH_FWD_TF32_WIDE

cudaError_t flash_fwd_tf32_wide(const void* q, const void* k, const void* v, void* out,
                                float* lse, int B, int H, int Sq, int Sk, int D,
                                const int64_t* st, float scale, cudaStream_t stream);

// the fp32 forward of ddpo_flash_fwd (flash_fwd.cu), same arguments
cudaError_t flash_fwd_tf32(const void* q, const void* k, const void* v, void* out, float* lse,
                           int B, int H, int Sq, int Sk, int D, const int64_t* st, float scale,
                           cudaStream_t stream) {
  switch ((D + 7) / 8) {
    DDPO_NK(1) DDPO_NK(2) DDPO_NK(3) DDPO_NK(4) DDPO_NK(5) DDPO_NK(6) DDPO_NK(7) DDPO_NK(8)
    DDPO_NK(9) DDPO_NK(10) DDPO_NK(11) DDPO_NK(12) DDPO_NK(13) DDPO_NK(14) DDPO_NK(15)
    DDPO_NK(16)
    default:
      return flash_fwd_tf32_wide(q, k, v, out, lse, B, H, Sq, Sk, D, st, scale, stream);
  }
}

#elif DDPO_FLASH_FWD_TF32_WIDE == 1  // 128 < D <= 192

cudaError_t flash_fwd_tf32_wider(const void* q, const void* k, const void* v, void* out,
                                 float* lse, int B, int H, int Sq, int Sk, int D,
                                 const int64_t* st, float scale, cudaStream_t stream);

cudaError_t flash_fwd_tf32_wide(const void* q, const void* k, const void* v, void* out,
                                float* lse, int B, int H, int Sq, int Sk, int D,
                                const int64_t* st, float scale, cudaStream_t stream) {
  switch ((D + 7) / 8) {
    DDPO_NK(17) DDPO_NK(18) DDPO_NK(19) DDPO_NK(20) DDPO_NK(21) DDPO_NK(22) DDPO_NK(23)
    DDPO_NK(24)
    default:
      return flash_fwd_tf32_wider(q, k, v, out, lse, B, H, Sq, Sk, D, st, scale, stream);
  }
}

#else  // D > 192

cudaError_t flash_fwd_tf32_wider(const void* q, const void* k, const void* v, void* out,
                                 float* lse, int B, int H, int Sq, int Sk, int D,
                                 const int64_t* st, float scale, cudaStream_t stream) {
  switch ((D + 7) / 8) {
    DDPO_NK(25) DDPO_NK(26) DDPO_NK(27) DDPO_NK(28) DDPO_NK(29) DDPO_NK(30) DDPO_NK(31)
    DDPO_NK(32)
    default:
      return cudaErrorInvalidValue;
  }
}

#endif  // DDPO_FLASH_FWD_TF32_WIDE

}  // namespace ddpo

#undef DDPO_NK
