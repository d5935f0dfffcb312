// Tensor-core building blocks shared by the streaming SVGD tile
// (svgd_tile.cu), the symmetric-traversal tile (svgd_sym.cu), B10's tile on
// a given D (svgd_on_d.cu) and the Gram stage of the median kernel, the
// bracket pass and the distance block (gram_stage.cuh): cp.async copies
// into shared memory (a chunk, or a whole tile), the 3xTF32 split and
// mma.sync m16n8k8 (tf32) / m16n8k16 (bf16), the row-block dot S = R T^T
// and the contraction K @ U.
//
// What bounds their users on the H100 is latency, not the tensor cores'
// rate: mma.sync issues from a warp one dependent product after another
// and each operand is split on the CUDA cores, so the kernels keep several
// warps' products in flight and stage their operands ahead by cp.async.
//
// Precision. 3xTF32 splits each f32 operand x into big = tf32(x) and small
// = tf32(x - big) and runs big*small + small*big + big*big with f32
// accumulation, which keeps the f32 tolerance class. The tensor cores
// truncate as they accumulate, so every product here sums each run of 32
// contraction indices in fresh registers and adds it into the running sum
// by an IEEE add. Integer operands of at most 11 significant bits (the
// lattice particles of the checks) are exact in tf32 (small = 0), so their
// dots are exact.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stein {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// A 4-byte copy for rows that are not 16-byte aligned (p % 4 != 0).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16-byte copies of a [rows, width] tile (width a multiple of 4) from src
// (row stride ss) to dst (row stride ds) by the block's THREADS threads,
// thread t taking chunks t, t + THREADS, ... in row-major order (two
// divisions a call).
template <int THREADS>
__device__ __forceinline__ void cp_async_tile(float* dst, int ds,
                                              const float* src, int ss,
                                              int rows, int width) {
  const int per_row = width / 4;
  const int dr = THREADS / per_row, dc = THREADS - dr * per_row;
  int r = threadIdx.x / per_row, c4 = threadIdx.x - r * per_row;
  for (; r < rows; r += dr, c4 += dc) {
    if (c4 >= per_row) {
      c4 -= per_row;
      if (++r >= rows) break;
    }
    cp_async16(dst + r * ds + 4 * c4,
               src + static_cast<size_t>(r) * ss + 4 * c4);
  }
}

// Waits until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to tf32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 for finite x, in two integer operations in place of the
// conversion instruction.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both tf32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 of G accumulators, the two small cross terms first, then big *
// big; each round issues G independent products, so the three that share
// an accumulator do not wait on each other back to back.
template <int G>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (*bb)[2],
                                           const uint32_t (*bs)[2]) {
#pragma unroll
  for (int i = 0; i < G; ++i) mma_tf32(d[i], as, bb[i]);
#pragma unroll
  for (int i = 0; i < G; ++i) mma_tf32(d[i], ab, bs[i]);
#pragma unroll
  for (int i = 0; i < G; ++i) mma_tf32(d[i], ab, bb[i]);
}

// One k-step of 8 contraction indices, 3xTF32: t[nt] += R[16 rows, k-step]
// T[8 nt + (0..8), k-step]^T, with r_lo / r_hi the rows gid and gid + 8 and
// tj the 32 columns (row stride sk), k = the k-step's first index + tig.
__device__ __forceinline__ void kstep_3xtf32(float (&t)[4][4],
                                             const float* r_lo,
                                             const float* r_hi,
                                             const float* tj, int sk, int k,
                                             int gid) {
  uint32_t ab[4], as[4], bb[4][2], bs[4][2];
  split(r_lo[k], ab[0], as[0]);
  split(r_hi[k], ab[1], as[1]);
  split(r_lo[k + 4], ab[2], as[2]);
  split(r_hi[k + 4], ab[3], as[3]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float* c = tj + (8 * nt + gid) * sk + k;
    split(c[0], bb[nt][0], bs[nt][0]);
    split(c[4], bb[nt][1], bs[nt][1]);
  }
  mma_3xtf32<4>(t, ab, as, bb, bs);
}

// The tensor cores add each product into the accumulator with truncation,
// so a sum carried through many products drifts towards zero. Both
// products below therefore accumulate a short run (32 contraction indices)
// in fresh registers and add it into the running sum with an IEEE add.

// s[nt] += ti[16 rows, kw] tj[8 nt + (0..8), kw]^T for the warp's 16 rows
// (row strides sk); lane = (gid, tig) = (lane / 4, lane % 4).
template <bool BF16>
__device__ __forceinline__ void dot_chunk(float (&s)[4][4], const float* ti,
                                          const float* tj, int sk, int kw,
                                          int gid, int tig) {
  const float* r_lo = ti + gid * sk;
  const float* r_hi = r_lo + 8 * sk;
  // Each of a run's k-steps accumulates into its own registers, so the
  // products of consecutive k-steps do not wait on each other; the run's
  // sets are added in a fixed order.
  constexpr int kStep = BF16 ? 16 : 8;
  constexpr int kSets = 32 / kStep;
  for (int k1 = 0; k1 < kw; k1 += 32) {
    float t[kSets][4][4] = {};
#pragma unroll
    for (int j = 0; j < kSets; ++j) {
      const int k0 = k1 + j * kStep;
      if (k0 >= kw) break;
      if constexpr (BF16) {
        const int k = k0 + 2 * tig;
        const float2 a0 = *reinterpret_cast<const float2*>(r_lo + k);
        const float2 a1 = *reinterpret_cast<const float2*>(r_hi + k);
        const float2 a2 = *reinterpret_cast<const float2*>(r_lo + k + 8);
        const float2 a3 = *reinterpret_cast<const float2*>(r_hi + k + 8);
        const uint32_t a[4] = {pack_bf16(a0.x, a0.y), pack_bf16(a1.x, a1.y),
                               pack_bf16(a2.x, a2.y), pack_bf16(a3.x, a3.y)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* c = tj + (8 * nt + gid) * sk + k;
          const float2 b0 = *reinterpret_cast<const float2*>(c);
          const float2 b1 = *reinterpret_cast<const float2*>(c + 8);
          const uint32_t b[2] = {pack_bf16(b0.x, b0.y), pack_bf16(b1.x, b1.y)};
          mma_bf16(t[j][nt], a, b);
        }
      } else {
        kstep_3xtf32(t[j], r_lo, r_hi, tj, sk, k0 + tig, gid);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = t[0][nt][e];
#pragma unroll
        for (int j = 1; j < kSets; ++j) v += t[j][nt][e];
        s[nt][e] += v;
      }
  }
}

// acc[q] += K[16 rows, 32 tile columns] U[32, 8 q + (0..8)], K held in the
// accumulator layout of the dot (k[nt][e]: row gid + 8 (e / 2), column
// 8 nt + 2 tig + e % 2); uj has row stride su. Each group of four output
// tiles takes the tile's 32 columns in fresh registers, then one add.
template <int NT, bool BF16>
__device__ __forceinline__ void contract(float (&acc)[NT][4],
                                         const float (&k)[4][4],
                                         const float* uj, int su, int gid,
                                         int tig) {
  if constexpr (BF16) {
    uint32_t a[2][4];
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      a[kb][0] = pack_bf16(k[2 * kb][0], k[2 * kb][1]);
      a[kb][1] = pack_bf16(k[2 * kb][2], k[2 * kb][3]);
      a[kb][2] = pack_bf16(k[2 * kb + 1][0], k[2 * kb + 1][1]);
      a[kb][3] = pack_bf16(k[2 * kb + 1][2], k[2 * kb + 1][3]);
    }
#pragma unroll
    for (int q0 = 0; q0 < NT; q0 += 4) {
      float t[4][4] = {};
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const float* u0 = uj + (16 * kb + 2 * tig) * su + gid + 8 * q0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* u = u0 + 8 * i;
          const uint32_t b[2] = {pack_bf16(u[0], u[su]),
                                 pack_bf16(u[8 * su], u[9 * su])};
          mma_bf16(t[i], a[kb], b);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q0 + i][e] += t[i][e];
    }
  } else {
    // Contraction slot tig holds column 2 tig, slot tig + 4 column 2 tig + 1.
    uint32_t ab[4][4], as[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      split(k[kb][0], ab[kb][0], as[kb][0]);
      split(k[kb][2], ab[kb][1], as[kb][1]);
      split(k[kb][1], ab[kb][2], as[kb][2]);
      split(k[kb][3], ab[kb][3], as[kb][3]);
    }
#pragma unroll
    for (int q0 = 0; q0 < NT; q0 += 4) {
      float t[4][4] = {};
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        const float* u0 = uj + (8 * kb + 2 * tig) * su + gid + 8 * q0;
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split(u0[8 * i], bb[i][0], bs[i][0]);
          split(u0[su + 8 * i], bb[i][1], bs[i][1]);
        }
        mma_3xtf32<4>(t, ab[kb], as[kb], bb, bs);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q0 + i][e] += t[i][e];
    }
  }
}

}  // namespace stein
