// The warm-bracket median search over an [m, n] f32 block in device memory,
// spread over every block of a cooperative grid. Shared by both kernels
// that search: the cold seed (replaces stein_tpu/ops/pallas_median.py:
// _warm_kernel) and the median stage of the fused step tail
// (stein_tpu/ops/pallas_step.py:_tail_kernel's warm_search_on_value).
//
// Contract: bitwise the value of stein_tpu/ops/median.py:_warm_search on
// the same block. Counts are integers (order-free sums, also across
// blocks), min/max are order-free, and the scalar interval arithmetic is the
// JAX expression tree written with __fmul_rn/__fadd_rn/__fsub_rn, so nvcc
// cannot contract lo + b*w into an FMA (which rounds once where XLA rounds
// twice). Every block reduces the same per-block partials with the same
// code, so every block holds the same interval without a second barrier.
//
// Bound on the H100: the sweeps over the block (1 MB at m=256, n=1000, 4
// MB for B12's whole n=1000 D, resident in the 50 MB L2), one for the
// range and the bracket counts and one per quad-ary round. Each sweep is a few loads per thread across the whole grid,
// then one grid barrier and the grid-wide totals; the barriers and the
// dependent chain between them, not bandwidth, set the time (~6 us a
// sweep). So the design cuts sweeps and shortens the chain: each sweep
// after the first counts two quad-ary rounds at once (round r's 3
// thresholds and the 3 of round r+1 in each of r's 4 possible
// sub-intervals: 15 counts), so warm_passes=8 takes 3 sweeps (was 5) and
// 30 cold passes 9 (was 16); after the barrier one warp per count sums the
// blocks' slots, in parallel, where one warp walked the counts in turn.
// The candidates' thresholds are the sequential search's own expression
// tree on the same inputs, so the selected interval is the same bits.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace stein {

namespace cg = cooperative_groups;

constexpr int kMaxBrackets = 8;
constexpr int kMaxCounts = 2 * kMaxBrackets;

struct Brackets {
  int count;
  float lo[kMaxBrackets];
  float hi[kMaxBrackets];
};

struct SweepShared {
  int warp_counts[32][kMaxCounts];
  float warp_min[32];
  float warp_max[32];
  int counts[kMaxCounts];
  float lo_full, hi_full;
  float thresholds[kMaxCounts];
};

// Per-sweep partials in device memory, one slot per block, count-major so
// that one warp reads a count's slots in one coalesced pass.
struct SweepScratch {
  int* counts;    // [sweeps][kMaxCounts][gridDim.x]
  float* range;   // [2][gridDim.x]
};

template <int NC>
__device__ __forceinline__ void count_one(float d, const float (&t)[NC],
                                          int nc, int (&c)[NC]) {
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < nc) c[i] += (d <= t[i]) ? 1 : 0;
}

// One sweep over this block's grid-stride share of D: |{D <= t_i}| for the
// nc thresholds in sh.thresholds and (with RANGE) min/max, reduced over the
// block and stored in this block's slot of `slot` / scratch.range. D may
// have been written earlier in the same launch, so it is read through L2
// (__ldcg), never through the read-only cache.
template <int NC, bool RANGE>
__device__ void sweep_block(const float* D, int total, int nc,
                            SweepShared& sh, int* slot, float* range) {
  float t[NC];
  int c[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    t[i] = i < nc ? sh.thresholds[i] : 0.0f;
    c[i] = 0;
  }
  float mn = CUDART_INF_F, mx = -CUDART_INF_F;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  int start = 0;
  if ((reinterpret_cast<uintptr_t>(D) & 15) == 0) {
    const float4* D4 = reinterpret_cast<const float4*>(D);
    const int n4 = total / 4;
    for (int e = tid; e < n4; e += stride) {
      const float4 v = __ldcg(D4 + e);
      count_one<NC>(v.x, t, nc, c);
      count_one<NC>(v.y, t, nc, c);
      count_one<NC>(v.z, t, nc, c);
      count_one<NC>(v.w, t, nc, c);
      if (RANGE) {
        mn = fminf(mn, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
        mx = fmaxf(mx, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
      }
    }
    start = 4 * n4;
  }
  for (int e = start + tid; e < total; e += stride) {
    const float d = __ldcg(D + e);
    count_one<NC>(d, t, nc, c);
    if (RANGE) {
      mn = fminf(mn, d);
      mx = fmaxf(mx, d);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NC; ++i) c[i] = __reduce_add_sync(0xffffffffu, c[i]);
  if (RANGE) {
    mn = warp_min(mn);
    mx = warp_max(mx);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NC; ++i) sh.warp_counts[warp][i] = c[i];
    sh.warp_min[warp] = mn;
    sh.warp_max[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    if (lane < nc) {
      int v = 0;
      for (int w = 0; w < n_warps; ++w) v += sh.warp_counts[w][lane];
      slot[lane * gridDim.x + blockIdx.x] = v;
    }
    if (RANGE) {
      float a = lane < n_warps ? sh.warp_min[lane] : CUDART_INF_F;
      float b = lane < n_warps ? sh.warp_max[lane] : -CUDART_INF_F;
      a = warp_min(a);
      b = warp_max(b);
      if (lane == 0) {
        range[blockIdx.x] = a;
        range[gridDim.x + blockIdx.x] = b;
      }
    }
  }
}

// After the grid barrier: the grid-wide totals of a sweep's slot (and
// range), identical in every block, into sh.counts / sh.lo_full /
// sh.hi_full. Warp w takes items w, w + warps, ... of the nc counts and
// (item nc) the range, each in one coalesced pass over the blocks' slots.
// Ends with a block barrier.
template <bool RANGE>
__device__ void sweep_totals(int nc, SweepShared& sh, const int* slot,
                             const float* range) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5, blocks = gridDim.x;
  for (int i = warp; i < nc + (RANGE ? 1 : 0); i += n_warps) {
    if (i < nc) {
      int v = 0;
      for (int b = lane; b < blocks; b += 32)
        v += __ldcg(slot + i * blocks + b);
      v = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0) sh.counts[i] = v;
    } else {
      float a = CUDART_INF_F, b = -CUDART_INF_F;
      for (int q = lane; q < blocks; q += 32) {
        a = fminf(a, __ldcg(range + q));
        b = fmaxf(b, __ldcg(range + blocks + q));
      }
      a = warp_min(a);
      b = warp_max(b);
      if (lane == 0) {
        sh.lo_full = a;
        sh.hi_full = b;
      }
    }
  }
  __syncthreads();
}

// The thresholds of a quad-ary round on [lo, lo + 4 w): lo + w, lo + 2 w,
// lo + 3 w, each rounded as XLA rounds the JAX expression.
__device__ __forceinline__ void quad_thresholds(float lo, float w, float* t) {
  t[0] = __fadd_rn(lo, w);
  t[1] = __fadd_rn(lo, __fmul_rn(2.0f, w));
  t[2] = __fadd_rn(lo, __fmul_rn(3.0f, w));
}

// b, the number of a round's three counts below rank k, as the JAX search
// sums it (f32, left to right).
__device__ __forceinline__ float below(const int* counts, int k) {
  return __fadd_rn(__fadd_rn(counts[0] < k ? 1.0f : 0.0f,
                             counts[1] < k ? 1.0f : 0.0f),
                   counts[2] < k ? 1.0f : 0.0f);
}

// The whole search; every thread of every block of the cooperative grid
// calls it. Block 0 writes out[0] = med and out[1] = med / log_n (h^2).
__device__ void grid_warm_search(const float* D, int total, float med_prev,
                                 int k, int rounds, const Brackets& br,
                                 float log_n, SweepScratch scratch,
                                 float* out) {
  __shared__ SweepShared sh;
  cg::grid_group grid = cg::this_grid();
  const int nb = br.count;
  if (threadIdx.x < nb) {
    sh.thresholds[2 * threadIdx.x] = __fmul_rn(br.lo[threadIdx.x], med_prev);
    sh.thresholds[2 * threadIdx.x + 1] =
        __fmul_rn(br.hi[threadIdx.x], med_prev);
  }
  __syncthreads();
  // Pass 1: the range and every bracket endpoint's count.
  sweep_block<kMaxCounts, true>(D, total, 2 * nb, sh, scratch.counts,
                                scratch.range);
  grid.sync();
  sweep_totals<true>(2 * nb, sh, scratch.counts, scratch.range);

  float lo = 0.0f, hi = 0.0f, w = 0.0f;
  if (threadIdx.x == 0) {
    // select_bracket: widest-first applies, tightest-last overrides.
    lo = fminf(sh.lo_full, 0.0f);
    hi = sh.hi_full;
    const bool have_hint = med_prev > 0.0f;
    for (int i = nb - 1; i >= 0; --i) {
      if (have_hint && sh.counts[2 * i] < k && sh.counts[2 * i + 1] >= k) {
        lo = sh.thresholds[2 * i];
        hi = sh.thresholds[2 * i + 1];
      }
    }
  }
  // Two rounds a sweep (an odd last round alone): round r's thresholds,
  // then for each b in 0..3 the thresholds round r + 1 would take after r
  // moved lo by b w.
  const int blocks = gridDim.x;
  for (int r = 0, sweep = 1; r < rounds; r += 2, ++sweep) {
    const bool two = r + 1 < rounds;
    if (threadIdx.x == 0) {
      w = __fmul_rn(0.25f, __fsub_rn(hi, lo));
      quad_thresholds(lo, w, sh.thresholds);
      if (two) {
        for (int b = 0; b < 4; ++b) {
          const float lo_b = __fadd_rn(lo, __fmul_rn(static_cast<float>(b), w));
          const float hi_b = __fadd_rn(lo_b, w);
          quad_thresholds(lo_b, __fmul_rn(0.25f, __fsub_rn(hi_b, lo_b)),
                          sh.thresholds + 3 + 3 * b);
        }
      }
    }
    __syncthreads();
    int* slot = scratch.counts + sweep * kMaxCounts * blocks;
    if (two)
      sweep_block<15, false>(D, total, 15, sh, slot, nullptr);
    else
      sweep_block<3, false>(D, total, 3, sh, slot, nullptr);
    grid.sync();
    sweep_totals<false>(two ? 15 : 3, sh, slot, nullptr);
    if (threadIdx.x == 0) {
      const float b = below(sh.counts, k);
      lo = __fadd_rn(lo, __fmul_rn(b, w));
      hi = __fadd_rn(lo, w);
      if (two) {
        w = __fmul_rn(0.25f, __fsub_rn(hi, lo));
        const float b2 = below(sh.counts + 3 + 3 * static_cast<int>(b), k);
        lo = __fadd_rn(lo, __fmul_rn(b2, w));
        hi = __fadd_rn(lo, w);
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const float med = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    out[0] = med;
    out[1] = __fdiv_rn(med, log_n);
  }
}

}  // namespace stein
