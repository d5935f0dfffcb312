// One tile of the centred squared-distance block
//   D[r, j] = |rows_r - c|^2 + |cols_j - c|^2 - 2 (rows_r - c).(cols_j - c)
// by an f32 dot on the CUDA cores, for a 16 x 32 tile (16 warps: warp =
// row, lane = column), one entry a thread. Its only user is
// dist_block_kernel (B4). The median kernel (B1's, B5's, B12's median) and
// the bracket pass (B8, B9) build the block on the tensor cores instead
// (gram_stage.cuh): the same D where it is exact (lattice particles), the
// f32 class elsewhere. Each tile re-centres its own 16 rows and 32 columns
// and feeds every FMA from two shared-memory loads, so at B4's shape
// (m = 128, n = 3000, p = 303) it runs far above its 3.5 us bound; moving
// B4 onto gram_stage.cuh is queued. p is walked in chunks of kGramChunk
// columns through shared memory, so any p fits; the chunk is a multiple of
// 32 and of 4, which keeps every sum in the order of one pass over p (each
// lane's squared norms over k = lane, lane + 32, ...; the dot in groups of
// four with the tail into the first accumulator).
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace stein {

constexpr int kGramRows = 16;   // = warps of the block
constexpr int kGramCols = 32;   // = lanes
constexpr int kGramThreads = 32 * kGramRows;
constexpr int kGramChunk = 128;
constexpr int kGramStride = kGramChunk + 1;

// rows [m, p], cols [n, p], c [p] (any memory space); writes the tile at
// rows r0.., columns j0.. of D (row stride n) and returns this thread's
// entry (row r0 + warp, column j0 + lane; 0 outside the block). Every
// thread of the 512-thread block calls it; it begins and ends with a block
// barrier.
__device__ __forceinline__ float gram_tile(const float* rows,
                                          const float* cols, const float* c,
                                          int m, int n, int p, int r0,
                                          int j0, float* D) {
  __shared__ float tr[kGramRows * kGramStride];
  __shared__ float tcol[kGramCols * kGramStride];
  __shared__ float rsq_r[kGramRows];
  __shared__ float rsq_c[kGramCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = r0 + warp, j = j0 + lane;
  float sr = 0.0f, sc[kGramCols / kGramRows] = {0.0f, 0.0f};
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
  __syncthreads();
  for (int k0 = 0; k0 < p; k0 += kGramChunk) {
    const int len = min(kGramChunk, p - k0);
    for (int kk = lane; kk < len; kk += 32) {
      const int k = k0 + kk;
      const float v = r < m ? rows[static_cast<size_t>(r) * p + k] - c[k]
                            : 0.0f;
      tr[warp * kGramStride + kk] = v;
      sr += v * v;
    }
#pragma unroll
    for (int a = 0; a < kGramCols / kGramRows; ++a) {
      const int jr = warp + kGramRows * a, jj = j0 + jr;
      for (int kk = lane; kk < len; kk += 32) {
        const int k = k0 + kk;
        const float v = jj < n ? cols[static_cast<size_t>(jj) * p + k] - c[k]
                               : 0.0f;
        tcol[jr * kGramStride + kk] = v;
        sc[a] += v * v;
      }
    }
    __syncthreads();
    const float* x = tr + warp * kGramStride;
    const float* y = tcol + lane * kGramStride;
    int kk = 0;
    for (; kk + 3 < len; kk += 4) {
      d0 += x[kk] * y[kk];
      d1 += x[kk + 1] * y[kk + 1];
      d2 += x[kk + 2] * y[kk + 2];
      d3 += x[kk + 3] * y[kk + 3];
    }
    for (; kk < len; ++kk) d0 += x[kk] * y[kk];
    __syncthreads();
  }
  sr = warp_sum(sr);
  if (lane == 0) rsq_r[warp] = sr;
#pragma unroll
  for (int a = 0; a < kGramCols / kGramRows; ++a) {
    const float s = warp_sum(sc[a]);
    if (lane == 0) rsq_c[warp + kGramRows * a] = s;
  }
  __syncthreads();
  float d = 0.0f;
  if (r < m && j < n) {
    d = (rsq_r[warp] + rsq_c[lane]) - 2.0f * ((d0 + d1) + (d2 + d3));
    D[static_cast<size_t>(r) * n + j] = d;
  }
  __syncthreads();
  return d;
}

}  // namespace stein
