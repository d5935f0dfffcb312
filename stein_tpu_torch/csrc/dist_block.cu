// Kernel B4, the centred distance block; replaces
// stein_tpu/ops/pallas_median.py:_dist_block_kernel. One 512-thread block
// per 16 x 32 tile of the [m, n] block: gram_tile (gram_tile.cuh)
// computes |r - c|^2 + |t - c|^2 - 2 (r - c).(t - c) by an f32 dot over p
// in chunks on the CUDA cores, and writes it to device memory (the median
// kernel's and the bracket pass's Gram stage, gram_stage.cuh, builds the
// same block on the tensor cores: bitwise the same D where it is exact,
// the f32 class elsewhere); columns past n are
// never written (the TPU kernel padded and trimmed them). Kernel B2 then
// searches the block.
//
// Bound on the H100 at the route's shape (m = 128, n = 3000, p = 303): 2 m
// n p = 0.23 GFLOP of f32 FMAs and a 1.5 MB write, over 752 blocks; the
// shared-memory dot at one result per thread sets the time (a few us).

#include <cuda_runtime.h>

#include "gram_tile.cuh"

namespace stein {
namespace {

__global__ void __launch_bounds__(kGramThreads)
    dist_block_kernel(const float* __restrict__ rows,
                      const float* __restrict__ cols,
                      const float* __restrict__ center, int m, int n, int p,
                      float* __restrict__ D) {
  const int tiles_j = (n + kGramCols - 1) / kGramCols;
  gram_tile(rows, cols, center, m, n, p,
            (blockIdx.x / tiles_j) * kGramRows,
            (blockIdx.x % tiles_j) * kGramCols, D);
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

// B4: D [m, n] from rows [m, p], cols [n, p] and center [p].
int stein_dist_block(const float* rows, const float* cols,
                     const float* center, int m, int n, int p, float* D,
                     void* stream) {
  const int tiles = ((m + kGramRows - 1) / kGramRows) *
                    ((n + kGramCols - 1) / kGramCols);
  dist_block_kernel<<<tiles, kGramThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rows, cols, center, m, n, p, D);
  return cudaGetLastError();
}

}  // extern "C"
