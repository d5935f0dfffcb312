// Kernel B4, the centred distance block; replaces
// stein_tpu/ops/pallas_median.py:_dist_block_kernel:
//
//   D[r, j] = |rows_r - c|^2 + |cols_j - c|^2 - 2 (rows_r - c).(cols_j - c)
//
// for the given centre c, written out as [m, n] (the TPU kernel padded the
// columns and trimmed them; here columns past n are never written). Kernel
// B2 then searches the block.
//
// One cooperative launch, one 512-thread block per SM, of the Gram stage
// that the median kernel (B1's, B5's and B12's median) and the bracket pass
// (B8, B9) run (gram_stage.cuh): each row and column is centred once, with
// its f32 norm, into 16-byte-aligned scratch; a grid barrier; then each
// block streams its tiles through a cp.async ring and runs mma.sync 3xTF32
// (each run of at most 32 contraction indices summed in fresh registers),
// so D keeps the f32 class and is exact where the particles are lattice
// points. The stage's dynamic shared memory has the median kernel's
// budget, so B4 takes the widths B5 takes (p = 46000 runs; past the room
// for one k-step beside the centre, ~47000, the launch is refused).
//
// Bound on the H100 at the route's shape (m = 128, n = 3000, p = 303): the
// rows, columns and D are 5.33 MB, 1.59 us at 3.35 TB/s; 2 m n p = 0.23
// GFLOP as three TF32 products each at 495 TFLOP/s is 1.41 us: bound by
// bytes. What it costs beyond that is latency: the launch, the centring
// pass and its grid barrier, and each block's three rounds of 32 x 32 tiles
// through the ring.

#include <cuda_runtime.h>

#include "common.cuh"
#include "gram_stage.cuh"

namespace stein {
namespace {

// The stage's dynamic shared memory: the median kernel's budget.
constexpr int kDistSmem = 232448 - 4096;

__global__ void __launch_bounds__(kStageThreads, 1)
    dist_block_kernel(GramArgs g, float* D) {
  extern __shared__ float4 sm4[];
  NoEpilogue none;
  gram_stage<false>(g, D, reinterpret_cast<float*>(sm4), none);
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

// B4: D [m, n] from rows [m, p], cols [n, p] and center [p]; prep:
// stein_gram_prep_floats(n, m, p) floats of scratch.
int stein_dist_block(const float* rows, const float* cols,
                     const float* center, int m, int n, int p, float* D,
                     float* prep, void* stream) {
  const size_t smem = gram_smem(p, kDistSmem);
  int blocks = 0;
  cudaError_t err = stage_grid(dist_block_kernel, smem, &blocks);
  if (err != cudaSuccess) return err;
  GramArgs g{cols, rows, n, p, m, nullptr, nullptr, center, prep};
  if ((err = gram_shape(g, blocks, kDistSmem)) != cudaSuccess) return err;
  void* args[] = {&g, &D};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(dist_block_kernel),
                                    blocks, kStageThreads, args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
