// B3's wide route (ops/svgd_tile.py:tile_route, WIDE): the same ku, ksum
// or phi as the streaming tile (svgd_tile.cu), for [m, p] rows against [n,
// p] columns about a centre c, with D formed once. The mma.sync tile holds
// at most 160 output columns a block and repeats the whole centred dot for
// each chunk of them: at p = 9203 (the SVGD paper's Year network) that is
// 58 chunks, so the tile does the Gram's 2 m n p work 58 times. Here:
//
//   phi_gram_kernel   the centred D [m, n] = |r - c|^2 + |t - c|^2 - 2 (r -
//                     c).(t - c), one cooperative launch of the Gram stage
//                     (gram_stage.cuh: each row centred once with its f32
//                     norm, then mma.sync 3xTF32 with each run of at most
//                     32 contraction indices summed in fresh registers, as
//                     the tile's dot is), into device memory;
//   on_d_prep_kernel, svgd_on_d_kernel   B10's tile (svgd_on_d.cu) about
//                     the centre: u = g - (t - c) / h^2 formed once, K =
//                     exp2 of (D / h^2) (-log2e/2) in registers (B3's
//                     order; B1's D (-log2e/2 / h^2) for div_h2 = 0), and
//                     K @ u by mma.sync 3xTF32 in 64-column output chunks;
//   tile_reduce_kernel  the shares added in share order, then ku and ksum,
//                     or phi (svgd_tile.cu).
//
// Every stage runs in a fixed order, so two calls give bitwise-equal
// output. The Gram stage's kernel has a name of its own (not B4's
// dist_block_kernel, which the median's trace layer claims), so that all
// of phi's time lands in its own layer.
//
// Bounds on the H100 at m = n = 2048, p = 9203: each product is 2 m n p =
// 7.7e10 FLOP, three TF32 products each, 0.47 ms a product at 495 TFLOP/s
// (the 3xTF32 ceiling is a third of the TF32 rate); D is 16 MB, theta, the
// gradients and phi 75 MB each. A chunk of the contraction costs only
// exp2 and an L2 read of D's rows, not a 9,216-wide dot.

#include <cuda_runtime.h>

#include "common.cuh"
#include "gram_stage.cuh"
#include "svgd_tile.cuh"

namespace stein {
namespace {

// The stage's dynamic shared memory: the median kernel's budget, as B4's.
constexpr int kWideSmem = 232448 - 4096;

__global__ void __launch_bounds__(kStageThreads, 1)
    phi_gram_kernel(GramArgs g, float* D) {
  extern __shared__ float4 sm4[];
  NoEpilogue none;
  gram_stage<false>(g, D, reinterpret_cast<float*>(sm4), none);
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

// The wide route's first stage: D [m, n] from rows [m, p], cols [n, p]
// and center [p] (the rows are the columns when they are one pointer and m
// == n); prep: stein_gram_prep_floats(n, m, p) floats of scratch (m = 0
// where the rows are the columns).
int stein_phi_gram(const float* rows, const float* cols, const float* center,
                   int m, int n, int p, float* D, float* prep, void* stream) {
  const size_t smem = gram_smem(p, kWideSmem);
  int blocks = 0;
  cudaError_t err = stage_grid(phi_gram_kernel, smem, &blocks);
  if (err != cudaSuccess) return err;
  GramArgs g{cols, rows, n, p, m, nullptr, nullptr, center, prep};
  if ((err = gram_shape(g, blocks, kWideSmem)) != cudaSuccess) return err;
  void* args[] = {&g, &D};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(phi_gram_kernel),
                                    blocks, kStageThreads, args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The wide route's second stage on the first's D [m, n]: u = grads - (cols
// - center) / h2 into u_buf [n, p], B10's tile in B3's exponent order
// (div_h2 = 1) or B1's (0), then the reduce. Scratch part_ku [splits * m *
// p], part_ksum [splits * m] (splits: stein_on_d_splits(m, n, p)). Writes
// ku [m, p] and ksum [m] when phi is null, else phi [m, p] = (ku + ksum
// (rows - center) / h2) / n_total.
int stein_svgd_wide_contract(const float* D, const float* rows,
                             const float* cols, const float* grads,
                             const float* center, const float* h2, int m,
                             int n, int p, int splits, float* part_ku,
                             float* part_ksum, float* u_buf, float* ku,
                             float* ksum, float* phi, float n_total,
                             int div_h2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  OnDArgs on_d{D, nullptr, grads, cols, center, h2, m, n, p,
               div_h2 == 0, splits, part_ku, part_ksum, u_buf};
  on_d.div_h2 = div_h2 != 0;
  cudaError_t err = launch_on_d(on_d, s);
  if (err != cudaSuccess) return err;
  TileArgs red{};
  red.rows = rows;
  red.center = center;
  red.h2 = h2;
  red.m = m;
  red.n = n;
  red.p = p;
  red.splits = splits;
  red.part_ku = part_ku;
  red.part_ksum = part_ksum;
  red.n_total = n_total;
  red.ku = ku;
  red.ksum = ksum;
  red.phi = phi;
  return launch_tile_reduce(red, s);
}

}  // extern "C"
