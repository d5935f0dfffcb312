// The streaming SVGD tile (svgd_tile.cu): its prep, the tensor-core tile
// kernel and the fixed-order reduce, launched by B1's step tail
// (stein_kernels.cu) and by B3 (ops/svgd_tile.py).
#pragma once

#include <cuda_runtime.h>

namespace stein {

struct TileArgs {
  const float* rows;    // [m, p]
  const float* cols;    // [n, p]
  const float* grads;   // [n, p]
  const float* center;  // [p], or null: no centre
  const float* h2;      // device scalar
  int m, n, p;
  // K's exponent as (D / h2) * (-log2e/2), the JAX tile's order (B3), or
  // as D * (-log2e/2 / h2), the JAX step tail's (B1).
  bool div_h2;
  int splits;           // column shares, tile_splits(m, n, p)
  float* part_ku;       // [splits, m, p] scratch
  float* part_ksum;     // [splits, m] scratch
  float n_total;
  float* ku;            // [m, p] raw sums, with ksum [m], when phi is null;
  float* ksum;
  float* phi;           // else phi [m, p] = (ku + ksum (r - c) / h2) / n_total
  float* partials;      // and, if not null, ||phi||^2 per reduce block
  float* prep;          // [tile_prep_floats(m, n, p)] scratch (launch_tile)
  bool bf16;            // bf16 dot operands (pallas_precision='bf16')
};

int tile_splits(int m, int n, int p);
long long tile_prep_floats(int m, int n, int p);
int tile_reduce_blocks(int m, int p);
// The prep, the tile and the reduce on `stream`; returns the first CUDA
// error.
cudaError_t launch_tile(const TileArgs& a, cudaStream_t stream);
// The reduce alone, over the shares of a.part_ku / a.part_ksum. With a
// null centre the combine's tc is the rows themselves.
cudaError_t launch_tile_reduce(const TileArgs& a, cudaStream_t stream);

// B10's tile on a given D (svgd_on_d.cu): the same [splits, m, p] and
// [splits, m] share layout, for launch_tile_reduce.
struct OnDArgs {
  const float* D;       // [m, n] rows of squared distances
  const float* u;       // [n, p], or null: u formed from grads and cols
  const float* grads;   // [n, p] (u null)
  const float* cols;    // [n, p] (u null)
  const float* center;  // [p] (u null): u = grads - (cols - center) / h2,
                        // or null: cols uncentred
  const float* h2;      // device scalar
  int m, n, p;
  // K's exponent as D * (-log2e/2 / h2), the JAX step tail's order (B1),
  // or as (D * (-log2e/2)) / h2, the JAX on-D tile's (B10).
  bool scale_first;
  int splits;           // on_d_splits(m, n, p)
  float* part_ku;       // [splits, m, p] scratch
  float* part_ksum;     // [splits, m] scratch
  float* u_buf;         // [n, p] scratch where u is formed (u null)
};

int on_d_splits(int m, int n, int p);
cudaError_t launch_on_d(const OnDArgs& a, cudaStream_t stream);

}  // namespace stein
