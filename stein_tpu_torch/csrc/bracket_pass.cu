// Kernels B8 and B9, the local half of the sharded warm median's first pass;
// they replace stein_tpu/ops/pallas_median.py:_bracket_gram_kernel (B8,
// fused_bracket_pass) and _bracket_grid_kernel (B9, fused_bracket_grid_pass).
// For a shard's median rows [m, p] against columns [n, p] about a centre c:
//
//   D    = |r - c|^2 + |t - c|^2 - 2 (r - c).(t - c)     [m, n], written out
//   cnts = |{D <= t_i}| for every threshold t_i          [nc] int32
//   mm   = [-min(min D, 0), max D]                       [2] (B8 only)
//
// B8's thresholds are the bracket endpoints lo_b * med_prev, hi_b * med_prev
// (__fmul_rn, as the JAX expression rounds once); B9's are the grid edges
// that ops/fused_median.grid_edges computed on the device, read as given
// (recomputing lo + t * w here would let nvcc contract it into an FMA). The
// collectives that follow (pmax of mm, psum of cnts) and the refinement
// rounds over D stay outside the kernel, as on the TPU.
//
// Two launches on the caller's stream. bracket_tile_kernel: one 512-thread
// block per 16 x 32 tile of D, built by gram_tile (gram_tile.cuh, B4's
// tile too, so both build bitwise the same D for the same rows, columns and
// centre; the median kernel's tensor-core Gram stage, B1's, B5's and B12's,
// agrees with it bitwise where D is exact and to the f32 class elsewhere);
// each thread then holds one entry, and every
// threshold's count is a warp ballot's popcount added into a shared-memory
// counter; min and max are warp then block reductions. The block's counts
// and range go to its slot of device-memory scratch. bracket_reduce_kernel:
// one block adds the slots (one warp per threshold) and reduces the ranges.
// Counts are integers and min/max order-free, so the result does not depend
// on the order in which blocks ran, and two calls agree bitwise.
//
// Bound on the H100 at the mesh path's shape (m=256, n=1000, p=128): 2 m n p
// = 65.5 MFLOP of f32 FMAs over 67 TFLOP/s, ~1 us; ~1.6 MB of inputs and D
// over 3.35 TB/s, ~0.5 us. The tile's shared-memory dot at one entry per
// thread (the same as B4's) sets the time, then the second launch.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"
#include "gram_tile.cuh"

namespace stein {
namespace {

constexpr int kMaxPassCounts = 2048;
constexpr int kMaxPassBrackets = 8;
constexpr int kReduceThreads = 256;

// B8's bracket multiples (warm_search.cuh's Brackets, which this source
// does not include: it holds the cooperative search).
struct PassBrackets {
  int count;
  float lo[kMaxPassBrackets];
  float hi[kMaxPassBrackets];
};

struct PassArgs {
  const float* rows;      // [m, p]
  const float* cols;      // [n, p]
  const float* center;    // [p]
  int m, n, p;
  const float* med_prev;  // B8: the endpoints' hint; nullptr for B9
  PassBrackets br;        // B8: the multiples of med_prev
  const float* edges;     // B9: [nc] thresholds; nullptr for B8
  int nc;
  float* D;               // [m, n] out
  int* part_counts;       // [gridDim.x][nc] scratch
  float* part_range;      // [gridDim.x][2] scratch, nullptr: no range (B9)
};

__global__ void __launch_bounds__(kGramThreads)
    bracket_tile_kernel(PassArgs a) {
  __shared__ float thr[kMaxPassCounts];
  __shared__ int counts[kMaxPassCounts];
  __shared__ float wmin[kGramRows], wmax[kGramRows];
  const int tiles_j = (a.n + kGramCols - 1) / kGramCols;
  const int r0 = (blockIdx.x / tiles_j) * kGramRows;
  const int j0 = (blockIdx.x % tiles_j) * kGramCols;
  for (int i = threadIdx.x; i < a.nc; i += blockDim.x) counts[i] = 0;
  if (a.edges != nullptr) {
    for (int i = threadIdx.x; i < a.nc; i += blockDim.x)
      thr[i] = __ldg(a.edges + i);
  } else if (threadIdx.x < a.br.count) {
    const float med = __ldg(a.med_prev);
    thr[2 * threadIdx.x] = __fmul_rn(a.br.lo[threadIdx.x], med);
    thr[2 * threadIdx.x + 1] = __fmul_rn(a.br.hi[threadIdx.x], med);
  }
  // gram_tile begins with a block barrier: thr and counts are ready after.
  const float d = gram_tile(a.rows, a.cols, a.center, a.m, a.n, a.p, r0, j0,
                            a.D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool valid = r0 + warp < a.m && j0 + lane < a.n;
  for (int i = 0; i < a.nc; ++i) {
    const unsigned bits = __ballot_sync(0xffffffffu, valid && d <= thr[i]);
    if (lane == 0 && bits != 0u) atomicAdd(counts + i, __popc(bits));
  }
  if (a.part_range != nullptr) {
    const float mn = warp_min(valid ? d : CUDART_INF_F);
    const float mx = warp_max(valid ? d : -CUDART_INF_F);
    if (lane == 0) {
      wmin[warp] = mn;
      wmax[warp] = mx;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.nc; i += blockDim.x)
    a.part_counts[static_cast<size_t>(blockIdx.x) * a.nc + i] = counts[i];
  if (a.part_range != nullptr && threadIdx.x == 0) {
    float mn = wmin[0], mx = wmax[0];
    for (int w = 1; w < kGramRows; ++w) {
      mn = fminf(mn, wmin[w]);
      mx = fmaxf(mx, wmax[w]);
    }
    a.part_range[2 * blockIdx.x] = mn;
    a.part_range[2 * blockIdx.x + 1] = mx;
  }
}

// cnts[i] = the sum of every block's count i (one warp per threshold);
// mm = [-min(min, 0), max] of the blocks' ranges.
__global__ void __launch_bounds__(kReduceThreads)
    bracket_reduce_kernel(const int* part_counts, const float* part_range,
                          int blocks, int nc, int* cnts, float* mm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int i = warp; i < nc; i += warps) {
    int s = 0;
    for (int b = lane; b < blocks; b += 32)
      s += part_counts[static_cast<size_t>(b) * nc + i];
    s = warp_sum_int(s);
    if (lane == 0) cnts[i] = s;
  }
  if (part_range != nullptr && warp == 0) {
    float mn = CUDART_INF_F, mx = -CUDART_INF_F;
    for (int b = lane; b < blocks; b += 32) {
      mn = fminf(mn, part_range[2 * b]);
      mx = fmaxf(mx, part_range[2 * b + 1]);
    }
    mn = warp_min(mn);
    mx = warp_max(mx);
    if (lane == 0) {
      mm[0] = -fminf(mn, 0.0f);
      mm[1] = mx;
    }
  }
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

// Blocks of bracket_tile_kernel for an [m, n] block (the scratch's slots).
int stein_bracket_blocks(int m, int n) {
  return ((m + kGramRows - 1) / kGramRows) *
         ((n + kGramCols - 1) / kGramCols);
}

// B8 (edges == nullptr: the 2 * nb endpoints of br_lo/br_hi times
// *med_prev, and mm) or B9 (edges: nc given thresholds, mm == nullptr).
// D [m, n], cnts [nc]; part_counts [blocks * nc], part_range [2 * blocks].
int stein_bracket_pass(const float* rows, const float* cols,
                       const float* center, int m, int n, int p,
                       const float* med_prev, const float* br_lo,
                       const float* br_hi, int nb, const float* edges, int nc,
                       float* D, int* cnts, float* mm, int* part_counts,
                       float* part_range, void* stream) {
  if (nc < 1 || nc > kMaxPassCounts || nb > kMaxPassBrackets ||
      (edges == nullptr && nc != 2 * nb))
    return cudaErrorInvalidValue;
  PassArgs a{rows,   cols,  center,      m,
             n,      p,     med_prev,    PassBrackets{},
             edges,  nc,    D,           part_counts,
             mm == nullptr ? nullptr : part_range};
  a.br.count = edges == nullptr ? nb : 0;
  for (int i = 0; i < a.br.count; ++i) {
    a.br.lo[i] = br_lo[i];
    a.br.hi[i] = br_hi[i];
  }
  const int blocks = stein_bracket_blocks(m, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bracket_tile_kernel<<<blocks, kGramThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bracket_reduce_kernel<<<1, kReduceThreads, 0, s>>>(
      part_counts, a.part_range, blocks, nc, cnts, mm);
  return cudaGetLastError();
}

}  // extern "C"
