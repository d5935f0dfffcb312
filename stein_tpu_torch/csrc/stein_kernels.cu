// Hand-written Hopper kernels of the SVGD main path, behind a plain C
// interface (loaded with ctypes by stein_tpu_torch/_cuda.py). Four
// __global__ kernels:
//
//   median_kernel       cooperative grid, one block per SM. Optionally
//                       first the centred median block (B1's Gram stage):
//                       the column mean c of theta from per-block partial
//                       sums, then D_sub = r_s + r^T - 2 (T_s-c)(T-c)^T by
//                       an in-kernel f32 dot, tile by tile. Then the warm
//                       median search (warm_search.cuh) on D_sub or on a
//                       given block, writing med and h^2 = med / log n.
//                       Alone it replaces stein_tpu/ops/pallas_median.py:
//                       _warm_kernel (B2).
//   phi_tile_kernel     per 32-row block and share of the 32-column tiles:
//                       the centred D tile from an f32 dot, K = exp2(D *
//                       (-log2e/2 / h^2)), ku += K @ (g - tc/h^2) and the
//                       row sums, written per column share. K never reaches
//                       device memory.
//   phi_reduce_kernel   adds the shares in a fixed order, phi = (ku + ksum
//                       * tc / h^2) / n, one ||phi||^2 partial per block.
//   clip_update_kernel  the global-norm clip from the partials (a
//                       fixed-order sum, no atomics) and the Adam or
//                       Adagrad update.
//
// The four in that order replace stein_tpu/ops/pallas_step.py:_tail_kernel
// (the fused step tail with gram_in_kernel=True, B1). On the TPU that
// kernel held D and K ([n, n] each) in 16 MiB of VMEM; a Hopper block has
// at most 227 KB of shared memory and blocks run in no order, so the tail
// is four launches on one stream joined by device-memory scratch, with
// grid barriers inside the cooperative median kernel.
//
// Bounds on the H100 at the slice's shape (n=1000, p=128, m=256), all f32
// on the CUDA cores (no tensor cores yet):
//   median_kernel  Gram: 33 MFLOP over every SM; search: 5 sweeps of a 1 MB
//                  L2-resident block, each ended by a grid barrier, so the
//                  barriers and the scalar chain between them set the time;
//   phi_tile       256 MFLOP (the [n, n] dot and K @ u). n=1000 gives only
//                  32 row blocks, so the column tiles are split over
//                  blocks as well (4 shares: 128 blocks for 132 SMs). Each
//                  warp register-blocks 4 rows (float4 shared loads, 5
//                  loads per 16 FMAs) and prefetches the next tile into
//                  registers while it computes;
//   phi_reduce,    one pass each over [n, p] state (~2-3 MB), bandwidth-
//   clip_update    and launch-bound.

#include <cuda_runtime.h>

#include "warm_search.cuh"

namespace stein {

constexpr int kMedianThreads = 512;
constexpr int kGramRows = 16;   // = warps of a median block
constexpr int kGramCols = 32;   // = lanes
constexpr int kPhiWarps = 8;
constexpr int kPhiThreads = 32 * kPhiWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kPhiRows = kRowsPerWarp * kPhiWarps;   // rows per block
constexpr int kPhiCols = 32;    // tile width = lanes
constexpr int kKtStride = 4 * kPhiWarps + 4;          // K tile, transposed
constexpr int kUpdateThreads = 256;
// -log2(e) / 2, rounded to f32 as the JAX tail's weakly-typed constant is.
constexpr float kLog2eHalf = -1.4426950408889634f / 2.0f;

enum OptKind { kAdam = 0, kAdagrad = 1 };

// Step-rule constants, each already rounded to f32 on the host:
// Adam: b1, 1-b1, b2, 1-b2, decay. Adagrad: alpha, 1-alpha.
struct OptParams {
  int kind;
  float c[5];
};

struct GramArgs {
  const float* theta;   // [n, p]; nullptr: no Gram stage
  const float* rows;    // [m, p] (theta_sub, or theta when m == n)
  int n, p, m;
  float* center;        // [p] out
  float* part_center;   // [gridDim.x, p] scratch
};

struct MedianArgs {
  const float* D;       // [total] block to search (the Gram's output)
  int total;
  const float* med_prev;
  int k, rounds;
  Brackets br;
  float log_n;
  float* out;           // [2] med, h^2
  SweepScratch scratch;
};

// The centred median block into a.D. Column sums: each block sums a
// strided subset of rows, then every block adds the gridDim.x partials in
// block order, so every block holds bitwise the same centre.
__device__ void gram_stage(const GramArgs& g, float* Dout, float* sm) {
  cg::grid_group grid = cg::this_grid();
  const int p = g.p, ps = p + 1;
  float* c = sm;                           // [p]
  float* tr = c + p;                       // [kGramRows][ps]
  float* tcol = tr + kGramRows * ps;       // [kGramCols][ps]
  float* rsq_r = tcol + kGramCols * ps;    // [kGramRows]
  float* rsq_c = rsq_r + kGramRows;        // [kGramCols]
  for (int k = threadIdx.x; k < p; k += blockDim.x) {
    float s = 0.0f;
    for (int r = blockIdx.x; r < g.n; r += gridDim.x)
      s += __ldg(g.theta + r * p + k);
    g.part_center[blockIdx.x * p + k] = s;
  }
  grid.sync();
  for (int k = threadIdx.x; k < p; k += blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < gridDim.x; ++b) s += __ldcg(g.part_center + b * p + k);
    c[k] = s / static_cast<float>(g.n);
    if (blockIdx.x == 0) g.center[k] = c[k];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles_i = (g.m + kGramRows - 1) / kGramRows;
  const int tiles_j = (g.n + kGramCols - 1) / kGramCols;
  for (int t = blockIdx.x; t < tiles_i * tiles_j; t += gridDim.x) {
    const int r0 = (t / tiles_j) * kGramRows, j0 = (t % tiles_j) * kGramCols;
    {  // row `warp` of the tile, and its squared norm
      const int r = r0 + warp;
      float s = 0.0f;
      for (int k = lane; k < p; k += 32) {
        const float v = r < g.m ? __ldg(g.rows + r * p + k) - c[k] : 0.0f;
        tr[warp * ps + k] = v;
        s += v * v;
      }
      s = warp_sum(s);
      if (lane == 0) rsq_r[warp] = s;
    }
    for (int jr = warp; jr < kGramCols; jr += kGramRows) {
      const int j = j0 + jr;
      float s = 0.0f;
      for (int k = lane; k < p; k += 32) {
        const float v = j < g.n ? __ldg(g.theta + j * p + k) - c[k] : 0.0f;
        tcol[jr * ps + k] = v;
        s += v * v;
      }
      s = warp_sum(s);
      if (lane == 0) rsq_c[jr] = s;
    }
    __syncthreads();
    const int r = r0 + warp, j = j0 + lane;
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
    const float* a = tr + warp * ps;
    const float* b = tcol + lane * ps;
    int k = 0;
    for (; k + 3 < p; k += 4) {
      d0 += a[k] * b[k];
      d1 += a[k + 1] * b[k + 1];
      d2 += a[k + 2] * b[k + 2];
      d3 += a[k + 3] * b[k + 3];
    }
    for (; k < p; ++k) d0 += a[k] * b[k];
    if (r < g.m && j < g.n)
      Dout[r * g.n + j] =
          (rsq_r[warp] + rsq_c[lane]) - 2.0f * ((d0 + d1) + (d2 + d3));
    __syncthreads();
  }
  grid.sync();
}

__global__ void __launch_bounds__(kMedianThreads)
    median_kernel(GramArgs g, MedianArgs a) {
  extern __shared__ float sm[];
  if (g.theta != nullptr) gram_stage(g, const_cast<float*>(a.D), sm);
  grid_warm_search(a.D, a.total, __ldcg(a.med_prev), a.k, a.rounds, a.br,
                   a.log_n, a.scratch, a.out);
}

// Stage 2 of B1. grid = (ceil(n / kPhiRows), splits): block (x, s) owns
// particle rows x * kPhiRows .. +kPhiRows and the s-th contiguous share of
// the 32-column tiles. Warp w owns rows 4w .. 4w+3 of the block; lane l
// owns tile column l in the dot, and columns l + 32q (q < OUT) of K @ u.
// Rows sit in shared memory with stride pp + 4 (pp = p rounded up to 4,
// zero-padded), so the dot reads float4s without bank conflicts.
// Writes the split's partial K @ u and row sums; phi_reduce_kernel adds
// the splits in a fixed order.
template <int OUT>
__global__ void __launch_bounds__(kPhiThreads)
    phi_tile_kernel(const float* __restrict__ theta,
                    const float* __restrict__ grads,
                    const float* __restrict__ center,
                    const float* __restrict__ med_h2, int n, int p,
                    float* __restrict__ part_ku,
                    float* __restrict__ part_ksum) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int pp = (p + 3) & ~3, ps = pp + 4;
  float* ti = sm;                               // [kPhiRows][ps]
  float* tj = ti + kPhiRows * ps;               // [kPhiCols][ps]
  float* uj = tj + kPhiCols * ps;               // [kPhiCols][ps]
  float* kt = uj + kPhiCols * ps;               // [kPhiCols][kKtStride]
  float* c = kt + kPhiCols * kKtStride;         // [pp]
  float* rsq_j = c + pp;                        // [kPhiCols]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float h2 = __ldg(med_h2 + 1);
  const float scale = __fdiv_rn(kLog2eHalf, h2);
  for (int k = threadIdx.x; k < pp; k += blockDim.x)
    c[k] = k < p ? __ldg(center + k) : 0.0f;
  __syncthreads();

  const int row0 = blockIdx.x * kPhiRows + kRowsPerWarp * warp;
  float rsq_i[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r;
    float sq = 0.0f;
    for (int k = lane; k < pp; k += 32) {
      const float v = (i < n && k < p) ? __ldg(theta + i * p + k) - c[k] : 0.0f;
      ti[(kRowsPerWarp * warp + r) * ps + k] = v;
      sq += v * v;
    }
    rsq_i[r] = warp_sum(sq);
  }

  const int tiles = (n + kPhiCols - 1) / kPhiCols;
  const int t_begin = blockIdx.y * tiles / gridDim.y;
  const int t_end = (blockIdx.y + 1) * tiles / gridDim.y;

  // Prefetch registers: tile rows warp + kPhiWarps * a, columns lane + 32q.
  constexpr int kLoadRows = kPhiCols / kPhiWarps;
  float pt[kLoadRows][OUT], pg[kLoadRows][OUT];
  auto load = [&](int j0) {
#pragma unroll
    for (int a = 0; a < kLoadRows; ++a) {
      const int j = j0 + warp + kPhiWarps * a;
#pragma unroll
      for (int q = 0; q < OUT; ++q) {
        const int k = lane + 32 * q;
        const bool in = j < n && k < p;
        pt[a][q] = in ? __ldg(theta + j * p + k) : 0.0f;
        pg[a][q] = in ? __ldg(grads + j * p + k) : 0.0f;
      }
    }
  };

  float acc[kRowsPerWarp][OUT], ksum_lane[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    ksum_lane[r] = 0.0f;
#pragma unroll
    for (int q = 0; q < OUT; ++q) acc[r][q] = 0.0f;
  }

  if (t_begin < t_end) load(t_begin * kPhiCols);
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * kPhiCols;
#pragma unroll
    for (int a = 0; a < kLoadRows; ++a) {
      const int jr = warp + kPhiWarps * a, j = j0 + jr;
      float sq = 0.0f;
#pragma unroll
      for (int q = 0; q < OUT; ++q) {
        const int k = lane + 32 * q;
        if (k < pp) {
          const float tc = (j < n && k < p) ? pt[a][q] - c[k] : 0.0f;
          tj[jr * ps + k] = tc;
          uj[jr * ps + k] = (j < n && k < p) ? pg[a][q] - tc / h2 : 0.0f;
          sq += tc * tc;
        }
      }
      sq = warp_sum(sq);
      if (lane == 0) rsq_j[jr] = sq;
    }
    __syncthreads();
    if (t + 1 < t_end) load(j0 + kPhiCols);  // in flight during compute

    // D for rows row0..row0+3 against tile column `lane`.
    float dot[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) dot[r] = 0.0f;
    const float4* b4 = reinterpret_cast<const float4*>(tj + lane * ps);
    const float4* a4 =
        reinterpret_cast<const float4*>(ti + kRowsPerWarp * warp * ps);
    for (int k4 = 0; k4 < pp / 4; ++k4) {
      const float4 bv = b4[k4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 av = a4[r * (ps / 4) + k4];
        dot[r] += av.x * bv.x + av.y * bv.y + av.z * bv.z + av.w * bv.w;
      }
    }
    float kv[kRowsPerWarp];
    const bool col_in = j0 + lane < n;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float d = (rsq_i[r] + rsq_j[lane]) - 2.0f * dot[r];
      kv[r] = col_in ? exp2f(d * scale) : 0.0f;
      ksum_lane[r] += kv[r];
    }
    reinterpret_cast<float4*>(kt + lane * kKtStride)[warp] =
        make_float4(kv[0], kv[1], kv[2], kv[3]);
    __syncwarp();
    for (int jj = 0; jj < kPhiCols; ++jj) {
      const float4 k4 = reinterpret_cast<const float4*>(kt + jj * kKtStride)[warp];
#pragma unroll
      for (int q = 0; q < OUT; ++q) {
        const int k = lane + 32 * q;
        if (k < pp) {
          const float u = uj[jj * ps + k];
          acc[0][q] += k4.x * u;
          acc[1][q] += k4.y * u;
          acc[2][q] += k4.z * u;
          acc[3][q] += k4.w * u;
        }
      }
    }
    __syncthreads();
  }

  float* ku_out = part_ku + static_cast<size_t>(blockIdx.y) * n * p;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r;
    const float ks = warp_sum(ksum_lane[r]);
    if (i < n) {
#pragma unroll
      for (int q = 0; q < OUT; ++q) {
        const int k = lane + 32 * q;
        if (k < p) ku_out[i * p + k] = acc[r][q];
      }
      if (lane == 0) part_ksum[blockIdx.y * n + i] = ks;
    }
  }
}

// Stage 2b of B1, one thread per (particle, coordinate): adds the splits'
// partial K @ u and row sums in split order, forms
// phi = (ku + ksum * tc / h^2) / n and one ||phi||^2 partial per block.
__global__ void __launch_bounds__(kUpdateThreads)
    phi_reduce_kernel(const float* __restrict__ part_ku,
                      const float* __restrict__ part_ksum, int splits,
                      const float* __restrict__ theta,
                      const float* __restrict__ center,
                      const float* __restrict__ med_h2, int n, int p,
                      float* __restrict__ phi, float* __restrict__ partials) {
  __shared__ float red[kUpdateThreads / 32];
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (e < n * p) {
    const int i = e / p, k = e % p;
    float ku = 0.0f, ks = 0.0f;
    for (int s = 0; s < splits; ++s) {
      ku += part_ku[static_cast<size_t>(s) * n * p + e];
      ks += part_ksum[s * n + i];
    }
    const float h2 = __ldg(med_h2 + 1);
    const float tc = __ldg(theta + e) - __ldg(center + k);
    v = (ku + ks * tc / h2) / static_cast<float>(n);
    phi[e] = v;
  }
  float sq = warp_sum(v * v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kUpdateThreads / 32; ++w) t += red[w];
    partials[blockIdx.x] = t;
  }
}

// Stage 3 of B1. grid.x = ceil(n * p / kUpdateThreads). Every block sums
// the n_partials ||phi||^2 partials in one fixed order (warp 0, then a
// shuffle tree), so every block derives the same norm. Block 0 writes the
// new count / learning rate and the stats to their own buffers, never over
// the inputs that other blocks still read.
__global__ void __launch_bounds__(kUpdateThreads)
    clip_update_kernel(const float* __restrict__ phi,
                       const float* __restrict__ partials, int n_partials,
                       const float* __restrict__ theta, int total,
                       float max_norm, OptParams opt,
                       const float* __restrict__ mom1,
                       const float* __restrict__ mom2,
                       const int* __restrict__ count,
                       const float* __restrict__ lr,
                       const float* __restrict__ med_h2,
                       float* __restrict__ new_theta,
                       float* __restrict__ new_mom1,
                       float* __restrict__ new_mom2,
                       int* __restrict__ new_count,
                       float* __restrict__ new_lr,
                       float* __restrict__ stats) {
  __shared__ float s_scale;
  if (threadIdx.x < 32) {
    float s = 0.0f;
    for (int b = threadIdx.x; b < n_partials; b += 32) s += partials[b];
    s = warp_sum(s);
    if (threadIdx.x == 0) {
      const float norm = sqrtf(s);
      s_scale = max_norm / fmaxf(max_norm, norm);
      if (blockIdx.x == 0) {
        stats[0] = med_h2[0];
        stats[1] = norm;
        stats[2] = med_h2[1];
        *new_count = *count + 1;
        *new_lr = opt.kind == kAdam ? *lr * opt.c[4] : *lr;
      }
    }
  }
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const float g = phi[e] * s_scale;
  const bool first = *count == 0;
  const float rate = *lr;
  float step;
  if (opt.kind == kAdam) {
    const float mu = first ? g : opt.c[0] * mom1[e] + opt.c[1] * g;
    const float nu = first ? g * g : opt.c[2] * mom2[e] + opt.c[3] * (g * g);
    const float t = static_cast<float>(*count + 1);
    const float mup = mu / (1.0f - powf(opt.c[0], t));
    const float nup = nu / (1.0f - powf(opt.c[2], t));
    step = mup / (1e-8f + sqrtf(nup)) * rate;
    new_mom1[e] = mu;
    new_mom2[e] = nu;
  } else {
    const float hist = first ? g * g : opt.c[0] * mom1[e] + opt.c[1] * (g * g);
    step = g / (1e-6f + sqrtf(hist)) * rate;
    new_mom1[e] = hist;
  }
  new_theta[e] = theta[e] + step;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

Brackets make_brackets(const float* lo, const float* hi, int count) {
  Brackets br{};
  br.count = count;
  for (int i = 0; i < count && i < kMaxBrackets; ++i) {
    br.lo[i] = lo[i];
    br.hi[i] = hi[i];
  }
  return br;
}

size_t gram_smem(int p) {
  return sizeof(float) *
         (p + (kGramRows + kGramCols) * (p + 1) + kGramRows + kGramCols);
}

size_t phi_smem(int p) {
  const int pp = (p + 3) & ~3;
  return sizeof(float) * ((kPhiRows + 2 * kPhiCols) * (pp + 4)
                          + kPhiCols * kKtStride + pp + kPhiCols);
}

// Column splits of phi_tile: enough blocks to cover every SM once.
int phi_splits(int n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_blocks = (n + kPhiRows - 1) / kPhiRows;
  const int tiles = (n + kPhiCols - 1) / kPhiCols;
  int s = sms / row_blocks;
  if (s > tiles) s = tiles;
  if (s > 16) s = 16;
  return s < 1 ? 1 : s;
}

// The cooperative grid: one block per SM (the kernel's occupancy is
// checked), so every block is resident for the grid barriers.
cudaError_t median_grid(size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = set_smem(reinterpret_cast<const void*>(median_kernel), smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, median_kernel, kMedianThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms;
  return cudaSuccess;
}

cudaError_t launch_median(const GramArgs& g, const MedianArgs& a, int blocks,
                          size_t smem, cudaStream_t stream) {
  GramArgs gg = g;
  MedianArgs aa = a;
  void* args[] = {&gg, &aa};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(median_kernel),
                                     blocks, kMedianThreads, args, smem,
                                     stream);
}

template <int OUT>
cudaError_t launch_phi(int n, int p, int splits, const float* theta,
                       const float* grads, const float* center,
                       const float* med_h2, float* part_ku, float* part_ksum,
                       cudaStream_t stream) {
  const size_t smem = phi_smem(p);
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(phi_tile_kernel<OUT>), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kPhiRows - 1) / kPhiRows, splits);
  phi_tile_kernel<OUT><<<grid, kPhiThreads, smem, stream>>>(
      theta, grads, center, med_h2, n, p, part_ku, part_ksum);
  return cudaGetLastError();
}

}  // namespace stein

using namespace stein;

extern "C" {

// The widest p the tiled kernels take (phi_tile keeps 16 * 32 columns of
// K @ u per thread at most) and the cooperative grid size (the wrapper
// sizes the per-block scratch from it).
int stein_max_p() { return 32 * 16; }

int stein_median_blocks(int p, int* blocks) {
  return median_grid(p > 0 ? gram_smem(p) : 0, blocks);
}

int stein_phi_splits(int n) { return phi_splits(n); }

int stein_reduce_blocks(int n, int p) {
  return (n * p + kUpdateThreads - 1) / kUpdateThreads;
}

// B2: out[0] = med, out[1] = med / log_n. med_prev is a device scalar;
// part_counts holds (1 + rounds) * blocks * 16 ints, part_range 2 * blocks
// floats.
int stein_warm_median(const float* D, int total, const float* med_prev,
                      int k, int rounds, const float* bracket_lo,
                      const float* bracket_hi, int n_brackets, float log_n,
                      float* out, int* part_counts, float* part_range,
                      void* stream) {
  if (n_brackets > kMaxBrackets) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = median_grid(0, &blocks);
  if (err != cudaSuccess) return err;
  GramArgs g{};
  MedianArgs a{D, total, med_prev, k, rounds,
               make_brackets(bracket_lo, bracket_hi, n_brackets), log_n, out,
               SweepScratch{part_counts, part_range}};
  err = launch_median(g, a, blocks, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// B1: the fused step tail. rows is theta_sub [m, p] or theta (m == n).
// Scratch: dsub [m*n], center [p], part_center [blocks*p], part_counts
// [(1+rounds)*blocks*16] (ints), part_range [2*blocks], part_ku
// [splits*n*p], part_ksum [splits*n], phi [n*p], partials
// [stein_reduce_blocks(n, p)], med_h2 [2]. mom2 / new_mom2 are unused by
// Adagrad.
int stein_fused_step_tail(const float* theta, const float* grads,
                          const float* rows, int n, int p, int m,
                          const float* med_prev, int k, int rounds,
                          const float* bracket_lo, const float* bracket_hi,
                          int n_brackets, float log_n, float max_norm,
                          int opt_kind, const float* opt_consts,
                          const float* mom1, const float* mom2,
                          const int* count, const float* lr,
                          float* new_theta, float* new_mom1, float* new_mom2,
                          int* new_count, float* new_lr, float* stats,
                          float* dsub, float* center, float* part_center,
                          int* part_counts, float* part_range, int splits,
                          float* part_ku, float* part_ksum, float* phi,
                          float* partials, float* med_h2, void* stream_ptr) {
  if (n_brackets > kMaxBrackets || p > stein_max_p() || splits < 1)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = gram_smem(p);
  int blocks = 0;
  cudaError_t err = median_grid(smem, &blocks);
  if (err != cudaSuccess) return err;
  GramArgs g{theta, rows, n, p, m, center, part_center};
  MedianArgs a{dsub, m * n, med_prev, k, rounds,
               make_brackets(bracket_lo, bracket_hi, n_brackets), log_n,
               med_h2, SweepScratch{part_counts, part_range}};
  if ((err = launch_median(g, a, blocks, smem, stream)) != cudaSuccess)
    return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int pp = (p + 3) & ~3;
  if (pp <= 32) err = launch_phi<1>(n, p, splits, theta, grads, center, med_h2, part_ku, part_ksum, stream);
  else if (pp <= 64) err = launch_phi<2>(n, p, splits, theta, grads, center, med_h2, part_ku, part_ksum, stream);
  else if (pp <= 128) err = launch_phi<4>(n, p, splits, theta, grads, center, med_h2, part_ku, part_ksum, stream);
  else if (pp <= 256) err = launch_phi<8>(n, p, splits, theta, grads, center, med_h2, part_ku, part_ksum, stream);
  else err = launch_phi<16>(n, p, splits, theta, grads, center, med_h2, part_ku, part_ksum, stream);
  if (err != cudaSuccess) return err;

  const int total = n * p;
  const int n_reduce = stein_reduce_blocks(n, p);
  phi_reduce_kernel<<<n_reduce, kUpdateThreads, 0, stream>>>(
      part_ku, part_ksum, splits, theta, center, med_h2, n, p, phi, partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  OptParams opt{};
  opt.kind = opt_kind;
  for (int i = 0; i < 5; ++i) opt.c[i] = opt_consts[i];
  clip_update_kernel<<<(total + kUpdateThreads - 1) / kUpdateThreads,
                       kUpdateThreads, 0, stream>>>(
      phi, partials, n_reduce, theta, total, max_norm, opt, mom1, mom2,
      count, lr, med_h2, new_theta, new_mom1, new_mom2, new_count, new_lr,
      stats);
  return cudaGetLastError();
}

}  // extern "C"
