// Hand-written Hopper kernels of the SVGD main path, behind a plain C
// interface (loaded with ctypes by stein_tpu_torch/_cuda.py). Two
// __global__ kernels here, plus the streaming tile of svgd_tile.cu:
//
//   median_kernel       cooperative grid, one block per SM. Optionally
//                       first the centred median block (the Gram stage):
//                       the column mean c of theta from per-block partial
//                       sums, or a given centre, then D_sub = r_s + r^T -
//                       2 (T_s-c)(T-c)^T on the tensor cores (mma.sync
//                       3xTF32), tile by tile, from centred copies. Then the warm median search
//                       (warm_search.cuh) on D_sub or on a given block,
//                       writing med and h^2 = med / log n. Alone it
//                       replaces stein_tpu/ops/pallas_median.py:
//                       _warm_kernel (B2); with a given centre, Gram and
//                       search together, _warm_from_theta_kernel (B5).
//   svgd_tile_kernel,   (svgd_tile.cu) K = exp2(D * (-log2e/2 / h^2)),
//   tile_reduce_kernel  ku += K @ (g - tc/h^2) and the row sums per column
//                       share, K never in device memory; then the shares in
//                       a fixed order, phi = (ku + ksum * tc / h^2) / n and
//                       one ||phi||^2 partial per block.
//   clip_update_kernel  the global-norm clip from the partials (a
//                       fixed-order sum, no atomics) and the Adam or
//                       Adagrad update (opt_step, a device function).
//   epilogue_kernel     B6 (replacing pallas_step.py:_epilogue_kernel): the
//                       large-n path's phi combine from the tile's (ku,
//                       ksum), the clip by a given norm, and opt_step.
//
// The four in that order replace stein_tpu/ops/pallas_step.py:_tail_kernel
// (the fused step tail, B1). On the TPU that kernel held D and K ([n, n]
// each) in 16 MiB of VMEM; a Hopper block has at most 227 KB of shared
// memory and blocks run in no order, so the tail is four launches on one
// stream joined by device-memory scratch, with grid barriers inside the
// cooperative median kernel. With a given D (step_impl='fused') the median
// kernel searches D's row block without its Gram stage and the tile is
// B10's on D (svgd_on_d.cu); with an in-kernel model the model stage
// (model_grad.cu) runs first and clip_update averages its log_p.
//
// B12 (replacing pallas_step.py:_pblock_kernel, the p-blocked whole-step
// tail) is the same four launches with D computed once: the median
// kernel's Gram stage writes the whole centred [n, n] D (every row kept;
// 4 MB at n = 1000, resident in the 50 MB L2) and searches all n^2
// entries, then B10's tile reads that D (u = g - (theta - c) / h^2 formed
// in-kernel about the Gram stage's centre), the reduce and clip_update.
// B1's Gram-mode chain computes the Gram twice (the median block and the
// streaming tile's D); B12's chain runs 2 n^2 p + 2 n^2 p products, the
// bound at n = 1000, p = 303 being 1.2 GFLOP (18 us at 67 TFLOP/s).
//
// Bounds on the H100 at the slice's shape (n=1000, p=128, m=256):
//   median_kernel  Gram: 2 m n p = 66 MFLOP, three TF32 products each on
//                  the tensor cores (0.4 us at 495 TFLOP/s; B12's n^2 at
//                  p = 303, 1.8 GFLOP: 3.7 us); search: 3 sweeps of a 1 MB
//                  L2-resident block, each ended by a grid barrier. Both
//                  stages are latency-bound: the Gram stage by the loads
//                  that feed its few tiles and the short mma.sync chains,
//                  the search by its barriers. So the Gram stage centres
//                  each row once (with its norm, f32) into 16-byte-aligned
//                  scratch, so that every tile streams through a two-slot
//                  cp.async ring in 16-byte copies even at p = 303; its
//                  block tile (16 x 32 warp tiles: 4 x 2, 2 x 1 or 1 x 1)
//                  is the largest that still gives every block of the grid
//                  a tile, a block's two small tiles share one stage, and all
//                  16 warps split the contraction; the search counts two
//                  quad-ary rounds a sweep (warm_search.cuh). The Gram
//                  stage lives in gram_stage.cuh, which the bracket pass
//                  (B8, B9) and the distance block (B4) share;
//   the tile       256 MFLOP (the [n, n] dot and K @ u); see svgd_tile.cu;
//   the reduce,    one pass each over [n, p] state (~2-3 MB), bandwidth-
//   clip_update    and launch-bound.

#include <cuda_runtime.h>

#include "gram_stage.cuh"
#include "svgd_tile.cuh"
#include "tf32_mma.cuh"
#include "warm_search.cuh"

namespace stein {

// What the cooperative kernel's dynamic shared memory may take beside its
// static SweepShared.
constexpr int kMedianSmem = 232448 - 4096;
constexpr int kUpdateThreads = 256;

enum OptKind { kAdam = 0, kAdagrad = 1 };

// Step-rule constants, each already rounded to f32 on the host:
// Adam: b1, 1-b1, b2, 1-b2, decay. Adagrad: alpha, 1-alpha.
struct OptParams {
  int kind;
  float c[5];
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


__global__ void __launch_bounds__(kStageThreads, 1)
    median_kernel(GramArgs g, MedianArgs a) {
  extern __shared__ float4 sm4[];
  if (g.theta != nullptr)
    {
    NoEpilogue none;
    gram_stage<true>(g, const_cast<float*>(a.D),
                     reinterpret_cast<float*>(sm4), none);
  }
  grid_warm_search(a.D, a.total, __ldcg(a.med_prev), a.k, a.rounds, a.br,
                   a.log_n, a.scratch, a.out);
}

// The optimizer state of one update: moments in and out (Adagrad's second
// pointers are unused), the count and learning rate in and out.
struct OptState {
  const float* mom1;
  const float* mom2;
  const int* count;
  const float* lr;
  float* new_mom1;
  float* new_mom2;
  int* new_count;
  float* new_lr;
};

// The step rule on coordinate e for the clipped phi value g: writes the new
// moments and returns the step (ops/optimizers.py, the Adam.update form).
__device__ __forceinline__ float opt_step(const OptParams& opt,
                                          const OptState& s, int e, float g) {
  const bool first = *s.count == 0;
  const float rate = *s.lr;
  if (opt.kind == kAdam) {
    const float mu = first ? g : opt.c[0] * s.mom1[e] + opt.c[1] * g;
    const float nu =
        first ? g * g : opt.c[2] * s.mom2[e] + opt.c[3] * (g * g);
    const float t = static_cast<float>(*s.count + 1);
    const float mup = mu / (1.0f - powf(opt.c[0], t));
    const float nup = nu / (1.0f - powf(opt.c[2], t));
    s.new_mom1[e] = mu;
    s.new_mom2[e] = nu;
    return mup / (1e-8f + sqrtf(nup)) * rate;
  }
  const float hist =
      first ? g * g : opt.c[0] * s.mom1[e] + opt.c[1] * (g * g);
  s.new_mom1[e] = hist;
  return g / (1e-6f + sqrtf(hist)) * rate;
}

// The new count and learning rate, written once (by block 0, thread 0) to
// their own buffers, never over the inputs that other blocks still read.
__device__ __forceinline__ void opt_scalars(const OptParams& opt,
                                            const OptState& s) {
  *s.new_count = *s.count + 1;
  *s.new_lr = opt.kind == kAdam ? *s.lr * opt.c[4] : *s.lr;
}

// Stage 3 of B1. grid.x = ceil(n * p / kUpdateThreads). Every block sums
// the n_partials ||phi||^2 partials in one fixed order (warp 0, then a
// shuffle tree), so every block derives the same norm. Block 0 writes the
// new count / learning rate and the stats; with a model stage, stats[3]
// is the mean of its n per-row log_p, summed in one fixed order.
__global__ void __launch_bounds__(kUpdateThreads)
    clip_update_kernel(const float* __restrict__ phi,
                       const float* __restrict__ partials, int n_partials,
                       const float* __restrict__ theta, int total,
                       float max_norm, OptParams opt, OptState st,
                       const float* __restrict__ med_h2,
                       const float* __restrict__ logp, int n,
                       float* __restrict__ new_theta,
                       float* __restrict__ stats) {
  __shared__ float s_scale;
  if (threadIdx.x < 32) {
    float s = 0.0f;
    for (int b = threadIdx.x; b < n_partials; b += 32) s += partials[b];
    s = warp_sum(s);
    float lp = 0.0f;
    if (blockIdx.x == 0 && logp != nullptr) {
      for (int i = threadIdx.x; i < n; i += 32) lp += logp[i];
      lp = warp_sum(lp);
    }
    if (threadIdx.x == 0) {
      const float norm = sqrtf(s);
      s_scale = max_norm / fmaxf(max_norm, norm);
      if (blockIdx.x == 0) {
        stats[0] = med_h2[0];
        stats[1] = norm;
        stats[2] = med_h2[1];
        if (logp != nullptr) stats[3] = lp / static_cast<float>(n);
        opt_scalars(opt, st);
      }
    }
  }
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  new_theta[e] = theta[e] + opt_step(opt, st, e, phi[e] * s_scale);
}

// B6, one thread per coordinate: phi = (ku + ksum (theta - c) / h2) /
// n_total in the JAX kernel's operation order, the clip by the given
// pre-clip norm, the update. Bound by its 7 [n, p] passes over device
// memory (ku, theta, two moments in; theta, two moments out).
__global__ void __launch_bounds__(kUpdateThreads)
    epilogue_kernel(const float* __restrict__ ku,
                    const float* __restrict__ ksum,
                    const float* __restrict__ theta,
                    const float* __restrict__ center,
                    const float* __restrict__ h2p,
                    const float* __restrict__ normp, int n, int p,
                    float n_total, float max_norm, OptParams opt,
                    OptState st, float* __restrict__ new_theta) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) opt_scalars(opt, st);
  if (e >= n * p) return;
  const int i = e / p, k = e % p;
  const float tc = theta[e] - center[k];
  const float phi = (ku[e] + ksum[i] * tc / *h2p) / n_total;
  const float g = phi * (max_norm / fmaxf(max_norm, *normp));
  new_theta[e] = theta[e] + opt_step(opt, st, e, g);
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

cudaError_t launch_median(const GramArgs& g, const MedianArgs& a, int blocks,
                          size_t smem, cudaStream_t stream) {
  GramArgs gg = g;
  MedianArgs aa = a;
  void* args[] = {&gg, &aa};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(median_kernel),
                                     blocks, kStageThreads, args, smem,
                                     stream);
}

}  // namespace stein

using namespace stein;

extern "C" {

// The cooperative grid size (the wrapper sizes the per-block scratch from
// it) and the tile's column shares and reduce blocks.
int stein_median_blocks(int p, int* blocks) {
  return stage_grid(median_kernel, p > 0 ? gram_smem(p, kMedianSmem) : 0,
                    blocks);
}

int stein_reduce_blocks(int n, int p) { return tile_reduce_blocks(n, p); }

int stein_gram_prep_floats(int n, int m, int p) {
  return static_cast<int>(gram_prep_floats(n, m, p));
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
  cudaError_t err = stage_grid(median_kernel, 0, &blocks);
  if (err != cudaSuccess) return err;
  GramArgs g{};
  MedianArgs a{D, total, med_prev, k, rounds,
               make_brackets(bracket_lo, bracket_hi, n_brackets), log_n, out,
               SweepScratch{part_counts, part_range}};
  err = launch_median(g, a, blocks, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// B1: the fused step tail. Gram mode (D null): block is theta_sub [m, p]
// or theta (m == n), and the median kernel's Gram stage writes the centred
// block into dsub [m*n]; with d_once (B12, m == n) the tile is B10's on
// dsub. D mode: D is the given [n, n] squared distances, block its [m, n]
// row block, searched in place; the tile is B10's on D and tc = theta (no
// centre). Scratch: center [p], part_center [blocks*p], part_counts
// [(1+rounds)*blocks*16] (ints), part_range [2*blocks], part_ku
// [splits*n*p], part_ksum [splits*n], phi [n*p], partials
// [stein_reduce_blocks(n, p)], med_h2 [2], tile_prep
// (the median kernel's Gram prep, stein_gram_prep_floats(n, m, p), in Gram
// mode; then the tile's, stein_tile_prep_floats(n, n, p, route), without
// d_once, else [n * p], where B10's tile forms u: the largest of those);
// splits is stein_tile_splits(n, n, p, route), or stein_on_d_splits in D
// mode and with d_once; route is the streaming tile's (TileArgs.route, Gram
// mode without d_once). mom2 / new_mom2
// are unused by Adagrad. logp [n] (a model stage's per-row log_p) or null;
// stats holds 3 floats, 4 with logp.
int stein_fused_step_tail(const float* theta, const float* grads,
                          const float* block, int n, int p, int m,
                          const float* D, int d_once, const float* med_prev,
                          int k,
                          int rounds, const float* bracket_lo,
                          const float* bracket_hi, int n_brackets,
                          float log_n, float max_norm, int opt_kind,
                          const float* opt_consts, const float* mom1,
                          const float* mom2, const int* count,
                          const float* lr, const float* logp,
                          float* new_theta, float* new_mom1, float* new_mom2,
                          int* new_count, float* new_lr, float* stats,
                          float* dsub, float* center, float* part_center,
                          int* part_counts, float* part_range, int splits,
                          float* part_ku, float* part_ksum, float* phi,
                          float* partials, float* med_h2, float* tile_prep,
                          int route, void* stream_ptr) {
  if (n_brackets > kMaxBrackets) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool gram = D == nullptr;
  if (d_once && (!gram || m != n)) return cudaErrorInvalidValue;
  const size_t smem = gram ? gram_smem(p, kMedianSmem) : 0;
  int blocks = 0;
  cudaError_t err = stage_grid(median_kernel, smem, &blocks);
  if (err != cudaSuccess) return err;
  GramArgs g{};
  if (gram) {
    g = GramArgs{theta, block, n, p, m, center, part_center, nullptr,
                 tile_prep};
    if ((err = gram_shape(g, blocks, kMedianSmem)) != cudaSuccess) return err;
  }
  MedianArgs a{gram ? dsub : block, m * n, med_prev, k, rounds,
               make_brackets(bracket_lo, bracket_hi, n_brackets), log_n,
               med_h2, SweepScratch{part_counts, part_range}};
  if ((err = launch_median(g, a, blocks, smem, stream)) != cudaSuccess)
    return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const TileArgs tile{theta, theta, grads, gram ? center : nullptr,
                      med_h2 + 1, n, n, p, false, splits, part_ku, part_ksum,
                      static_cast<float>(n), nullptr, nullptr, phi, partials,
                      tile_prep, false, route};
  if (gram && !d_once) {
    err = launch_tile(tile, stream);
  } else {
    // B10's tile on the given D, or (d_once) on the Gram stage's own D
    // about its centre; u is formed into tile_prep.
    const OnDArgs on_d{gram ? dsub : D, nullptr, grads, theta,
                       gram ? center : nullptr, med_h2 + 1, n, n, p, true,
                       splits, part_ku, part_ksum, tile_prep};
    if ((err = launch_on_d(on_d, stream)) == cudaSuccess)
      err = launch_tile_reduce(tile, stream);
  }
  if (err != cudaSuccess) return err;

  const int total = n * p;
  OptParams opt{};
  opt.kind = opt_kind;
  for (int i = 0; i < 5; ++i) opt.c[i] = opt_consts[i];
  const OptState st{mom1, mom2, count, lr, new_mom1, new_mom2, new_count,
                    new_lr};
  clip_update_kernel<<<(total + kUpdateThreads - 1) / kUpdateThreads,
                       kUpdateThreads, 0, stream>>>(
      phi, partials, stein_reduce_blocks(n, p), theta, total, max_norm, opt,
      st, med_h2, logp, n, new_theta, stats);
  return cudaGetLastError();
}

// B6: ku, theta [n, p], ksum [n], center [p]; h2 and the pre-clip norm are
// device scalars. Moments and scalars as in stein_fused_step_tail.
int stein_fused_epilogue(const float* ku, const float* ksum,
                         const float* theta, const float* center,
                         const float* h2, const float* norm, int n, int p,
                         float n_total, float max_norm, int opt_kind,
                         const float* opt_consts, const float* mom1,
                         const float* mom2, const int* count, const float* lr,
                         float* new_theta, float* new_mom1, float* new_mom2,
                         int* new_count, float* new_lr, void* stream) {
  OptParams opt{};
  opt.kind = opt_kind;
  for (int i = 0; i < 5; ++i) opt.c[i] = opt_consts[i];
  const OptState st{mom1, mom2, count, lr, new_mom1, new_mom2, new_count,
                    new_lr};
  const int total = n * p;
  epilogue_kernel<<<(total + kUpdateThreads - 1) / kUpdateThreads,
                    kUpdateThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ku, ksum, theta, center, h2, norm, n, p, n_total, max_norm, opt, st,
      new_theta);
  return cudaGetLastError();
}

// B5: the centred [m, n] block of rows against cols about the given
// centre, then the warm search on it, in one cooperative launch. out[0] =
// med, out[1] = med / log_n; dsub holds m * n floats, prep
// stein_gram_prep_floats(n, m, p).
int stein_warm_from_theta(const float* rows, const float* cols,
                          const float* center, int m, int n, int p,
                          const float* med_prev, int k, int rounds,
                          const float* bracket_lo, const float* bracket_hi,
                          int n_brackets, float log_n, float* out,
                          float* dsub, int* part_counts, float* part_range,
                          float* prep, void* stream) {
  if (n_brackets > kMaxBrackets) return cudaErrorInvalidValue;
  const size_t smem = gram_smem(p, kMedianSmem);
  int blocks = 0;
  cudaError_t err = stage_grid(median_kernel, smem, &blocks);
  if (err != cudaSuccess) return err;
  GramArgs g{cols, rows, n, p, m, nullptr, nullptr, center, prep};
  if ((err = gram_shape(g, blocks, kMedianSmem)) != cudaSuccess) return err;
  MedianArgs a{dsub, m * n, med_prev, k, rounds,
               make_brackets(bracket_lo, bracket_hi, n_brackets), log_n, out,
               SweepScratch{part_counts, part_range}};
  err = launch_median(g, a, blocks, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
