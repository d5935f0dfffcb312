// B11, the symmetric-traversal SVGD tile (replacing
// stein_tpu/ops/pallas_svgd.py:_svgd_sym_tile_kernel): for [n, p] particles
// theta and gradients g, with gt = [g | theta] ([n, 2p]),
//
//   D   = rsq_i + rsq_j - 2 theta_i theta_j^T      (uncentred, as B11 is)
//   K   = exp2((D / h^2) * (-log2e/2)),           rows and columns >= n masked
//   both = K @ gt, ksum = rowsum K, from the tiles j >= i only (K = K^T)
//   phi = (both[:, :p] + (ksum theta - both[:, p:]) / h^2) / n
//
// The TPU kernel walked the upper tiles in grid order, adding each strictly
// upper tile's K^T @ gt_i into a VMEM-resident [n, 2p] column accumulator.
// Hopper blocks run in no order and there is no float atomic here (two
// calls must give bitwise-equal output), so each upper tile is one block
// that writes partial sums, and a second launch adds them in a fixed order.
// The upper tiles are numbered row by row, (0, 0) .. (0, T-1), (1, 1) ..,
// and taken in bands of consecutive numbers, so that the scratch is one
// band's partials:
//
//   sym_tile_kernel    block b is tile t0 + b, (I, J), J >= I, of 128 x 128
//                      particles. It computes the D tile by an f32 dot
//                      (theta in k-chunks of 32, 8 x 8 outputs per thread),
//                      K into shared memory (67.6 KB), its row and column
//                      sums, then, chunk by chunk of 128 output columns of
//                      gt, K @ gt_J (the row side, for row block I) and, for
//                      J > I, K^T @ gt_I (the column side, for row block J)
//                      into the band's scratch.
//   sym_accum_kernel   one thread per (row, column of [both | ksum]): the
//                      band's partials of that row in tile order, added to
//                      the [n, 2p + 1] accumulator.
//   sym_phi_kernel     one thread per (row, coordinate): phi.
//
// Row block R receives one partial from each tile (s, R), s < R, then one
// from each tile (R, s), s >= R, and these are numbered in that order: the
// accumulator adds them in slot order s = 0 .. T-1 whatever the band, so
// the output does not depend on the band size.
//
// Scratch: a band's partials, 2 * 128 * (2p + 1) floats a tile (263 KB at
// p = 128), and the [n, 2p + 1] accumulator. The wrapper sizes the band
// to a budget (stein_sym_band). All partials are written once and read once
// (842 MB at n = 10240, p = 128: 0.5 ms at 3.35 TB/s).
//
// Bounds on the H100 at n = 10240, p = 128, f32 on the CUDA cores. The
// fewest operations any implementation of this phi needs: it equals
// (K @ (g - theta / h^2) + ksum theta / h^2) / n, a contraction p wide, and
// by symmetry D costs n^2 p FLOP (n^2 / 2 pairs, p multiply-adds each) and
// the contraction n^2 p on each side, so 3 n^2 p FLOP = 40 GFLOP: 0.60 ms
// at 67 TFLOP/s, plus n^2 / 2 exponentials. The inputs and phi (16 MB) are
// nothing beside it: bound by operations. This kernel carries [G|T], 2p
// wide, on both sides (5 n^2 p), and the scratch traffic above.
// Two blocks per SM (102 KB of shared memory each).

#include <cuda_runtime.h>

#include "common.cuh"

namespace stein {
namespace {

constexpr int kB = 128;             // tile rows = tile columns
constexpr int kThreads = 256;       // 16 x 16, 8 x 8 outputs each
constexpr int kK = 32;              // depth of a staged chunk
constexpr int kS = kB + 4;          // shared row stride (float4-aligned)
constexpr int kReduceThreads = 256;
constexpr int kAhead = 8;           // partials in flight per accumulating thread
// -log2(e) / 2, rounded to f32 as the JAX kernels' weakly-typed constant.
constexpr float kLog2eHalf = -1.4426950408889634f / 2.0f;

struct SymArgs {
  const float* theta;   // [n, p]
  const float* grads;   // [n, p]
  const float* h2;      // device scalar
  int n, p, tiles;      // tiles = T = ceil(n / kB)
  int t0, t1;           // this band: upper tiles t0 .. t1 - 1,
  int r0, r1;           // in tile rows r0 .. r1
  float* part;          // [t1 - t0, 2, kB, 2p]: row side 0, column side 1
  float* part_ksum;     // [t1 - t0, 2, kB]
  float* acc;           // [n, 2p]
  float* acc_ksum;      // [n]
  float* phi;           // [n, p]
};

// Thread (tx, ty) owns tile rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, and
// columns tx*4 + {0..3} and 64 + tx*4 + {0..3}: float4 shared loads hit 32
// distinct banks per quarter warp.
__device__ __forceinline__ int own(int t, int r) {
  return (r < 4 ? 0 : 64) + t * 4 + (r & 3);
}

__device__ __forceinline__ void load8(const float* row, int t, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + t * 4);
  const float4 b = *reinterpret_cast<const float4*>(row + 64 + t * 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// gt[j][c] = [grads | theta][j][c], zero past n rows or 2p columns.
__device__ __forceinline__ float gt_at(const SymArgs& a, int j, int c) {
  if (j >= a.n || c >= 2 * a.p) return 0.0f;
  const size_t row = static_cast<size_t>(j) * a.p;
  return c < a.p ? __ldg(a.grads + row + c) : __ldg(a.theta + row + c - a.p);
}

// acc = op(K) @ gt[g0 .. g0+128, c0 .. c0+128]: op(K) = K (row side,
// A[i][k] = K[i][k]) or K^T (column side, A[j][k] = K[k][j]).
template <bool kTrans>
__device__ __forceinline__ void contract(const SymArgs& a, const float* ks,
                                         float* bs, int g0, int c0,
                                         float acc[8][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  for (int k0 = 0; k0 < kB; k0 += kK) {
    for (int e = threadIdx.x; e < kK * kB; e += kThreads) {
      const int kk = e / kB, cc = e % kB;
      bs[kk * kS + cc] = gt_at(a, g0 + k0 + kk, c0 + cc);
    }
    __syncthreads();
    if constexpr (kTrans) {
      for (int kk = 0; kk < kK; ++kk) {
        float av[8], bv[8];
        load8(ks + (k0 + kk) * kS, ty, av);
        load8(bs + kk * kS, tx, bv);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] += av[r] * bv[c];
      }
    } else {
      for (int kk = 0; kk < kK; kk += 4) {
        float4 av[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          av[r] = *reinterpret_cast<const float4*>(ks + own(ty, r) * kS +
                                                   k0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float bv[8];
          load8(bs + (kk + q) * kS, tx, bv);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float k = q == 0 ? av[r].x : q == 1 ? av[r].y
                            : q == 2 ? av[r].z : av[r].w;
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] += k * bv[c];
          }
        }
      }
    }
    __syncthreads();
  }
}

// Side `side` of the band's tile b: this thread's 8 x 8 outputs of the
// chunk at c0.
__device__ __forceinline__ void store_part(const SymArgs& a, int b, int side,
                                           int c0, float acc[8][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int w = 2 * a.p;
  float* out = a.part + (static_cast<size_t>(b) * 2 + side) * kB * w;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + own(tx, c);
      if (col < w) out[static_cast<size_t>(own(ty, r)) * w + col] = acc[r][c];
    }
}

__global__ void __launch_bounds__(kThreads, 2) sym_tile_kernel(SymArgs a) {
  extern __shared__ float4 sm4[];
  float* ks = reinterpret_cast<float*>(sm4);   // [kB][kS] K tile
  float* as = ks + kB * kS;                    // [kK][kS] staging
  float* bs = as + kK * kS;                    // [kK][kS] staging
  float* rsq = bs + kK * kS;                   // [2][kB] row norms

  // Block b -> tile t0 + b = (I, J), J >= I, rows of the upper triangle in
  // order.
  const int b = blockIdx.x;
  int t = a.t0 + b, I = 0;
  while (t >= a.tiles - I) {
    t -= a.tiles - I;
    ++I;
  }
  const int J = I + t;
  const int i0 = I * kB, j0 = J * kB;
  const int n = a.n, p = a.p;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float h2 = __ldg(a.h2);

  // The D tile: theta_I theta_J^T in chunks of kK columns; thread r < 128
  // sums the squares of row r of theta_I, thread 128 + r of theta_J.
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  float sq = 0.0f;
  for (int k0 = 0; k0 < p; k0 += kK) {
    for (int e = threadIdx.x; e < kB * kK; e += kThreads) {
      const int row = e / kK, kk = e % kK, k = k0 + kk;
      const int gi = i0 + row, gj = j0 + row;
      as[kk * kS + row] =
          gi < n && k < p ? __ldg(a.theta + static_cast<size_t>(gi) * p + k)
                          : 0.0f;
      bs[kk * kS + row] =
          gj < n && k < p ? __ldg(a.theta + static_cast<size_t>(gj) * p + k)
                          : 0.0f;
    }
    __syncthreads();
    {
      const float* src = threadIdx.x < kB ? as : bs;
      const int row = threadIdx.x & (kB - 1);
      for (int kk = 0; kk < kK; ++kk) {
        const float v = src[kk * kS + row];
        sq += v * v;
      }
    }
    for (int kk = 0; kk < kK; ++kk) {
      float av[8], bv[8];
      load8(as + kk * kS, ty, av);
      load8(bs + kk * kS, tx, bv);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] += av[r] * bv[c];
    }
    __syncthreads();
  }
  rsq[threadIdx.x] = sq;
  __syncthreads();

  // K, masked past n on both sides (the column sums would otherwise take
  // K of padded rows), in the JAX tile's operation order.
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = own(ty, r);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = own(tx, c);
      const float d = (rsq[i] + rsq[kB + j]) - 2.0f * acc[r][c];
      ks[i * kS + j] = i0 + i < n && j0 + j < n
                           ? exp2f((d / h2) * kLog2eHalf)
                           : 0.0f;
    }
  }
  __syncthreads();

  // Row sums to the row side; column sums to the column side.
  {
    const int r = threadIdx.x & (kB - 1);
    float s = 0.0f;
    if (threadIdx.x < kB) {
      for (int j = 0; j < kB; ++j) s += ks[r * kS + j];
      a.part_ksum[(static_cast<size_t>(b) * 2 + 0) * kB + r] = s;
    } else if (J > I) {
      for (int i = 0; i < kB; ++i) s += ks[i * kS + r];
      a.part_ksum[(static_cast<size_t>(b) * 2 + 1) * kB + r] = s;
    }
  }

  for (int c0 = 0; c0 < 2 * p; c0 += kB) {
    contract<false>(a, ks, bs, j0, c0, acc);
    store_part(a, b, 0, c0, acc);
    if (J > I) {
      contract<true>(a, ks, bs, i0, c0, acc);
      store_part(a, b, 1, c0, acc);
    }
  }
}

// Column c of [both | ksum] (c == 2p is ksum), row il of side `side` of the
// band's tile b.
__device__ __forceinline__ float part_at(const SymArgs& a, int b, int side,
                                         int il, int c) {
  const int w = 2 * a.p;
  const size_t r = (static_cast<size_t>(b) * 2 + side) * kB + il;
  return c < w ? a.part[r * w + c] : a.part_ksum[r];
}

// Rows below tile row r0 take nothing from the band: the grid starts there.
// Each thread loads kAhead partials before adding them in order, so that
// its loads overlap and its sum keeps its order.
__global__ void __launch_bounds__(kReduceThreads)
    sym_accum_kernel(SymArgs a) {
  const int w = 2 * a.p, wk = w + 1, T = a.tiles, t0 = a.t0, t1 = a.t1;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x + static_cast<size_t>(a.r0) * kB * wk;
  if (e >= static_cast<size_t>(a.n) * wk) return;
  const int i = static_cast<int>(e / wk), c = static_cast<int>(e % wk);
  const int R = i / kB, il = i % kB;
  float* dst = c < w ? a.acc + static_cast<size_t>(i) * w + c : a.acc_ksum + i;
  float s = *dst;
  // The column sides of tiles (I, R), I < R, from the band's tile rows:
  // tile I T - I (I - 1) / 2 + R - I, rising with I. Then the row sides of
  // tiles (R, J), J >= R, which follow.
  const int last = min(R - 1, a.r1);
  for (int I0 = a.r0; I0 <= last; I0 += kAhead) {
    float v[kAhead];
    bool in[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int I = I0 + k, t = I * T - I * (I - 1) / 2 + R - I;
      in[k] = I <= last && t >= t0 && t < t1;
      v[k] = in[k] ? part_at(a, t - t0, 1, il, c) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (in[k]) s += v[k];
  }
  const int base = R * T - R * (R - 1) / 2;
  const int hi = min(base + T - R, t1);
  for (int tr = max(base, t0); tr < hi; tr += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      v[k] = tr + k < hi ? part_at(a, tr + k - t0, 0, il, c) : 0.0f;
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (tr + k < hi) s += v[k];
  }
  *dst = s;
}

__global__ void __launch_bounds__(kReduceThreads) sym_phi_kernel(SymArgs a) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(a.n) * a.p) return;
  const int i = static_cast<int>(e / a.p), c = static_cast<int>(e % a.p);
  const float* row = a.acc + static_cast<size_t>(i) * 2 * a.p;
  const float h2 = __ldg(a.h2);
  const float num =
      __fsub_rn(__fmul_rn(a.acc_ksum[i], __ldg(a.theta + e)), row[a.p + c]);
  a.phi[e] = (row[c] + num / h2) / static_cast<float>(a.n);
}

size_t sym_smem() { return sizeof(float) * ((kB + 2 * kK) * kS + 2 * kB); }

unsigned blocks_for(size_t total) {
  return static_cast<unsigned>((total + kReduceThreads - 1) / kReduceThreads);
}

// The tile row I of upper tile t.
int tile_row(int t, int tiles) {
  int I = 0;
  while (t >= tiles - I) t -= tiles - I++;
  return I;
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

// The tile count T per side.
int stein_sym_tiles(int n) { return (n + kB - 1) / kB; }

// Upper tiles per band for a scratch budget of budget_mib MiB: the most
// whose partials fit, in whole waves of two blocks per SM where a wave
// fits, and at least one tile.
int stein_sym_band(int n, int p, int budget_mib) {
  const long long T = stein_sym_tiles(n), total = T * (T + 1) / 2;
  const long long per_tile = sizeof(float) * 2LL * kB * (2LL * p + 1);
  long long band = (static_cast<long long>(budget_mib) << 20) / per_tile;
  const long long wave = 2LL * sm_count();
  if (band >= wave) band -= band % wave;
  if (band < 1) band = 1;
  return static_cast<int>(band < total ? band : total);
}

// B11. theta, grads [n, p]; h2 a device scalar; part, part_ksum a band's
// scratch ([band, 2, 128, 2p] and [band, 2, 128] floats); acc, acc_ksum
// [n, 2p] and [n]; writes phi [n, p].
int stein_svgd_sym(const float* theta, const float* grads, const float* h2,
                   int n, int p, int band, float* part, float* part_ksum,
                   float* acc, float* acc_ksum, float* phi,
                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int tiles = stein_sym_tiles(n), total = tiles * (tiles + 1) / 2;
  SymArgs a{theta, grads, h2, n, p, tiles, 0, 0, 0, 0,
            part, part_ksum, acc, acc_ksum, phi};
  const size_t smem = sym_smem();
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(sym_tile_kernel), smem);
  if (err != cudaSuccess) return err;
  const size_t w = 2 * static_cast<size_t>(p);
  if ((err = cudaMemsetAsync(acc, 0, sizeof(float) * n * w, stream)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(acc_ksum, 0, sizeof(float) * n, stream)) !=
          cudaSuccess)
    return err;
  for (a.t0 = 0; a.t0 < total; a.t0 = a.t1) {
    a.t1 = a.t0 + band < total ? a.t0 + band : total;
    a.r0 = tile_row(a.t0, tiles);
    a.r1 = tile_row(a.t1 - 1, tiles);
    sym_tile_kernel<<<a.t1 - a.t0, kThreads, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sym_accum_kernel<<<blocks_for((n - static_cast<size_t>(a.r0) * kB) *
                                  (w + 1)),
                       kReduceThreads, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  sym_phi_kernel<<<blocks_for(static_cast<size_t>(n) * p), kReduceThreads, 0,
                   stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
