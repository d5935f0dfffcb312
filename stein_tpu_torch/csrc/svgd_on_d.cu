// B10, the SVGD tile on a given distance block (replacing
// stein_tpu/ops/pallas_svgd.py:_svgd_on_d_tile_kernel): for D rows [m, n]
// and u [n, p],
//
//   K = exp2 of -D / (2 h^2), padded columns masked to 0,
//   ku = K @ u, ksum = rowsum K,
//
// with K never in device memory. The TPU kernel walked [BI, BJ] blocks of D
// in grid order, carrying the sums from one column block to the next in its
// output block. Here, as in the streaming tile (svgd_tile.cu), block (x, s,
// z) holds rows x*32 .. +32, walks the s-th contiguous share of the
// 32-column tiles and owns output columns z*128 .. +128; it writes its
// share's partial sums, and launch_tile_reduce adds the shares in share
// order, so two calls give bitwise-equal output. Per tile each warp loads
// its 4 rows of D (lane = column, one coalesced row segment each),
// exponentiates and masks them, and the block stages the tile's 32 rows of
// u in shared memory; then K @ u from a transposed K tile.
//
// u is given (B10), or formed while staging as u = g - theta / h^2 with
// theta uncentred (B1's D-given tail, step_impl='fused', whose reduce then
// forms phi with tc = theta), or as u = g - (theta - c) / h^2 about a given
// centre (B12's whole-D tail, on the median kernel's centred D). The
// exponent's operation order follows the caller's JAX function: (D *
// (-log2e/2)) / h^2 for B10, D * (-log2e/2 / h^2) for B1's and B12's tails.
//
// Bounds on the H100 at n = 1000, p = 128 (f32 on the CUDA cores): 2 m n p
// = 256 MFLOP (3.8 us at 67 TFLOP/s) against 4.6 MB of D, u and the
// outputs (1.4 us at 3.35 TB/s): operations bound. At n = 1000 there are
// 32 row blocks, so the column tiles are split into shares (4: 128 blocks
// for 132 SMs).

#include <cuda_runtime.h>

#include "common.cuh"
#include "svgd_tile.cuh"

namespace stein {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kRowsPerWarp * kWarps;   // rows per block
constexpr int kCols = 32;                      // tile width = lanes
constexpr int kOut = 4;                        // output columns per lane
constexpr int kChunk = 32 * kOut;              // output columns per block
constexpr int kUStride = kChunk + 4;
constexpr int kKtStride = 4 * kWarps + 4;      // K tile, transposed
// -log2(e) / 2, rounded to f32 as the JAX kernels' weakly-typed constant.
constexpr float kLog2eHalf = -1.4426950408889634f / 2.0f;

__global__ void __launch_bounds__(kThreads) svgd_on_d_kernel(OnDArgs a) {
  __shared__ float uj[kCols * kUStride];
  __shared__ __align__(16) float kt[kCols * kKtStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = a.m, n = a.n, p = a.p;
  const int c0 = blockIdx.z * kChunk;
  const float h2 = __ldg(a.h2);
  const float scale = __fdiv_rn(kLog2eHalf, h2);
  const int row0 = blockIdx.x * kRows + kRowsPerWarp * warp;
  const int tiles = (n + kCols - 1) / kCols;
  const int t_begin = blockIdx.y * tiles / gridDim.y;
  const int t_end = (blockIdx.y + 1) * tiles / gridDim.y;

  float acc[kRowsPerWarp][kOut], ksum_lane[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    ksum_lane[r] = 0.0f;
#pragma unroll
    for (int q = 0; q < kOut; ++q) acc[r][q] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * kCols;
    // u for tile rows warp + kWarps * b, chunk columns lane + 32q.
#pragma unroll
    for (int b = 0; b < kCols / kWarps; ++b) {
      const int jr = warp + kWarps * b, j = j0 + jr;
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
        const int k = c0 + lane + 32 * q;
        float v = 0.0f;
        if (j < n && k < p) {
          const size_t e = static_cast<size_t>(j) * p + k;
          if (a.u != nullptr) {
            v = __ldg(a.u + e);
          } else {
            const float t = a.center != nullptr
                                ? __ldg(a.cols + e) - __ldg(a.center + k)
                                : __ldg(a.cols + e);
            v = __ldg(a.grads + e) - t / h2;
          }
        }
        uj[jr * kUStride + lane + 32 * q] = v;
      }
    }
    // K for rows row0 .. row0+3 against tile column `lane`.
    const int j = j0 + lane;
    float kv[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = row0 + r;
      float kij = 0.0f;
      if (j < n && i < m) {
        const float d = __ldg(a.D + static_cast<size_t>(i) * n + j);
        kij = exp2f(a.scale_first ? d * scale : (d * kLog2eHalf) / h2);
      }
      kv[r] = kij;
      ksum_lane[r] += kij;
    }
    reinterpret_cast<float4*>(kt + lane * kKtStride)[warp] =
        make_float4(kv[0], kv[1], kv[2], kv[3]);
    __syncthreads();
    for (int jj = 0; jj < kCols; ++jj) {
      const float4 k4 =
          reinterpret_cast<const float4*>(kt + jj * kKtStride)[warp];
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
        const float u = uj[jj * kUStride + lane + 32 * q];
        acc[0][q] += k4.x * u;
        acc[1][q] += k4.y * u;
        acc[2][q] += k4.z * u;
        acc[3][q] += k4.w * u;
      }
    }
    __syncthreads();
  }

  float* ku_out = a.part_ku + static_cast<size_t>(blockIdx.y) * m * p;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r;
    const float ks = warp_sum(ksum_lane[r]);
    if (i < m) {
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
        const int k = c0 + lane + 32 * q;
        if (k < p) ku_out[static_cast<size_t>(i) * p + k] = acc[r][q];
      }
      if (lane == 0 && blockIdx.z == 0) a.part_ksum[blockIdx.y * m + i] = ks;
    }
  }
}

int chunks(int p) { return (p + kChunk - 1) / kChunk; }

}  // namespace

// Column shares: enough blocks to cover every SM once, at most 16.
int on_d_splits(int m, int n, int p) {
  const int blocks = ((m + kRows - 1) / kRows) * chunks(p);
  const int tiles = (n + kCols - 1) / kCols;
  int s = sm_count() / blocks;
  if (s > tiles) s = tiles;
  if (s > 16) s = 16;
  return s < 1 ? 1 : s;
}

cudaError_t launch_on_d(const OnDArgs& a, cudaStream_t stream) {
  if (a.splits < 1) return cudaErrorInvalidValue;
  const dim3 grid((a.m + kRows - 1) / kRows, a.splits, chunks(a.p));
  svgd_on_d_kernel<<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace stein

using namespace stein;

extern "C" {

int stein_on_d_splits(int m, int n, int p) { return on_d_splits(m, n, p); }

// B10. D [m, n], u [n, p], h2 a device scalar. Scratch part_ku [splits * m
// * p], part_ksum [splits * m]. Writes ku [m, p] and ksum [m].
int stein_svgd_on_d(const float* D, const float* u, const float* h2, int m,
                    int n, int p, int splits, float* part_ku,
                    float* part_ksum, float* ku, float* ksum, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const OnDArgs on_d{D, u, nullptr, nullptr, nullptr, h2, m, n, p,
                     false, splits, part_ku, part_ksum};
  cudaError_t err = launch_on_d(on_d, s);
  if (err != cudaSuccess) return err;
  TileArgs red{};
  red.m = m;
  red.n = n;
  red.p = p;
  red.h2 = h2;
  red.splits = splits;
  red.part_ku = part_ku;
  red.part_ksum = part_ksum;
  red.ku = ku;
  red.ksum = ksum;
  return launch_tile_reduce(red, s);
}

}  // extern "C"
