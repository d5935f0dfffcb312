// The streaming SVGD tile, one kernel for B1's step tail and for B3
// (replacing stein_tpu/ops/pallas_svgd.py:_svgd_tile_kernel). Two
// launches:
//
//   svgd_tile_kernel    grid (row blocks of 32, column shares, p chunks).
//                       Block (x, s, z) holds rows x*32 .. +32 and walks
//                       the s-th contiguous share of the 32-column tiles.
//                       Per tile: the centred D tile by an f32 dot, K =
//                       exp2 of -D/(2 h^2) with the padded columns masked
//                       to 0, then ku += K @ u for the block's chunk z of
//                       output columns (u = g - (t - c) / h^2) and the row
//                       sums. K never reaches device memory. Writes the
//                       share's partial ku and row sums.
//   tile_reduce_kernel  adds the shares in share order (two calls give
//                       bitwise-equal output), then writes ku and ksum, or
//                       phi = (ku + ksum * (r - c) / h^2) / n_total and,
//                       for B1's clip, one ||phi||^2 partial per block.
//
// Rectangular [m, n], any n (the last tile is masked) and any p. A p chunk
// is 32 * OUT columns, OUT <= 12 per lane. When p fits one chunk (p <=
// 384) the block's rows stay in shared memory for the whole walk; wider p
// runs gridDim.z = ceil(p / 384) chunks, each block restaging the rows
// and columns chunk by chunk for the dot and keeping u for its own chunk
// only (the dot is repeated per chunk). h^2 is read from device memory.
// The TPU kernel's [BI, BJ] blocks do not carry over: the tile sizes here
// are this kernel's own.
//
// Bounds on the H100, f32 on the CUDA cores (no tensor cores yet): the dot
// and K @ u are 4 m n p FLOP (1.2 GFLOP at m = n = 1000, p = 303; 54 GFLOP
// at n = 10240, p = 128). Each warp register-blocks 4 rows (float4 shared
// loads, 5 loads per 16 FMAs) and prefetches the next tile's columns and
// gradients into registers while it computes. At n = 1000 there are only
// 32 row blocks, so the column tiles are split into shares as well (4:
// 128 blocks for 132 SMs).

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
constexpr int kLoadRows = kCols / kWarps;      // tile rows each warp loads
constexpr int kKtStride = 4 * kWarps + 4;      // K tile, transposed
constexpr int kMaxOut = 12;                    // p chunk = 32 * OUT <= 384
constexpr int kReduceThreads = 256;
// -log2(e) / 2, rounded to f32 as the JAX kernels' weakly-typed constant.
constexpr float kLog2eHalf = -1.4426950408889634f / 2.0f;

int out_width(int p) {  // 32-column groups of a p chunk per lane
  const int w = (((p + 3) & ~3) + 31) / 32;
  if (w <= 1) return 1;
  if (w <= 2) return 2;
  if (w <= 4) return 4;
  if (w <= 8) return 8;
  return kMaxOut;
}

int tile_chunks(int p) {
  const int w = 32 * out_width(p);
  return (p + w - 1) / w;
}

// Shared rows have stride cw + 4 (cw = the chunk, or p rounded up to 4 when
// p is one chunk; zero-padded), so the dot reads float4s without bank
// conflicts.
size_t tile_smem(int p) {
  const int pp = (p + 3) & ~3;
  const int cw = pp < 32 * out_width(p) ? pp : 32 * out_width(p);
  return sizeof(float) * ((kRows + 2 * kCols) * (cw + 4)
                          + kCols * kKtStride + kCols);
}

// Warp w owns rows 4w .. 4w+3 of the block; lane l owns tile column l in
// the dot, and chunk columns l + 32q (q < OUT) everywhere else.
template <int OUT>
__global__ void __launch_bounds__(kThreads) svgd_tile_kernel(TileArgs a) {
  constexpr int kW = 32 * OUT;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int m = a.m, n = a.n, p = a.p, nc = gridDim.z;
  const int pp = (p + 3) & ~3;
  const int cw = pp < kW ? pp : kW, ps = cw + 4;
  float* ti = sm;                               // [kRows][ps]
  float* tj = ti + kRows * ps;                  // [kCols][ps]
  float* uj = tj + kCols * ps;                  // [kCols][ps]
  float* kt = uj + kCols * ps;                  // [kCols][kKtStride]
  float* rsq_j = kt + kCols * kKtStride;        // [kCols]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int z = blockIdx.z;
  const float h2 = __ldg(a.h2);
  const float scale = __fdiv_rn(kLog2eHalf, h2);
  const int row0 = blockIdx.x * kRows + kRowsPerWarp * warp;

  float cr[OUT];   // the centre at this lane's columns of the chunk
  auto load_center = [&](int c0) {
#pragma unroll
    for (int q = 0; q < OUT; ++q) {
      const int k = c0 + lane + 32 * q;
      cr[q] = k < p ? __ldg(a.center + k) : 0.0f;
    }
  };
  // The warp's own rows of chunk c0, centred (zero past p and m).
  auto stage_rows = [&](int c0, float* sq) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = row0 + r;
#pragma unroll
      for (int q = 0; q < OUT; ++q) {
        const int kk = lane + 32 * q, k = c0 + kk;
        if (kk < cw) {
          const float v = (i < m && k < p)
                              ? __ldg(a.rows + static_cast<size_t>(i) * p + k) - cr[q]
                              : 0.0f;
          ti[(kRowsPerWarp * warp + r) * ps + kk] = v;
          sq[r] += v * v;
        }
      }
    }
  };

  // Row norms over every chunk; with one chunk the rows stay staged.
  float rsq_i[kRowsPerWarp] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 0; c < nc; ++c) {
    load_center(c * kW);
    stage_rows(c * kW, rsq_i);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) rsq_i[r] = warp_sum(rsq_i[r]);

  const int tiles = (n + kCols - 1) / kCols;
  const int t_begin = blockIdx.y * tiles / gridDim.y;
  const int t_end = (blockIdx.y + 1) * tiles / gridDim.y;

  // Prefetch registers: tile rows warp + kWarps * b, chunk columns
  // lane + 32q; the gradients only for the block's own chunk.
  float pt[kLoadRows][OUT], pg[kLoadRows][OUT];
  auto load = [&](int j0, int c0, bool with_g) {
#pragma unroll
    for (int b = 0; b < kLoadRows; ++b) {
      const int j = j0 + warp + kWarps * b;
#pragma unroll
      for (int q = 0; q < OUT; ++q) {
        const int k = c0 + lane + 32 * q;
        const bool in = j < n && k < p;
        const size_t e = static_cast<size_t>(j) * p + k;
        pt[b][q] = in ? __ldg(a.cols + e) : 0.0f;
        if (with_g) pg[b][q] = in ? __ldg(a.grads + e) : 0.0f;
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

  if (t_begin < t_end) load(t_begin * kCols, 0, z == 0);
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * kCols;
    float dot[kRowsPerWarp] = {0.0f, 0.0f, 0.0f, 0.0f};
    float sq_j[kLoadRows] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < nc; ++c) {
      const int c0 = c * kW;
      if (nc > 1) {
        float unused[kRowsPerWarp] = {0.0f, 0.0f, 0.0f, 0.0f};
        load_center(c0);
        stage_rows(c0, unused);
      }
#pragma unroll
      for (int b = 0; b < kLoadRows; ++b) {
        const int jr = warp + kWarps * b, j = j0 + jr;
#pragma unroll
        for (int q = 0; q < OUT; ++q) {
          const int kk = lane + 32 * q, k = c0 + kk;
          if (kk < cw) {
            const bool in = j < n && k < p;
            const float tc = in ? pt[b][q] - cr[q] : 0.0f;
            tj[jr * ps + kk] = tc;
            if (c == z) uj[jr * ps + kk] = in ? pg[b][q] - tc / h2 : 0.0f;
            sq_j[b] += tc * tc;
          }
        }
        if (c == nc - 1) {
          const float s = warp_sum(sq_j[b]);
          if (lane == 0) rsq_j[jr] = s;
        }
      }
      __syncthreads();
      // In flight during the dot: the next chunk, or the next tile.
      if (c + 1 < nc) load(j0, c0 + kW, c + 1 == z);
      else if (t + 1 < t_end) load(j0 + kCols, 0, z == 0);

      // D for rows row0..row0+3 against tile column `lane`.
      const int len4 = (pp - c0 < cw ? pp - c0 : cw) / 4;
      const float4* b4 = reinterpret_cast<const float4*>(tj + lane * ps);
      const float4* a4 =
          reinterpret_cast<const float4*>(ti + kRowsPerWarp * warp * ps);
      for (int k4 = 0; k4 < len4; ++k4) {
        const float4 bv = b4[k4];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 av = a4[r * (ps / 4) + k4];
          dot[r] += av.x * bv.x + av.y * bv.y + av.z * bv.z + av.w * bv.w;
        }
      }
      if (c + 1 < nc) __syncthreads();
    }

    float kv[kRowsPerWarp];
    const bool col_in = j0 + lane < n;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float d = (rsq_i[r] + rsq_j[lane]) - 2.0f * dot[r];
      const float x = a.div_h2 ? (d / h2) * kLog2eHalf : d * scale;
      kv[r] = col_in ? exp2f(x) : 0.0f;
      ksum_lane[r] += kv[r];
    }
    reinterpret_cast<float4*>(kt + lane * kKtStride)[warp] =
        make_float4(kv[0], kv[1], kv[2], kv[3]);
    __syncwarp();
    for (int jj = 0; jj < kCols; ++jj) {
      const float4 k4 = reinterpret_cast<const float4*>(kt + jj * kKtStride)[warp];
#pragma unroll
      for (int q = 0; q < OUT; ++q) {
        const int kk = lane + 32 * q;
        if (kk < cw) {
          const float u = uj[jj * ps + kk];
          acc[0][q] += k4.x * u;
          acc[1][q] += k4.y * u;
          acc[2][q] += k4.z * u;
          acc[3][q] += k4.w * u;
        }
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
      for (int q = 0; q < OUT; ++q) {
        const int k = z * kW + lane + 32 * q;
        if (k < p) ku_out[static_cast<size_t>(i) * p + k] = acc[r][q];
      }
      if (lane == 0 && z == 0) a.part_ksum[blockIdx.y * m + i] = ks;
    }
  }
}

// One thread per (row, coordinate): the shares in share order, then the
// raw sums, or phi and one ||phi||^2 partial per block.
__global__ void __launch_bounds__(kReduceThreads) tile_reduce_kernel(TileArgs a) {
  __shared__ float red[kReduceThreads / 32];
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (e < static_cast<size_t>(a.m) * a.p) {
    const int i = static_cast<int>(e / a.p), k = static_cast<int>(e % a.p);
    float ku = 0.0f, ks = 0.0f;
    for (int s = 0; s < a.splits; ++s) {
      ku += a.part_ku[static_cast<size_t>(s) * a.m * a.p + e];
      ks += a.part_ksum[s * a.m + i];
    }
    if (a.phi == nullptr) {
      a.ku[e] = ku;
      if (k == 0) a.ksum[i] = ks;
    } else {
      const float r = __ldg(a.rows + e);
      const float tc = a.center != nullptr ? r - __ldg(a.center + k) : r;
      v = (ku + ks * tc / __ldg(a.h2)) / a.n_total;
      a.phi[e] = v;
    }
  }
  if (a.partials == nullptr) return;
  const float sq = warp_sum(v * v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kReduceThreads / 32; ++w) t += red[w];
    a.partials[blockIdx.x] = t;
  }
}

template <int OUT>
cudaError_t launch_tile_kernel(const TileArgs& a, cudaStream_t stream) {
  const size_t smem = tile_smem(a.p);
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(svgd_tile_kernel<OUT>), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.m + kRows - 1) / kRows, a.splits, tile_chunks(a.p));
  svgd_tile_kernel<OUT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Column shares: enough blocks to cover every SM once, at most 16.
int tile_splits(int m, int n, int p) {
  const int blocks = ((m + kRows - 1) / kRows) * tile_chunks(p);
  const int tiles = (n + kCols - 1) / kCols;
  int s = sm_count() / blocks;
  if (s > tiles) s = tiles;
  if (s > 16) s = 16;
  return s < 1 ? 1 : s;
}

int tile_reduce_blocks(int m, int p) {
  return static_cast<int>(
      (static_cast<size_t>(m) * p + kReduceThreads - 1) / kReduceThreads);
}

cudaError_t launch_tile(const TileArgs& a, cudaStream_t stream) {
  if (a.splits < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (out_width(a.p)) {
    case 1: err = launch_tile_kernel<1>(a, stream); break;
    case 2: err = launch_tile_kernel<2>(a, stream); break;
    case 4: err = launch_tile_kernel<4>(a, stream); break;
    case 8: err = launch_tile_kernel<8>(a, stream); break;
    default: err = launch_tile_kernel<kMaxOut>(a, stream); break;
  }
  if (err != cudaSuccess) return err;
  return launch_tile_reduce(a, stream);
}

cudaError_t launch_tile_reduce(const TileArgs& a, cudaStream_t stream) {
  tile_reduce_kernel<<<tile_reduce_blocks(a.m, a.p), kReduceThreads, 0,
                       stream>>>(a);
  return cudaGetLastError();
}

}  // namespace stein

using namespace stein;

extern "C" {

int stein_tile_splits(int m, int n, int p) { return tile_splits(m, n, p); }

// B3. rows [m, p]; cols, grads [n, p]; center [p]; h2 a device scalar.
// Scratch part_ku [splits * m * p], part_ksum [splits * m]. Writes ku
// [m, p] and ksum [m] when phi is null, else phi [m, p] (divided by
// n_total).
int stein_svgd_tile(const float* rows, const float* cols, const float* grads,
                    const float* center, const float* h2, int m, int n,
                    int p, int splits, float* part_ku, float* part_ksum,
                    float* ku, float* ksum, float* phi, float n_total,
                    void* stream) {
  const TileArgs a{rows, cols, grads, center, h2, m, n, p, true, splits,
                   part_ku, part_ksum, n_total, ku, ksum, phi, nullptr};
  return launch_tile(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
