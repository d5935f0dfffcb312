// The centred Gram stage on the tensor cores, shared by the cooperative
// median kernel (stein_kernels.cu: B1's, B5's and B12's median block), the
// bracket pass (bracket_pass.cu: B8, B9) and the distance block
// (dist_block.cu: B4). It builds
//
//   D[r, j] = |rows_r - c|^2 + |cols_j - c|^2 - 2 (rows_r - c).(cols_j - c)
//
// for an [m, n] block in a grid of 512-thread blocks that are all resident
// (a cooperative launch): each row is centred once, with its f32 norm,
// into 16-byte-aligned scratch, then every block streams its tiles through
// a two-slot cp.async ring and runs mma.sync 3xTF32 (tf32_mma.cuh), each
// run of at most 32 contraction indices summed in fresh registers. The
// caller's epilogue sees each finished warp tile in registers, so a pass
// that counts or reduces D needs no second read of it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace stein {

namespace cg = cooperative_groups;

constexpr int kStageThreads = 512;
constexpr int kStageWarps = kStageThreads / 32;
constexpr int kGramLines = 128;            // staged rows + columns, at most
constexpr int kGramSlot = 20480;           // floats of a ring slot, at most
constexpr int kGramRed = 16 * kStageThreads;  // the k-groups' partial tiles

struct GramArgs {
  const float* theta;   // [n, p] columns; nullptr: no Gram stage
  const float* rows;    // [m, p] (theta_sub, or theta when m == n)
  int n, p, m;
  float* center;        // [p] out (nullptr: not written)
  float* part_center;   // [gridDim.x, p] scratch
  const float* center_in;  // [p] given centre, or nullptr: the column mean
  float* prep;          // [(n + m) * (p8 + 1)] scratch: centred rows, norms
  int wr, wc;           // the block tile: wr x wc warp tiles of 16 x 32
  int tp;               // tiles a ring stage holds, 1 or 2
  int kc;               // contraction indices a ring stage holds (8 | kc)
  int slot;             // floats of a ring slot
};

// The epilogue of a caller that only needs D written.
struct NoEpilogue {
  __device__ void operator()(const float (&)[4][4], unsigned) const {}
};

// The centred [m, n] block into Dout. The centre is given, or the column
// sums: each block sums a strided subset of rows, then every block adds
// the gridDim.x partials in block order, so every block holds bitwise the
// same centre. Then the centred columns and rows, zero-padded to p8 = 8
// ceil(p / 8) with 16-byte-aligned rows, and their squared norms (f32, one
// warp a row) go to g.prep, each row once, and a grid barrier. Block b
// then takes the block tiles b, b + gridDim.x, ...: wr x wc warp tiles of
// 16 rows x 32 columns, streamed through a two-slot cp.async ring, g.kc
// contraction indices a stage (all of p8 where the slot holds it). The 16
// warps split the contraction: warp w runs warp tile w % (wr wc) on the
// k-steps of 8 indices congruent to w / (wr wc), four at most in fresh
// registers before each IEEE add; at the tile's end the k-groups' partial
// sums are added in group order through shared memory, and D = (|r|^2 +
// |t|^2) - 2 S. The warps that hold a finished warp tile pass its 16
// entries a thread (the accumulator layout: row gid + 8 (e / 2), column
// 8 nt + 2 tig + e % 2) and the mask of those inside the block to epi,
// all 32 lanes together; with kFinalSync a grid barrier ends the stage.
template <bool kFinalSync, class Epilogue>
__device__ void gram_stage(const GramArgs& g, float* Dout, float* sm,
                           Epilogue& epi) {
  cg::grid_group grid = cg::this_grid();
  const int p = g.p, pp = (p + 7) & ~7;
  float* c = sm;                          // [pp]
  float* ring = c + pp;                   // 2 x [g.slot]
  float* red = ring + 2 * g.slot;         // [kStageWarps][16][32]
  if (g.center_in != nullptr) {
    for (int k = threadIdx.x; k < p; k += blockDim.x)
      c[k] = __ldg(g.center_in + k);
  } else {
    for (int k = threadIdx.x; k < p; k += blockDim.x) {
      float s = 0.0f;
      for (int r = blockIdx.x; r < g.n; r += gridDim.x)
        s += __ldg(g.theta + r * p + k);
      g.part_center[blockIdx.x * p + k] = s;
    }
    grid.sync();
    for (int k = threadIdx.x; k < p; k += blockDim.x) {
      float s = 0.0f;
      for (int b = 0; b < gridDim.x; ++b)
        s += __ldcg(g.part_center + b * p + k);
      c[k] = s / static_cast<float>(g.n);
      if (blockIdx.x == 0 && g.center != nullptr) g.center[k] = c[k];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The centred operands: columns [n][pp], then (unless the rows are the
  // columns) rows [m][pp], then the norms of each.
  const bool shared_rows = g.rows == g.theta && g.m == g.n;
  float* cols_c = g.prep;
  float* rows_c = shared_rows ? cols_c : cols_c + static_cast<size_t>(g.n) * pp;
  float* nrm_c = g.prep + static_cast<size_t>(g.n + (shared_rows ? 0 : g.m)) * pp;
  float* nrm_r = shared_rows ? nrm_c : nrm_c + g.n;
  for (int r = blockIdx.x * kStageWarps + warp;
       r < g.n + (shared_rows ? 0 : g.m); r += gridDim.x * kStageWarps) {
    const bool col = r < g.n;
    const int i = col ? r : r - g.n;
    const float* src = (col ? g.theta : g.rows) + static_cast<size_t>(i) * p;
    float* dst = (col ? cols_c : rows_c) + static_cast<size_t>(i) * pp;
    float sq = 0.0f;
    for (int k = lane; k < pp; k += 32) {
      const float v = k < p ? __ldg(src + k) - c[k] : 0.0f;
      dst[k] = v;
      sq += v * v;
    }
    sq = warp_sum(sq);
    if (lane == 0) (col ? nrm_c : nrm_r)[i] = sq;
  }
  grid.sync();

  const int bm = 16 * g.wr, bn = 32 * g.wc, lines = bm + bn;
  const int sk = g.kc + 4;
  const int tiles_j = (g.n + bn - 1) / bn;
  const int tiles = ((g.m + bm - 1) / bm) * tiles_j;
  const int mine = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
                   gridDim.x;
  const int nk = (pp + g.kc - 1) / g.kc;
  const int stages = (mine + g.tp - 1) / g.tp * nk;
  // The block's tiles are b, b + G, b + 2 G, ... (G = gridDim.x), g.tp of
  // them a stage: stage s holds chunk s % nk of the tiles of round s / nk.
  auto tile_of = [&](int s, int ts) {
    return static_cast<int>(blockIdx.x) + ((s / nk) * g.tp + ts) * gridDim.x;
  };
  // Stage s into ring slot s & 1: line L is line l = L % lines of tile
  // slot L / lines, centred row r0 + l for l < bm, else column j0 + l - bm;
  // what lies outside the block (or is no tile) is zero. The lines' rows of
  // g.prep (-1: zero) are worked out once a round of tiles (s % nk == 0)
  // into a table, double-buffered by the round's parity, so the copies
  // themselves (a warp a line) do no integer division.
  __shared__ int line_src[2][kGramLines];
  auto issue = [&](int s) {
    int* src_of = line_src[(s / nk) & 1];
    if (s % nk == 0) {
      for (int L = threadIdx.x; L < g.tp * lines; L += blockDim.x) {
        const int t = tile_of(s, L / lines), l = L % lines;
        const bool row = l < bm;
        const int src = row ? (t / tiles_j) * bm + l
                            : (t % tiles_j) * bn + l - bm;
        src_of[L] = t < tiles && src < (row ? g.m : g.n)
                        ? (row && !shared_rows ? g.n + src : src)
                        : -1;
      }
      __syncthreads();
    }
    float* slot = ring + (s & 1) * g.slot;
    const int k0 = (s % nk) * g.kc, q = min(g.kc, pp - k0) / 4;
    for (int L = warp; L < g.tp * lines; L += kStageWarps) {
      const int src = src_of[L];
      float* to = slot + L * sk;
      for (int kk = 4 * lane; kk < 4 * q; kk += 128) {
        if (src >= 0)
          cp_async16(to + kk, g.prep + static_cast<size_t>(src) * pp + k0 + kk);
        else
          *reinterpret_cast<float4*>(to + kk) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };

  // Warp w works on tile slot ts = w / (16 / tp): warp tile tw, k-group
  // grp of `groups`.
  const int gid = lane >> 2, tig = lane & 3;
  const int tiles_w = g.wr * g.wc, per_slot = kStageWarps / g.tp;
  const int groups = per_slot / tiles_w, ts = warp / per_slot;
  const int tw = warp % per_slot % tiles_w, grp = warp % per_slot / tiles_w;
  const int wr = tw / g.wc, wc = tw % g.wc, base = ts * lines;
  float s[4][4] = {};
  float* partial = red + warp * 16 * 32 + lane;   // [16][32], this lane's
  if (stages > 0) issue(0);
  cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) issue(st + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* slot = ring + (st & 1) * g.slot;
    const int kw = min(g.kc, pp - (st % nk) * g.kc);
    const bool last = st % nk == nk - 1;
    {
      const float* r_lo = slot + (base + 16 * wr + gid) * sk;
      const float* tj = slot + (base + bm + 32 * wc) * sk;
      float t[4][4] = {};
      int run = 0;
      for (int j = grp; j < kw / 8; j += groups) {
        kstep_3xtf32(t, r_lo, r_lo + 8 * sk, tj, sk, 8 * j + tig, gid);
        if (++run == 4) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            s[i / 4][i % 4] += t[i / 4][i % 4];
            t[i / 4][i % 4] = 0.0f;
          }
          run = 0;
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i / 4][i % 4] += t[i / 4][i % 4];
    }
    if (last) {
      if (grp > 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) partial[32 * i] = s[i / 4][i % 4];
      }
      __syncthreads();
      const int t = tile_of(st, ts);
      if (grp == 0 && t < tiles) {
        for (int q = 1; q < groups; ++q) {
          const float* other = partial + q * tiles_w * 16 * 32;
#pragma unroll
          for (int i = 0; i < 16; ++i) s[i / 4][i % 4] += other[32 * i];
        }
        const int r0 = (t / tiles_j) * bm + 16 * wr;
        const int j0 = (t % tiles_j) * bn + 32 * wc;
        // The tile's norms first, all loads in flight together (a load
        // after a store to D would wait for it: the pointers may alias).
        float nr[2], nc[4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + gid + 8 * h;
          nr[h] = r < g.m ? __ldcg(nrm_r + r) : 0.0f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int j = j0 + 8 * nt + 2 * tig + h;
            nc[nt][h] = j < g.n ? __ldcg(nrm_c + j) : 0.0f;
          }
        }
        float d[4][4];
        unsigned in = 0u;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = r0 + gid + 8 * (e >> 1);
            const int j = j0 + 8 * nt + 2 * tig + (e & 1);
            d[nt][e] = 0.0f;
            if (r < g.m && j < g.n) {
              d[nt][e] = (nr[e >> 1] + nc[nt][e & 1]) - 2.0f * s[nt][e];
              Dout[static_cast<size_t>(r) * g.n + j] = d[nt][e];
              in |= 1u << (4 * nt + e);
            }
          }
        epi(d, in);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i / 4][i % 4] = 0.0f;
    }
    __syncthreads();
  }
  if (kFinalSync) grid.sync();
}

// A ring slot's floats at width p: kGramSlot, or less where the centre
// leaves less room in `budget` bytes of dynamic shared memory.
inline int gram_slot(int p, int budget) {
  const int pp = (p + 7) & ~7;
  const int fit = (budget / 4 - pp - kGramRed) / 2;
  return (fit < kGramSlot ? fit : kGramSlot) & ~3;
}

// The Gram stage's dynamic shared memory: the centre, the two ring slots
// and the k-groups' partial tiles.
inline size_t gram_smem(int p, int budget) {
  return sizeof(float) *
         (((p + 7) & ~7) + 2 * gram_slot(p, budget) + kGramRed);
}

// The cooperative grid of a kernel of kStageThreads-thread blocks with
// `smem` bytes of dynamic shared memory: one block per SM, so that every
// block is resident for the grid barriers, after the kernel's opt-in to
// that memory and a check that a block fits on an SM.
template <class Kernel>
cudaError_t stage_grid(Kernel kernel, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = set_smem(reinterpret_cast<const void*>(kernel), smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kStageThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms;
  return cudaSuccess;
}

// Floats of the Gram stage's g.prep at this shape.
inline long long gram_prep_floats(int n, int m, int p) {
  return static_cast<long long>(n + m) * (((p + 7) & ~7) + 1);
}

// The block tile, in warp tiles of 16 rows x 32 columns: 4 x 2 or 2 x 1,
// the first whose tiles give every block of the grid one, else 1 x 1.
// Where no block has more than two tiles and two fit a stage, a block
// stages both at once (8 warps each), so its second tile does not wait for
// its first. Then the contraction indices a ring slot holds: at least one
// k-step of 8, else (p past ~45k, where the centre leaves the ring too
// little room) the shape is refused.
inline cudaError_t gram_shape(GramArgs& g, int blocks, int budget) {
  static const int shapes[2][2] = {{4, 2}, {2, 1}};
  g.wr = g.wc = 1;
  for (const auto& sh : shapes) {
    const long long tiles =
        static_cast<long long>((g.m + 16 * sh[0] - 1) / (16 * sh[0])) *
        ((g.n + 32 * sh[1] - 1) / (32 * sh[1]));
    if (tiles >= blocks) {
      g.wr = sh[0];
      g.wc = sh[1];
      break;
    }
  }
  const int pp = (g.p + 7) & ~7;
  const int lines = 16 * g.wr + 32 * g.wc;
  const long long tiles =
      static_cast<long long>((g.m + 16 * g.wr - 1) / (16 * g.wr)) *
      ((g.n + 32 * g.wc - 1) / (32 * g.wc));
  g.tp = tiles <= 2LL * blocks && 2 * lines <= kGramLines &&
                 2 * g.wr * g.wc <= kStageWarps
             ? 2
             : 1;
  g.slot = gram_slot(g.p, budget);
  g.kc = g.slot > 0 ? (g.slot / (g.tp * lines) - 4) & ~7 : 0;
  if (g.kc > pp) g.kc = pp;
  return g.kc >= 8 ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace stein
