// The streaming SVGD tile's wgmma route (TileArgs.route == 1; the design
// and its bounds are in svgd_tile.cu's head note). Three launches:
//
//   tile_prep_kernel   grid (32 columns, 32 k): the centred rows, raw f32,
//                      and the column operands split for 3xTF32: the centred
//                      columns as big = tf32(t) and small = tf32(t - big),
//                      [n_pad, pp] each, and u = g - tc / h^2 transposed,
//                      [pp, n_pad] each, the columns of every aligned group
//                      of 8 permuted (position q holds column 2q for q < 4
//                      and 2(q - 4) + 1 for q >= 4, so that the dot's
//                      accumulator serves as the contraction's A operand
//                      unchanged); the row norms.
//   svgd_tile_kernel   grid (row blocks of 128 rows, column shares). Two
//                      consumer warpgroups, 64 rows each, and one producer
//                      warp, of which one thread keeps two TMA rings full:
//                      the 32-column tiles' split columns and norms (3-4
//                      stages) and their split u^T (2-4 stages),
//                      each stage with a full and an empty mbarrier. A
//                      consumer holds its rows raw in shared memory (loaded
//                      once, XOR-swizzled by 16 bytes) and per tile runs S =
//                      R T^T as wgmma m64nNTk8 with A, its rows split a
//                      k-step at a time, in registers; D = |r|^2 + |t|^2 - 2
//                      S and K = exp2 of the exponent (padded columns 0) in
//                      the accumulator, which frees the columns' stage; then
//                      ku += K U as wgmma m64nWCk8 with A = K from those
//                      registers and B = u^T from its stage, and the row
//                      sums. K never leaves registers. Writes the share's
//                      partial ku and row sums.
//   tile_reduce_kernel svgd_tile.cu's, unchanged: the shares in share order.
//
// wgmma reads an f32 word as tf32 by dropping its low bits, so the shared-
// memory operands hold the split parts as data, each exact in tf32. Every
// product is small*big + big*small + big*big with f32 accumulation; each
// run of 32 contraction indices of the dot and each tile's contraction (32
// indices) is summed in fresh registers and added into the running sum by
// an IEEE add. No atomics; two calls give bitwise-equal output.
//
// Shapes: p <= 128, padded to pp = 32, 64 or 128; the contraction runs in
// two halves at pp = 128 (the registers: ptxas holds both warpgroups at the
// 168 registers of three warpgroups' launch bound, and setmaxnreg did not
// lift it). Wider p stays on the mma.sync route, which is faster there.

#include <cuda.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "svgd_tile.cuh"
#include "tf32_mma.cuh"
#include "tma_ring.cuh"

namespace stein {
namespace wg {

constexpr int kMaxP = 128;
constexpr int kNT = 32;           // columns a tile
constexpr int kWarpgroups = 2;    // consumer warpgroups, 64 rows each
constexpr int kRows = 64 * kWarpgroups;         // rows a block
constexpr int kConsumerWarps = 4 * kWarpgroups;
constexpr int kThreads = 128 * kWarpgroups + 32;  // and the producer warp
constexpr int kPrepCols = 32;     // columns a prep block
constexpr int kPrepThreads = 256;
constexpr size_t kSmemLimit = 232448;
// -log2(e) / 2, rounded to f32 as the JAX kernels' weakly-typed constant.
constexpr float kLog2eHalf = -1.4426950408889634f / 2.0f;

int round_up(int x, int k) { return (x + k - 1) / k * k; }

struct Geom {
  int pp;       // the dot's zero-padded width
  int n_pad;    // columns rounded up to 32
  int m_pad;    // separate rows rounded up to 32
  size_t smem;
};

struct Ptrs {
  float* colsc;   // [n_pad, pp] raw centred columns (the rows when shared)
  float* tb;      // [n_pad, pp] their tf32 big parts
  float* ts;      // [n_pad, pp] and small parts
  float* ub;      // [pp, n_pad] u^T, permuted by 8s, big parts
  float* us;      // [pp, n_pad] small parts
  float* rsq_j;   // [n_pad]
  float* rowsc;   // [m_pad, pp] raw centred rows (colsc when shared)
  float* rsq_i;   // [m_pad] (rsq_j when shared)
};

// The block's raw rows in shared memory, pp floats a row.
__host__ __device__ constexpr size_t rows_bytes(int pp) {
  return sizeof(float) * static_cast<size_t>(kRows) * pp;
}

// A stage of the columns' ring: the split columns and their norms.
__host__ __device__ constexpr size_t col_stage_bytes(int pp) {
  return sizeof(float) * static_cast<size_t>(kNT) * (2 * pp + 1);
}

// A stage of u^T's ring: the split u^T.
__host__ __device__ constexpr size_t u_stage_bytes(int pp) {
  return sizeof(float) * 2 * static_cast<size_t>(kNT) * pp;
}

// Four stages of each ring up to pp = 64; at pp = 128 the rows leave room
// for three of the columns' and two of u^T's (its stage is used last in a
// tile and released last).
__host__ __device__ constexpr int col_stages(int pp) {
  return pp < 128 ? 4 : 3;
}
__host__ __device__ constexpr int u_stages(int pp) {
  return pp < 128 ? 4 : 2;
}

// 1024 bytes of slack to align the swizzled operands; each stage's norms
// sit after the rings (col_stage_bytes' last term); two barriers a stage.
__host__ __device__ constexpr size_t smem_bytes(int pp) {
  return 1024 + rows_bytes(pp) + col_stages(pp) * col_stage_bytes(pp) +
         u_stages(pp) * u_stage_bytes(pp) +
         2 * sizeof(uint64_t) * (col_stages(pp) + u_stages(pp));
}
static_assert(smem_bytes(32) <= kSmemLimit && smem_bytes(64) <= kSmemLimit &&
                  smem_bytes(128) <= kSmemLimit,
              "the wgmma tile's rings exceed one block's shared memory");

bool geom(int m, int n, int p, Geom& g) {
  if (m < 1 || n < 1 || p < 1 || p > kMaxP) return false;
  g.pp = p <= 32 ? 32 : p <= 64 ? 64 : 128;
  g.n_pad = round_up(n, 32);
  g.m_pad = round_up(m, 32);
  g.smem = smem_bytes(g.pp);
  return true;
}

size_t prep_floats(const Geom& g) {
  return static_cast<size_t>(g.n_pad) * (5 * g.pp + 1) +
         static_cast<size_t>(g.m_pad) * (g.pp + 1);
}

Ptrs prep_ptrs(float* base, const Geom& g, bool shared_rows) {
  const size_t cols = static_cast<size_t>(g.n_pad) * g.pp;
  Ptrs q;
  q.colsc = base;
  q.tb = q.colsc + cols;
  q.ts = q.tb + cols;
  q.ub = q.ts + cols;
  q.us = q.ub + cols;
  q.rsq_j = q.us + cols;
  float* rows = q.rsq_j + g.n_pad;
  q.rowsc = shared_rows ? q.colsc : rows;
  q.rsq_i = shared_rows ? q.rsq_j : rows + static_cast<size_t>(g.m_pad) * g.pp;
  return q;
}

// ------------------------------------------------------------- the prep

// Grid (column blocks of 32, then row blocks of 32; k-chunks of 32). A
// column block splits its [32, 32] piece of the centred columns and of u,
// and writes u's piece transposed, coalesced along the columns; the norms
// come from the k-chunk 0 blocks, each warp summing whole rows.
__global__ void __launch_bounds__(kPrepThreads)
    tile_prep_kernel(TileArgs a, Geom g, Ptrs q, int rows_too) {
  __shared__ float u_sm[kPrepCols][kPrepCols + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pp = g.pp;
  const int col_blocks = g.n_pad / kPrepCols;
  constexpr int kRowsAWarp = kPrepCols / (kPrepThreads / 32);
  auto centred = [&](const float* src, int i, int lim, int k) {
    if (i >= lim || k >= a.p) return 0.0f;
    const float v = __ldg(src + static_cast<size_t>(i) * a.p + k);
    return a.center != nullptr ? v - __ldg(a.center + k) : v;
  };
  // The norm of row i of src, as the other route's prep sums it.
  auto norm = [&](const float* src, int i, int lim) {
    float sq = 0.0f;
    for (int k = lane; k < pp; k += 32) {
      const float v = centred(src, i, lim, k);
      sq += v * v;
    }
    return warp_sum(sq);
  };
  if (static_cast<int>(blockIdx.x) >= col_blocks) {
    if (!rows_too) return;
    const int i0 = (blockIdx.x - col_blocks) * kPrepCols;
    const int k = blockIdx.y * 32 + lane;
    for (int r = warp * kRowsAWarp; r < (warp + 1) * kRowsAWarp; ++r) {
      const int i = i0 + r;
      if (i >= g.m_pad) break;
      q.rowsc[static_cast<size_t>(i) * pp + k] = centred(a.rows, i, a.m, k);
      if (blockIdx.y == 0) {
        const float sq = norm(a.rows, i, a.m);
        if (lane == 0) q.rsq_i[i] = sq;
      }
    }
    return;
  }
  const int j0 = blockIdx.x * kPrepCols;
  const int k = blockIdx.y * 32 + lane;
  const float h2 = __ldg(a.h2);
  for (int r = warp * kRowsAWarp; r < (warp + 1) * kRowsAWarp; ++r) {
    const int j = j0 + r;
    const float v = centred(a.cols, j, a.n, k);
    const size_t e = static_cast<size_t>(j) * pp + k;
    uint32_t big, small;
    split(v, big, small);
    q.colsc[e] = v;
    q.tb[e] = __uint_as_float(big);
    q.ts[e] = __uint_as_float(small);
    u_sm[r][lane] =
        (j < a.n && k < a.p)
            ? __ldg(a.grads + static_cast<size_t>(j) * a.p + k) - v / h2
            : 0.0f;
    if (blockIdx.y == 0) {
      const float sq = norm(a.cols, j, a.n);
      if (lane == 0) q.rsq_j[j] = sq;
    }
  }
  __syncthreads();
  // u^T: row k, columns j0 .. j0 + 32, each aligned group of 8 permuted.
  const int o = lane & 7;
  const int src = (lane & ~7) + (o < 4 ? 2 * o : 2 * (o - 4) + 1);
  for (int kr = warp * kRowsAWarp; kr < (warp + 1) * kRowsAWarp; ++kr) {
    uint32_t big, small;
    split(u_sm[src][kr], big, small);
    const size_t e =
        static_cast<size_t>(blockIdx.y * 32 + kr) * g.n_pad + j0 + lane;
    q.ub[e] = __uint_as_float(big);
    q.us[e] = __uint_as_float(small);
  }
}

// ------------------------------------------------------------- the tile

// The row block's raw rows in shared memory, pp floats a row, each 16-byte
// group of a row XOR-swizzled by the row's index mod 8: the A fragments'
// loads (8 rows x 4 consecutive k of a warp) meet 32 distinct banks.
__device__ __forceinline__ int row_at(int r, int k, int pp) {
  return r * pp + (k ^ ((r & 7) << 2));
}

template <int PP>
__global__ void __launch_bounds__(kThreads, 1)
    svgd_tile_kernel(const __grid_constant__ CUtensorMap tm_tb,
                     const __grid_constant__ CUtensorMap tm_ts,
                     const __grid_constant__ CUtensorMap tm_ub,
                     const __grid_constant__ CUtensorMap tm_us, TileArgs a,
                     Geom g, Ptrs q) {
  constexpr int NT = kNT, kRuns = PP / 32;
  // Contraction columns a group: two groups at PP = 128 (the registers).
  constexpr int WC = PP > 64 ? PP / 2 : PP;
  // One split part of a tile's columns, and of its u^T (rows of NT floats,
  // 128 bytes, as the columns' runs of 32).
  constexpr uint32_t t_bytes = sizeof(float) * NT * PP;
  constexpr uint32_t u_bytes = sizeof(float) * NT * PP;
  extern __shared__ uint8_t sm_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(sm_raw) + 1023) & ~uintptr_t(1023));
  constexpr int st_n = col_stages(PP), su_n = u_stages(PP);
  // [the rows][st x (tb | ts)][su x (ub | us)][st x NT norms]
  // [st full, st empty, su full, su empty barriers]
  float* rows_sm = reinterpret_cast<float*>(sm);
  uint8_t* t_ring = sm + rows_bytes(PP);
  uint8_t* u_ring = t_ring + st_n * 2 * t_bytes;
  float* rsq_sm = reinterpret_cast<float*>(u_ring + su_n * 2 * u_bytes);
  uint64_t* t_full = reinterpret_cast<uint64_t*>(rsq_sm + st_n * NT);
  uint64_t* t_empty = t_full + st_n;
  uint64_t* u_full = t_empty + st_n;
  uint64_t* u_empty = u_full + su_n;

  const int tiles = g.n_pad / NT;
  const int t_begin = blockIdx.y * tiles / gridDim.y;
  const int count = (blockIdx.y + 1) * tiles / gridDim.y - t_begin;
  // The warp's index through a shuffle, so that the compiler knows it is
  // uniform across the warp: a role branch it cannot prove uniform makes it
  // serialise every wgmma behind it.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < st_n; ++s) {
      mbar_init(&t_full[s], 1);
      mbar_init(&t_empty[s], kConsumerWarps);
    }
    for (int s = 0; s < su_n; ++s) {
      mbar_init(&u_full[s], 1);
      mbar_init(&u_empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // The producer warp: one thread keeps both rings full, a tile's
    // columns, then its u^T.
    if (lane == 0) {
      tma_prefetch_map(&tm_tb);
      tma_prefetch_map(&tm_ts);
      tma_prefetch_map(&tm_ub);
      tma_prefetch_map(&tm_us);
      for (int it = 0; it < count; ++it) {
        const int j0 = (t_begin + it) * NT;
        const int s = it % st_n, u = it % su_n;
        mbar_wait(&t_empty[s], ((it / st_n) & 1) ^ 1);
        uint8_t* ts_ = t_ring + s * 2 * t_bytes;
        mbar_arrive_expect_tx(&t_full[s], 2 * t_bytes + sizeof(float) * NT);
#pragma unroll
        for (int c = 0; c < kRuns; ++c) {
          tma_load_2d(ts_ + c * NT * 128, &tm_tb, 32 * c, j0, &t_full[s]);
          tma_load_2d(ts_ + t_bytes + c * NT * 128, &tm_ts, 32 * c, j0,
                      &t_full[s]);
        }
        tma_load_bytes(rsq_sm + s * NT, q.rsq_j + j0, sizeof(float) * NT,
                       &t_full[s]);
        mbar_wait(&u_empty[u], ((it / su_n) & 1) ^ 1);
        uint8_t* us_ = u_ring + u * 2 * u_bytes;
        mbar_arrive_expect_tx(&u_full[u], 2 * u_bytes);
        tma_load_2d(us_, &tm_ub, j0, 0, &u_full[u]);
        tma_load_2d(us_ + u_bytes, &tm_us, j0, 0, &u_full[u]);
      }
    }
    return;
  }

  // The consumers: warpgroup wg holds rows row0 .. row0 + 64, warp wq its
  // rows 16 wq .. + 16; a thread's A fragment of k-step t is the rows gid
  // and gid + 8 at k = 8 t + tig and 8 t + tig + 4.
  const int wg = warp >> 2, wq = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int m = a.m, n = a.n;
  const int row0 = blockIdx.x * kRows + 64 * wg;
  const int r_lo = row0 + 16 * wq + gid;
  float* my_rows = rows_sm + 64 * wg * PP;
  for (int e = threadIdx.x & 127; e < 16 * PP; e += 128) {
    const int r = e / (PP / 4), k = 4 * (e - r * (PP / 4));
    const int i = row0 + r;
    const float4 v =
        i < m ? __ldg(reinterpret_cast<const float4*>(
                    q.rowsc + static_cast<size_t>(i) * PP + k))
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(my_rows + row_at(r, k, PP)) = v;
  }
  named_sync(1 + wg, 128);
  // The A fragments' addresses: row gid of the warp's 16 at k = 32 c + 8 kk
  // + tig (+ 4); the swizzle touches bits 2-4 of k alone, so a run's 32 c
  // and the row gid + 8 (8 pp) are constant offsets from these 8.
  const float* fr = my_rows + (16 * wq + gid) * PP;
  int off[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    off[q] = (8 * (q >> 1) + 4 * (q & 1) + tig) ^ (gid << 2);

  const float h2 = __ldg(a.h2);
  const float scale = __fdiv_rn(kLog2eHalf, h2);
  const float rsq[2] = {r_lo < m ? __ldg(q.rsq_i + r_lo) : 0.0f,
                        r_lo + 8 < m ? __ldg(q.rsq_i + r_lo + 8) : 0.0f};
  float acc[PP / 2], ks[2] = {0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < PP / 2; ++e) acc[e] = 0.0f;

  // Per tile: S = R T^T by runs of 32 k, each run's 4 k-steps of three
  // products in fresh registers, added in run order; K (then the columns'
  // stage goes back); ku += K U in PP / WC groups of three products a
  // k-step in fresh registers, each added into ku (then u^T's stage goes
  // back). A warpgroup waits for each group of products; the other
  // warpgroup's fill the tensor cores meanwhile.
  for (int it = 0; it < count; ++it) {
    const int s = it % st_n, u = it % su_n;
    mbar_wait(&t_full[s], (it / st_n) & 1);
    const uint8_t* ts_ = t_ring + s * 2 * t_bytes;
    float sv[NT / 2];
#pragma unroll
    for (int c = 0; c < kRuns; ++c) {
      uint32_t fb[4][4], fs[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* lo = fr + 32 * c + off[2 * kk];
        const float* hi = fr + 32 * c + off[2 * kk + 1];
        split(lo[0], fb[kk][0], fs[kk][0]);
        split(lo[8 * PP], fb[kk][1], fs[kk][1]);
        split(hi[0], fb[kk][2], fs[kk][2]);
        split(hi[8 * PP], fb[kk][3], fs[kk][3]);
      }
      float f[NT / 2];
      wgmma_fence();
      fence_regs(f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint8_t* b = ts_ + c * NT * 128 + 32 * kk;
        const uint64_t db = wgmma_desc(b);
        const uint64_t ds = wgmma_desc(b + t_bytes);
        wgmma_tf32<NT>(f, fs[kk], db, kk);
        wgmma_tf32<NT>(f, fb[kk], ds, 1);
        wgmma_tf32<NT>(f, fb[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(f);
#pragma unroll
      for (int e = 0; e < NT / 2; ++e) sv[e] = c == 0 ? f[e] : sv[e] + f[e];
    }
    // K in the accumulator's layout: sv[4 i + e] is row gid + 8 (e / 2),
    // column 8 i + 2 tig + e % 2 of the tile.
    const float* rj = rsq_sm + s * NT;
    const int j0 = (t_begin + it) * NT;
#pragma unroll
    for (int i = 0; i < NT / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * i + 2 * tig + (e & 1);
        const float d = (rsq[e >> 1] + rj[col]) - 2.0f * sv[4 * i + e];
        const float x = a.div_h2 ? (d / h2) * kLog2eHalf : d * scale;
        const float kv = j0 + col < n ? exp2f(x) : 0.0f;
        ks[e >> 1] += kv;
        sv[4 * i + e] = kv;
      }
    }
    mbar_arrive_if(&t_empty[s], lane == 0);
    // ku += K U: contraction slot tig holds column 2 tig, slot tig + 4
    // column 2 tig + 1 (u^T's permutation), so the A fragment is sv's.
    uint32_t kb[NT / 8][4], ksm[NT / 8][4];
#pragma unroll
    for (int i = 0; i < NT / 8; ++i) {
      split(sv[4 * i], kb[i][0], ksm[i][0]);
      split(sv[4 * i + 2], kb[i][1], ksm[i][1]);
      split(sv[4 * i + 1], kb[i][2], ksm[i][2]);
      split(sv[4 * i + 3], kb[i][3], ksm[i][3]);
    }
    mbar_wait(&u_full[u], (it / su_n) & 1);
    const uint8_t* us_ = u_ring + u * 2 * u_bytes;
#pragma unroll
    for (int h = 0; h < PP / WC; ++h) {
      float cf[WC / 2];
      wgmma_fence();
      fence_regs(cf);
#pragma unroll
      for (int i = 0; i < NT / 8; ++i) {
        const uint8_t* b = us_ + h * WC * NT * 4 + 32 * i;
        const uint64_t db = wgmma_desc(b);
        const uint64_t ds = wgmma_desc(b + u_bytes);
        wgmma_tf32<WC>(cf, ksm[i], db, i);
        wgmma_tf32<WC>(cf, kb[i], ds, 1);
        wgmma_tf32<WC>(cf, kb[i], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(cf);
#pragma unroll
      for (int e = 0; e < WC / 2; ++e) acc[h * WC / 2 + e] += cf[e];
    }
    mbar_arrive_if(&u_empty[u], lane == 0);
  }

  float* ku_out = a.part_ku + static_cast<size_t>(blockIdx.y) * m * a.p;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r_lo + 8 * h;
    float v = ks[h];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (i >= m) continue;
#pragma unroll
    for (int c8 = 0; c8 < PP / 8; ++c8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * c8 + 2 * tig + e;
        if (k < a.p)
          ku_out[static_cast<size_t>(i) * a.p + k] = acc[4 * c8 + 2 * h + e];
      }
    }
    if (tig == 0) a.part_ksum[blockIdx.y * m + i] = v;
  }
}

// ------------------------------------------------------------- the host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [outer, inner] f32 array read in [box_outer, box_inner]
// boxes.
bool tensor_map(CUtensorMap* map, const float* base, int inner, int outer,
                int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {sizeof(float) *
                                 static_cast<cuuint64_t>(inner)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps' boxes: a 32-float run of NT columns' split parts, and
// NT columns of all pp rows of u^T's; every row 128 bytes, 128-byte swizzle.
template <int PP>
cudaError_t launch_kernel(const TileArgs& a, const Geom& g, const Ptrs& q,
                          cudaStream_t stream) {
  CUtensorMap tb, ts, ub, us;
  constexpr CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&tb, q.tb, g.pp, g.n_pad, 32, kNT, sw) ||
      !tensor_map(&ts, q.ts, g.pp, g.n_pad, 32, kNT, sw) ||
      !tensor_map(&ub, q.ub, g.n_pad, g.pp, kNT, PP, sw) ||
      !tensor_map(&us, q.us, g.n_pad, g.pp, kNT, PP, sw))
    return cudaErrorInvalidValue;
  const auto kernel = svgd_tile_kernel<PP>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), g.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.m + kRows - 1) / kRows, a.splits);
  kernel<<<grid, kThreads, g.smem, stream>>>(tb, ts, ub, us, a, g, q);
  return cudaGetLastError();
}

}  // namespace wg

// Column shares: one block an SM, so the shares set the waves. The cost of
// s shares is waves x (a share's tiles + ~4 tiles of a block's own start:
// its rows and the rings' first fill); each share also adds an [m, p]
// partial to the reduce, so the fewest shares within 2% of the least cost
// win. At most 16, at most one a tile.
int tile_splits_wg(int m, int n, int p) {
  wg::Geom g;
  if (!wg::geom(m, n, p, g)) return 1;
  const int blocks = (m + wg::kRows - 1) / wg::kRows;
  const int tiles = g.n_pad / wg::kNT;
  const int sms = sm_count();
  long long cost[17] = {};
  long long least = -1;
  for (int s = 1; s <= 16 && s <= tiles; ++s) {
    const long long waves =
        (static_cast<long long>(blocks) * s + sms - 1) / sms;
    cost[s] = waves * ((tiles + s - 1) / s + 4);
    if (least < 0 || cost[s] < least) least = cost[s];
  }
  for (int s = 1; s <= 16 && s <= tiles; ++s)
    if (cost[s] * 100 <= least * 102) return s;
  return 1;
}

long long tile_prep_floats_wg(int m, int n, int p) {
  wg::Geom g;
  return wg::geom(m, n, p, g) ? static_cast<long long>(wg::prep_floats(g))
                              : 0;
}

cudaError_t launch_tile_wg(const TileArgs& a, cudaStream_t stream) {
  wg::Geom g;
  if (!wg::geom(a.m, a.n, a.p, g)) return cudaErrorInvalidValue;
  const bool shared_rows = a.rows == a.cols && a.m == a.n;
  const wg::Ptrs q = wg::prep_ptrs(a.prep, g, shared_rows);
  const dim3 blocks(
      (g.n_pad + (shared_rows ? 0 : g.m_pad)) / wg::kPrepCols, g.pp / 32);
  wg::tile_prep_kernel<<<blocks, wg::kPrepThreads, 0, stream>>>(
      a, g, q, shared_rows ? 0 : 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (g.pp) {
    case 32: err = wg::launch_kernel<32>(a, g, q, stream); break;
    case 64: err = wg::launch_kernel<64>(a, g, q, stream); break;
    default: err = wg::launch_kernel<128>(a, g, q, stream); break;
  }
  if (err != cudaSuccess) return err;
  return launch_tile_reduce(a, stream);
}

}  // namespace stein
