// The streaming SVGD tile, one kernel for B1's step tail, for B3 and for the
// mesh steps (replacing stein_tpu/ops/pallas_svgd.py:_svgd_tile_kernel), on
// Hopper's tensor cores. Three launches:
//
//   tile_prep_kernel    what the JAX wrapper computes before its
//                       pallas_call: the centred columns tc = t - c, the
//                       regrouped operand u = g - tc / h^2 and the row norms
//                       |tc|^2 (and, for a separate row block, the centred
//                       rows and their norms), zero-padded to the tile's
//                       shapes, into one scratch buffer.
//   svgd_tile_kernel    grid (row blocks of 64, column shares, output
//                       chunks). Block (x, s, z) holds rows x*64 .. +64, one
//                       warp per 16 rows, and walks the s-th contiguous share
//                       of the 32-column tiles, which stream through a
//                       two-slot cp.async ring in shared memory. Per tile:
//                       S = R T^T by mma.sync, D = |r|^2 + |t|^2 - 2 S, K =
//                       exp2 of -D/(2 h^2) with the padded columns masked to
//                       0, then ku += K U_z by mma.sync for the block's output
//                       chunk z, and the row sums. K stays in registers: the
//                       m16n8 accumulator of S is reused as the A operand of
//                       the second product (for tf32 m16n8k8 by permuting the
//                       8 contraction indices, 2t -> t and 2t+1 -> t+4, in
//                       both operands; for bf16 m16n8k16 the layouts agree).
//                       Writes the share's partial ku and row sums.
//   tile_reduce_kernel  adds the shares in share order (two calls give
//                       bitwise-equal output), then writes ku and ksum, or
//                       phi = (ku + ksum * (r - c) / h^2) / n_total and, for
//                       B1's clip, one ||phi||^2 partial per block.
//
// Precision. 'f32' (every path's default) runs 3xTF32: each operand x is
// split into big = tf32(x) and small = tf32(x - big), and each product is
// big*small + small*big + big*big with f32 accumulation, which keeps the f32
// tolerance class. The tensor cores truncate as they accumulate, so each
// run of 32 contraction indices is summed in fresh registers and added
// into the running sum by an IEEE add (without it the NN path's n=3000
// trajectory left the f32 class by step 5). 'bf16' (pallas_precision='bf16', B3 only) rounds the
// centred rows and columns for the dot, and K and u for the contraction, to
// bf16 (the JAX kernel's mxu_dtype casts) and runs one m16n8k16 product each;
// the norms, D, K and the row sums stay f32.
//
// Shapes. Rectangular [m, n], any n (the last tile is masked) and any p: p
// is padded to pp = 16 ceil(p / 16) with zeros. Output chunks are at most
// 160 columns (gridDim.z = ceil(pp / 160)), each block repeating the dot.
// Where the block's 64 rows fit shared memory beside the ring (pp <= 400
// or so) they are loaded once; wider rows stream through the ring in
// 128-column chunks beside the columns. Column shares cover the SMs at small
// n (tile_splits). No atomics: the shares go to [splits, m, p] / [splits, m]
// scratch in the layout that B10's tile (svgd_on_d.cu) also writes for
// launch_tile_reduce.
//
// Bounds on the H100 for the 4 m n p FLOP of the two products: f32 on the
// CUDA cores (67 TFLOP/s) 801 us at m = n = 10240, p = 128 and 18.1 us at
// m = n = 1000, p = 303; on the tensor cores 3xTF32 issues three TF32
// products (495 TFLOP/s): 325 us and 7.3 us; bf16 one (989 TFLOP/s): 54 us
// and 1.2 us. The n^2 exp2s take ~25 us at n = 10240. The tile runs two
// blocks of four warps per SM (what the registers and, at p = 128, 101 KB
// of shared memory allow), too few to hide the latency of the ring and of
// the dependent mma.sync chains: it takes several times these bounds
// (PERF.md's kernel table).

#include <cuda_runtime.h>

#include "common.cuh"
#include "svgd_tile.cuh"
#include "tf32_mma.cuh"

namespace stein {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;    // rows per block, 16 per warp
constexpr int kCols = 32;             // columns per tile
constexpr int kChunk = 128;           // dot chunk when the rows stream too
constexpr int kMaxNT = 20;            // output chunk <= 8 * 20 columns
constexpr int kReduceThreads = 256;
constexpr int kPrepWarps = 8;
constexpr size_t kSmemLimit = 232448;
// -log2(e) / 2, rounded to f32 as the JAX kernels' weakly-typed constant.
constexpr float kLog2eHalf = -1.4426950408889634f / 2.0f;

int round_up(int x, int k) { return (x + k - 1) / k * k; }

struct Geom {
  int pp;       // p rounded up to 16, the dot's zero-padded width
  int nt;       // 8-column output tiles of a chunk
  int zc;       // output chunks (gridDim.z)
  int su;       // u's row stride, zc * 8 * nt
  int n_pad;    // columns rounded up to 64
  int m_pad;    // rows rounded up to 64
  int whole;    // the block's rows stay in shared memory
};

struct PrepPtrs {
  float* colsc;   // [n_pad, pp]
  float* u;       // [n_pad, su]
  float* rsq_j;   // [n_pad]
  float* rowsc;   // [m_pad, pp] (colsc when the rows are the columns)
  float* rsq_i;   // [m_pad]
};

size_t smem_whole(int pp, int w) {
  return sizeof(float) *
         (static_cast<size_t>(kRows) * (pp + 4) +
          2 * (static_cast<size_t>(kCols) * (pp + 4) + kCols * (w + 4) + kCols));
}

size_t smem_chunked(int w) {
  return sizeof(float) * 2 *
         (static_cast<size_t>(kRows + kCols) * (kChunk + 4) +
          kCols * (w + 4) + kCols);
}

Geom geom(int m, int n, int p) {
  Geom g;
  g.pp = round_up(p, 16);
  const int pp8 = g.pp / 8;
  g.zc = (pp8 + kMaxNT - 1) / kMaxNT;
  const int need = (pp8 + g.zc - 1) / g.zc;
  g.nt = need <= 4 ? 4 : need <= 8 ? 8 : need <= 12 ? 12 : need <= 16 ? 16 : 20;
  g.su = g.zc * 8 * g.nt;
  g.n_pad = round_up(n, kRows);
  g.m_pad = round_up(m, kRows);
  g.whole = smem_whole(g.pp, 8 * g.nt) <= kSmemLimit;
  return g;
}

size_t tile_smem(const Geom& g) {
  return g.whole ? smem_whole(g.pp, 8 * g.nt) : smem_chunked(8 * g.nt);
}

size_t prep_floats(const Geom& g) {
  return static_cast<size_t>(g.n_pad) * (g.pp + g.su + 1) +
         static_cast<size_t>(g.m_pad) * (g.pp + 1);
}

PrepPtrs prep_ptrs(float* base, const Geom& g, bool shared_rows) {
  PrepPtrs q;
  q.colsc = base;
  q.u = q.colsc + static_cast<size_t>(g.n_pad) * g.pp;
  q.rsq_j = q.u + static_cast<size_t>(g.n_pad) * g.su;
  float* rows = q.rsq_j + g.n_pad;
  q.rowsc = shared_rows ? q.colsc : rows;
  q.rsq_i = shared_rows ? q.rsq_j : rows + static_cast<size_t>(g.m_pad) * g.pp;
  return q;
}

// ------------------------------------------------------------- the prep

// One warp per padded row: the columns (r < n_pad), then the separate rows.
__global__ void __launch_bounds__(32 * kPrepWarps)
    tile_prep_kernel(TileArgs a, Geom g, PrepPtrs q, int rows_too) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kPrepWarps + (threadIdx.x >> 5);
  const bool col = r < g.n_pad;
  if (!col && !(rows_too && r < g.n_pad + g.m_pad)) return;
  const int i = col ? r : r - g.n_pad;
  const int lim = col ? a.n : a.m;
  const float* src = col ? a.cols : a.rows;
  float* dst = col ? q.colsc : q.rowsc;
  auto centred = [&](int k) {
    if (i >= lim || k >= a.p) return 0.0f;
    const float v = __ldg(src + static_cast<size_t>(i) * a.p + k);
    return a.center != nullptr ? v - __ldg(a.center + k) : v;
  };
  float sq = 0.0f;
  for (int k = lane; k < g.pp; k += 32) {
    const float v = centred(k);
    dst[static_cast<size_t>(i) * g.pp + k] = v;
    sq += v * v;
  }
  if (col) {
    const float h2 = __ldg(a.h2);
    for (int k = lane; k < g.su; k += 32) {
      const float v = (i < lim && k < a.p)
                          ? __ldg(a.grads + static_cast<size_t>(i) * a.p + k) -
                                centred(k) / h2
                          : 0.0f;
      q.u[static_cast<size_t>(i) * g.su + k] = v;
    }
  }
  sq = warp_sum(sq);
  if (lane == 0) (col ? q.rsq_j : q.rsq_i)[i] = sq;
}

// ------------------------------------------------------------- the tile

template <int NT, bool BF16>
__global__ void __launch_bounds__(kThreads)
    svgd_tile_kernel(TileArgs a, Geom g, PrepPtrs q) {
  constexpr int kW = 8 * NT;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m = a.m, n = a.n, pp = g.pp, z = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const bool whole = g.whole;
  const int sk = (whole ? pp : kChunk) + 4;   // row stride of a dot chunk
  const int nk = whole ? 1 : (pp + kChunk - 1) / kChunk;
  constexpr int su = kW + 4;
  // Shared memory: [the rows, when whole] then two ring slots, each
  // [the rows' chunk, when not whole][columns' chunk][u tile][|t|^2 tile].
  float* ring = whole ? sm + kRows * sk : sm;
  const int off_tj = whole ? 0 : kRows * sk;
  const int off_u = off_tj + kCols * sk;
  const int off_r = off_u + kCols * su;
  const int slot = off_r + kCols;

  const int tiles = (n + kCols - 1) / kCols;
  const int t_begin = blockIdx.y * tiles / gridDim.y;
  const int t_end = (blockIdx.y + 1) * tiles / gridDim.y;
  const int stages = (t_end - t_begin) * nk;

  // 16-byte copies of a [rows, width] tile (tf32_mma.cuh).
  const auto copy = [](float* dst, int ds, const float* src, int ss,
                       int rows, int width) {
    cp_async_tile<kThreads>(dst, ds, src, ss, rows, width);
  };
  // Stage s = (tile t_begin + s / nk, dot chunk s % nk); u and |t|^2 come
  // with the tile's last chunk, where they are used.
  auto issue = [&](int s) {
    float* base = ring + (s & 1) * slot;
    const int t = t_begin + s / nk, c = s % nk, c0 = c * kChunk;
    const int kw = whole ? pp : min(kChunk, pp - c0);
    const int j0 = t * kCols;
    if (!whole)
      copy(base, sk, q.rowsc + static_cast<size_t>(row0) * pp + c0, pp, kRows,
           kw);
    copy(base + off_tj, sk, q.colsc + static_cast<size_t>(j0) * pp + c0, pp,
         kCols, kw);
    if (c == nk - 1) {
      copy(base + off_u, su, q.u + static_cast<size_t>(j0) * g.su + z * kW,
           g.su, kCols, kW);
      copy(base + off_r, 0, q.rsq_j + j0, 0, 1, kCols);
    }
  };

  if (whole)
    copy(sm, sk, q.rowsc + static_cast<size_t>(row0) * pp, pp, kRows, pp);
  if (stages > 0) issue(0);
  cp_async_commit();

  const float h2 = __ldg(a.h2);
  const float scale = __fdiv_rn(kLog2eHalf, h2);
  const int r_lo = row0 + 16 * warp + gid;
  const float rsq[2] = {__ldg(q.rsq_i + r_lo), __ldg(q.rsq_i + r_lo + 8)};
  float acc[NT][4], s[4][4], ks[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;

  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) issue(st + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* base = ring + (st & 1) * slot;
    const int c = st % nk;
    const int kw = whole ? pp : min(kChunk, pp - c * kChunk);
    dot_chunk<BF16>(s, (whole ? sm : base) + 16 * warp * sk, base + off_tj,
                    sk, kw, gid, tig);
    if (c == nk - 1) {
      const float* rj = base + off_r;
      const int j0 = (t_begin + st / nk) * kCols;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * tig + (e & 1);
          const float d = (rsq[e >> 1] + rj[col]) - 2.0f * s[nt][e];
          const float x = a.div_h2 ? (d / h2) * kLog2eHalf : d * scale;
          const float kv = j0 + col < n ? exp2f(x) : 0.0f;
          ks[e >> 1] += kv;
          s[nt][e] = kv;
        }
      }
      contract<NT, BF16>(acc, s, base + off_u, su, gid, tig);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
    }
    __syncthreads();
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
    for (int qq = 0; qq < NT; ++qq) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = z * kW + 8 * qq + 2 * tig + e;
        if (k < a.p) ku_out[static_cast<size_t>(i) * a.p + k] = acc[qq][2 * h + e];
      }
    }
    if (tig == 0 && z == 0) a.part_ksum[blockIdx.y * m + i] = v;
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

template <int NT, bool BF16>
cudaError_t launch_tile_kernel(const TileArgs& a, const Geom& g,
                               const PrepPtrs& q, cudaStream_t stream) {
  const size_t smem = tile_smem(g);
  cudaError_t err = set_smem(
      reinterpret_cast<const void*>(svgd_tile_kernel<NT, BF16>), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.m_pad / kRows, a.splits, g.zc);
  svgd_tile_kernel<NT, BF16><<<grid, kThreads, smem, stream>>>(a, g, q);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_tile_nt(const TileArgs& a, const Geom& g,
                           const PrepPtrs& q, cudaStream_t stream) {
  switch (g.nt) {
    case 4: return launch_tile_kernel<4, BF16>(a, g, q, stream);
    case 8: return launch_tile_kernel<8, BF16>(a, g, q, stream);
    case 12: return launch_tile_kernel<12, BF16>(a, g, q, stream);
    case 16: return launch_tile_kernel<16, BF16>(a, g, q, stream);
    default: return launch_tile_kernel<kMaxNT, BF16>(a, g, q, stream);
  }
}

}  // namespace

// Column shares: the fewest that fill the resident block slots' waves to
// 90% (two blocks an SM where the shared memory allows, as the registers
// do), else the best filling, at most 16 and at most one per tile.
int tile_splits(int m, int n, int p) {
  const Geom g = geom(m, n, p);
  const int blocks = (g.m_pad / kRows) * g.zc;
  const int tiles = (n + kCols - 1) / kCols;
  const int sms = sm_count() * (2 * tile_smem(g) <= kSmemLimit ? 2 : 1);
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= 16 && s <= tiles; ++s) {
    const int b = blocks * s;
    const double fill = static_cast<double>(b) / (((b + sms - 1) / sms) * sms);
    if (fill >= 0.9) return s;
    if (fill > best_fill) {
      best_fill = fill;
      best = s;
    }
  }
  return best;
}

long long tile_prep_floats(int m, int n, int p) {
  return static_cast<long long>(prep_floats(geom(m, n, p)));
}

int tile_reduce_blocks(int m, int p) {
  return static_cast<int>(
      (static_cast<size_t>(m) * p + kReduceThreads - 1) / kReduceThreads);
}

cudaError_t launch_tile(const TileArgs& a, cudaStream_t stream) {
  if (a.splits < 1 || a.prep == nullptr) return cudaErrorInvalidValue;
  const Geom g = geom(a.m, a.n, a.p);
  const bool shared_rows = a.rows == a.cols && a.m == a.n;
  const PrepPtrs q = prep_ptrs(a.prep, g, shared_rows);
  const int warps = g.n_pad + (shared_rows ? 0 : g.m_pad);
  tile_prep_kernel<<<(warps + kPrepWarps - 1) / kPrepWarps, 32 * kPrepWarps,
                     0, stream>>>(a, g, q, shared_rows ? 0 : 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = a.bf16 ? launch_tile_nt<true>(a, g, q, stream)
               : launch_tile_nt<false>(a, g, q, stream);
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

long long stein_tile_prep_floats(int m, int n, int p) {
  return tile_prep_floats(m, n, p);
}

// B3. rows [m, p]; cols, grads [n, p]; center [p] or null; h2 a device
// scalar; bf16 selects pallas_precision='bf16'; div_h2 the exponent order
// (TileArgs.div_h2: B3's is 1, B1's 0). Scratch part_ku [splits * m * p],
// part_ksum [splits * m], prep [stein_tile_prep_floats(m, n, p)]. Writes ku
// [m, p] and ksum [m] when phi is null, else phi [m, p] (divided by
// n_total).
int stein_svgd_tile(const float* rows, const float* cols, const float* grads,
                    const float* center, const float* h2, int m, int n,
                    int p, int splits, float* part_ku, float* part_ksum,
                    float* ku, float* ksum, float* phi, float n_total,
                    int bf16, int div_h2, float* prep, void* stream) {
  const TileArgs a{rows, cols, grads, center, h2, m, n, p, div_h2 != 0,
                   splits, part_ku, part_ksum, n_total, ku, ksum, phi,
                   nullptr, prep, bf16 != 0};
  return launch_tile(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
