// B11, the symmetric-traversal SVGD tile (replacing
// stein_tpu/ops/pallas_svgd.py:_svgd_sym_tile_kernel), on Hopper's tensor
// cores. For [n, p] particles theta (t) and gradients g:
//
//   D   = |t_i|^2 + |t_j|^2 - 2 t_i t_j^T          (uncentred, as B11 is)
//   K   = exp2((D / h^2) * (-log2e/2)),            rows and columns >= n masked
//   phi = (K @ u + ksum t / h^2) / n,   u = g - t / h^2,   ksum = rowsum K
//
// This is the JAX kernel's phi regrouped as B3's prep groups it: one
// contraction p wide, where the JAX kernel carries K @ [g | t], 2p wide.
// Only the 128 x 128 tiles (I, J), J >= I, are formed. Tile (I, J) gives
// row block I its row side K @ u_J with the row sums, and, for J > I, row
// block J its column side K^T @ u_I with the column sums (K_JI = K_IJ^T).
// Two launches:
//
//   sym_prep_kernel   theta zero-padded to [n_pad, pp], the norms |t|^2, u
//                     zero-padded to [n_pad, zc * W] (output groups of W
//                     columns); zeroes the counters below.
//   sym_tile_kernel   one persistent launch of 8-warp blocks, one an SM.
//                     A block takes work units from a ticket counter
//                     (atomicAdd) in a fixed order (unit_of), and takes the
//                     next only when its unit is done. A unit is a run of
//                     tiles (I, J0 .. J1 - 1) of one tile row and one output
//                     group. The block holds the 128 rows of I (theta_I,
//                     where it fits, and u_I) in shared memory and streams
//                     the run's columns in chunks of 32 through a two-slot
//                     cp.async ring. Per chunk, warp w forms S = t_I t_J^T
//                     for its 16 rows by mma.sync 3xTF32, then D and K; the
//                     row side K @ u_J and the row sums stay in registers for
//                     the whole unit (K is the A operand straight from the
//                     accumulator registers, B3's permutation). Off the
//                     diagonal, K is stored transposed into shared memory
//                     and warp w forms the column side K^T @ u_I of one
//                     slice of the chunk (16 columns by a quarter of the
//                     output) by mma.sync 3xTF32; the warps of the first
//                     quarter also form the column sums, as the product
//                     with a column of ones.
//
// The order. Tile rows are taken in panels of 8; a panel's rows are cut
// into runs of L tiles at the multiples of L (L = 4; 2 in the last panel
// but one, 1 in the last, which shortens the tail), so that a panel's rows
// walk the same columns in step. Units are numbered panel by panel, in a
// panel run by run, in a run row by row, output group fastest.
//
// Fixed order of adds, no partial scratch. Each slice (16 rows by a quarter
// of an output group; the row sums go with the first quarter) of row block R
// takes R + U_R contributions in slot order: the column sides of tiles
// (0, R) .. (R - 1, R) (slot I), then the row sides of R's U_R units in J
// order (slot R + u). Each is added into an [n_pad, W] accumulator (and an
// [n_pad] row-sum column) in device memory, 5.3 MB at n = 10240, p = 128,
// which stays in L2. A counter per slice orders the adds: the warp that
// holds a contribution waits (ld.acquire.gpu) until the counter reaches its
// slot, adds (slot 0 stores), and releases the next slot (st.release.gpu).
// The last contribution of a row, the row side of its last unit, does not
// store the sums: it writes phi. Two calls give bitwise-equal phi, whatever
// block takes whatever unit; there are no float atomics.
//
// No deadlock. Every wait is on a contribution of a unit with a smaller
// ticket. The column side of (I, J) waits for that of (I - 1, J): row I - 1
// lies in an earlier panel, or in the same one at the same run, which takes
// it before row I. The row side of unit (R, u) waits for the column sides
// of (I, R), I < R, which lie in earlier panels or at run R / L of the same
// panel (no later than unit (R, u)'s run, and before row R there), and for
// unit (R, u - 1), one run earlier. A block takes a ticket only while it
// runs and keeps running until its unit is done, so every unit with a
// smaller ticket is done or held by a running block, and the unit with the
// smallest ticket not done waits on nothing. This holds at any grid size (a
// grid of one block runs the units in ticket order).
//
// The unit lengths set the order in which a row's sides are added (a
// unit's row side is one register sum), so they are constants of the
// design, not knobs; the grid size is free (the wrapper's SYM_BLOCKS).
//
// Precision. 3xTF32 as in tf32_mma.cuh: every product sums each run of at
// most 32 contraction indices in fresh registers and adds it by an IEEE add.
// Integer particles of at most 11 bits are exact in tf32, so D is exact on
// them.
//
// Shapes. Any n (the last tile is masked) and any p: the dot's width is
// padded to pp = 16 ceil(p / 16), the contraction's to output groups of W =
// 8 NT <= 128 columns (zc = ceil(p / 128) groups; S is formed once per
// group). Where theta_I does not fit beside the ring (pp > 144 at W = 128)
// it streams through the ring in 64-column chunks with the columns.
//
// Bounds on the H100 at n = 10240, p = 128. The upper tiles' n^2 / 2 pairs
// take p multiply-adds for D and p for each side of K @ u: 3 n^2 p = 40.3
// GFLOP, on the tensor cores as three TF32 products each (3xTF32): 244 us at
// 495 TFLOP/s (601.76 us as f32 on the CUDA cores), plus n^2 / 2
// exponentials. The inputs and phi (16 MB) are nothing beside it: bound by
// operations. What holds the kernel above it: eight warps an SM (the
// registers of a unit's row side and 220 KB of shared memory allow one
// block) do not hide the latency of the mma.sync chains, the operand splits
// and the three block barriers of a chunk; the slices' waits for their
// slot; and the tail, where the last rows' units wait for the column sides
// of the rows above.

#include <cuda_runtime.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace stein {
namespace {

constexpr int kTile = 128;          // rows = columns of a tile
constexpr int kWarps = 8;           // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;           // columns of a streamed chunk
constexpr int kChunks = kTile / kCols;
constexpr int kChunk = 64;          // dot chunk when theta_I streams too
constexpr int kUnit = 4;            // tiles of a unit (2, 1 in the last panels)
constexpr int kPanel = 8;           // tile rows of a panel, a multiple of kUnit
constexpr int kMaxNT = 16;          // output group <= 8 * 16 columns
constexpr int kSlices = 8;          // of a 32-row group: 2 halves x 4 quarters
constexpr int kKts = kTile + 4;     // row stride of K^T in shared memory
constexpr int kPrepWarps = 8;
constexpr size_t kSmemLimit = 232448 - 16;   // beside the ticket slot
// -log2(e) / 2, rounded to f32 as the JAX kernels' weakly-typed constant.
constexpr float kLog2eHalf = -1.4426950408889634f / 2.0f;

int round_up(int x, int k) { return (x + k - 1) / k * k; }

// The unit length L of the panel from tile row r0 (the header's order).
__host__ __device__ __forceinline__ int unit_len(int r0, int T) {
  const int left = T - r0;
  return left > 2 * kPanel ? kUnit : left > kPanel ? 2 : 1;
}

__host__ __device__ __forceinline__ int units_of_row(int R, int T) {
  const int L = unit_len(R / kPanel * kPanel, T);
  return (T + L - 1) / L - R / L;
}

struct Geom {
  int T;        // tiles per side
  int n_pad;    // T * kTile
  int pp;       // p rounded up to 16, the dot's zero-padded width
  int nt;       // 8-column tiles of an output group (4, 8, 12 or 16)
  int zc;       // output groups
  int su;       // u's row stride, zc * 8 * nt
  int whole;    // theta_I stays in shared memory for the unit
  int units;    // work units of one output group
};

struct SymArgs {
  const float* theta;   // [n, p]
  const float* grads;   // [n, p]
  const float* h2;      // device scalar
  int n, p;
  float* tp;            // [n_pad, pp] theta, zero-padded
  float* u;             // [n_pad, su] g - theta / h^2, zero-padded
  float* rsq;           // [n_pad] |theta|^2
  float* acc;           // [zc, n_pad, 8 nt] the sides' running sums
  float* ksum;          // [zc, n_pad] the row sums' running sums
  int* cnt;             // [zc, T * kChunks, kSlices] slots taken per slice
                        // of a 32-row group, then the ticket
  float* phi;           // [n, p]
};

size_t smem_bytes(int pp, int nt, bool whole) {
  const size_t sk = (whole ? pp : kChunk) + 4, su = 8 * nt + 4;
  const size_t slot = (whole ? 0 : kTile * sk) + kCols * (sk + su + 1);
  return sizeof(float) *
         ((whole ? kTile * sk : 0) + kTile * su + kCols * kKts + 2 * slot);
}

Geom geom(int n, int p) {
  Geom g;
  g.T = (n + kTile - 1) / kTile;
  g.n_pad = g.T * kTile;
  g.pp = round_up(p, 16);
  const int p8 = (p + 7) / 8;
  g.zc = (p8 + kMaxNT - 1) / kMaxNT;
  g.nt = round_up((p8 + g.zc - 1) / g.zc, 4);
  g.su = g.zc * 8 * g.nt;
  g.whole = smem_bytes(g.pp, g.nt, true) <= kSmemLimit;
  g.units = 0;
  for (int R = 0; R < g.T; ++R) g.units += units_of_row(R, g.T);
  return g;
}

size_t scratch_floats(const Geom& g) {
  const size_t np = g.n_pad;
  return np * (g.pp + g.su + 1) + g.zc * np * (8 * g.nt + 1) +
         round_up(g.zc * g.T * kChunks * kSlices + 1, 4);
}

SymArgs carve(const Geom& g, float* s) {
  SymArgs a{};
  const size_t np = g.n_pad;
  a.tp = s;
  a.u = a.tp + np * g.pp;
  a.rsq = a.u + np * g.su;
  a.acc = a.rsq + np;
  a.ksum = a.acc + g.zc * np * 8 * g.nt;
  a.cnt = reinterpret_cast<int*>(a.ksum + g.zc * np);
  return a;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Lane 0 waits until each of the n slices from cnt has taken `slot`
// contributions; then the warp reads their sums.
__device__ __forceinline__ void warp_wait(const int* cnt, int n, int slot) {
  if ((threadIdx.x & 31) == 0)
    for (int i = 0; i < n; ++i)
      while (ld_acquire(cnt + i) < slot) __nanosleep(32);
  __syncwarp();
}

// The warp's adds to the n slices are done: their next slot may go. The
// warp barrier orders every lane's stores before lane 0's release, whose
// release semantics carry them (no further fence).
__device__ __forceinline__ void warp_release(int* cnt, int n, int next) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    for (int i = 0; i < n; ++i) st_release(cnt + i, next);
}

// Work unit k of an output group: tile row R, its u-th unit, tiles J0 ..
// J1 - 1. The units are taken panel by panel; in a panel run by run, in a
// run row by row. Every wait is then on a smaller ticket (the header's
// argument).
__device__ __forceinline__ void unit_of(int k, int T, int& R, int& u,
                                        int& J0, int& J1) {
  int r0 = 0;
  for (;; r0 += kPanel) {
    const int r1 = min(r0 + kPanel, T);
    int in_panel = 0;
    for (int r = r0; r < r1; ++r) in_panel += units_of_row(r, T);
    if (k < in_panel) break;
    k -= in_panel;
  }
  const int r1 = min(r0 + kPanel, T), L = unit_len(r0, T);
  // Run b holds the panel's rows R with R / L <= b.
  int b = r0 / L;
  for (int rows = min(r1, (b + 1) * L) - r0; k >= rows;
       rows = min(r1, (b + 1) * L) - r0) {
    k -= rows;
    ++b;
  }
  R = r0 + k;
  u = b - R / L;
  J0 = u == 0 ? R : b * L;
  J1 = min((b + 1) * L, T);
}

// ------------------------------------------------------------- the prep

// One warp per padded row; block 0 also zeroes the counters and the ticket.
__global__ void __launch_bounds__(32 * kPrepWarps)
    sym_prep_kernel(SymArgs a, Geom g) {
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i <= g.zc * g.T * kChunks * kSlices;
         i += blockDim.x)
      a.cnt[i] = 0;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kPrepWarps + (threadIdx.x >> 5);
  if (r >= g.n_pad) return;
  const bool in = r < a.n;
  const float* t = a.theta + static_cast<size_t>(r) * a.p;
  float sq = 0.0f;
  for (int k = lane; k < g.pp; k += 32) {
    const float v = in && k < a.p ? __ldg(t + k) : 0.0f;
    a.tp[static_cast<size_t>(r) * g.pp + k] = v;
    sq += v * v;
  }
  const float h2 = __ldg(a.h2);
  for (int k = lane; k < g.su; k += 32)
    a.u[static_cast<size_t>(r) * g.su + k] =
        in && k < a.p
            ? __ldg(a.grads + static_cast<size_t>(r) * a.p + k) -
                  __ldg(t + k) / h2
            : 0.0f;
  sq = warp_sum(sq);
  if (lane == 0) a.rsq[r] = sq;
}

// ------------------------------------------------------------- the tile

// The column side of a chunk: c[q] += K^T[16 columns j, 128 rows i]
// U_I[128 rows i, 8 q + (0..8)], with kt the chunk's K^T from the warp's
// first column (row stride kKts) and ui the rows' u from the warp's first
// output column (row stride su); with `sums`, also the column sums as the
// product with a column of ones (sum[0] for column gid, sum[2] for gid + 8).
// Runs of 32 rows in fresh registers.
template <int NQ>
__device__ __forceinline__ void contract_t(float (&c)[NQ][4],
                                           float (&sum)[4], bool sums,
                                           const float* kt, const float* ui,
                                           int su, int gid, int tig) {
  const uint32_t one[2] = {0x3f800000u, 0x3f800000u};   // 1.0f, exact
  const float* a_lo = kt + gid * kKts;
  const float* a_hi = a_lo + 8 * kKts;
  for (int k1 = 0; k1 < kTile; k1 += 32) {
    float t[NQ][4] = {}, t1[4] = {};
#pragma unroll
    for (int k0 = k1; k0 < k1 + 32; k0 += 8) {
      const int k = k0 + tig;
      uint32_t ab[4], as[4], bb[NQ][2], bs[NQ][2];
      split(a_lo[k], ab[0], as[0]);
      split(a_hi[k], ab[1], as[1]);
      split(a_lo[k + 4], ab[2], as[2]);
      split(a_hi[k + 4], ab[3], as[3]);
      const float* u0 = ui + k * su + gid;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        split(u0[8 * q], bb[q][0], bs[q][0]);
        split(u0[4 * su + 8 * q], bb[q][1], bs[q][1]);
      }
      mma_3xtf32<NQ>(t, ab, as, bb, bs);
      if (sums) {
        mma_tf32(t1, as, one);
        mma_tf32(t1, ab, one);
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[q][e] += t[q][e];
    if (sums)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] += t1[e];
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    sym_tile_kernel(SymArgs a, Geom g) {
  constexpr int kW = 8 * NT, su = kW + 4, NQ = NT / 4;
  extern __shared__ float4 sm4[];
  __shared__ int ticket;
  float* sm = reinterpret_cast<float*>(sm4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n = a.n, p = a.p, pp = g.pp, T = g.T;
  const bool whole = g.whole;
  const int sk = (whole ? pp : kChunk) + 4;   // row stride of a dot chunk
  const int nk = whole ? 1 : (pp + kChunk - 1) / kChunk;
  // Shared memory: [theta_I, when whole][u_I][K^T of a chunk], then two
  // ring slots, each [theta_I's chunk, when not whole][theta_J's chunk]
  // [u_J's chunk][|t_J|^2].
  float* th_i = sm;
  float* u_i = th_i + (whole ? kTile * sk : 0);
  float* kt = u_i + kTile * su;
  float* ring = kt + kCols * kKts;
  const int off_tj = whole ? 0 : kTile * sk;
  const int off_u = off_tj + kCols * sk;
  const int off_r = off_u + kCols * su;
  const int slot = off_r + kCols;
  const int tickets = g.units * g.zc;
  int* const ticket_ctr = a.cnt + g.zc * T * kChunks * kSlices;
  const float h2 = __ldg(a.h2);
  const int r_lo = 16 * warp + gid;   // this thread's rows r_lo, r_lo + 8
  // The column side's slice of a chunk: its 16 columns 16 mt .. and output
  // tiles qg NQ .. + NQ; the warps with qg = 0 also take the column sums.
  const int mt = warp & 1, qg = warp >> 1, q0 = qg * NQ;

  // 16-byte copies of a [rows, width] tile (tf32_mma.cuh).
  const auto copy = [](float* dst, int ds, const float* src, int ss,
                       int rows, int width) {
    cp_async_tile<kThreads>(dst, ds, src, ss, rows, width);
  };

  for (;;) {
    if (threadIdx.x == 0) ticket = atomicAdd(ticket_ctr, 1);
    __syncthreads();   // also: the last unit's reads of shared memory are done
    const int tk = ticket;
    if (tk >= tickets) break;
    const int z = tk % g.zc;
    int R, uu, J0, J1;
    unit_of(tk / g.zc, T, R, uu, J0, J1);
    const int units_r = units_of_row(R, T);
    const int i0 = R * kTile;
    float* acc_z = a.acc + static_cast<size_t>(z) * g.n_pad * kW;
    float* ks_z = a.ksum + static_cast<size_t>(z) * g.n_pad;
    int* cnt_z = a.cnt + z * T * kChunks * kSlices;
    const float* u_z = a.u + z * kW;
    const int stages = (J1 - J0) * kChunks * nk;

    // Stage s = (chunk s / nk of the unit's columns, dot chunk s % nk); u
    // and |t|^2 come with the chunk's last stage, where they are used.
    auto issue = [&](int s) {
      float* base = ring + (s & 1) * slot;
      const int c = s / nk, kc = s % nk, c0 = kc * kChunk;
      const int kw = whole ? pp : min(kChunk, pp - c0);
      const int j0 = J0 * kTile + c * kCols;
      if (!whole)
        copy(base, sk, a.tp + static_cast<size_t>(i0) * pp + c0, pp, kTile,
             kw);
      copy(base + off_tj, sk, a.tp + static_cast<size_t>(j0) * pp + c0, pp,
           kCols, kw);
      if (kc == nk - 1) {
        copy(base + off_u, su, u_z + static_cast<size_t>(j0) * g.su, g.su,
             kCols, kW);
        copy(base + off_r, 0, a.rsq + j0, 0, 1, kCols);
      }
    };

    if (whole)
      copy(th_i, sk, a.tp + static_cast<size_t>(i0) * pp, pp, kTile, pp);
    copy(u_i, su, u_z + static_cast<size_t>(i0) * g.su, g.su, kTile, kW);
    issue(0);
    cp_async_commit();

    const float rsq[2] = {__ldg(a.rsq + i0 + r_lo),
                          __ldg(a.rsq + i0 + r_lo + 8)};
    const bool row_in[2] = {i0 + r_lo < n, i0 + r_lo + 8 < n};
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
      const int c = st / nk, kc = st % nk;
      const int J = J0 + c / kChunks, cq = c % kChunks;
      const int j0 = J * kTile + cq * kCols;
      const bool upper = J > R;
      const int kw = whole ? pp : min(kChunk, pp - kc * kChunk);
      dot_chunk<false>(s, (whole ? th_i : base) + 16 * warp * sk,
                       base + off_tj, sk, kw, gid, tig);
      if (kc == nk - 1) {
        const float* rj = base + off_r;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * nt + 2 * tig + (e & 1);
            const float d = (rsq[e >> 1] + rj[col]) - 2.0f * s[nt][e];
            const float kv = row_in[e >> 1] && j0 + col < n
                                 ? exp2f((d / h2) * kLog2eHalf)
                                 : 0.0f;
            ks[e >> 1] += kv;
            s[nt][e] = kv;
            if (upper) kt[col * kKts + r_lo + 8 * (e >> 1)] = kv;
          }
        }
        contract<NT, false>(acc, s, base + off_u, su, gid, tig);
        if (upper) {
          __syncthreads();
          float cs[NQ][4], csum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int q = 0; q < NQ; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) cs[q][e] = 0.0f;
          contract_t<NQ>(cs, csum, qg == 0, kt + 16 * mt * kKts,
                         u_i + 8 * q0, su, gid, tig);
          // Slot R of the slice (slot 0 stores): every old sum is read
          // before the first store, so that the reads overlap.
          const bool first = R == 0;
          int* slice = cnt_z + (J * kChunks + cq) * kSlices + mt * 4 + qg;
          float2* dst[2][NQ];
          float2 old[2][NQ];
          float oks[2] = {0.0f, 0.0f};
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              dst[h][q] = reinterpret_cast<float2*>(
                  acc_z +
                  static_cast<size_t>(j0 + 16 * mt + gid + 8 * h) * kW +
                  8 * (q0 + q) + 2 * tig);
          if (!first) {
            warp_wait(slice, 1, R);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int q = 0; q < NQ; ++q) old[h][q] = __ldcg(dst[h][q]);
              if (qg == 0) oks[h] = __ldcg(ks_z + j0 + 16 * mt + gid + 8 * h);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              float2 v = make_float2(cs[q][2 * h], cs[q][2 * h + 1]);
              if (!first)
                v = make_float2(old[h][q].x + v.x, old[h][q].y + v.y);
              __stcg(dst[h][q], v);
            }
            if (qg == 0 && tig == 0)
              __stcg(ks_z + j0 + 16 * mt + gid + 8 * h,
                     first ? csum[2 * h] : oks[h] + csum[2 * h]);
          }
          warp_release(slice, 1, R + 1);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
      }
      __syncthreads();
    }

    // The row side: slot R + uu of row block R; the row's last unit writes
    // phi instead of the sums.
    const int slot_r = R + uu;
    const bool first = slot_r == 0, last = uu == units_r - 1;
    // This warp's 16 rows: the four slices (R, warp / 2, warp % 2, *).
    int* rows = cnt_z + (R * kChunks + (warp >> 1)) * kSlices + mt * 4;
    if (!first) warp_wait(rows, 4, slot_r);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float k = ks[h];
      k += __shfl_xor_sync(0xffffffffu, k, 1);
      k += __shfl_xor_sync(0xffffffffu, k, 2);
      const int i = i0 + r_lo + 8 * h;
      if (!first) k = __ldcg(ks_z + i) + k;
      float2 v[NT];
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        v[q] = make_float2(acc[q][2 * h], acc[q][2 * h + 1]);
        if (!first) {
          const float2 o = __ldcg(reinterpret_cast<const float2*>(
              acc_z + static_cast<size_t>(i) * kW + 8 * q + 2 * tig));
          v[q] = make_float2(o.x + v[q].x, o.y + v[q].y);
        }
      }
      if (!last) {
#pragma unroll
        for (int q = 0; q < NT; ++q)
          __stcg(reinterpret_cast<float2*>(
                     acc_z + static_cast<size_t>(i) * kW + 8 * q + 2 * tig),
                 v[q]);
        if (tig == 0) __stcg(ks_z + i, k);
      } else if (i < n) {
        const size_t row = static_cast<size_t>(i) * p;
#pragma unroll
        for (int q = 0; q < NT; ++q) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = z * kW + 8 * q + 2 * tig + e;
            const float ku = e == 0 ? v[q].x : v[q].y;
            if (col < p)
              a.phi[row + col] =
                  (ku + k * __ldg(a.theta + row + col) / h2) /
                  static_cast<float>(n);
          }
        }
      }
    }
    if (!last) warp_release(rows, 4, slot_r + 1);
  }
}

template <int NT>
cudaError_t launch_tile(const SymArgs& a, const Geom& g, int blocks,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes(g.pp, g.nt, g.whole);
  const void* kernel = reinterpret_cast<const void*>(sym_tile_kernel<NT>);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (blocks <= 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    blocks = sm_count() * (per_sm > 0 ? per_sm : 1);
  }
  if (blocks > g.units * g.zc) blocks = g.units * g.zc;
  sym_tile_kernel<NT><<<blocks, kThreads, smem, stream>>>(a, g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

// Scratch floats of B11 at n, p: the padded operands, the running sums and
// the counters, O(n p).
long long stein_sym_scratch_floats(int n, int p) {
  return static_cast<long long>(scratch_floats(geom(n, p)));
}

// B11. theta, grads [n, p]; h2 a device scalar; scratch
// [stein_sym_scratch_floats(n, p)]; blocks the persistent grid (0: as many
// as are resident on the card; phi does not depend on it). Writes phi
// [n, p].
int stein_svgd_sym(const float* theta, const float* grads, const float* h2,
                   int n, int p, int blocks, float* scratch, float* phi,
                   void* stream_ptr) {
  if (n < 1 || p < 1) return cudaSuccess;   // phi has no entry
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Geom g = geom(n, p);
  SymArgs a = carve(g, scratch);
  a.theta = theta;
  a.grads = grads;
  a.h2 = h2;
  a.n = n;
  a.p = p;
  a.phi = phi;
  sym_prep_kernel<<<(g.n_pad + kPrepWarps - 1) / kPrepWarps,
                    32 * kPrepWarps, 0, stream>>>(a, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (g.nt) {
    case 4: return launch_tile<4>(a, g, blocks, stream);
    case 8: return launch_tile<8>(a, g, blocks, stream);
    case 12: return launch_tile<12>(a, g, blocks, stream);
    default: return launch_tile<kMaxNT>(a, g, blocks, stream);
  }
}

}  // extern "C"
