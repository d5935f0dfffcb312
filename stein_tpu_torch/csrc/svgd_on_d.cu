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
// z) holds rows x*64 .. +64 (16 a warp), walks the s-th contiguous share of
// the 32-column tiles of D and owns the output columns of chunk z (at most
// 64); it writes its share's partial sums, and launch_tile_reduce adds the
// shares in share order, so two calls give bitwise-equal output.
//
// Per tile, on the tensor cores: each thread loads the D entries of its
// m16n8 accumulator-layout fragment (two columns of a row as one float2)
// and takes exp2 of them, the padded columns masked to 0, so K lands in
// registers already in the layout contract() (tf32_mma.cuh) takes as the A
// operand of mma.sync m16n8k8; the row sums come from the same registers.
// The tile's 32 rows of u stream through a cp.async ring (kSlots tiles, two
// in flight) as the B operand, split into big and small tf32 parts as they
// are read (3xTF32, each 32-column tile summed in fresh registers).
//
// u is given (B10), or formed once on the card by a prep launch, into
// scratch the tile then reads like a given u: u = g - theta / h^2 with
// theta uncentred (B1's D-given tail, step_impl='fused', whose reduce then
// forms phi with tc = theta), or u = g - (theta - c) / h^2 about a given
// centre (B12's whole-D tail, on the median kernel's centred D; B3's wide
// route, svgd_wide.cu, on its own). Formed in
// the tile, every row block and output chunk recomputed it. The exponent's operation order follows the
// caller's JAX function: (D * (-log2e/2)) / h^2 for B10, D * (-log2e/2 /
// h^2) for B1's and B12's tails, (D / h^2) * (-log2e/2) for B3's.
//
// Bounds on the H100: 2 m n p multiply-adds, three TF32 products each on
// the tensor cores: at n = 1000, p = 128, 0.77 GFLOP (1.6 us at 495
// TFLOP/s) against 4.6 MB of D, u and the outputs (1.4 us at 3.35 TB/s);
// at p = 303 (B12) 1.8 GFLOP, 3.7 us. What holds it back is latency: the
// loads of D and u and the dependent mma.sync chains, which one warp per
// scheduler cannot cover. So each block owns at most 64 output columns
// (few registers: four blocks of four warps fit an SM, each recomputing K
// for its chunk, a few exp2 a row), the grid is split into column shares
// until it fills those block slots in one wave (at n = 1000: p = 128, 16
// row blocks x 2 chunks x 16 shares; p = 303, 16 x 5 x 6), and each
// block's next two u tiles are in flight while it contracts the current
// one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "svgd_tile.cuh"
#include "tf32_mma.cuh"

namespace stein {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // rows per block, 16 per warp
constexpr int kCols = 32;            // columns of D (rows of u) per tile
constexpr int kNT = 8;               // output chunk: 8 * 8 columns
constexpr int kSlots = 3;            // u tiles in the ring
constexpr int kResident = 4;         // blocks an SM holds (registers)
constexpr int kPrepThreads = 256;
// -log2(e) / 2, rounded to f32 as the JAX kernels' weakly-typed constant.
constexpr float kLog2eHalf = -1.4426950408889634f / 2.0f;

// Output chunks of kNT * 8 columns (gridDim.z).
int chunks(int p) { return ((p + 7) / 8 + kNT - 1) / kNT; }

// The ring: kSlots u tiles of [kCols][8 kNT + 4].
constexpr size_t kSmem = sizeof(float) * kSlots * kCols * (8 * kNT + 4);

__host__ __device__ inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// u = g - theta / h^2, or g - (theta - c) / h^2 about a centre, into the
// scratch the tile then reads (the caller's JAX expression, once per
// entry).
__global__ void __launch_bounds__(kPrepThreads) on_d_prep_kernel(OnDArgs a) {
  const float h2 = __ldg(a.h2);
  const size_t total = static_cast<size_t>(a.n) * a.p;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float t = a.center != nullptr
                        ? __ldg(a.cols + e) - __ldg(a.center + e % a.p)
                        : __ldg(a.cols + e);
    a.u_buf[e] = __ldg(a.grads + e) - t / h2;
  }
}

__global__ void __launch_bounds__(kThreads) svgd_on_d_kernel(OnDArgs a) {
  constexpr int kW = 8 * kNT, su = kW + 4, slot = kCols * su;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const float* u = a.u != nullptr ? a.u : a.u_buf;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m = a.m, n = a.n, p = a.p;
  const int c0 = blockIdx.z * kW;
  const float h2 = __ldg(a.h2);
  const float scale = __fdiv_rn(kLog2eHalf, h2);
  const int r_lo = blockIdx.x * kRows + 16 * warp + gid;
  const int tiles = (n + kCols - 1) / kCols;
  const int t_begin = blockIdx.y * tiles / gridDim.y;
  const int stages = (blockIdx.y + 1) * tiles / gridDim.y - t_begin;
  const bool vec = (p & 3) == 0 && aligned16(u);
  const bool d2 = (n & 1) == 0 && (reinterpret_cast<uintptr_t>(a.D) & 7) == 0;

  // The u tile of stage s into slot s % kSlots; rows past n and columns
  // past p are zero.
  auto issue = [&](int s) {
    float* base = sm + (s % kSlots) * slot;
    const int j0 = (t_begin + s) * kCols;
    const int q = vec ? kW / 4 : kW;
    for (int e = threadIdx.x; e < kCols * q; e += kThreads) {
      const int r = e / q, kk = (vec ? 4 : 1) * (e - r * q);
      const int j = j0 + r, k = c0 + kk;
      float* to = base + r * su + kk;
      const float* from = u + static_cast<size_t>(j) * p + k;
      const bool ok = j < n && k < p;
      if (vec) {
        if (ok) cp_async16(to, from);
        else *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        if (ok) cp_async4(to, from);
        else *to = 0.0f;
      }
    }
  };

  float acc[kNT][4], k[4][4], ks[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int s0 = 0; s0 < kSlots - 1; ++s0) {
    if (s0 < stages) issue(s0);
    cp_async_commit();
  }
  for (int st = 0; st < stages; ++st) {
    if (st + kSlots - 1 < stages) issue(st + kSlots - 1);
    cp_async_commit();
    // This tile's D entries, in flight while the ring's copies land: k[nt]
    // [e] is row r_lo + 8 (e / 2), column j0 + 8 nt + 2 tig + e % 2.
    const int j0 = (t_begin + st) * kCols;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = j0 + 8 * nt + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r_lo + 8 * h;
        const float* row = a.D + static_cast<size_t>(i) * n + j;
        float2 v = make_float2(0.0f, 0.0f);
        if (i < m) {
          if (d2 && j + 1 < n) {
            v = __ldg(reinterpret_cast<const float2*>(row));
          } else {
            if (j < n) v.x = __ldg(row);
            if (j + 1 < n) v.y = __ldg(row + 1);
          }
        }
        k[nt][2 * h] = v.x;
        k[nt][2 * h + 1] = v.y;
      }
    }
    cp_async_wait<kSlots - 1>();
    __syncthreads();
    const float* base = sm + (st % kSlots) * slot;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r_lo + 8 * (e >> 1);
        const int j = j0 + 8 * nt + 2 * tig + (e & 1);
        const float d = k[nt][e];
        float kv = 0.0f;
        if (i < m && j < n)
          kv = exp2f(a.div_h2        ? (d / h2) * kLog2eHalf
                     : a.scale_first ? d * scale
                                     : (d * kLog2eHalf) / h2);
        ks[e >> 1] += kv;
        k[nt][e] = kv;
      }
    }
    contract<kNT, false>(acc, k, base, su, gid, tig);
    __syncthreads();
  }

  float* ku_out = a.part_ku + static_cast<size_t>(blockIdx.y) * m * p;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r_lo + 8 * h;
    float v = ks[h];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (i >= m) continue;
#pragma unroll
    for (int qq = 0; qq < kNT; ++qq) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = c0 + 8 * qq + 2 * tig + e;
        if (kc < p) ku_out[static_cast<size_t>(i) * p + kc] = acc[qq][2 * h + e];
      }
    }
    if (tig == 0 && blockIdx.z == 0) a.part_ksum[blockIdx.y * m + i] = v;
  }
}

}  // namespace

// Column shares: as many as fill the kResident block slots of every SM in
// one wave (at least one block an SM), at most one per tile and at most
// 16.
int on_d_splits(int m, int n, int p) {
  const int blocks = ((m + kRows - 1) / kRows) * chunks(p);
  const int tiles = (n + kCols - 1) / kCols;
  const int sms = sm_count();
  int s = kResident * sms / blocks;
  if (s * blocks < sms) s = (sms + blocks - 1) / blocks;
  if (s > tiles) s = tiles;
  if (s > 16) s = 16;
  return s < 1 ? 1 : s;
}

cudaError_t launch_on_d(const OnDArgs& a, cudaStream_t stream) {
  if (a.splits < 1 || (a.u == nullptr && a.u_buf == nullptr))
    return cudaErrorInvalidValue;
  if (a.u == nullptr) {
    const long long total = static_cast<long long>(a.n) * a.p;
    const int blocks = static_cast<int>(
        (total + kPrepThreads - 1) / kPrepThreads < 4 * sm_count()
            ? (total + kPrepThreads - 1) / kPrepThreads
            : 4 * sm_count());
    on_d_prep_kernel<<<blocks, kPrepThreads, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(svgd_on_d_kernel), kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.m + kRows - 1) / kRows, a.splits, chunks(a.p));
  svgd_on_d_kernel<<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace stein

using namespace stein;

extern "C" {

int stein_on_d_splits(int m, int n, int p) { return on_d_splits(m, n, p); }

// The tile's grid size at this shape: row blocks x shares x output chunks.
int stein_on_d_blocks(int m, int n, int p) {
  return ((m + kRows - 1) / kRows) * on_d_splits(m, n, p) * chunks(p);
}

// B10. D [m, n], u [n, p], h2 a device scalar; or, u null, u = grads -
// (cols - center) / h2 formed on the card into u_buf [n, p], with the step
// tails' exponent order (B12's form). Scratch part_ku [splits * m * p],
// part_ksum [splits * m]. Writes ku [m, p] and ksum [m].
int stein_svgd_on_d(const float* D, const float* u, const float* grads,
                    const float* cols, const float* center, const float* h2,
                    int m, int n, int p, int splits, float* part_ku,
                    float* part_ksum, float* u_buf, float* ku, float* ksum,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const OnDArgs on_d{D, u, grads, cols, center, h2, m, n, p,
                     u == nullptr, splits, part_ku, part_ksum, u_buf};
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
