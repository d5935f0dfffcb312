// The linear models' per-particle data products, every particle folded into
// one launch: the product Y = W M^T of the models' log_p (the JAX package's
// jnp.matmul(batch["X"], w) and A @ w under jax.vmap(jax.value_and_grad),
// stein_tpu/models/linear_regression.py:87,93, logistic_regression.py:163,
// stein_tpu/api.py:442) and its transpose G = R M, each the other's
// backward (ops/data_product.py). No Pallas kernel: XLA forms these
// products on the TPU. It replaces torch.func's batched GEMV (cuBLAS's
// bmm), whose kernel, picked by the shape, sums a particle's row in
// another order in a block of 250 particles than in one of 1000.
//
//   tc_forward_kernel    Y [n, N] = W [n, p] . M [N, p]^T
//   tc_transpose_kernel  G [n, p] = R [n, N] . M [N, p]
//
// The contract is row invariance: for every (N, p, dtype) a particle's
// output row is the same bits whatever n is, wherever the row lies in the
// launch, whichever tile variant and grid run it, on one card and on every
// rank of a mesh. So everything that orders a sum is a function of (N, p,
// dtype) alone, never of n, the grid, the SM count or the variant:
//
// - f32 runs 3xTF32 on mma.sync m16n8k8 and bf16 mma.sync m16n8k16, on the
//   tensor cores, under tf32_mma.cuh's precision rule as its dot_chunk
//   applies it: the contraction goes in runs of 32 indices, their
//   boundaries at multiples of 32 from the start of the contraction (of
//   G's chunk, itself at a multiple of 32); each k-step of a run (8
//   indices, bf16 16) is summed in fresh registers by its mma (f32: small
//   * big, big * small, big * big), the run's k-steps are added in order
//   by IEEE adds and the run's sum into the running f32 sum. Zeros pad the
//   last k-step of the contraction (a function of N or p) and the rows and
//   columns past the edge; k-steps wholly past the end are not issued.
// - G's contraction over N is cut into S chunks, S and the chunk length a
//   function of N alone (ops/data_product.transpose_plan: S0 = min(8,
//   ceil(N / 128)), chunk = 32 ceil(ceil(N / S0) / 32), S = ceil(N /
//   chunk); N = 1000: seven chunks of 128 and one of 104). The S blocks of
//   an output tile form a thread-block cluster: each sums its chunk into a
//   partial tile in its shared memory; after the cluster's barrier each
//   block adds its slice of the tile over the cluster's shared memory in
//   rank order, ((P0 + P1) + P2) + ..., and writes it. One launch, no
//   scratch, no atomics, nothing read by the host: a capture replays it.
// - Y contracts over p (the model's width) with no split.
// - f64 keeps the FMA-chain template below (data_product_kernel): every
//   element one chain of __fma_rn in contraction order from 0, no split.
//
// Whether the tensor cores sum an element the same way in every row of a
// 16-row fragment is the hardware's business: chip_smoke.py's [kernels]
// data_product launches every case's rows again in blocks of 250, 97, 33
// and 1 at every offset (other variants, grids and fragment rows) and
// holds them bitwise to the full launch.
//
// The tensor-core kernels stage f32 operands in shared memory by cp.async
// (16-byte copies where the rows are 16-byte aligned, else 4-byte; bf16
// is converted to f32 on the way), k-tiles of 32 (one run each), two in
// flight. A warp owns a 32 x 32 (or 16 x 32) block of the output tile in
// mma fragments and splits its operands to tf32 (or packs them to bf16)
// as it reads them.
// Y's tile leaves through shared memory in 16-byte row stores; G's partial
// tiles meet in the cluster's shared memory.
//
// What bounds them on the H100 is neither the bytes nor the tensor cores'
// rate but issuing and waiting: three mma and the operands' splits for
// every product, an IEEE add for every k-step's sum, the mma's latency,
// and for G the cluster's two barriers. Bounds at n = N
// = 1000, p = 128: each product is 2 n N p = 256 MFLOP, three TF32
// products each (3xTF32): 1.55 us at 495 TFLOP/s; 5.1 MB in and out, 1.52
// us at 3.35 TB/s. PERF.md holds the times.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------------------------ f64
// The FMA-chain template, which f64 runs: a register-tiled product, every
// element one chain of fused multiply-adds in contraction order.

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Storage to the accumulator's type and back (store_as also rounds the
// tensor-core route's f32 sums to bf16).
template <typename Acc, typename S>
__device__ __forceinline__ Acc load_as(S v) {
  return static_cast<Acc>(v);
}
template <typename S, typename Acc>
__device__ __forceinline__ S store_as(Acc v) {
  return static_cast<S>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16_rn(v);
}

// The TM x TN operands of one k index from shared memory, in 16-byte
// loads (the rows and columns of a thread are adjacent).
template <int W>
__device__ __forceinline__ void load_row(double (&v)[W], const double* p) {
#pragma unroll
  for (int i = 0; i < W; i += 2) {
    const double2 q = *reinterpret_cast<const double2*>(p + i);
    v[i] = q.x; v[i + 1] = q.y;
  }
}

// One k index of a thread's TM x TN chains: acc[i][j] += a[i] b[j], fused.
template <typename T, int TM, int TN>
__device__ __forceinline__ void fma_step(T (&acc)[TM][TN], const T* a_row,
                                         const T* b_row) {
  T a[TM], b[TN];
  load_row<TM>(a, a_row);
  load_row<TN>(b, b_row);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fma_rn(a[i], b[j], acc[i][j]);
}

// Global -> registers for the k-tile at k0 (THREADS threads, each LA
// entries of A's [BM, BK] tile and LB of B's [BK, BN]): A read along k
// (BK consecutive entries a row); M along k (kBT) or along the columns.
template <typename S, typename T, int BM, int BN, int BK, int THREADS,
          bool kBT>
__device__ __forceinline__ void fetch_tile(
    T (&ra)[BM * BK / THREADS], T (&rb)[BN * BK / THREADS],
    const S* __restrict__ A, const S* __restrict__ M, long long row0,
    long long col0, int k0, int rows, int cols, int K, int tid) {
#pragma unroll
  for (int it = 0; it < BM * BK / THREADS; ++it) {
    const int e = tid + it * THREADS, r = e / BK, c = e % BK;
    const long long gr = row0 + r;
    const int gk = k0 + c;
    ra[it] = (gr < rows && gk < K) ? load_as<T>(A[gr * K + gk]) : T(0);
  }
#pragma unroll
  for (int it = 0; it < BN * BK / THREADS; ++it) {
    const int e = tid + it * THREADS;
    const int c = kBT ? e / BK : e % BN, kk = kBT ? e % BK : e / BN;
    const long long gc = col0 + c;
    const long long gk = k0 + kk;
    rb[it] = (gc < cols && gk < K)
                 ? load_as<T>(kBT ? M[gc * K + gk] : M[gk * cols + gc])
                 : T(0);
  }
}

// C [rows, cols] = A [rows, K] . B (K, cols), where B(k, j) is M[j K + k]
// (kBT: M is [cols, K]) or M[k cols + j] (M is [K, cols]); row-major.
// S is the storage type, T the accumulator's. A block holds a BM x BN
// tile of C, a thread a TM x TN block of it (rows ty TM + i, columns
// tx TN + j); the contraction goes by BK-wide k-tiles, the next tile's
// global loads held in registers while the current one is summed.
template <typename S, typename T, int BM, int BN, int BK, int TM, int TN,
          bool kBT>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    data_product_kernel(const S* __restrict__ A, const S* __restrict__ M,
                        S* __restrict__ C, int rows, int cols, int K) {
  constexpr int TX = BN / TN, THREADS = (BM / TM) * TX;
  constexpr int LA = BM * BK / THREADS, LB = BN * BK / THREADS;
  // Rows padded by 4 entries: 16-byte aligned, fewer bank conflicts on
  // the transposed stores.
  __shared__ __align__(16) T As[BK][BM + 4];
  __shared__ __align__(16) T Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const long long col0 = static_cast<long long>(blockIdx.y) * BN;

  T ra[LA], rb[LB];
  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  fetch_tile<S, T, BM, BN, BK, THREADS, kBT>(ra, rb, A, M, row0, col0, 0,
                                               rows, cols, K, tid);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int it = 0; it < LA; ++it) {
      const int e = tid + it * THREADS;
      As[e % BK][e / BK] = ra[it];
    }
#pragma unroll
    for (int it = 0; it < LB; ++it) {
      const int e = tid + it * THREADS;
      if (kBT) Bs[e % BK][e / BK] = rb[it];
      else Bs[e / BN][e % BN] = rb[it];
    }
    __syncthreads();
    if (k0 + BK < K)
      fetch_tile<S, T, BM, BN, BK, THREADS, kBT>(ra, rb, A, M, row0, col0,
                                                   k0 + BK, rows, cols, K,
                                                   tid);
    // Each chain advances in k order; the last tile's loop stops at K.
    if (K - k0 >= BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk)
        fma_step<T, TM, TN>(acc, &As[kk][ty * TM], &Bs[kk][tx * TN]);
    } else {
      for (int kk = 0; kk < K - k0; ++kk)
        fma_step<T, TM, TN>(acc, &As[kk][ty * TM], &Bs[kk][tx * TN]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty * TM + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long c = col0 + tx * TN + j;
      if (c < cols) C[r * cols + c] = store_as<S>(acc[i][j]);
    }
  }
}

// Launches one tile variant: a BM x BN tile a block, TM x TN a thread.
template <typename S, typename T, int BM, int BN, int BK, int TM, int TN,
          bool kBT>
int launch_tiles(const S* A, const S* M, S* C, int rows, int cols, int K,
                 cudaStream_t s) {
  dim3 grid((rows + BM - 1) / BM, (cols + BN - 1) / BN);
  data_product_kernel<S, T, BM, BN, BK, TM, TN, kBT>
      <<<grid, (BM / TM) * (BN / TN), 0, s>>>(A, M, C, rows, cols, K);
  return cudaGetLastError();
}

// f64's variants of the forward product, then of the transpose product:
// the larger tile where its grid gives every SM a block, else the smaller.
template <typename S, typename T, bool kBT>
int launch(const void* A, const void* M, void* C, int rows, int cols, int K,
           void* stream) {
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const S* a = static_cast<const S*>(A);
  const S* m = static_cast<const S*>(M);
  S* c = static_cast<S*>(C);
  const long long tiles64 = static_cast<long long>((rows + 63) / 64) *
                            ((cols + 63) / 64);
  const bool big = tiles64 >= stein::sm_count();
  if (kBT) {
    if (big)
      return launch_tiles<S, T, 64, 64, 16, 4, 4, kBT>(a, m, c, rows, cols,
                                                        K, st);
    return launch_tiles<S, T, 32, 32, 16, 4, 2, kBT>(a, m, c, rows, cols, K,
                                                      st);
  }
  if (big)
    return launch_tiles<S, T, 64, 32, 16, 4, 2, kBT>(a, m, c, rows, cols, K,
                                                      st);
  return launch_tiles<S, T, 32, 32, 16, 2, 2, kBT>(a, m, c, rows, cols, K,
                                                    st);
}

// ------------------------------------------------------- tensor cores
using stein::cp_async16;
using stein::cp_async4;
using stein::mma_bf16;
using stein::pack_bf16;
using stein::split;

constexpr int kRun = 32;   // a run of the contraction: one staged k-tile
constexpr int kMaxSplits = 8;   // a cluster's blocks (portable size)

template <bool kBF16>
struct Route {
  using S = std::conditional_t<kBF16, __nv_bfloat16, float>;
  static constexpr int kStep = kBF16 ? 16 : 8;   // an mma's k
  // Row strides (floats) of the staged tiles, for conflict-free fragment
  // reads: tiles along k (32 + pad a row) and G's tile of M along the
  // columns (BN + pad a row).
  static constexpr int kLdk = kBF16 ? 40 : 36;
  static constexpr int kPadN = kBF16 ? 4 : 8;
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Rows r0 .. r0 + R of a row-major [rows, ld] matrix at contraction
// indices k0 .. k0 + 32 into dst[r kLdk + kk], zeros past the rows or
// k_hi. vec: 16-byte copies (f32; ld and k_hi multiples of 4, src
// 16-byte aligned), else 4-byte ones (bf16: loads converted to f32).
template <bool kBF16, int R, int THREADS>
__device__ __forceinline__ void stage_rows(
    float* dst, const typename Route<kBF16>::S* __restrict__ src,
    long long ld, long long r0, long long rows, long long k0,
    long long k_hi, bool vec) {
  constexpr int LD = Route<kBF16>::kLdk;
  if constexpr (!kBF16) {
    if (vec) {
#pragma unroll
      for (int g = threadIdx.x; g < R * (kRun / 4); g += THREADS) {
        const int r = g / (kRun / 4), c = (g % (kRun / 4)) * 4;
        float* d = dst + r * LD + c;
        if (r0 + r < rows && k0 + c < k_hi)
          cp_async16(d, src + (r0 + r) * ld + k0 + c);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < R * kRun; e += THREADS) {
    const int r = e / kRun, c = e % kRun;
    float* d = dst + r * LD + c;
    const bool in = r0 + r < rows && k0 + c < k_hi;
    if constexpr (kBF16) {
      *d = in ? __bfloat162float(src[(r0 + r) * ld + k0 + c]) : 0.f;
    } else {
      if (in) cp_async4(d, src + (r0 + r) * ld + k0 + c);
      else *d = 0.f;
    }
  }
}

// Rows k0 .. k0 + 32 of M [.., p] (contraction indices) at columns c0 ..
// c0 + BN into dst[kk (BN + kPadN) + c], zeros past k_hi or p.
template <bool kBF16, int BN, int THREADS>
__device__ __forceinline__ void stage_cols(
    float* dst, const typename Route<kBF16>::S* __restrict__ M, int p,
    long long k0, long long k_hi, int c0, bool vec) {
  constexpr int LD = BN + Route<kBF16>::kPadN;
  if constexpr (!kBF16) {
    if (vec) {
#pragma unroll
      for (int g = threadIdx.x; g < kRun * (BN / 4); g += THREADS) {
        const int kk = g / (BN / 4), c = (g % (BN / 4)) * 4;
        float* d = dst + kk * LD + c;
        if (k0 + kk < k_hi && c0 + c < p)
          cp_async16(d, M + (k0 + kk) * p + c0 + c);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < kRun * BN; e += THREADS) {
    const int kk = e / BN, c = e % BN;
    float* d = dst + kk * LD + c;
    const bool in = k0 + kk < k_hi && c0 + c < p;
    if constexpr (kBF16) {
      *d = in ? __bfloat162float(M[(k0 + kk) * p + c0 + c]) : 0.f;
    } else {
      if (in) cp_async4(d, M + (k0 + kk) * p + c0 + c);
      else *d = 0.f;
    }
  }
}

__device__ __forceinline__ uint32_t pack2(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}

// One k-step (8 contraction indices, bf16 16) at k of a warp's block of MT
// x NT fragments (rows wm0 + 16 mt, columns wn0 + 8 nt of the tile) into
// t. A is staged along k (As[row][k]); B along k too (kBT: Bs[column][k],
// Y's M) or along the columns (Bs[k][column], G's M; row stride LDB).
// Each element's sequence of operations is the same whatever MT, NT, the
// warp or the fragment row.
template <bool kBF16, bool kBT, int MT, int NT, int LDB>
__device__ __forceinline__ void k_step(float (&t)[MT][NT][4],
                                       const float* As, const float* Bs,
                                       int k, int wm0, int wn0, int gid,
                                       int tig) {
  constexpr int LDA = Route<kBF16>::kLdk;
  if constexpr (kBF16) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* r = As + (wm0 + 16 * mt + gid) * LDA + k + 2 * tig;
      a[mt][0] = pack2(r);
      a[mt][1] = pack2(r + 8 * LDA);
      a[mt][2] = pack2(r + 8);
      a[mt][3] = pack2(r + 8 * LDA + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if constexpr (kBT) {
        const float* c = Bs + (wn0 + 8 * nt + gid) * LDA + k + 2 * tig;
        b[nt][0] = pack2(c);
        b[nt][1] = pack2(c + 8);
      } else {
        const float* c = Bs + (k + 2 * tig) * LDB + wn0 + 8 * nt + gid;
        b[nt][0] = pack_bf16(c[0], c[LDB]);
        b[nt][1] = pack_bf16(c[8 * LDB], c[9 * LDB]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(t[mt][nt], a[mt], b[nt]);
  } else {
    uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* r = As + (wm0 + 16 * mt + gid) * LDA + k + tig;
      split(r[0], ab[mt][0], as[mt][0]);
      split(r[8 * LDA], ab[mt][1], as[mt][1]);
      split(r[4], ab[mt][2], as[mt][2]);
      split(r[8 * LDA + 4], ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if constexpr (kBT) {
        const float* c = Bs + (wn0 + 8 * nt + gid) * LDA + k + tig;
        split(c[0], bb[nt][0], bs[nt][0]);
        split(c[4], bb[nt][1], bs[nt][1]);
      } else {
        const float* c = Bs + (k + tig) * LDB + wn0 + 8 * nt + gid;
        split(c[0], bb[nt][0], bs[nt][0]);
        split(c[4 * LDB], bb[nt][1], bs[nt][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      stein::mma_3xtf32<NT>(t[mt], ab[mt], as[mt], bb, bs);
  }
}

// One k-step's products in fresh registers, added into the run's sum v
// (v = the first k-step's sum as it is).
template <bool kBF16, bool kBT, int MT, int NT, int LDB>
__device__ __forceinline__ void run_step(float (&v)[MT][NT][4], bool first,
                                         const float* As, const float* Bs,
                                         int k, int wm0, int wn0, int gid,
                                         int tig) {
  float t[MT][NT][4] = {};
  k_step<kBF16, kBT, MT, NT, LDB>(t, As, Bs, k, wm0, wn0, gid, tig);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[mt][nt][e] = first ? t[mt][nt][e] : v[mt][nt][e] + t[mt][nt][e];
}

// One run (a staged k-tile with kw valid indices) of a warp's fragments,
// summed as tf32_mma.cuh's dot_chunk sums one: each k-step in fresh
// registers (the tensor cores truncate each mma's sum, so a k-step's three
// carry only its own magnitude), the run's k-steps added in order, ((t0 +
// t1) + t2) + t3, by IEEE adds, the run's sum added into s. A whole run's
// k-steps go unguarded, so the compiler may overlap one k-step's loads
// with the last one's products; only the contraction's last run checks
// each. A 16 x 32 warp tile keeps every k-step's sum apart (a k-step past
// the end adds its zeros), so no k-step's mma waits on another's; a 32 x 32
// tile has the registers for one k-step's sum and the run's. The order is
// the same, and so are the bits (s never holds -0).
template <bool kBF16, bool kBT, int MT, int NT, int LDB>
__device__ __forceinline__ void run_tile(float (&s)[MT][NT][4],
                                         const float* As, const float* Bs,
                                         int wm0, int wn0, int kw, int gid,
                                         int tig) {
  constexpr int kStep = Route<kBF16>::kStep, kSets = kRun / kStep;
  float v[MT][NT][4];
  if constexpr (MT == 1) {
    float t[kSets][MT][NT][4] = {};
    if (kw >= kRun) {
#pragma unroll
      for (int j = 0; j < kSets; ++j)
        k_step<kBF16, kBT, MT, NT, LDB>(t[j], As, Bs, j * kStep, wm0, wn0,
                                        gid, tig);
    } else {
#pragma unroll
      for (int j = 0; j < kSets; ++j) {
        if (j * kStep >= kw) break;
        k_step<kBF16, kBT, MT, NT, LDB>(t[j], As, Bs, j * kStep, wm0, wn0,
                                        gid, tig);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[0][nt][e] = t[0][0][nt][e];
#pragma unroll
        for (int j = 1; j < kSets; ++j) v[0][nt][e] += t[j][0][nt][e];
      }
  } else {
    if (kw >= kRun) {
#pragma unroll
      for (int k = 0; k < kRun; k += kStep)
        run_step<kBF16, kBT, MT, NT, LDB>(v, k == 0, As, Bs, k, wm0, wn0,
                                          gid, tig);
    } else {
#pragma unroll
      for (int k = 0; k < kRun; k += kStep) {
        if (k >= kw) break;
        run_step<kBF16, kBT, MT, NT, LDB>(v, k == 0, As, Bs, k, wm0, wn0,
                                          gid, tig);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] += v[mt][nt][e];
}

// The warp's fragments into an f32 tile of row stride LDO: c0, c1 at row
// gid, columns 2 tig and 2 tig + 1; c2, c3 eight rows below.
template <int MT, int NT, int LDO>
__device__ __forceinline__ void fragments_to_tile(
    const float (&s)[MT][NT][4], float* out, int wm0, int wn0, int gid,
    int tig) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* o = out + (wm0 + 16 * mt + gid) * LDO + wn0 + 8 * nt + 2 * tig;
      *reinterpret_cast<float2*>(o) =
          make_float2(s[mt][nt][0], s[mt][nt][1]);
      *reinterpret_cast<float2*>(o + 8 * LDO) =
          make_float2(s[mt][nt][2], s[mt][nt][3]);
    }
}

// Four adjacent entries of a row-major output (row stride ld) from v: one
// 16-byte (f32) or 8-byte (bf16) store where all four lie in the row and
// vec (ld a multiple of 4, out 16-byte aligned), else one store each.
template <typename S>
__device__ __forceinline__ void store4(S* __restrict__ out, long long row,
                                       long long col, long long ld,
                                       const float4& v, bool vec) {
  S* o = out + row * ld + col;
  if (vec && col + 4 <= ld) {
    if constexpr (std::is_same_v<S, float>) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(o) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
    return;
  }
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < ld) o[i] = store_as<S>(f[i]);
}

// A block's contraction from k_lo to k_hi in k-tiles of 32: the first
// STAGES tiles issued at once (a contraction of up to 32 STAGES indices
// waits on one round trip), each buffer refilled with the tile STAGES on
// once it has been summed. issue(t, buffer) stages tile t, run(buffer, kw)
// sums it (kw: its valid indices). Returns with every copy landed and the
// block past a barrier, so the stage memory may be reused.
template <int STAGES, typename Issue, typename Run>
__device__ __forceinline__ void pipeline(float* smem, int stage_floats,
                                         long long k_lo, long long k_hi,
                                         Issue issue, Run run) {
  const int ktiles =
      k_hi > k_lo ? static_cast<int>((k_hi - k_lo + kRun - 1) / kRun) : 0;
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i < ktiles) issue(i, smem + i * stage_floats);
    stein::cp_async_commit();
  }
  for (int t = 0; t < ktiles; ++t) {
    // STAGES + t groups committed; tile t's is done when at most
    // STAGES - 1 are pending.
    stein::cp_async_wait<STAGES - 1>();
    __syncthreads();
    float* buf = smem + (t % STAGES) * stage_floats;
    const long long left = k_hi - k_lo - static_cast<long long>(t) * kRun;
    run(buf, static_cast<int>(left < kRun ? left : kRun));
    if (t + STAGES < ktiles) {
      __syncthreads();   // every warp is done with the buffer
      issue(t + STAGES, buf);
    }
    stein::cp_async_commit();
  }
  stein::cp_async_wait<0>();
  __syncthreads();
}

// Y [n, N] = W [n, p] . M [N, p]^T: a block a BM x BN tile (BM rows of W
// by BN rows of M; blockIdx.x runs over M's tiles), a warp WM x WN of it,
// the contraction over p. The tile leaves through shared memory in row
// stores.
template <bool kBF16, int BM, int BN, int WM, int WN, int STAGES, int MINB>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MINB)
    tc_forward_kernel(const typename Route<kBF16>::S* __restrict__ W,
                      const typename Route<kBF16>::S* __restrict__ M,
                      typename Route<kBF16>::S* __restrict__ Y, int n,
                      int N, int p, bool vec_in, bool vec_out) {
  using S = typename Route<kBF16>::S;
  constexpr int THREADS = (BM / WM) * (BN / WN) * 32;
  constexpr int MT = WM / 16, NT = WN / 8, LDA = Route<kBF16>::kLdk;
  constexpr int STAGE = (BM + BN) * LDA, LDO = BN + 8;
  static_assert(BM * LDO <= STAGES * STAGE, "the output tile fits");
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = (warp % (BM / WM)) * WM, wn0 = (warp / (BM / WM)) * WN;
  const long long row0 = static_cast<long long>(blockIdx.y) * BM;
  const long long col0 = static_cast<long long>(blockIdx.x) * BN;

  float s[MT][NT][4] = {};
  pipeline<STAGES>(
      smem, STAGE, 0, p,
      [&](int t, float* buf) {
        const long long k0 = static_cast<long long>(t) * kRun;
        stage_rows<kBF16, BM, THREADS>(buf, W, p, row0, n, k0, p, vec_in);
        stage_rows<kBF16, BN, THREADS>(buf + BM * LDA, M, p, col0, N, k0, p,
                                       vec_in);
      },
      [&](const float* buf, int kw) {
        run_tile<kBF16, true, MT, NT, 0>(s, buf, buf + BM * LDA, wm0, wn0,
                                         kw, gid, tig);
      });

  fragments_to_tile<MT, NT, LDO>(s, smem, wm0, wn0, gid, tig);
  __syncthreads();
#pragma unroll 4
  for (int g = threadIdx.x; g < BM * (BN / 4); g += THREADS) {
    const int r = g / (BN / 4), c = (g % (BN / 4)) * 4;
    if (row0 + r < n && col0 + c < N)
      store4<S>(Y, row0 + r, col0 + c, N,
                *reinterpret_cast<const float4*>(smem + r * LDO + c),
                vec_out);
  }
}

// G [n, p] = R [n, N] . M [N, p]: a cluster of S blocks a BM x BN output
// tile (blockIdx.x = S x the row tile + the rank), the block of cluster
// rank j summing the chunk [j chunk, min(N, (j + 1) chunk)) of the
// contraction into a partial tile in its shared memory; then every block
// adds its slice of the tile over the S partials in rank order and writes
// it.
template <bool kBF16, int BM, int BN, int WM, int WN, int STAGES, int MINB>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MINB)
    tc_transpose_kernel(const typename Route<kBF16>::S* __restrict__ R,
                        const typename Route<kBF16>::S* __restrict__ M,
                        typename Route<kBF16>::S* __restrict__ G, int n,
                        int N, int p, int chunk, bool vec_r, bool vec_m,
                        bool vec_out) {
  using S = typename Route<kBF16>::S;
  constexpr int THREADS = (BM / WM) * (BN / WN) * 32;
  constexpr int MT = WM / 16, NT = WN / 8, LDA = Route<kBF16>::kLdk;
  constexpr int LDB = BN + Route<kBF16>::kPadN;
  constexpr int STAGE = BM * LDA + kRun * LDB, LDP = BN + 8;
  static_assert(BM * LDP <= STAGES * STAGE, "the partial tile fits");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = (warp % (BM / WM)) * WM, wn0 = (warp / (BM / WM)) * WN;
  const long long row0 = static_cast<long long>(blockIdx.x / splits) * BM;
  const int col0 = blockIdx.y * BN;
  const long long k_lo = static_cast<long long>(rank) * chunk;
  const long long k_hi = k_lo + chunk < N ? k_lo + chunk : N;

  float s[MT][NT][4] = {};
  pipeline<STAGES>(
      smem, STAGE, k_lo, k_hi,
      [&](int t, float* buf) {
        const long long k0 = k_lo + static_cast<long long>(t) * kRun;
        stage_rows<kBF16, BM, THREADS>(buf, R, N, row0, n, k0, k_hi, vec_r);
        stage_cols<kBF16, BN, THREADS>(buf + BM * LDA, M, p, k0, k_hi, col0,
                                       vec_m);
      },
      [&](const float* buf, int kw) {
        run_tile<kBF16, false, MT, NT, LDB>(s, buf, buf + BM * LDA, wm0,
                                            wn0, kw, gid, tig);
      });

  fragments_to_tile<MT, NT, LDP>(s, smem, wm0, wn0, gid, tig);
  cluster.sync();   // every partial tile written, visible to the cluster
  constexpr int Q = BM * (BN / 4);
  const int q_hi = (rank + 1) * Q / splits;
  for (int q = rank * Q / splits + threadIdx.x; q < q_hi; q += THREADS) {
    const int r = q / (BN / 4), c = (q % (BN / 4)) * 4;
    const int off = r * LDP + c;
    float4 v[kMaxSplits];
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < splits)
        v[j] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(smem, j) + off);
    float4 acc = v[0];
#pragma unroll
    for (int j = 1; j < kMaxSplits; ++j)
      if (j < splits) {
        acc.x += v[j].x;
        acc.y += v[j].y;
        acc.z += v[j].z;
        acc.w += v[j].w;
      }
    if (row0 + r < n && col0 + c < p)
      store4<S>(G, row0 + r, col0 + c, p, acc, vec_out);
  }
  cluster.sync();   // no block leaves while another reads its tile
}

template <bool kBF16, int BM, int BN, int WM, int WN, int STAGES, int MINB>
cudaError_t launch_forward_tiles(const void* W, const void* M, void* Y,
                                 int n, int N, int p, cudaStream_t st) {
  using S = typename Route<kBF16>::S;
  constexpr int THREADS = (BM / WM) * (BN / WN) * 32;
  constexpr size_t smem =
      sizeof(float) * STAGES * (BM + BN) * Route<kBF16>::kLdk;
  static_assert(smem <= 48 * 1024, "no opt-in to more shared memory");
  auto kernel = tc_forward_kernel<kBF16, BM, BN, WM, WN, STAGES, MINB>;
  const dim3 grid((N + BN - 1) / BN, (n + BM - 1) / BM);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const S*>(W), static_cast<const S*>(M),
      static_cast<S*>(Y), n, N, p,
      p % 4 == 0 && aligned16(W) && aligned16(M),
      N % 4 == 0 && aligned16(Y));
  return cudaGetLastError();
}

// Both products take one of two tile variants, the same for each: 64 x 64
// tiles of four warps of 32 x 32 (each loaded operand feeds more mma) where
// their grid gives every SM a block, else 32 x 64 tiles of four warps of
// 16 x 32 (twice the blocks for a small grid). Two k-tiles in flight; the
// launch bounds hold the registers to 170 (64 x 64: three blocks an SM)
// or 128 (32 x 64: four). All variants give the same bits.
template <bool kBF16>
cudaError_t launch_forward(const void* W, const void* M, void* Y, int n,
                           int N, int p, cudaStream_t st) {
  const long long tiles = static_cast<long long>((n + 63) / 64) *
                          ((N + 63) / 64);
  if (tiles >= stein::sm_count())
    return launch_forward_tiles<kBF16, 64, 64, 32, 32, 2, 3>(W, M, Y, n, N,
                                                             p, st);
  return launch_forward_tiles<kBF16, 32, 64, 16, 32, 2, 4>(W, M, Y, n, N, p,
                                                           st);
}

template <bool kBF16, int BM, int BN, int WM, int WN, int STAGES, int MINB>
cudaError_t launch_transpose_tiles(const void* R, const void* M, void* G,
                                   int n, int N, int p, int splits,
                                   int chunk, cudaStream_t st) {
  using S = typename Route<kBF16>::S;
  constexpr int THREADS = (BM / WM) * (BN / WN) * 32;
  constexpr size_t smem =
      sizeof(float) * STAGES *
      (BM * Route<kBF16>::kLdk + kRun * (BN + Route<kBF16>::kPadN));
  static_assert(smem <= 48 * 1024, "no opt-in to more shared memory");
  auto kernel = tc_transpose_kernel<kBF16, BM, BN, WM, WN, STAGES, MINB>;
  const long long row_tiles = (n + BM - 1) / BM;
  const int col_tiles = (p + BN - 1) / BN;
  if (row_tiles * splits > 0x7fffffffLL || col_tiles > 65535)
    return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(row_tiles * splits), col_tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(splits);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const S*>(R), static_cast<const S*>(M),
      static_cast<S*>(G), n, N, p, chunk, N % 4 == 0 && aligned16(R),
      p % 4 == 0 && aligned16(M), p % 4 == 0 && aligned16(G));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// G's variants (Y's tiles), a cluster of `splits` blocks a tile.
template <bool kBF16>
cudaError_t launch_transpose(const void* R, const void* M, void* G, int n,
                             int N, int p, int splits, int chunk,
                             cudaStream_t st) {
  const long long blocks = static_cast<long long>((n + 63) / 64) * splits *
                           ((p + 63) / 64);
  if (blocks >= stein::sm_count())
    return launch_transpose_tiles<kBF16, 64, 64, 32, 32, 2, 3>(
        R, M, G, n, N, p, splits, chunk, st);
  return launch_transpose_tiles<kBF16, 32, 64, 16, 32, 2, 4>(
      R, M, G, n, N, p, splits, chunk, st);
}

}  // namespace

extern "C" {

// Y [n, N] = W [n, p] . M [N, p]^T; dtype 0 f32, 1 f64, 2 bf16.
int stein_data_product(const void* W, const void* M, void* Y, int n, int N,
                       int p, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<double, double, true>(W, M, Y, n, N, p, stream);
  if (n <= 0 || N <= 0) return cudaSuccess;
  if (dtype == 2) return launch_forward<true>(W, M, Y, n, N, p, st);
  return launch_forward<false>(W, M, Y, n, N, p, st);
}

// G [n, p] = R [n, N] . M [N, p]; dtype 0 f32, 1 f64, 2 bf16. (splits,
// chunk) is ops/data_product.transpose_plan(N): splits chunks of `chunk`
// indices (a multiple of 32), the last one shorter and none empty.
int stein_data_product_t(const void* R, const void* M, void* G, int n, int N,
                         int p, int dtype, int splits, int chunk,
                         void* stream) {
  if (splits < 1 || splits > kMaxSplits || chunk <= 0 || chunk % kRun != 0 ||
      static_cast<long long>(splits) * chunk < N ||
      static_cast<long long>(splits - 1) * chunk >= (N > 0 ? N : 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<double, double, false>(R, M, G, n, p, N, stream);
  if (n <= 0 || p <= 0) return cudaSuccess;
  if (dtype == 2)
    return launch_transpose<true>(R, M, G, n, N, p, splits, chunk, st);
  return launch_transpose<false>(R, M, G, n, N, p, splits, chunk, st);
}

}  // extern "C"
