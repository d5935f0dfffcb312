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
//   data_product_kernel<kBT = true>   Y [n, N] = W [n, p] . M [N, p]^T
//   data_product_kernel<kBT = false>  G [n, p] = R [n, N] . M [N, p]
//
// The contract is row invariance: every output element is one chain of
// fused multiply-adds over the contraction index in increasing order,
// acc = fma(a_k, b_k, acc) from acc = 0, and nothing else (no split of the
// contraction, no atomics, no padding terms: the last k-tile's loop stops
// at the contraction's end). That order is the same whatever n, the grid,
// the tile variant or the row's place in the launch, so rows [a:b] of a
// launch over n particles are bitwise the rows of a launch over those
// b - a particles alone. The FMAs are written as __fmaf_rn / __fma_rn, so
// nvcc has no multiply and add to contract on its own; no --use_fast_math.
// IEEE f32 (or f64) on the CUDA cores, the class of the port's f32 data
// products with TF32 off; bf16 operands are summed in f32 and the sum
// rounded once, as cuBLAS's bf16 product does.
//
// The kernel is a register-tiled product: a block holds a BM x BN tile of
// the output, each thread a TM x TN block of it (adjacent rows and
// columns, read from shared memory in 16- or 8-byte loads). Per 16-index
// k-tile the block stages A's [BM, 16] and B's [16, BN] tiles in shared
// memory, transposed where the source runs along k (rows padded by 4),
// while the next tile's global loads wait in registers; then each
// thread's chains advance 16 indices. Each product has two variants: the
// larger tile where its grid gives every SM a block, else the smaller:
//   Y: 64 x 64 (4 x 4 a thread, 256 threads), else 32 x 32 (4 x 2, 128);
//   G: 64 x 32 (4 x 2, 256 threads), else 32 x 32 (2 x 2, 256).
// G is a long contraction (N = 1000) into few outputs (n x p): at
// n = 1000, p = 128 it is 128 blocks, one an SM, and each thread's chains
// are 1000 FMAs long, so it runs latency-bound (PERF.md). All variants
// give the same bits (every element is the same chain).
//
// Bounds on the H100 (f32 on the CUDA cores at 67 TFLOP/s): each product
// at n = 1000, N = 1000, p = 128 is 2 n N p = 256 MFLOP (3.82 us) over
// 5.1 MB (1.52 us at 3.35 TB/s): by operations; the pair 7.6 us a step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Storage to the accumulator's type and back (bf16 sums in f32).
template <typename Acc, typename S>
__device__ __forceinline__ Acc load_as(S v) {
  return static_cast<Acc>(v);
}
template <>
__device__ __forceinline__ float load_as<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
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

// The TM x TN operands of one k index from shared memory, in 16- or
// 8-byte loads (the rows and columns of a thread are adjacent).
template <int W>
__device__ __forceinline__ void load_row(float (&v)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    static_assert(W == 2, "rows of 2 or 4");
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}
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

// The forward product's variants, then the transpose product's: the
// larger tile where its grid gives every SM a block, else the smaller.
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

}  // namespace

extern "C" {

// Y [n, N] = W [n, p] . M [N, p]^T; dtype 0 f32, 1 f64, 2 bf16.
int stein_data_product(const void* W, const void* M, void* Y, int n, int N,
                       int p, int dtype, void* stream) {
  if (dtype == 1)
    return launch<double, double, true>(W, M, Y, n, N, p, stream);
  if (dtype == 2)
    return launch<__nv_bfloat16, float, true>(W, M, Y, n, N, p, stream);
  return launch<float, float, true>(W, M, Y, n, N, p, stream);
}

// G [n, p] = R [n, N] . M [N, p]; dtype 0 f32, 1 f64, 2 bf16.
int stein_data_product_t(const void* R, const void* M, void* G, int n, int N,
                         int p, int dtype, void* stream) {
  if (dtype == 1)
    return launch<double, double, false>(R, M, G, n, p, N, stream);
  if (dtype == 2)
    return launch<__nv_bfloat16, float, false>(R, M, G, n, p, N, stream);
  return launch<float, float, false>(R, M, G, n, p, N, stream);
}

}  // extern "C"
