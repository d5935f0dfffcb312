// The bin count of median='binned' (ops/median.py: bin_count), fed by the
// Gram. It replaces no Pallas kernel: the JAX package forms each row
// block's D and counts it with XLA's scatter-add inside its scanned
// histogram (stein_tpu/ops/median.py:262-266, _block_histogram;
// ring_binned_median's body). For a Gram block G [rows, cols] and the
// norms r [rows], c [cols], in G's dtype, and one or two windows (lo,
// width):
//
//   d   = (r_i + c_j) - 2 g_ij, the plain route's D: the add, the product
//         by 2 and the subtraction each rounded in D's dtype (bf16: each in
//         f32, then rounded to bf16, as torch's bf16 ops round), nothing
//         contracted (an FMA would differ where 2 g overflows);
//   q   = (d - lo) / width, rounded the same way;
//   bin = 0 for q < min(1, n_bins - 1), n_bins - 1 for q >= n_bins - 1,
//         trunc(q) otherwise (JAX's clip(int32(q), 0, n_bins - 1); NaN
//         lands in bin 0, as XLA converts it to 0);
//   out[w] = acc[w] + float(the exact int32 count of each bin of window w)
//            (acc given), or float(the count) (acc null).
//
// D is never written: it lives in registers between the read of G and the
// count. lo and width are read from device memory, so nothing goes to the
// host and a capture replays the launch as it is.
//
// One cooperative launch, at most one 1024-thread block per SM. Each block
// streams its share of G with 16-byte loads (the norms beside them), four
// loads in flight a thread before it counts; counts every window's
// interior bins in a shared-memory int32 histogram (n_bins words a window)
// and the two end bins in registers (past the first level nearly every
// entry falls there), reduced by a warp and added once per warp; adds its
// nonzero bins to a global int32 scratch by atomics (exact in any order).
// Then one grid barrier, and every block converts its own slice of the
// bins: one load of the scratch and of acc a bin, the f32 add, the store,
// and the scratch zeroed for the next launch. No block waits on another's
// epilogue and no thread runs a chain of dependent atomics. Past the
// shared memory's room (about 58000 bins a window) the interior counts go
// to the scratch directly. The device's SM count and shared-memory limit,
// and each kernel's opt-in to that memory, are read once per device.
//
// Bound on the H100 at the path's shape ([256, 10240] f32): one read of G,
// 10.5 MB, 3.1 us at 3.35 TB/s; on the CUDA cores three operations an
// entry for D and four a window, 0.3 us for one window.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace stein {
namespace {

namespace cg = cooperative_groups;

constexpr int kBinThreads = 1024;
constexpr int kMaxWindows = 2;
// Entries a thread, for the grid's size (up to one block an SM): a
// thread's count, not its loads, sets its time, so the grid is as wide as
// the SMs allow, one 16-byte group or one batch of scalar loads a thread.
constexpr int kPerThread = 4;
constexpr int kUnroll = 4;      // loads in flight a thread
constexpr int kMaxDevices = 64;
// The largest block the kernel takes: its flat indices stay in 32 bits.
constexpr long long kMaxEntries = (1LL << 31) - (1LL << 24);

// D's entry from the Gram, in the plain route's rounding.
__device__ __forceinline__ float dist(float r, float c, float g) {
  return __fsub_rn(__fadd_rn(r, c), __fmul_rn(2.0f, g));
}

__device__ __forceinline__ double dist(double r, double c, double g) {
  return __dsub_rn(__dadd_rn(r, c), __dmul_rn(2.0, g));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ __nv_bfloat16 dist(__nv_bfloat16 r,
                                              __nv_bfloat16 c,
                                              __nv_bfloat16 g) {
  const float t = bf16_round(__fadd_rn(__bfloat162float(r),
                                       __bfloat162float(c)));
  const float u = bf16_round(__fmul_rn(2.0f, __bfloat162float(g)));
  return __float2bfloat16_rn(__fsub_rn(t, u));
}

// The quotient in D's rounding, and the type it is compared in (exact for
// bf16, whose values f32 holds).
__device__ __forceinline__ float quotient(float d, float lo, float w) {
  return __fdiv_rn(__fsub_rn(d, lo), w);
}

__device__ __forceinline__ double quotient(double d, double lo, double w) {
  return __ddiv_rn(__dsub_rn(d, lo), w);
}

__device__ __forceinline__ float quotient(__nv_bfloat16 d, __nv_bfloat16 lo,
                                          __nv_bfloat16 w) {
  const float t = bf16_round(__fsub_rn(__bfloat162float(d),
                                       __bfloat162float(lo)));
  return bf16_round(__fdiv_rn(t, __bfloat162float(w)));
}

template <typename C>
struct Counter {
  C first_below, last_from;   // min(1, n_bins - 1), n_bins - 1
  int* hist;                  // interior bins: shared or the scratch
  unsigned first, last;

  __device__ __forceinline__ void add(C q) {
    if (q >= last_from) {
      ++last;
    } else if (q >= first_below) {
      atomicAdd(hist + static_cast<int>(q), 1);
    } else {
      ++first;   // also NaN
    }
  }
};

template <typename T>
struct BinArgs {
  const T* G;
  const T* rsq_rows;
  const T* colsq;
  int rows, cols, vec;   // vec: G and colsq by 16-byte loads
  const T* lo[kMaxWindows];
  const T* w[kMaxWindows];
  int n_bins;
  const float* acc;   // [windows, n_bins] or null
  float* out;         // [windows, n_bins]
  int* scratch;       // [windows, n_bins], zero between launches
};

// The entries of G in `kPer`-wide groups (a 16-byte load each, or one
// entry), grid-strided: a thread loads up to kUnroll groups (and their
// norms) before it counts any. Its row and column advance by the stride's
// quotient and remainder, with no division a group.
template <typename T, int kPer, int kWin, typename C>
__device__ __forceinline__ void count_pass(const BinArgs<T>& a,
                                           Counter<C> (&cnt)[kWin],
                                           const T (&lo)[kWin],
                                           const T (&w)[kWin]) {
  using V = typename std::conditional<kPer == 1, T, uint4>::type;
  const unsigned per_row = static_cast<unsigned>(a.cols) / kPer;
  const unsigned groups = static_cast<unsigned>(a.rows) * per_row;
  if (groups == 0) return;
  const unsigned stride = gridDim.x * kBinThreads;
  const unsigned step_row = stride / per_row;
  const unsigned step_col = stride - step_row * per_row;
  unsigned i = blockIdx.x * kBinThreads + threadIdx.x;
  unsigned row = i / per_row;
  unsigned col = i - row * per_row;
  const V* Gv = reinterpret_cast<const V*>(a.G);
  const V* Cv = reinterpret_cast<const V*>(a.colsq);
  for (;;) {
    V g[kUnroll], c[kUnroll];
    T r[kUnroll];
    int n = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i < groups) {
        g[u] = __ldg(Gv + i);
        c[u] = __ldg(Cv + col);
        r[u] = a.rsq_rows[row];
        n = u + 1;
        i += stride;
        row += step_row;
        col += step_col;
        if (col >= per_row) {
          col -= per_row;
          ++row;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < n) {
        const T* ge = reinterpret_cast<const T*>(&g[u]);
        const T* ce = reinterpret_cast<const T*>(&c[u]);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const T d = dist(r[u], ce[k], ge[k]);
#pragma unroll
          for (int v = 0; v < kWin; ++v)
            cnt[v].add(quotient(d, lo[v], w[v]));
        }
      }
    }
    if (n < kUnroll) return;
  }
}

template <typename T, int kWin, bool kShared>
__global__ void __launch_bounds__(kBinThreads, 1)
    bin_count_kernel(BinArgs<T> a) {
  extern __shared__ int sh[];
  using C = decltype(quotient(T(), T(), T()));
  const int nb = a.n_bins;
  int* hist = kShared ? sh : a.scratch;
  T lo[kWin], w[kWin];
#pragma unroll
  for (int v = 0; v < kWin; ++v) {
    lo[v] = *a.lo[v];
    w[v] = *a.w[v];
  }
  if (kShared) {
    for (int b = threadIdx.x; b < kWin * nb; b += kBinThreads) sh[b] = 0;
    __syncthreads();
  }
  Counter<C> cnt[kWin];
#pragma unroll
  for (int v = 0; v < kWin; ++v)
    cnt[v] = Counter<C>{static_cast<C>(nb > 1 ? 1 : 0),
                        static_cast<C>(nb - 1), hist + v * nb, 0u, 0u};
  if (a.vec)
    count_pass<T, static_cast<int>(16 / sizeof(T)), kWin>(a, cnt, lo, w);
  else
    count_pass<T, 1, kWin>(a, cnt, lo, w);

  // The end bins: a warp's sum, added once by its first lane.
#pragma unroll
  for (int v = 0; v < kWin; ++v) {
    const int first = warp_sum_int(static_cast<int>(cnt[v].first));
    const int last = warp_sum_int(static_cast<int>(cnt[v].last));
    if ((threadIdx.x & 31) == 0) {
      if (first) atomicAdd(hist + v * nb, first);
      if (last) atomicAdd(hist + v * nb + nb - 1, last);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < kWin * nb; b += kBinThreads)
      if (sh[b]) atomicAdd(a.scratch + b, sh[b]);
  }

  // Every block's counts are in the scratch; each block converts its
  // slice, adds it to acc and zeroes it.
  cg::this_grid().sync();
  for (int b = blockIdx.x * kBinThreads + threadIdx.x; b < kWin * nb;
       b += gridDim.x * kBinThreads) {
    const float f = __int2float_rn(__ldcg(a.scratch + b));
    a.scratch[b] = 0;
    a.out[b] = a.acc ? a.acc[b] + f : f;
  }
}

// What a launch needs of its device, read once per device.
struct DeviceLimits {
  int sms, smem;   // SM count, a block's opt-in shared memory
};

cudaError_t device_limits(DeviceLimits* out, int* dev) {
  static DeviceLimits limits[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceLimits& d = limits[*dev];
  if (d.sms == 0) {
    int sms = 0, smem = 0;
    if ((err = cudaDeviceGetAttribute(
             &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      *dev)) != cudaSuccess)
      return err;
    d.smem = smem;
    d.sms = sms;
  }
  *out = d;
  return cudaSuccess;
}

template <typename T, int kWin, bool kShared>
cudaError_t launch_kernel(const BinArgs<T>& a, int blocks, size_t smem,
                          const DeviceLimits& lim, int dev,
                          cudaStream_t stream) {
  // The kernel's opt-in to the device's shared memory, once per device.
  static bool opted[kMaxDevices] = {};
  const void* k = reinterpret_cast<const void*>(
      bin_count_kernel<T, kWin, kShared>);
  if (kShared && !opted[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, lim.smem);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  BinArgs<T> args = a;
  void* params[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel(k, blocks, kBinThreads,
                                                params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(BinArgs<T> a, int n_windows, cudaStream_t stream) {
  DeviceLimits lim{};
  int dev = 0;
  cudaError_t err = device_limits(&lim, &dev);
  if (err != cudaSuccess) return err;
  constexpr int kPer = 16 / sizeof(T);
  a.vec = reinterpret_cast<uintptr_t>(a.G) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.colsq) % 16 == 0 &&
          a.cols % kPer == 0;
  const long long numel = static_cast<long long>(a.rows) * a.cols;
  long long blocks = (numel + kBinThreads * kPerThread - 1) /
                     (kBinThreads * kPerThread);
  blocks = blocks < 1 ? 1 : (blocks > lim.sms ? lim.sms : blocks);
  const size_t smem =
      static_cast<size_t>(n_windows) * a.n_bins * sizeof(int);
  const bool shared = smem + 64 <= static_cast<size_t>(lim.smem);
  const int nb = static_cast<int>(blocks);
  if (n_windows == 1)
    return shared ? launch_kernel<T, 1, true>(a, nb, smem, lim, dev, stream)
                  : launch_kernel<T, 1, false>(a, nb, 0, lim, dev, stream);
  return shared ? launch_kernel<T, 2, true>(a, nb, smem, lim, dev, stream)
                : launch_kernel<T, 2, false>(a, nb, 0, lim, dev, stream);
}

template <typename T>
cudaError_t launch_typed(const void* G, int rows, int cols,
                         const void* rsq_rows, const void* colsq,
                         int n_windows, const void* const* lo,
                         const void* const* w, int n_bins, const float* acc,
                         float* out, int* scratch, cudaStream_t stream) {
  BinArgs<T> a{};
  a.G = static_cast<const T*>(G);
  a.rsq_rows = static_cast<const T*>(rsq_rows);
  a.colsq = static_cast<const T*>(colsq);
  a.rows = rows;
  a.cols = cols;
  for (int v = 0; v < n_windows; ++v) {
    a.lo[v] = static_cast<const T*>(lo[v]);
    a.w[v] = static_cast<const T*>(w[v]);
  }
  a.n_bins = n_bins;
  a.acc = acc;
  a.out = out;
  a.scratch = scratch;
  return launch<T>(a, n_windows, stream);
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

// out [n_windows, n_bins] f32 = acc + the counts of D = (rsq_rows[:, None]
// + colsq[None, :]) - 2 G over each window (lo_v, w_v), v < n_windows (1
// or 2; lo1 and w1 unused for one); acc may be null, or out itself. G is a
// contiguous [rows, cols] block; dtype 0 f32, 1 bf16, 2 f64 (G, the norms,
// lo and w alike); scratch: n_windows * n_bins int32, zero before the
// launch and after it.
int stein_bin_count(const void* G, int rows, int cols, int dtype,
                    const void* rsq_rows, const void* colsq, int n_windows,
                    const void* lo0, const void* w0, const void* lo1,
                    const void* w1, int n_bins, const float* acc, float* out,
                    int* scratch, void* stream) {
  if (n_bins < 1 || rows < 0 || cols < 0 || n_windows < 1 ||
      n_windows > kMaxWindows ||
      static_cast<long long>(rows) * cols > kMaxEntries)
    return cudaErrorInvalidValue;
  const void* lo[kMaxWindows] = {lo0, lo1};
  const void* w[kMaxWindows] = {w0, w1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_typed<float>(G, rows, cols, rsq_rows, colsq, n_windows,
                                 lo, w, n_bins, acc, out, scratch, s);
    case 1:
      return launch_typed<__nv_bfloat16>(G, rows, cols, rsq_rows, colsq,
                                         n_windows, lo, w, n_bins, acc, out,
                                         scratch, s);
    case 2:
      return launch_typed<double>(G, rows, cols, rsq_rows, colsq, n_windows,
                                  lo, w, n_bins, acc, out, scratch, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
