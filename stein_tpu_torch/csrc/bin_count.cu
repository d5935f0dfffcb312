// The bin count of median='binned' (ops/median.py: bin_count). It replaces
// no Pallas kernel: the JAX package counts with XLA's scatter-add inside
// its scanned histogram (stein_tpu/ops/median.py:263-266, _block_histogram;
// ring_binned_median's body), which torch.bincount took in the port until
// its read of the input's range on the host kept the binned samplers out of
// CUDA graphs. For a block D of any shape, in D's dtype:
//
//   q   = (D - lo) / width, each op rounded in D's dtype (bf16: in f32,
//         then rounded to bf16, as torch's bf16 ops round);
//   bin = 0 for q < min(1, n_bins - 1), n_bins - 1 for q >= n_bins - 1,
//         trunc(q) otherwise (JAX's clip(int32(q), 0, n_bins - 1); NaN
//         lands in bin 0, as XLA converts it to 0);
//   out = acc + float(the exact int32 count of each bin)   (acc given)
//       = float(the count)                                  (acc null)
//
// lo and width are read from device memory, so nothing goes to the host
// and a capture replays the launch as it is.
//
// One launch. Each block streams its share of D with 16-byte loads,
// counts the interior bins in a shared-memory int32 histogram (n_bins
// words: 16 KB at 4096 bins) and the two end bins in registers (past the
// first level nearly every entry falls there), reduced by a warp and added
// once per warp; then it adds its nonzero bins to a global int32 scratch
// by atomics (exact in any order). The last block to finish (a ticket in
// the scratch's last word) converts each bin to f32, adds it to acc, and
// leaves the scratch zeroed for the next launch. Past the shared memory's
// room (about 58000 bins) the interior counts go to the scratch directly.
//
// Bound on the H100 at the path's shape ([256, 10240] f32): one read of D,
// 10.5 MB, 3.1 us at 3.35 TB/s; about ten operations an entry on the CUDA
// cores, 0.4 us. What it costs beyond the read: the shared atomics of the
// first level, where the entries spread over the bins, and each block's
// flush of its bins.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace stein {
namespace {

constexpr int kBinThreads = 1024;

// The quotient in D's rounding, and the type it is compared in (exact for
// bf16, whose values f32 holds).
__device__ __forceinline__ float quotient(float d, float lo, float w) {
  return (d - lo) / w;
}

__device__ __forceinline__ double quotient(double d, double lo, double w) {
  return (d - lo) / w;
}

__device__ __forceinline__ float quotient(__nv_bfloat16 d, __nv_bfloat16 lo,
                                          __nv_bfloat16 w) {
  const float t = __bfloat162float(
      __float2bfloat16_rn(__bfloat162float(d) - __bfloat162float(lo)));
  return __bfloat162float(__float2bfloat16_rn(t / __bfloat162float(w)));
}

template <typename C>
struct Counter {
  C first_below, last_from;   // min(1, n_bins - 1), n_bins - 1
  int* hist;                  // interior bins: shared or the scratch
  unsigned first = 0, last = 0;

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

template <typename T, bool kShared>
__global__ void __launch_bounds__(kBinThreads)
    bin_count_kernel(const T* __restrict__ D, long long numel, int vec_ok,
                     const T* lo_p, const T* w_p, int n_bins,
                     const float* acc, float* out, int* scratch) {
  extern __shared__ int sh[];
  using C = decltype(quotient(T(), T(), T()));
  constexpr int kPer = 16 / sizeof(T);
  const T lo = *lo_p, w = *w_p;
  int* hist = kShared ? sh : scratch;
  if (kShared) {
    for (int b = threadIdx.x; b < n_bins; b += kBinThreads) sh[b] = 0;
    __syncthreads();
  }
  Counter<C> c{static_cast<C>(n_bins > 1 ? 1 : 0),
               static_cast<C>(n_bins - 1), hist};
  const long long stride = static_cast<long long>(gridDim.x) * kBinThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kBinThreads +
                        threadIdx.x;
  const long long n_vec = vec_ok ? numel / kPer : 0;
  const uint4* D4 = reinterpret_cast<const uint4*>(D);
  for (long long i = tid; i < n_vec; i += stride) {
    const uint4 v = __ldg(D4 + i);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int k = 0; k < kPer; ++k) c.add(quotient(e[k], lo, w));
  }
  for (long long i = n_vec * kPer + tid; i < numel; i += stride)
    c.add(quotient(D[i], lo, w));

  // The end bins: a warp's sum, added once by its first lane.
  const int first = warp_sum_int(static_cast<int>(c.first));
  const int last = warp_sum_int(static_cast<int>(c.last));
  if ((threadIdx.x & 31) == 0) {
    if (first) atomicAdd(hist, first);
    if (last) atomicAdd(hist + n_bins - 1, last);
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += kBinThreads)
      if (sh[b]) atomicAdd(scratch + b, sh[b]);
  }

  // The last block to finish converts and adds, then zeroes the scratch.
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(scratch + n_bins, 1) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int b = threadIdx.x; b < n_bins; b += kBinThreads) {
    const float f = __int2float_rn(atomicExch(scratch + b, 0));
    out[b] = acc ? acc[b] + f : f;
  }
  if (threadIdx.x == 0) scratch[n_bins] = 0;
}

template <typename T>
cudaError_t launch(const void* D, long long numel, const void* lo,
                   const void* w, int n_bins, const float* acc, float* out,
                   int* scratch, cudaStream_t stream) {
  const int vec_ok = reinterpret_cast<uintptr_t>(D) % 16 == 0;
  const long long per_block = static_cast<long long>(kBinThreads) * 16;
  long long blocks = (numel + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : (blocks > sm_count() ? sm_count() : blocks);
  const size_t smem = static_cast<size_t>(n_bins) * sizeof(int);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const T* d = static_cast<const T*>(D);
  const T* l = static_cast<const T*>(lo);
  const T* wp = static_cast<const T*>(w);
  if (smem + 64 <= static_cast<size_t>(optin)) {
    const void* k = reinterpret_cast<const void*>(bin_count_kernel<T, true>);
    cudaError_t err = set_smem(k, smem);
    if (err != cudaSuccess) return err;
    bin_count_kernel<T, true><<<static_cast<int>(blocks), kBinThreads, smem,
                                stream>>>(d, numel, vec_ok, l, wp, n_bins,
                                          acc, out, scratch);
  } else {
    bin_count_kernel<T, false><<<static_cast<int>(blocks), kBinThreads, 0,
                                 stream>>>(d, numel, vec_ok, l, wp, n_bins,
                                           acc, out, scratch);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

// out [n_bins] f32 = acc + the counts of D's numel entries (acc may be
// null, or out itself); dtype 0 f32, 1 bf16, 2 f64 (D, lo and width alike);
// scratch: n_bins + 1 int32, zero before the launch and after it.
int stein_bin_count(const void* D, long long numel, int dtype, const void* lo,
                    const void* width, int n_bins, const float* acc,
                    float* out, int* scratch, void* stream) {
  if (n_bins < 1 || numel < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(D, numel, lo, width, n_bins, acc, out, scratch, s);
    case 1:
      return launch<__nv_bfloat16>(D, numel, lo, width, n_bins, acc, out,
                                   scratch, s);
    case 2:
      return launch<double>(D, numel, lo, width, n_bins, acc, out, scratch,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
