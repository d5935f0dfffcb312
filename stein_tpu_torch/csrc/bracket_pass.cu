// Kernels B8 and B9, the local half of the sharded warm median's first pass;
// they replace stein_tpu/ops/pallas_median.py:_bracket_gram_kernel (B8,
// fused_bracket_pass) and _bracket_grid_kernel (B9, fused_bracket_grid_pass).
// For a shard's median rows [m, p] against columns [n, p] about a centre c:
//
//   D    = |r - c|^2 + |t - c|^2 - 2 (r - c).(t - c)     [m, n], written out
//   cnts = |{D <= t_i}| for every threshold t_i          [nc] int32
//   mm   = [-min(min D, 0), max D]                       [2] (B8 only)
//
// B8's thresholds are the bracket endpoints lo_b * med_prev, hi_b * med_prev;
// B9's are the grid edges of ops/fused_median.grid_edges, formed here from
// med_prev, hi_bound, the bracket multiples and g1 in that function's
// expression order (lo = m_lo med, the fallback lo = -1e-6 (1 + hib), w =
// (hi - lo) / g1, lo + t w), each operation rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc may not contract
// them), so they equal grid_edges' bitwise. The collectives that follow
// (pmax of mm, psum of cnts) and the refinement rounds over D stay outside
// the kernel, as on the TPU.
//
// One cooperative launch, one 512-thread block per SM. The Gram stage of
// gram_stage.cuh, which the median kernel runs too: each row and column is
// centred once, with its f32 norm, into 16-byte-aligned scratch; a grid
// barrier; then each block streams its tiles through a cp.async ring and
// runs mma.sync 3xTF32 (each run of at most 32 contraction indices summed
// in fresh registers), so D keeps the f32 class and is exact where the
// particles are lattice points. The warps that finish a tile write D from
// their accumulator fragments and count their own 16 entries against every
// threshold held in shared memory (a warp's counts summed by
// __reduce_add_sync, then into the block's counters), with a running min
// and max: no second pass over D. Each block then adds its counts into the
// outputs by atomicAdd and raises the range by an order-free float maximum
// (atomic_max_float); block 0 clears the outputs before the grid barrier.
// Counts are integers and min/max order-free, so the result does not
// depend on the order in which blocks ran, and two calls agree bitwise. (A
// last block adding every block's slot after an atomic ticket left a
// longer tail on the card: a fence, the ticket's round trip, then its
// loads of every slot.)
//
// Bound on the H100 at the mesh path's shape (m=256, n=1000, p=128): ~1.7
// MB of inputs and D over 3.35 TB/s, 0.5 us; 2 m n p = 65.5 MFLOP as three
// TF32 products each at 495 TFLOP/s, 0.4 us. What it costs beyond that is
// latency: the launch, the centring pass and its grid barrier, and the
// ring's first stage, which every SM loads from L2 at once (each tile's 16
// or 32 rows and 32 columns: the block's lines are read again by the
// tiles that share them).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"
#include "gram_stage.cuh"

namespace stein {
namespace {

constexpr int kMaxPassCounts = 2048;
constexpr int kMaxPassBrackets = 8;
// The dynamic shared memory the Gram stage may take beside the kernel's
// static thresholds, counters and ranges (16.1 KB).
constexpr int kPassSmem = 232448 - 20480;

struct PassBrackets {
  int count;
  float lo[kMaxPassBrackets];
  float hi[kMaxPassBrackets];
};

struct PassArgs {
  GramArgs g;             // rows against columns about the given centre
  float* D;               // [m, n] out
  const float* med_prev;  // device scalar
  PassBrackets br;        // the multiples of med_prev
  const float* hi_bound;  // B9: device scalar; nullptr for B8
  int g1;                 // B9: intervals of each grid
  int nc;                 // thresholds
  float* thr;             // [nc] out: the thresholds counted
  int* cnts;              // [nc] out
  float* mm;              // [2] out (B8), or nullptr
};

// The thresholds into shared memory: B8's bracket endpoints, or B9's grids
// (bracket-major, the fallback last), each by grid_edges' expression tree.
__device__ void form_thresholds(const PassArgs& a, float* thr) {
  const float med = __ldg(a.med_prev);
  if (a.hi_bound == nullptr) {
    for (int b = threadIdx.x; b < a.br.count; b += blockDim.x) {
      thr[2 * b] = __fmul_rn(a.br.lo[b], med);
      thr[2 * b + 1] = __fmul_rn(a.br.hi[b], med);
    }
    return;
  }
  const float hib = __ldg(a.hi_bound);
  const int per = a.g1 + 1;
  for (int e = threadIdx.x; e < a.nc; e += blockDim.x) {
    const int b = e / per, t = e - b * per;
    float lo = hib, hi = hib;
    if (b < a.br.count) {
      lo = __fmul_rn(a.br.lo[b], med);
      hi = __fmul_rn(a.br.hi[b], med);
    } else {
      lo = __fmul_rn(-1e-6f, __fadd_rn(1.0f, hib));
    }
    const float w = __fdiv_rn(__fsub_rn(hi, lo), static_cast<float>(a.g1));
    thr[e] = __fadd_rn(lo, __fmul_rn(static_cast<float>(t), w));
  }
}

// The Gram stage's epilogue: a finished warp tile's entries (16 a thread)
// into the running range and the block's counters.
struct CountEpilogue {
  const float* thr;
  int* counts;
  int nc;
  float mn, mx;

  __device__ void operator()(const float (&d)[4][4], unsigned in) {
    float v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const bool inside = (in >> q) & 1u;
      v[q] = inside ? d[q / 4][q % 4] : CUDART_NAN_F;   // NaN <= t is false
      if (inside) {
        mn = fminf(mn, v[q]);
        mx = fmaxf(mx, v[q]);
      }
    }
    for (int i = 0; i < nc; ++i) {
      const float t = thr[i];
      int c = 0;
#pragma unroll
      for (int q = 0; q < 16; ++q) c += v[q] <= t;
      c = __reduce_add_sync(0xffffffffu, c);
      if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(counts + i, c);
    }
  }
};

// max(*addr, v) for floats, order-free: a non-negative v raises the stored
// bits as a signed int, a negative one lowers them as an unsigned int, so
// the word always holds a float (start it at -inf, or at -0.0 for a
// maximum of values that are >= 0 or -0.0).
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.0f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

__global__ void __launch_bounds__(kStageThreads, 1)
    bracket_kernel(PassArgs a) {
  extern __shared__ float4 sm4[];
  __shared__ float thr[kMaxPassCounts];
  __shared__ int counts[kMaxPassCounts];
  __shared__ float wmin[kStageWarps], wmax[kStageWarps];
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < a.nc; i += blockDim.x) a.cnts[i] = 0;
    if (a.mm != nullptr && threadIdx.x == 0) {
      a.mm[0] = -0.0f;
      a.mm[1] = -CUDART_INF_F;
    }
  }
  for (int i = threadIdx.x; i < a.nc; i += blockDim.x) counts[i] = 0;
  form_thresholds(a, thr);
  // The stage's grid barrier (after the centring) orders the cleared
  // outputs, the thresholds and the zeroed counters before any tile.
  CountEpilogue epi{thr, counts, a.nc, CUDART_INF_F, -CUDART_INF_F};
  gram_stage<false>(a.g, a.D, reinterpret_cast<float*>(sm4), epi);

  // The stage ends with a block barrier: the counters are complete. The
  // block adds them into the outputs (integers: exact in any order) and
  // raises the range (mm[0] = -min(min D, 0) as the maximum of -min(bmn,
  // 0) over the blocks: negation is exact).
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < a.nc; i += blockDim.x) {
    if (blockIdx.x == 0) a.thr[i] = thr[i];
    if (counts[i] != 0) atomicAdd(a.cnts + i, counts[i]);
  }
  if (a.mm == nullptr) return;
  const float mn = warp_min(epi.mn), mx = warp_max(epi.mx);
  if (lane == 0) {
    wmin[warp] = mn;
    wmax[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bmn = wmin[0], bmx = wmax[0];
    for (int w = 1; w < kStageWarps; ++w) {
      bmn = fminf(bmn, wmin[w]);
      bmx = fmaxf(bmx, wmax[w]);
    }
    if (bmn <= bmx) {   // the block had tiles
      atomic_max_float(a.mm, -fminf(bmn, 0.0f));
      atomic_max_float(a.mm + 1, bmx);
    }
  }
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

// B8 (hi_bound == nullptr: the 2 * nb endpoints of br_lo/br_hi times
// *med_prev, and mm) or B9 (hi_bound: the (nb + 1) * (g1 + 1) grid edges;
// mm is not written). D [m, n], cnts [nc], thr [nc] (the thresholds
// counted); prep: stein_gram_prep_floats(n, m, p) floats of scratch.
int stein_bracket_pass(const float* rows, const float* cols,
                       const float* center, int m, int n, int p,
                       const float* med_prev, const float* br_lo,
                       const float* br_hi, int nb, const float* hi_bound,
                       int g1, float* D, int* cnts, float* mm, float* thr,
                       float* prep, void* stream) {
  const int nc = hi_bound == nullptr ? 2 * nb : (nb + 1) * (g1 + 1);
  if (nb < 0 || nb > kMaxPassBrackets || nc < 1 || nc > kMaxPassCounts ||
      (hi_bound != nullptr && g1 < 1))
    return cudaErrorInvalidValue;
  const size_t smem = gram_smem(p, kPassSmem);
  int blocks = 0;
  cudaError_t err = stage_grid(bracket_kernel, smem, &blocks);
  if (err != cudaSuccess) return err;
  PassArgs a{GramArgs{cols, rows, n, p, m, nullptr, nullptr, center, prep},
             D, med_prev, PassBrackets{}, hi_bound, g1, nc, thr, cnts,
             hi_bound == nullptr ? mm : nullptr};
  if ((err = gram_shape(a.g, blocks, kPassSmem)) != cudaSuccess) return err;
  a.br.count = nb;
  for (int i = 0; i < nb; ++i) {
    a.br.lo[i] = br_lo[i];
    a.br.hi[i] = br_hi[i];
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(bracket_kernel),
                                    blocks, kStageThreads, args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
