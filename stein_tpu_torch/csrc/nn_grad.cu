// Kernel B7, the Bayesian-NN log-posterior and its hand-derived gradient
// for every particle; replaces stein_tpu/models/bayesian_nn.py:
// _nn_grad_kernel. The model is the 1-hidden-layer ReLU MLP of
// models/bayesian_nn.py with Gamma hyperpriors on the two log-precisions.
//
// A team of W = min(ceil(H / 32), 8) warps per particle, one thread per
// hidden unit (units h, h + 32 W, ... where H > 256), and 8 / W teams a
// block; every thread reads the batch X [B, f] and y [B] through L1 (no
// staging, so a particle's loads all start at once). The observations go
// in chunks of kObs = 20, the batch of every path (each loop over a chunk
// unrolled, no slot wasted there; a larger B takes several chunks). For
// its unit each thread loads b1[h], the f weights w1[., h] and w2[h] (a
// particle's row read once, coalesced across the team) and forms the
// chunk's pre-activations a = b1 + x.w1 once, in registers, each product
// and sum rounded as the plain version's are; its contributions relu(a) w2
// to the chunk's predictions are summed over the warp by a butterfly that
// leaves lane o with observation o's sum (31 shuffles for all of them, no
// dependent chain per observation), then over the team's warps through
// shared memory in a fixed order, so every warp holds the same residual
// r_o in lane o. The backward reads gamma r_o by shuffle and the same
// registers: the gradients of b1, w2 and each w1 row go to the [n, p]
// gradient in the ravel layout b_1 [H] | b_2 | log_gamma | log_lambda |
// w_1 [f*H] | w_2 [H], written by consecutive threads to consecutive
// addresses (a chunk past the first adds into them); the team's first
// thread writes the scalars and log_p. Any n, f, H and B (8 * 33 * 2
// floats of shared memory).
//
// Bound on the H100 at the NN shape (n = 1000, H = 100, B = 20, f = 1):
// the 2.4 MB read of theta and write of the gradient over 3.35 TB/s, 0.72
// us (~12 MFLOP of f32). At n = 1000 the grid is 500 blocks of 8 warps
// (three resident an SM), so the loads of many particles are in flight
// at once; launch latency, the loads' round trip and the instructions a
// warp issues per chunk (the butterfly, one shuffle per observation in the
// backward) set the time.

#include <cuda_runtime.h>

#include "common.cuh"

namespace stein {
namespace {

constexpr int kNNThreads = 256;
constexpr int kNNWarps = kNNThreads / 32;
constexpr int kChunk = 32;          // the butterfly's width
constexpr int kObs = 20;            // observations a chunk keeps in registers
constexpr int kPartStride = 33;     // a warp's 32 sums and its |w|^2

// The scalars of the backward, rounded to f32 on the host.
struct NNConsts {
  float s, inv_nt, am1, beta, n_weights, c_prior, half_log_2pi, B;
};

size_t nn_smem(int, int) {
  return sizeof(float) * 2 * kNNWarps * kPartStride;
}

// Warps a particle's team takes for H hidden units.
int nn_team_warps(int H) {
  const int w = (H + 31) / 32;
  return w < kNNWarps ? w : kNNWarps;
}

// v[o] summed over the warp's lanes for o = 0..31, left in lane o: at each
// of five halvings (kHalf = 16, 8, .., 1) a lane keeps the half of its
// indices that its lane bit kHalf selects and adds its partner's copy of
// that half. Returns lane o's sum.
template <int kHalf>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[kChunk],
                                                     int lane) {
  const bool upper = lane & kHalf;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float keep = upper ? v[k + kHalf] : v[k];
    const float send = upper ? v[k] : v[k + kHalf];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
  if constexpr (kHalf > 1) return warp_reduce_scatter<kHalf / 2>(v, lane);
  return v[0];
}

// The unit's parameters and its pre-activations a[o] = b1 + x_o . w1 for
// the chunk's observations c0 .. c0 + bc (0 past them), each product and
// sum rounded on its own as the plain version's are, so that both see the
// same sign of every a (a ReLU flip at a ~ 0 moves a gradient by a whole
// term); |w|^2 of the unit into w_sq when it is not null.
__device__ __forceinline__ void pre_activations(
    const float* t, const float* X, int f, int H, int h, bool ok, int c0,
    int bc, float& b1h, float& w2h, float (&a)[kObs], float* w_sq) {
  b1h = ok ? __ldg(t + h) : 0.0f;
  w2h = ok ? __ldg(t + H + 3 + f * H + h) : 0.0f;
#pragma unroll
  for (int o = 0; o < kObs; ++o) a[o] = b1h;
  float sq = b1h * b1h + w2h * w2h;
  for (int j = 0; j < f; ++j) {
    const float w = ok ? __ldg(t + H + 3 + j * H + h) : 0.0f;
    sq += w * w;
#pragma unroll
    for (int o = 0; o < kObs; ++o)
      if (o < bc)
        a[o] = __fadd_rn(a[o], __fmul_rn(__ldg(X + (c0 + o) * f + j), w));
  }
#pragma unroll
  for (int o = 0; o < kObs; ++o)
    if (o >= bc) a[o] = 0.0f;
  if (w_sq != nullptr) *w_sq += sq;
}

// Three blocks an SM: at most 85 registers a thread.
__global__ void __launch_bounds__(kNNThreads, 3)
    nn_grad_kernel(const float* __restrict__ theta, int n, int p,
                   const float* __restrict__ X, const float* __restrict__ y,
                   int B, int f, int H, int team_warps, NNConsts c,
                   float* __restrict__ logp, float* __restrict__ grads) {
  extern __shared__ float part[];   // [2][kNNWarps][kPartStride]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team_threads = 32 * team_warps;
  const int team = threadIdx.x / team_threads;
  const int tt = threadIdx.x - team * team_threads;   // the unit's thread
  const int first = team * team_warps;                // the team's warp 0
  const int i = blockIdx.x * (blockDim.x / team_threads) + team;
  const bool live = i < n;
  const int units = (H + team_threads - 1) / team_threads;
  const float* t = theta + static_cast<size_t>(live ? i : 0) * p;
  float* g = grads + static_cast<size_t>(live ? i : 0) * p;
  const float b2 = __ldg(t + H), lg = __ldg(t + H + 1), ll = __ldg(t + H + 2);
  const float gam = expf(lg), lam = expf(ll);

  const int chunks = B > kObs ? (B + kObs - 1) / kObs : 1;
  float a[kObs], b1h = 0.0f, w2h = 0.0f;
  float w_sq = 0.0f, sum_r2 = 0.0f, db2 = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * kObs, bc = min(kObs, B - c0);
    const float yo = lane < bc ? __ldg(y + c0 + lane) : 0.0f;   // lane o's
    // Forward: this thread's relu(a) w2 for each observation, over its
    // units (a stays in registers when the thread has one unit); the
    // butterfly's slots past kObs hold 0.
    float v[kChunk];
#pragma unroll
    for (int o = 0; o < kChunk; ++o) v[o] = 0.0f;
    for (int u = 0; u < units; ++u) {
      const int h = tt + u * team_threads;
      pre_activations(t, X, f, H, h, live && h < H, c0, bc, b1h, w2h, a,
                         ch == 0 ? &w_sq : nullptr);
#pragma unroll
      for (int o = 0; o < kObs; ++o) v[o] += fmaxf(a[o], 0.0f) * w2h;
    }
    float* buf = part + (ch & 1) * kNNWarps * kPartStride;
    const float mine = warp_reduce_scatter<kChunk / 2>(v, lane);
    buf[warp * kPartStride + lane] = mine;
    if (ch == 0) {
      const float sq = warp_sum(w_sq);
      if (lane == 0) buf[warp * kPartStride + 32] = sq;
    }
    __syncthreads();
    // Lane o: the prediction of observation c0 + o, the team's warps added
    // in order (the same bits in every warp of the team).
    float pred = 0.0f;
    for (int w = 0; w < team_warps; ++w)
      pred += buf[(first + w) * kPartStride + lane];
    const float r = lane < bc ? yo - (pred + b2) : 0.0f;
    const float gr = gam * r;
    sum_r2 += warp_sum(r * r);
    db2 += warp_sum(gr);
    if (ch == 0) {
      float sq = 0.0f;
      for (int w = 0; w < team_warps; ++w)
        sq += buf[(first + w) * kPartStride + 32];
      w_sq = sq + b2 * b2;
    }

    // Backward over the chunk, per unit.
    const bool last = ch == chunks - 1;
    for (int u = 0; u < units; ++u) {
      const int h = tt + u * team_threads;
      const bool ok = live && h < H;
      if (units > 1)
        pre_activations(t, X, f, H, h, ok, c0, bc, b1h, w2h, a, nullptr);
      float db1 = 0.0f, dw2 = 0.0f;
#pragma unroll
      for (int o = 0; o < kObs; ++o) {
        const float gro = __shfl_sync(0xffffffffu, gr, o);
        dw2 += gro * fmaxf(a[o], 0.0f);
        const float da = a[o] > 0.0f ? gro * w2h : 0.0f;
        db1 += da;
        a[o] = da;
      }
      if (!ok) continue;
      const float prev_b1 = ch > 0 ? g[h] : 0.0f;
      const float prev_w2 = ch > 0 ? g[H + 3 + f * H + h] : 0.0f;
      g[h] = last ? (c.s * (prev_b1 + db1) - lam * b1h) * c.inv_nt
                  : prev_b1 + db1;
      g[H + 3 + f * H + h] =
          last ? (c.s * (prev_w2 + dw2) - lam * w2h) * c.inv_nt
               : prev_w2 + dw2;
      for (int j = 0; j < f; ++j) {
        float dw1 = 0.0f;
#pragma unroll
        for (int o = 0; o < kObs; ++o)
          if (o < bc) dw1 += __ldg(X + (c0 + o) * f + j) * a[o];
        float* dst = g + H + 3 + j * H + h;
        const float tot = (ch > 0 ? *dst : 0.0f) + dw1;
        *dst = last ? (c.s * tot - lam * __ldg(t + H + 3 + j * H + h)) *
                          c.inv_nt
                    : tot;
      }
    }
  }
  if (live && tt == 0) {
    g[H] = (c.s * db2 - lam * b2) * c.inv_nt;
    g[H + 1] = (c.s * (-0.5f * gam * sum_r2 + 0.5f * c.B) + c.am1 -
                c.beta * gam) * c.inv_nt;
    g[H + 2] = (c.am1 - c.beta * lam + 0.5f * c.n_weights -
                0.5f * lam * w_sq) * c.inv_nt;
    const float log_l = -0.5f * gam * sum_r2 + c.B * (0.5f * lg - c.half_log_2pi);
    const float g_lam = c.c_prior + c.am1 * ll - c.beta * lam;
    const float g_gam = c.c_prior + c.am1 * lg - c.beta * gam;
    const float prior_w =
        -0.5f * lam * w_sq + c.n_weights * (0.5f * ll - c.half_log_2pi);
    logp[i] = (c.s * log_l + g_lam + g_gam + prior_w) * c.inv_nt;
  }
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

int stein_max_smem() { return 232448; }   // 227 KB, a block's opt-in limit

int stein_nn_grad_smem(int B, int f) {
  return static_cast<int>(nn_smem(B, f));
}

// B7: logp [n] and grads [n, p] of theta [n, p]; X [B, f], y [B];
// consts = s, 1/n_train, alpha - 1, beta, n_weights, alpha log beta -
// lgamma(alpha), log(2 pi)/2, B.
int stein_nn_grads(const float* theta, int n, int p, const float* X,
                   const float* y, int B, int f, int H, const float* consts,
                   float* logp, float* grads, void* stream) {
  const NNConsts c{consts[0], consts[1], consts[2], consts[3],
                   consts[4], consts[5], consts[6], consts[7]};
  const size_t smem = nn_smem(B, f);
  cudaError_t err = cudaSuccess;
  const int team_warps = nn_team_warps(H);
  const int per_block = kNNWarps / team_warps;
  const dim3 grid((n + per_block - 1) / per_block);
  const dim3 block(32 * team_warps * per_block);
  if ((err = set_smem(reinterpret_cast<const void*>(nn_grad_kernel),
                      smem)) != cudaSuccess)
    return err;
  nn_grad_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      theta, n, p, X, y, B, f, H, team_warps, c, logp, grads);
  return cudaGetLastError();
}

}  // extern "C"
