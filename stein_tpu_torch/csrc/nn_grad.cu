// Kernel B7, the Bayesian-NN log-posterior and its hand-derived gradient
// for every particle; replaces stein_tpu/models/bayesian_nn.py:
// _nn_grad_kernel. The model is the 1-hidden-layer ReLU MLP of
// models/bayesian_nn.py with Gamma hyperpriors on the two log-precisions.
//
// One warp per particle, lanes over the hidden units; the batch X [B, f]
// and y [B] sit in shared memory. Pass 1 loops over the B observations:
// each lane's share of relu(a) . w2, a warp shuffle sum for the
// prediction, the residual r kept in the warp's shared row. Pass 2 walks
// the lane's hidden units and loops over the observations again for the
// gradients of b1, w2 and each w1 row, written straight into the [n, p]
// gradient in the ravel layout b_1 [H] | b_2 | log_gamma | log_lambda |
// w_1 [f*H] | w_2 [H]; lane 0 writes the scalars and log_p. Any f, H, B
// (B*(f+9) floats of shared memory).
//
// Bound on the H100 at the NN shape (n = 1000, H = 100, B = 20, f = 1):
// ~3 B H n = 6 MFLOP and a 2.4 MB read + write of theta and the gradient;
// launch latency and the per-observation shuffle chain set the time.

#include <cuda_runtime.h>

#include "common.cuh"

namespace stein {
namespace {

constexpr int kNNWarps = 8;
constexpr int kNNThreads = 32 * kNNWarps;

// The scalars of the backward, rounded to f32 on the host.
struct NNConsts {
  float s, inv_nt, am1, beta, n_weights, c_prior, half_log_2pi, B;
};

size_t nn_smem(int B, int f) {
  return sizeof(float) * (static_cast<size_t>(B) * f + B + kNNWarps * B);
}

__device__ __forceinline__ float pre_act(const float* x, const float* w1,
                                         float b1h, int f, int H, int h) {
  float a = b1h;
  for (int j = 0; j < f; ++j) a = a + x[j] * w1[j * H + h];
  return a;
}

__global__ void __launch_bounds__(kNNThreads)
    nn_grad_kernel(const float* __restrict__ theta, int n, int p,
                   const float* __restrict__ X, const float* __restrict__ y,
                   int B, int f, int H, NNConsts c, float* __restrict__ logp,
                   float* __restrict__ grads) {
  extern __shared__ float sm[];
  float* xs = sm;                 // [B][f]
  float* ys = xs + B * f;         // [B]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* rs = ys + B + warp * B;  // this warp's residuals [B]
  for (int e = threadIdx.x; e < B * f; e += blockDim.x) xs[e] = X[e];
  for (int e = threadIdx.x; e < B; e += blockDim.x) ys[e] = y[e];
  __syncthreads();
  const int i = blockIdx.x * kNNWarps + warp;
  if (i >= n) return;

  const float* t = theta + static_cast<size_t>(i) * p;
  const float* b1 = t;
  const float b2 = t[H], lg = t[H + 1], ll = t[H + 2];
  const float* w1 = t + H + 3;
  const float* w2 = w1 + f * H;
  const float gam = expf(lg), lam = expf(ll);

  float sum_r2 = 0.0f, db2 = 0.0f;
  for (int o = 0; o < B; ++o) {
    float part = 0.0f;
    for (int h = lane; h < H; h += 32)
      part += fmaxf(pre_act(xs + o * f, w1, b1[h], f, H, h), 0.0f) * w2[h];
    const float r = ys[o] - (warp_sum(part) + b2);
    if (lane == 0) rs[o] = r;
    sum_r2 += r * r;
    db2 += gam * r;
  }
  __syncwarp();

  float* g = grads + static_cast<size_t>(i) * p;
  float w_sq = 0.0f;
  for (int h = lane; h < H; h += 32) {
    const float b1h = b1[h], w2h = w2[h];
    float db1 = 0.0f, dw2 = 0.0f;
    for (int o = 0; o < B; ++o) {
      const float a = pre_act(xs + o * f, w1, b1h, f, H, h);
      const float gr = gam * rs[o];
      dw2 += gr * fmaxf(a, 0.0f);
      if (a > 0.0f) db1 += gr * w2h;
    }
    g[h] = (c.s * db1 - lam * b1h) * c.inv_nt;
    g[H + 3 + f * H + h] = (c.s * dw2 - lam * w2h) * c.inv_nt;
    w_sq += b1h * b1h + w2h * w2h;
    for (int j = 0; j < f; ++j) {
      const float w1jh = w1[j * H + h];
      float dw1 = 0.0f;
      for (int o = 0; o < B; ++o) {
        const float a = pre_act(xs + o * f, w1, b1h, f, H, h);
        if (a > 0.0f) dw1 += xs[o * f + j] * (gam * rs[o] * w2h);
      }
      g[H + 3 + j * H + h] = (c.s * dw1 - lam * w1jh) * c.inv_nt;
      w_sq += w1jh * w1jh;
    }
  }
  w_sq = warp_sum(w_sq) + b2 * b2;
  if (lane == 0) {
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
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(nn_grad_kernel), smem);
  if (err != cudaSuccess) return err;
  nn_grad_kernel<<<(n + kNNWarps - 1) / kNNWarps, kNNThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      theta, n, p, X, y, B, f, H, c, logp, grads);
  return cudaGetLastError();
}

}  // extern "C"
