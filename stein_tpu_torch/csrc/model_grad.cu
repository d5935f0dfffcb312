// The in-kernel model stage of B1 (stein_tpu/ops/pallas_step.py:
// _tail_kernel's model_grad branch): every particle's log-posterior
// gradient and log_p value, for the two model kinds the fused step knows.
// On the TPU the model's jnp grad_fn was traced into the step kernel; CUDA
// cannot trace Python, so each kind is a kernel of its own, launched first
// in B1's chain, whose gradients then feed the rest of the chain.
//
//   glm_grad_kernel       the explicit quadratic log_p(w) = -w^T A w / 2 +
//                         b^T w (pallas_step.py:_glm_grad): G = theta A,
//                         grads = b - G, log_p_i = theta_i . (b - G_i / 2).
//   logistic_grad_kernel  the hierarchical logistic likelihood
//                         (stein_tpu/models/logistic_regression.py:
//                         inkernel_model's grad_fn): logits = theta X_pad^T,
//                         sig = 1 / (1 + exp(-logits)), the likelihood
//                         gradient (y - sig) X_pad scaled by n_train /
//                         n_batch, the weight prior -alpha w and the
//                         log_alpha column; log_p_i with the sigmoid
//                         cross-entropy in its max(x,0) - x z +
//                         log1p(exp(-|x|)) form.
//
// One warp per particle, lanes over the output columns (glm) or over the
// observations and then the columns (logistic); the particle's row, the
// operands (logistic: X_pad, y and the two column masks) sit in shared
// memory. Each lane sums its products in index order, and a row's log_p is
// one butterfly sum, so two calls are bitwise equal. The per-row log_p goes
// to device memory; B1's clip_update_kernel takes their mean in a fixed
// order.
//
// Bounds on the H100 (f32 on the CUDA cores): glm at n=1000, p=128 is
// 2 n p^2 = 33 MFLOP (0.5 us at 67 TFLOP/s) over 1 MB of theta and grads;
// logistic at n=1000, p=55, N=50 observations is 4 n N p = 11 MFLOP over
// 0.45 MB. Both are a few microseconds of work, so launch latency and the
// warp's serial walk over p (glm) or N (logistic) set the time.

#include <cuda_runtime.h>

#include "common.cuh"

namespace stein {
namespace {

constexpr int kGradWarps = 8;
constexpr int kGradThreads = 32 * kGradWarps;

__global__ void __launch_bounds__(kGradThreads)
    glm_grad_kernel(const float* __restrict__ theta, int n, int p,
                    const float* __restrict__ A, const float* __restrict__ b,
                    float* __restrict__ grads, float* __restrict__ logp) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kGradWarps + warp;
  if (i >= n) return;
  float* th = sm + warp * p;
  const float* t = theta + static_cast<size_t>(i) * p;
  for (int k = lane; k < p; k += 32) th[k] = t[k];
  __syncwarp();
  float term = 0.0f;
  for (int k = lane; k < p; k += 32) {
    float g = 0.0f;
    for (int j = 0; j < p; ++j) g += th[j] * __ldg(A + static_cast<size_t>(j) * p + k);
    const float bk = __ldg(b + k);
    grads[static_cast<size_t>(i) * p + k] = bk - g;
    term += th[k] * (bk - 0.5f * g);
  }
  term = warp_sum(term);
  if (lane == 0) logp[i] = term;
}

struct LogisticConsts {
  float scale;    // n_train / n_batch
  float half_d;   // n_feats / 2
};

__global__ void __launch_bounds__(kGradThreads)
    logistic_grad_kernel(const float* __restrict__ theta, int n, int p,
                         const float* __restrict__ X, const float* __restrict__ y,
                         int N, const float* __restrict__ w_mask,
                         const float* __restrict__ la_onehot, LogisticConsts c,
                         float* __restrict__ grads, float* __restrict__ logp) {
  extern __shared__ float sm[];
  float* xs = sm;              // [N][p]
  float* ys = xs + N * p;      // [N]
  float* wm = ys + N;          // [p]
  float* lo = wm + p;          // [p]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* th = lo + p + warp * (p + N);   // this warp's particle [p]
  float* rs = th + p;                    // and its residuals y - sig [N]
  for (int e = threadIdx.x; e < N * p; e += blockDim.x) xs[e] = X[e];
  for (int e = threadIdx.x; e < N; e += blockDim.x) ys[e] = y[e];
  for (int e = threadIdx.x; e < p; e += blockDim.x) {
    wm[e] = w_mask[e];
    lo[e] = la_onehot[e];
  }
  __syncthreads();
  const int i = blockIdx.x * kGradWarps + warp;
  if (i >= n) return;

  const float* t = theta + static_cast<size_t>(i) * p;
  float la = 0.0f, wsq = 0.0f;
  for (int k = lane; k < p; k += 32) {
    const float v = t[k];
    th[k] = v;
    la += v * lo[k];
    const float w = v * wm[k];
    wsq += w * w;
  }
  la = warp_sum(la);
  wsq = warp_sum(wsq);
  __syncwarp();

  float sce = 0.0f;
  for (int o = lane; o < N; o += 32) {
    float x = 0.0f;
    for (int k = 0; k < p; ++k) x += th[k] * xs[o * p + k];
    const float sig = 1.0f / (1.0f + expf(-x));
    rs[o] = ys[o] - sig;
    sce += (fmaxf(x, 0.0f) - x * ys[o]) + log1pf(expf(-fabsf(x)));
  }
  sce = warp_sum(sce);
  __syncwarp();

  const float alpha = expf(la);
  const float g_la = c.half_d - 0.5f * alpha * wsq - 0.01f * alpha;
  float* g = grads + static_cast<size_t>(i) * p;
  for (int k = lane; k < p; k += 32) {
    float glik = 0.0f;
    for (int o = 0; o < N; ++o) glik += rs[o] * xs[o * p + k];
    g[k] = (c.scale * glik - alpha * (th[k] * wm[k])) + lo[k] * g_la;
  }
  if (lane == 0)
    logp[i] = -c.scale * sce + c.half_d * la - 0.5f * alpha * wsq -
              0.01f * alpha;
}

size_t glm_smem(int p) { return sizeof(float) * kGradWarps * p; }

size_t logistic_smem(int p, int N) {
  return sizeof(float) *
         (static_cast<size_t>(N) * p + N + 2 * p + kGradWarps * (p + N));
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

int stein_glm_grad_smem(int p) { return static_cast<int>(glm_smem(p)); }

int stein_logistic_grad_smem(int p, int N) {
  return static_cast<int>(logistic_smem(p, N));
}

// grads [n, p] = b - theta A and logp [n] = theta_i . (b - (theta A)_i / 2)
// for theta [n, p], A [p, p], b [p].
int stein_glm_grads(const float* theta, int n, int p, const float* A,
                    const float* b, float* grads, float* logp, void* stream) {
  const size_t smem = glm_smem(p);
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(glm_grad_kernel), smem);
  if (err != cudaSuccess) return err;
  glm_grad_kernel<<<(n + kGradWarps - 1) / kGradWarps, kGradThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(theta, n, p, A, b,
                                                         grads, logp);
  return cudaGetLastError();
}

// The logistic model's grads [n, p] and logp [n] (minus the constant) for
// theta [n, p], X_pad [N, p], y [N], the column masks w_mask, la_onehot
// [p]; scale = n_train / n_batch, half_d = n_feats / 2.
int stein_logistic_grads(const float* theta, int n, int p, const float* X,
                         const float* y, int N, const float* w_mask,
                         const float* la_onehot, float scale, float half_d,
                         float* grads, float* logp, void* stream) {
  const size_t smem = logistic_smem(p, N);
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(logistic_grad_kernel), smem);
  if (err != cudaSuccess) return err;
  logistic_grad_kernel<<<(n + kGradWarps - 1) / kGradWarps, kGradThreads,
                         smem, static_cast<cudaStream_t>(stream)>>>(
      theta, n, p, X, y, N, w_mask, la_onehot, LogisticConsts{scale, half_d},
      grads, logp);
  return cudaGetLastError();
}

}  // extern "C"
