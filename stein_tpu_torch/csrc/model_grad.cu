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
// glm_grad_kernel is a register-tiled product for Hopper: a block holds 16
// particles and walks the 128-column groups of G in order (one group where
// p <= 128). Per 128-row k-chunk the block stages A's [128, 128] tile and
// its particles' [16, 128] rows in shared memory once (float4 loads all in
// flight where p is a multiple of 4); each of its 256 threads then holds a
// 2 x 4 block of G in registers, so its eight FMAs per k are independent (a
// float4 of A and two broadcasts of theta), with two warps a scheduler. The
// epilogue writes b - G and adds theta_ik (b_k - G_ik / 2) in column order;
// the 32 column threads of a row sum by a butterfly, so two calls are
// bitwise equal. At n = 1000, p = 128: 63 blocks of 8 warps; at n = 50, 4.

// logistic_grad_kernel runs one warp per particle, lanes over the
// observations and then the columns; X_pad, y and the two column masks sit
// in shared memory. Each lane sums its products in index order, and a
// row's log_p is one butterfly sum, so two calls are bitwise equal. The
// per-row log_p goes to device memory; B1's clip_update_kernel takes their
// mean in a fixed order.
//
// Bounds on the H100 (f32 on the CUDA cores): glm at n=1000, p=128 is
// 2 n p^2 + 4 n p = 33 MFLOP (0.50 us at 67 TFLOP/s) over 1.09 MB of theta,
// A, b, grads and log_p (0.33 us at 3.35 TB/s): 0.50 us, by operations.
// Logistic at n=1000, p=55, N=50 observations is 4 n N p = 11 MFLOP over
// 0.45 MB. Both are a few microseconds of work, so launch latency and
// (logistic) the warp's serial walk over N set the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace stein {
namespace {

constexpr int kGradWarps = 8;
constexpr int kGradThreads = 32 * kGradWarps;

constexpr int kGlmColThreads = 32;             // x 4 columns = one group
constexpr int kGlmThreads = 256;
constexpr int kGlmRT = 2;                      // rows per thread
constexpr int kGlmRows = kGlmRT * (kGlmThreads / kGlmColThreads);   // 16
constexpr int kGlmGroup = 4 * kGlmColThreads;  // 128 columns
constexpr int kGlmK = 128;                     // k-chunk
// A's [k-chunk, group] tile and the rows' [16, k-chunk] in shared memory.
constexpr size_t kGlmSmem =
    sizeof(float) * (kGlmK * kGlmGroup + kGlmRows * (kGlmK + 4));

// vec: p % 4 == 0 and theta, A 16-byte aligned, so the staging loads are
// float4s (a float4 of a row lies wholly inside or past column p), all
// independent, in flight together.
__global__ void __launch_bounds__(kGlmThreads)
    glm_grad_kernel(const float* __restrict__ theta, int n, int p,
                    const float* __restrict__ A, const float* __restrict__ b,
                    float* __restrict__ grads, float* __restrict__ logp,
                    int vec) {
  extern __shared__ float4 glm_sm4[];
  auto as = reinterpret_cast<float (*)[kGlmGroup]>(glm_sm4);
  auto ts = reinterpret_cast<float (*)[kGlmK + 4]>(
      reinterpret_cast<float*>(glm_sm4) + kGlmK * kGlmGroup);
  const int tx = threadIdx.x % kGlmColThreads, ty = threadIdx.x / kGlmColThreads;
  const int row0 = blockIdx.x * kGlmRows;
  const int groups = (p + kGlmGroup - 1) / kGlmGroup;
  float term[kGlmRT] = {};
  for (int gi = 0; gi < groups; ++gi) {
    const int c0 = gi * kGlmGroup;
    float acc[kGlmRT][4] = {}, bk[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)   // loaded early, in flight with A
      bk[c] = c0 + 4 * tx + c < p ? __ldg(b + c0 + 4 * tx + c) : 0.0f;
    for (int k0 = 0; k0 < p; k0 += kGlmK) {
      const int kw = min(kGlmK, p - k0);
      if (vec) {
        // A fixed trip count, fully unrolled: every load in flight at once.
        constexpr int kG4 = kGlmGroup / 4;
        constexpr int kK4 = kGlmK / 4;
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 va[kGlmK * kG4 / kGlmThreads], vt[kGlmRows * kK4 / kGlmThreads];
#pragma unroll
        for (int i = 0; i < kGlmK * kG4 / kGlmThreads; ++i) {
          const int e = threadIdx.x + i * kGlmThreads;
          const int k = e / kG4, c = 4 * (e % kG4);
          va[i] = k < kw && c0 + c < p
                      ? __ldg(reinterpret_cast<const float4*>(
                            A + static_cast<size_t>(k0 + k) * p + c0 + c))
                      : zero;
        }
#pragma unroll
        for (int i = 0; i < kGlmRows * kK4 / kGlmThreads; ++i) {
          const int e = threadIdx.x + i * kGlmThreads;
          const int r = e / kK4, k = 4 * (e % kK4);
          vt[i] = row0 + r < n && k < kw
                      ? __ldg(reinterpret_cast<const float4*>(
                            theta + static_cast<size_t>(row0 + r) * p + k0 + k))
                      : zero;
        }
#pragma unroll
        for (int i = 0; i < kGlmK * kG4 / kGlmThreads; ++i) {
          const int e = threadIdx.x + i * kGlmThreads;
          *reinterpret_cast<float4*>(&as[e / kG4][4 * (e % kG4)]) = va[i];
        }
#pragma unroll
        for (int i = 0; i < kGlmRows * kK4 / kGlmThreads; ++i) {
          const int e = threadIdx.x + i * kGlmThreads;
          float* t = &ts[e / kK4][4 * (e % kK4)];
          t[0] = vt[i].x;
          t[1] = vt[i].y;
          t[2] = vt[i].z;
          t[3] = vt[i].w;
        }
      } else {
        for (int e = threadIdx.x; e < kw * kGlmGroup; e += kGlmThreads) {
          const int k = e / kGlmGroup, c = e % kGlmGroup;
          as[k][c] = c0 + c < p
                         ? __ldg(A + static_cast<size_t>(k0 + k) * p + c0 + c)
                         : 0.0f;
        }
        for (int e = threadIdx.x; e < kGlmRows * kw; e += kGlmThreads) {
          const int r = e / kw, k = e % kw;
          ts[r][k] = row0 + r < n
                         ? __ldg(theta + static_cast<size_t>(row0 + r) * p + k0 + k)
                         : 0.0f;
        }
      }
      __syncthreads();
      // Unrolled so that eight k's shared loads are in flight together.
#pragma unroll 8
      for (int k = 0; k < kw; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&as[k][4 * tx]);
#pragma unroll
        for (int r = 0; r < kGlmRT; ++r) {
          const float t = ts[kGlmRT * ty + r][k];
          acc[r][0] += t * av.x;
          acc[r][1] += t * av.y;
          acc[r][2] += t * av.z;
          acc[r][3] += t * av.w;
        }
      }
      __syncthreads();
    }
    // One k-chunk (p <= 128): the rows' theta is still in shared memory.
#pragma unroll
    for (int r = 0; r < kGlmRT; ++r) {
      const int i = row0 + kGlmRT * ty + r;
      if (i >= n) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = c0 + 4 * tx + c;
        if (k >= p) continue;
        const float g = acc[r][c];
        const float t = p <= kGlmK
                            ? ts[kGlmRT * ty + r][k]
                            : __ldg(theta + static_cast<size_t>(i) * p + k);
        grads[static_cast<size_t>(i) * p + k] = bk[c] - g;
        term[r] += t * (bk[c] - 0.5f * g);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kGlmRT; ++r) {
    float v = term[r];
    for (int o = kGlmColThreads / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    const int i = row0 + kGlmRT * ty + r;
    if (tx == 0 && i < n) logp[i] = v;
  }
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

size_t logistic_smem(int p, int N) {
  return sizeof(float) *
         (static_cast<size_t>(N) * p + N + 2 * p + kGradWarps * (p + N));
}

}  // namespace
}  // namespace stein

using namespace stein;

extern "C" {

int stein_logistic_grad_smem(int p, int N) {
  return static_cast<int>(logistic_smem(p, N));
}

// grads [n, p] = b - theta A and logp [n] = theta_i . (b - (theta A)_i / 2)
// for theta [n, p], A [p, p], b [p].
int stein_glm_grads(const float* theta, int n, int p, const float* A,
                    const float* b, float* grads, float* logp, void* stream) {
  const int vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(theta) % 16 == 0;
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(glm_grad_kernel), kGlmSmem);
  if (err != cudaSuccess) return err;
  glm_grad_kernel<<<(n + kGlmRows - 1) / kGlmRows, kGlmThreads, kGlmSmem,
                    static_cast<cudaStream_t>(stream)>>>(theta, n, p, A, b,
                                                         grads, logp, vec);
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
