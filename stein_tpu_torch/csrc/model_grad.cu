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

// logistic_grad_kernel treats the stage as two small products with an
// elementwise pass between them: logits = theta X_pad^T [n, N], the
// residuals y - sig(logits) with the sigmoid cross-entropy terms, then G =
// scale (y - sig) X_pad [n, p] and the prior columns. A block of 8 warps
// holds 4 particles (250 blocks at n = 1000, two an SM) and runs in three
// phases between two barriers:
//   - loads: its operands into shared memory, each thread's loads of a
//     batch in flight before its stores: X_pad (rows an odd stride apart,
//     no bank conflicts down a column) by six warps, the particles
//     transposed (a float4 a column) by one, y and the masks by one;
//   - logits: a group of 1, 2 or 4 adjacent lanes an observation, each a 4
//     x 1 register tile (the 4 particles: a float4 of them and one X_pad
//     value feed four independent FMAs an index) over its chunk of the
//     columns; the group's butterfly adds the chunks, then its lanes share
//     the 4 particles' transcendentals (the sigmoid and log1p(exp(-|x|)))
//     and write the residuals; the last warp meanwhile forms the
//     particles' log_alpha and |w|^2 sums;
//   - gradients: the same over the observations, a group a column, its
//     lanes writing the 4 particles' gradient entries; the last warp sums
//     the cross-entropy terms and writes log_p.
// At the Covertype shape (N = 50, p = 55) every group has 4 lanes, so
// each thread's chain is 14 (logits) or 13 (G) long. Every sum runs in a
// fixed order (the butterflies are the same in every lane), so two calls
// are bitwise equal. The per-row log_p goes to device memory; B1's
// clip_update_kernel takes their mean in a fixed order.
//
// Bounds on the H100 (f32 on the CUDA cores): glm at n=1000, p=128 is
// 2 n p^2 + 4 n p = 33 MFLOP (0.50 us at 67 TFLOP/s) over 1.09 MB of theta,
// A, b, grads and log_p (0.33 us at 3.35 TB/s): 0.50 us, by operations.
// Logistic at n=1000, p=55, N=50 observations is 4 n N p = 11 MFLOP (0.17
// us) over 0.45 MB (0.14 us): 0.17 us, by operations. Both are a few
// microseconds of work, so latency sets the time: the launch, the operand
// loads' round trip and (logistic) the two product phases, whose shared-
// memory loads and instructions, not their FMAs, set their length. The
// logistic kernel's code is kept small (a load batch of 8, the product
// loops not unrolled): larger unrolled bodies ran slower on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace stein {
namespace {

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

constexpr int kLogRows = 4;       // particles a block: a float4 of each
constexpr int kLogThreads = 256;
constexpr int kLogWarps = kLogThreads / 32;
constexpr int kLogXWarps = kLogWarps - 2;   // the warps that load X_pad
constexpr int kLogBatch = 8;      // operand loads a thread keeps in flight

struct LogisticConsts {
  float scale;    // n_train / n_batch
  float half_d;   // n_feats / 2
};

// The lanes that split a product's contraction when it has `items` outputs
// a particle: as many as keep the block's threads busy, 1, 2 or 4 (a
// power of two, so a group of them lies in one warp).
__host__ __device__ inline int log_splits(int items) {
  return items <= kLogThreads / 4 ? 4 : (items <= kLogThreads / 2 ? 2 : 1);
}

// The float4 column u[i] (4 particles) contracted with v[i * stride] over
// i in [i0, i1), in index order.
__device__ __forceinline__ float4 dot4(const float4* u, const float* v,
                                       int stride, int i0, int i1) {
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = i0; i < i1; ++i) {
    const float4 t = u[i];
    const float w = v[i * stride];
    a.x += t.x * w;
    a.y += t.y * w;
    a.z += t.z * w;
    a.w += t.w * w;
  }
  return a;
}

// The sum over a group of `lanes` adjacent lanes (1, 2 or 4), in every
// lane of it: the same butterfly in every lane, so bitwise the same sum.
__device__ __forceinline__ float4 group_sum(float4 a, int lanes) {
  for (int d = 1; d < lanes; d <<= 1) {
    a.x += __shfl_xor_sync(0xffffffffu, a.x, d);
    a.y += __shfl_xor_sync(0xffffffffu, a.y, d);
    a.z += __shfl_xor_sync(0xffffffffu, a.z, d);
    a.w += __shfl_xor_sync(0xffffffffu, a.w, d);
  }
  return a;
}

__device__ __forceinline__ float comp(const float4& a, int r) {
  return r == 0 ? a.x : (r == 1 ? a.y : (r == 2 ? a.z : a.w));
}

__global__ void __launch_bounds__(kLogThreads)
    logistic_grad_kernel(const float* __restrict__ theta, int n, int p,
                         const float* __restrict__ X, const float* __restrict__ y,
                         int N, const float* __restrict__ w_mask,
                         const float* __restrict__ la_onehot, LogisticConsts c,
                         float* __restrict__ grads, float* __restrict__ logp) {
  extern __shared__ float4 log_sm4[];
  const int ps = p | 1, s1 = log_splits(N), s2 = log_splits(p);
  float4* th = log_sm4;                // [p]: the 4 particles at column k
  float4* rs = th + p;                 // [N]: y - sig
  float* sm = reinterpret_cast<float*>(log_sm4);
  const int x_at = 4 * (p + N), y_at = x_at + N * ps;
  const int w_at = y_at + N, l_at = w_at + p;
  const float* xs = sm + x_at;         // [N][ps]
  const float* ys = sm + y_at;         // [N]
  const float* wm = sm + w_at;         // [p]
  const float* lo = sm + l_at;         // [p]
  float* sce = sm + l_at + p;          // [4][N]: cross-entropy terms
  float* row_c = sce + kLogRows * N;   // [4][2]: alpha, g_la
  const float* thf = sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kLogRows, rows = min(kLogRows, n - r0);

  // The operands into shared memory, each thread's loads of a batch in
  // flight before its stores: X_pad (rows ps apart) by the first warps (two
  // batches at the Covertype shape), the particles transposed (zero past
  // n) by the next, y and the masks by the last (one batch each).
  if (warp < kLogXWarps) {
    const int step = kLogXWarps * 32, nx = N * p;
    int q = tid / p, k = tid - q * p;               // element tid's place
    const int dq = step / p, dk = step - dq * p;    // and a step's move
    for (int base = 0; base < nx; base += kLogBatch * step) {
      float v[kLogBatch];
      int at[kLogBatch];
#pragma unroll
      for (int u = 0; u < kLogBatch; ++u) {
        const int i = base + tid + u * step;
        v[u] = i < nx ? __ldg(X + i) : 0.0f;
        at[u] = x_at + q * ps + k;
        q += dq;
        if ((k += dk) >= p) {
          k -= p;
          ++q;
        }
      }
#pragma unroll
      for (int u = 0; u < kLogBatch; ++u)
        if (base + tid + u * step < nx) sm[at[u]] = v[u];
    }
  } else if (warp == kLogXWarps) {
    const float* t_rows = theta + static_cast<size_t>(r0) * p;
    for (int base = 0; base < kLogRows * p; base += kLogBatch * 32) {
      float v[kLogBatch];
#pragma unroll
      for (int u = 0; u < kLogBatch; ++u) {
        const int i = base + lane + 32 * u;
        v[u] = i < rows * p ? __ldg(t_rows + i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLogBatch; ++u) {
        const int i = base + lane + 32 * u;
        const int r = (i >= p) + (i >= 2 * p) + (i >= 3 * p);
        if (i < kLogRows * p) sm[4 * (i - r * p) + r] = v[u];
      }
    }
  } else {
    const int nv = N + 2 * p;
    for (int base = 0; base < nv; base += kLogBatch * 32) {
      float v[kLogBatch];
#pragma unroll
      for (int u = 0; u < kLogBatch; ++u) {
        const int i = base + lane + 32 * u;
        const float* src = i < N ? y + i
                                 : (i < N + p ? w_mask + (i - N)
                                              : la_onehot + (i - N - p));
        v[u] = i < nv ? __ldg(src) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLogBatch; ++u) {
        const int i = base + lane + 32 * u;
        if (i < nv) sm[y_at + i] = v[u];   // y, w_mask, la_onehot adjoin
      }
    }
  }
  __syncthreads();

  // The logits: a group of s1 lanes an observation o, lane s summing chunk
  // s of the p columns, the group's butterfly adding the chunks; then lane
  // s takes particles s, s + s1, ...: the residual and the sigmoid
  // cross-entropy term. The last warp meanwhile forms each particle's
  // log_alpha and |w|^2 sums, its alpha and log_alpha gradient.
  const int c1 = (p + s1 - 1) / s1, l1 = s1 == 4 ? 2 : s1 - 1;
  for (int base = warp * 32; base < s1 * N; base += kLogThreads) {
    const int it = base + lane, o = min(it >> l1, N - 1), s = it & (s1 - 1);
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (it < s1 * N)
      a = dot4(th, xs + o * ps, 1, s * c1, min(p, (s + 1) * c1));
    a = group_sum(a, s1);
    if (it < s1 * N) {
      const float yo = ys[o];
      for (int r = s; r < kLogRows; r += s1) {
        const float x = comp(a, r);
        const float sig = 1.0f / (1.0f + expf(-x));
        reinterpret_cast<float*>(rs)[4 * o + r] = yo - sig;
        sce[r * N + o] = (fmaxf(x, 0.0f) - x * yo) + log1pf(expf(-fabsf(x)));
      }
    }
  }
  float la[kLogRows] = {}, wsq[kLogRows] = {};   // the last warp's
  if (warp == kLogWarps - 1) {
    for (int k = lane; k < p; k += 32) {
      const float4 t = th[k];
#pragma unroll
      for (int r = 0; r < kLogRows; ++r) {
        const float v = comp(t, r);
        la[r] += v * lo[k];
        const float w = v * wm[k];
        wsq[r] += w * w;
      }
    }
#pragma unroll
    for (int r = 0; r < kLogRows; ++r) {
      la[r] = warp_sum(la[r]);
      wsq[r] = warp_sum(wsq[r]);
    }
    if (lane < kLogRows) {
      const int r = lane;
      const float alpha = expf(la[r]);
      row_c[2 * r] = alpha;
      row_c[2 * r + 1] = c.half_d - 0.5f * alpha * wsq[r] - 0.01f * alpha;
    }
  }
  __syncthreads();

  // The gradients: a group of s2 lanes a column k, lane s summing chunk s
  // of the observations; then lane s writes particles s, s + s2, ...: the
  // likelihood term, the weight prior and the log_alpha column. The last
  // warp meanwhile sums each particle's cross-entropy and writes log_p.
  const int c2 = (N + s2 - 1) / s2, l2 = s2 == 4 ? 2 : s2 - 1;
  for (int base = warp * 32; base < s2 * p; base += kLogThreads) {
    const int it = base + lane, k = min(it >> l2, p - 1), s = it & (s2 - 1);
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (it < s2 * p) a = dot4(rs, xs + k, ps, s * c2, min(N, (s + 1) * c2));
    a = group_sum(a, s2);
    if (it < s2 * p) {
      for (int r = s; r < rows; r += s2)
        grads[static_cast<size_t>(r0 + r) * p + k] =
            (c.scale * comp(a, r) - row_c[2 * r] * (thf[4 * k + r] * wm[k])) +
            lo[k] * row_c[2 * r + 1];
    }
  }
  if (warp == kLogWarps - 1) {
    float sc[kLogRows] = {};
    for (int o = lane; o < N; o += 32) {
#pragma unroll
      for (int r = 0; r < kLogRows; ++r) sc[r] += sce[r * N + o];
    }
#pragma unroll
    for (int r = 0; r < kLogRows; ++r) sc[r] = warp_sum(sc[r]);
#pragma unroll
    for (int r = 0; r < kLogRows; ++r) {
      const float alpha = row_c[2 * r];
      if (lane == r && r < rows)
        logp[r0 + r] = -c.scale * sc[r] + c.half_d * la[r] -
                       0.5f * alpha * wsq[r] - 0.01f * alpha;
    }
  }
}

size_t logistic_smem(int p, int N) {
  return sizeof(float) *
         (4 * static_cast<size_t>(p + N) + static_cast<size_t>(N) * (p | 1) +
          N + 2 * static_cast<size_t>(p) + kLogRows * N + 2 * kLogRows);
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
  logistic_grad_kernel<<<(n + kLogRows - 1) / kLogRows, kLogThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      theta, n, p, X, y, N, w_mask, la_onehot, LogisticConsts{scale, half_d},
      grads, logp);
  return cudaGetLastError();
}

}  // extern "C"
