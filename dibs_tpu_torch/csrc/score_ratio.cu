// The REINFORCE ratio of the score estimator as one weighted pass over the
// hard graphs (#10).
//
// Replaces no TPU kernel: dibs_tpu leaves the ratio to XLA
// (dibs_tpu/inference/estimators.py:262-293), where it is the signed
// logsumexp over per-sample gradients grad_Z log p(G_m | Z) [P, M, d, k, 2].
// Eager PyTorch wrote that tensor (839 MB at P = 100, M = 64, d = k = 128)
// and passed over it some ten times. The ratio is linear in the residuals
// alpha (G_m - p), so with the self-normalized weights w [P, M] (the
// numerator's signs and log-weights less the denominator's logsumexp,
// computed by the caller) it is R @ V and R^T @ U with
//   R[p] = alpha (sum_m w[p, m] G[p, m] - (sum_m w[p, m]) prob[p]),
// zero on the diagonal. This kernel writes R; the caller makes the two
// [P, d, d] @ [P, d, k] products.
//
// Bound on this card: bytes. It reads the graphs once (P M d^2 floats: 419
// MB at P = 100, M = 64, d = 128, 0.125 ms at 3.35 TB/s), and prob and R
// are 1/M of that; the 2 P M d^2 operations are 0.003 ms of float32 peak.
// The design:
//   * a thread owns `kVec` adjacent elements (4 where d * d % 4 == 0 and
//     the tensors are 16-byte aligned: 16-byte loads along (i, j), a warp
//     reading 512 contiguous bytes a sample; else 1) of one particle's
//     d x d block and loops over the samples, kUnroll loads in flight;
//   * the block stages its particle's weights in shared memory, kChunk at
//     a time (any M), as float64;
//   * sums are float64 in ascending m, and every thread of a particle forms
//     sum_m w_m in the same order: no atomics and no cross-thread
//     reduction, so two launches give the same bits, and R is within one
//     float32 rounding of exact (the PyTorch twin, gpu_kernels.
//     score_ratio_plain, sums in float64 too). The last step rounds each
//     product and difference explicitly (no FMA contraction), as the twin.
// A ragged d * d (the scalar build) and a last block past the particle's
// elements are masked; particles beyond gridDim.y's 65,535 take further
// launches.
#include "common.h"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;   // sample loads in flight a thread
constexpr int kChunk = 256;  // weights staged a pass

template <int kVec>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ void add(double (&acc)[4], double w,
                                             const float4& v) {
    acc[0] += w * static_cast<double>(v.x);
    acc[1] += w * static_cast<double>(v.y);
    acc[2] += w * static_cast<double>(v.z);
    acc[3] += w * static_cast<double>(v.w);
  }
};

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ void add(double (&acc)[1], double w,
                                             float v) {
    acc[0] += w * static_cast<double>(v);
  }
};

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    score_ratio_kernel(const float* __restrict__ g,
                       const float* __restrict__ w,
                       const float* __restrict__ prob,
                       float* __restrict__ out, int n_samples, int d,
                       double alpha) {
  using V = Vec<kVec>;
  using T = typename V::T;
  __shared__ double ws[kChunk];
  const int dd = d * d;
  const int e = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  const bool active = e < dd;
  const int64_t p = blockIdx.y;
  const float* gp = g + p * n_samples * dd + (active ? e : 0);
  const float* wp = w + p * n_samples;
  double acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.0;
  double wsum = 0.0;
  for (int m0 = 0; m0 < n_samples; m0 += kChunk) {
    const int mn = min(kChunk, n_samples - m0);
    __syncthreads();  // the previous chunk's weights are used up
    for (int i = threadIdx.x; i < mn; i += kThreads) {
      ws[i] = static_cast<double>(wp[m0 + i]);
    }
    __syncthreads();
    const float* gm = gp + static_cast<int64_t>(m0) * dd;
    int m = 0;
    if (active) {
      for (; m + kUnroll <= mn; m += kUnroll) {
        T v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = __ldg(reinterpret_cast<const T*>(
              gm + static_cast<int64_t>(m + u) * dd));
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) V::add(acc, ws[m + u], v[u]);
      }
      for (; m < mn; ++m) {
        V::add(acc, ws[m],
               __ldg(reinterpret_cast<const T*>(
                   gm + static_cast<int64_t>(m) * dd)));
      }
    }
    for (int i = 0; i < mn; ++i) wsum += ws[i];
  }
  if (!active) return;
  const float* pp = prob + p * dd + e;
  float r[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int idx = e + k;
    const double q = static_cast<double>(pp[k]);
    const double v = __dmul_rn(alpha, __dadd_rn(acc[k], -__dmul_rn(wsum, q)));
    r[k] = idx % (d + 1) == 0 ? 0.0f : static_cast<float>(v);
  }
  float* op = out + p * dd + e;
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(op) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    op[0] = r[0];
  }
}

}  // namespace

// R [P, d, d] from the graphs g [P, M, d, d], the weights w [P, M] and the
// edge probabilities prob [P, d, d] (row-major float32; 16-byte aligned and
// d * d % 4 == 0 for vec = 4).
DIBS_API int dibs_score_ratio(const float* g, const float* w,
                              const float* prob, float* out,
                              int n_particles, int n_samples, int d,
                              double alpha, int vec,
                              cudaStream_t stream) {
  if (n_particles < 0 || n_samples < 0 || d < 1 || d > 46340 ||
      (vec != 1 && vec != 4) || (d * d) % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dd = d * d;
  const int per_block = kThreads * vec;
  const unsigned blocks = static_cast<unsigned>((dd + per_block - 1) /
                                                per_block);
  for (int64_t p0 = 0; p0 < n_particles; p0 += 65535) {
    const int np = static_cast<int>(
        n_particles - p0 < 65535 ? n_particles - p0 : 65535);
    const dim3 grid(blocks, np);
    const float* gb = g + p0 * n_samples * dd;
    const float* wb = w + p0 * n_samples;
    const float* pb = prob + p0 * dd;
    float* ob = out + p0 * dd;
    if (vec == 4) {
      score_ratio_kernel<4><<<grid, kThreads, 0, stream>>>(
          gb, wb, pb, ob, n_samples, d, alpha);
    } else {
      score_ratio_kernel<1><<<grid, kThreads, 0, stream>>>(
          gb, wb, pb, ob, n_samples, d, alpha);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
