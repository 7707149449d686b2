// Fused SVGD transport family.
//
// Replaces dibs_tpu/ops/transport_kernel.py::transport_phi (the pallas_call
// at :153; bodies _phi_kernel_joint and _phi_kernel_marginal). For kernel
// matrices K_own, K_other [P, P], the flat scores g and particle values
// v [P, n] (row-major float32), the column means mu [n] and the rank-1
// weight w[i] = (c / P) colsum(K_own)[i], it computes
//
//   phi = -(1/P) (K_own^T (g + c v') + K_other^T g) + w ⊙ v',  v' = v - mu,
//
// the SVGD transport (kernel-weighted scores plus SE repulsion, negated)
// by the identity K^T g + c (K_own^T v' - colsum(K_own) ⊙ v') with
// K = K_own + K_other. K_other == nullptr gives the marginal form (one
// product); mu == nullptr means no centring.
//
// Design: one block per 64 x 128 output tile of [P, n]; the contraction
// axis (the source particle m) is walked in chunks of 16. Each chunk stages
// K_own[m, i-tile], K_other[m, i-tile], the combined rhs g + c (v - mu) and
// g[m, col-tile] in shared memory (the combine and the centring are done as
// the tile is loaded, so no [P, n] intermediate touches device memory), and
// every thread accumulates a 4 x 8 register tile of both products in the
// same registers. The epilogue (the -1/P scale and the rank-1 term) is
// applied in registers before the single store. The [P, P] matrices are not
// resident (the TPU kept them in VMEM, hence its P <= 1024): the P axis is
// tiled too, so any P and n are served. float32 throughout with fused
// multiply-adds; no bf16 split and no TF32.
//
// Bound on this card: 2 P^2 n (marginal) or 4 P^2 n (joint) float32
// operations against 3 P n + 2 P^2 floats of traffic; at P = 1000 the
// family is bound by operations (2.0 ms at the H100's 67 TFLOP/s for
// n = 32,768 joint), at P = 30 by launch latency. The inner loop does
// 64 FMAs per 6 float4 shared-memory reads per thread; no tensor cores
// (they would need TF32 or a bf16 split, which the port does not take).
#include "common.h"

namespace {

constexpr int kBm = 64;    // output rows (target particles i) per block
constexpr int kBn = 128;   // output columns per block
constexpr int kBk = 16;    // contraction chunk (source particles m)
constexpr int kTm = 4;     // rows per thread
constexpr int kTn = 8;     // columns per thread: two groups of 4
constexpr int kThreads = (kBm / kTm) * (kBn / kTn);  // 256

template <bool kJoint>
__global__ void __launch_bounds__(kThreads)
    transport_phi_kernel(const float* __restrict__ k_own,
                         const float* __restrict__ k_other,
                         const float* __restrict__ g,
                         const float* __restrict__ v,
                         const float* __restrict__ mu,
                         const float* __restrict__ w, float* __restrict__ out,
                         int p, int n, float c, float neg_inv_p) {
  __shared__ __align__(16) float ka[kBk][kBm];
  __shared__ __align__(16) float kb[kJoint ? kBk : 1][kBm];
  __shared__ __align__(16) float rhs[kBk][kBn];
  __shared__ __align__(16) float gs[kJoint ? kBk : 1][kBn];

  const int tid = threadIdx.x;
  const int tx = tid % (kBn / kTn);  // 16 column groups
  const int ty = tid / (kBn / kTn);  // 16 row groups
  const int i0 = blockIdx.y * kBm;
  const int j0 = blockIdx.x * kBn;

  float acc[kTm][kTn];
#pragma unroll
  for (int r = 0; r < kTm; ++r) {
#pragma unroll
    for (int q = 0; q < kTn; ++q) acc[r][q] = 0.0f;
  }

  for (int m0 = 0; m0 < p; m0 += kBk) {
    // --- stage the chunk: K tiles [kBk, kBm], rhs and g tiles [kBk, kBn] ---
    for (int idx = tid; idx < kBk * kBm; idx += kThreads) {
      const int k = idx / kBm, i = idx - k * kBm;
      const int gm = m0 + k, gi = i0 + i;
      const bool ok = gm < p && gi < p;
      const int64_t off = static_cast<int64_t>(gm) * p + gi;
      ka[k][i] = ok ? k_own[off] : 0.0f;
      if constexpr (kJoint) kb[k][i] = ok ? k_other[off] : 0.0f;
    }
    for (int idx = tid; idx < kBk * kBn; idx += kThreads) {
      const int k = idx / kBn, j = idx - k * kBn;
      const int gm = m0 + k, gj = j0 + j;
      float gv = 0.0f, r = 0.0f;
      if (gm < p && gj < n) {
        const int64_t off = static_cast<int64_t>(gm) * n + gj;
        gv = g[off];
        const float vc = mu != nullptr ? v[off] - mu[gj] : v[off];
        r = fmaf(c, vc, gv);
      }
      rhs[k][j] = r;
      if constexpr (kJoint) gs[k][j] = gv;
    }
    __syncthreads();

    // --- both products into the same registers ---
#pragma unroll
    for (int k = 0; k < kBk; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&ka[k][ty * kTm]);
      const float a[kTm] = {a4.x, a4.y, a4.z, a4.w};
      const float4 r0 = *reinterpret_cast<const float4*>(&rhs[k][tx * 4]);
      const float4 r1 =
          *reinterpret_cast<const float4*>(&rhs[k][kBn / 2 + tx * 4]);
      const float b[kTn] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
      for (int r = 0; r < kTm; ++r) {
#pragma unroll
        for (int q = 0; q < kTn; ++q) acc[r][q] = fmaf(a[r], b[q], acc[r][q]);
      }
      if constexpr (kJoint) {
        const float4 o4 = *reinterpret_cast<const float4*>(&kb[k][ty * kTm]);
        const float o[kTm] = {o4.x, o4.y, o4.z, o4.w};
        const float4 g0 = *reinterpret_cast<const float4*>(&gs[k][tx * 4]);
        const float4 g1 =
            *reinterpret_cast<const float4*>(&gs[k][kBn / 2 + tx * 4]);
        const float h[kTn] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int r = 0; r < kTm; ++r) {
#pragma unroll
          for (int q = 0; q < kTn; ++q)
            acc[r][q] = fmaf(o[r], h[q], acc[r][q]);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the tiles
  }

  // --- epilogue: -1/P scale and the rank-1 term, then the single store ---
#pragma unroll
  for (int r = 0; r < kTm; ++r) {
    const int gi = i0 + ty * kTm + r;
    if (gi >= p) continue;
    const float wi = w[gi];
#pragma unroll
    for (int q = 0; q < kTn; ++q) {
      const int gj = j0 + (q < 4 ? tx * 4 + q : kBn / 2 + tx * 4 + q - 4);
      if (gj >= n) continue;
      const int64_t off = static_cast<int64_t>(gi) * n + gj;
      const float vc = mu != nullptr ? v[off] - mu[gj] : v[off];
      out[off] = fmaf(wi, vc, acc[r][q] * neg_inv_p);
    }
  }
}

}  // namespace

// phi [P, n] from K_own, K_other [P, P] (K_other may be null: the marginal
// family), g, v [P, n], mu [n] (may be null) and w [P]; all row-major
// float32 on the device.
DIBS_API int dibs_transport_phi(const float* k_own, const float* k_other,
                                const float* g, const float* v,
                                const float* mu, const float* w, float* out,
                                int p, int n, float c, cudaStream_t stream) {
  if (p < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0 || n == 0) return 0;
  const dim3 grid((n + kBn - 1) / kBn, (p + kBm - 1) / kBm);
  const float neg_inv_p = -1.0f / static_cast<float>(p);
  if (k_other != nullptr) {
    transport_phi_kernel<true><<<grid, kThreads, 0, stream>>>(
        k_own, k_other, g, v, mu, w, out, p, n, c, neg_inv_p);
  } else {
    transport_phi_kernel<false><<<grid, kThreads, 0, stream>>>(
        k_own, nullptr, g, v, mu, w, out, p, n, c, neg_inv_p);
  }
  return static_cast<int>(cudaGetLastError());
}
