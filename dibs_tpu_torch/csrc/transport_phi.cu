// Fused SVGD transport family.
//
// Replaces dibs_tpu/ops/transport_kernel.py::transport_phi (the pallas_call
// at :153; bodies _phi_kernel_joint and _phi_kernel_marginal). For kernel
// matrices K_own, K_other [P, P], the flat scores g and particle values
// v [P, n] (row-major float32), the column means mu [n] and colsum(K_own)
// [P], with the rank-1 weight w[i] = (c / P) colsum(K_own)[i], it computes
//
//   phi = -(1/P) (K_own^T (g + c v') + K_other^T g) + w ⊙ v',  v' = v - mu,
//
// the SVGD transport (kernel-weighted scores plus SE repulsion, negated)
// by the identity K^T g + c (K_own^T v' - colsum(K_own) ⊙ v') with
// K = K_own + K_other. K_other == nullptr gives the marginal form (one
// product); mu == nullptr means no centring.
//
// What bounds it on the H100: the FP32 pipes. 2 n_mats P^2 n float32
// operations (n_mats = 2 joint, 1 marginal) against 3 P n + n_mats P^2
// floats of traffic; at config 5 (P = 1000, n = 32,768, joint) that is
// 131 GFLOP, 1.96 ms at 67 TFLOP/s, beside 0.4 GB of operands (0.12 ms of
// HBM if each is read once). Tensor cores would need TF32 or a bf16 split,
// which the port does not take. The first design (64 x 128 tiles, 4 x 8
// outputs a thread, 16-deep single-buffered chunks of scalar loads, the
// column tile fastest in launch order) ran at 1.8x the cuBLAS route: bound
// by shared-memory issue and load latency, and it re-read each g/v column
// strip from HBM once per row tile.
//
// The design:
// - One contraction in the joint form: A = [K_own; K_other] (2P rows m),
//   B = [g + c v'; g]; one accumulator tile and one inner loop. The
//   marginal form walks the first half only.
// - 128 x 128 block tile, 256 threads, 8 x 8 outputs a thread; the eight
//   warps tile the block 2 x 4 (64 x 32 each): four 16-byte shared loads
//   feed 64 FFMAs, and a warp's loads of one source particle are one
//   shared wavefront per operand.
// - Copies overlap the math: two shared stages of 16 source particles; the
//   next stage's K and g (and v) are fetched into registers before the
//   current stage's FFMAs, the combine g + c (v - mu) is applied on the
//   register-to-shared store (no [P, n] intermediate in device memory), and
//   one barrier closes each stage. 128 registers, two blocks an SM. (Tried
//   on the card and not kept: 8-deep stages, a 16 x 16 thread grid, one
//   block an SM with more registers, cp.async for the K tiles.)
// - Rasterization along P first: block b takes row tile b % row_tiles and
//   column tile b / row_tiles, so the row tiles of one column strip run
//   together and the strip comes from HBM about once, then from L2.
// - Ragged shapes inside the kernel: rows and columns past P or n load as
//   zeros and are not stored. The aligned instantiation (kVec) uses 16-byte
//   global loads and stores and needs P % 4 == 0, n % 4 == 0 and 16-byte
//   aligned pointers; the other loads and stores scalars. The wrapper
//   (ops/transport_kernel.py) chooses.
// - Fleets (dibs_tpu_torch/fleet.py): `batch` independent families, each
//   operand with a leading dataset axis, one a gridDim.y slice; each
//   dataset's blocks do exactly the work of an unbatched launch on its
//   operands, so each family has that launch's bits. The dataset offsets
//   are a compile-time variant (kBatched): in the single-family kernels
//   they cost 8-10 registers a thread.
// float32 with fused multiply-adds throughout; the -1/P scale and the
// rank-1 term are applied in registers before the single store.
#include "common.h"

namespace {

constexpr int kBm = 128;  // output rows (target particles i) per block
constexpr int kBn = 128;  // output columns per block
constexpr int kBk = 16;   // source particles m per stage
constexpr int kThreads = 256;
constexpr int kLoads = kBk / 8;  // float4 loads per thread, operand, stage

// Four consecutive floats of a row from column j (zeros where j >= limit or
// for a row outside the matrix).
template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ row,
                                            int j, int limit) {
  float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row == nullptr) return q;
  if constexpr (kVec) {
    if (j < limit) q = __ldg(reinterpret_cast<const float4*>(row + j));
  } else {
    if (j < limit) q.x = __ldg(row + j);
    if (j + 1 < limit) q.y = __ldg(row + j + 1);
    if (j + 2 < limit) q.z = __ldg(row + j + 2);
    if (j + 3 < limit) q.w = __ldg(row + j + 3);
  }
  return q;
}

__device__ __forceinline__ void store4(float* dst, float4 q) {
  *reinterpret_cast<float4*>(dst) = q;
}

// Two resident blocks an SM (128 registers) for the aligned instantiation;
// the scalar one serves small or ragged shapes and may take more registers.
template <bool kJoint, bool kVec, bool kBatched>
__global__ void __launch_bounds__(kThreads, kVec ? 2 : 1)
    transport_phi_kernel(const float* __restrict__ k_own,
                         const float* __restrict__ k_other,
                         const float* __restrict__ g,
                         const float* __restrict__ v,
                         const float* __restrict__ mu,
                         const float* __restrict__ colsum,
                         float* __restrict__ out, int p, int n, int row_tiles,
                         float c, float c_over_p, float neg_inv_p) {
  __shared__ __align__(16) float as[2][kBk][kBm];
  __shared__ __align__(16) float bs[2][kBk][kBn];
  if constexpr (kBatched) {  // this block's dataset
    const int64_t ds = blockIdx.y;
    const int64_t pp = static_cast<int64_t>(p) * p;
    const int64_t pn = static_cast<int64_t>(p) * n;
    k_own += ds * pp;
    if (k_other != nullptr) k_other += ds * pp;
    g += ds * pn;
    v += ds * pn;
    out += ds * pn;
    if (mu != nullptr) mu += ds * n;
    colsum += ds * p;
  }

  // Eight warps as 2 (rows) x 4 (columns), each warp a 64 x 32 tile, its
  // lanes 8 x 4; a thread owns rows r0 + {0..3, 32..35} and columns
  // c0 + {0..3, 16..19}. Per source particle a warp reads 128 contiguous
  // bytes of the A tile and 64 of the B tile: one shared wavefront each.
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = (warp >> 2) * 64 + (lane >> 2) * 4;
  const int c0 = (warp & 3) * 32 + (lane & 3) * 4;
  const int i0 = (blockIdx.x % row_tiles) * kBm;  // P first
  const int j0 = (blockIdx.x / row_tiles) * kBn;

  // loader role: stage rows lk + 8u, columns lc..lc+3 of the A and B tiles
  const int lk = tid >> 5;
  const int lc = (tid & 31) * 4;
  const int chunks = (p + kBk - 1) / kBk;  // stages per half
  const int stages = kJoint ? 2 * chunks : chunks;
  const float4 mu4 = mu == nullptr ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                                   : load_quad<kVec>(mu, j0 + lc, n);

  // A and B values of stage st for this thread's loader slots
  float4 a4[kLoads], b4[kLoads];
  auto fetch = [&](int st) {
    const bool own = st < chunks;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int m = (own ? st : st - chunks) * kBk + lk + 8 * u;
      const bool in = m < p;
      const float* krow = in ? (own ? k_own : k_other) +
                                   static_cast<int64_t>(m) * p
                             : nullptr;
      const int64_t off = static_cast<int64_t>(m) * n;
      a4[u] = load_quad<kVec>(krow, i0 + lc, p);
      b4[u] = load_quad<kVec>(in ? g + off : nullptr, j0 + lc, n);
      if (own && in && j0 + lc < n) {  // rhs g + c (v - mu)
        const float4 v4 = load_quad<kVec>(v + off, j0 + lc, n);
        b4[u].x = fmaf(c, v4.x - mu4.x, b4[u].x);
        b4[u].y = fmaf(c, v4.y - mu4.y, b4[u].y);
        b4[u].z = fmaf(c, v4.z - mu4.z, b4[u].z);
        b4[u].w = fmaf(c, v4.w - mu4.w, b4[u].w);
      }
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      store4(&as[buf][lk + 8 * u][lc], a4[u]);
      store4(&bs[buf][lk + 8 * u][lc], b4[u]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
  }

  fetch(0);
  put(0);
  __syncthreads();

  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    const bool more = st + 1 < stages;
    if (more) fetch(st + 1);  // in flight during the math
#pragma unroll
    for (int k = 0; k < kBk; ++k) {
      const float4 x0 = *reinterpret_cast<const float4*>(&as[buf][k][r0]);
      const float4 x1 =
          *reinterpret_cast<const float4*>(&as[buf][k][r0 + 32]);
      const float4 y0 = *reinterpret_cast<const float4*>(&bs[buf][k][c0]);
      const float4 y1 =
          *reinterpret_cast<const float4*>(&bs[buf][k][c0 + 16]);
      const float ar[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float br[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(ar[r], br[q], acc[r][q]);
      }
    }
    if (more) put(buf ^ 1);
    __syncthreads();  // one barrier a stage: stores visible, reads done
  }

  // epilogue: -1/P scale and the rank-1 term, then the single store
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + r0 + (r >> 2) * 32 + (r & 3);
    if (i >= p) continue;
    const float wi = c_over_p * colsum[i];
    const int64_t row = static_cast<int64_t>(i) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + c0 + h * 16;
      if constexpr (kVec) {
        if (j >= n) continue;
        const float4 v4 = __ldg(reinterpret_cast<const float4*>(v + row + j));
        const float4 m4 =
            mu == nullptr ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                          : __ldg(reinterpret_cast<const float4*>(mu + j));
        float4 o;
        o.x = fmaf(wi, v4.x - m4.x, acc[r][4 * h] * neg_inv_p);
        o.y = fmaf(wi, v4.y - m4.y, acc[r][4 * h + 1] * neg_inv_p);
        o.z = fmaf(wi, v4.z - m4.z, acc[r][4 * h + 2] * neg_inv_p);
        o.w = fmaf(wi, v4.w - m4.w, acc[r][4 * h + 3] * neg_inv_p);
        store4(out + row + j, o);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e >= n) continue;
          const float vc =
              mu != nullptr ? v[row + j + e] - mu[j + e] : v[row + j + e];
          out[row + j + e] = fmaf(wi, vc, acc[r][4 * h + e] * neg_inv_p);
        }
      }
    }
  }
}

template <bool kJoint>
void launch(int vec, dim3 blocks, int row_tiles, const float* k_own,
            const float* k_other, const float* g, const float* v,
            const float* mu, const float* colsum, float* out, int p, int n,
            float c, float c_over_p, float neg_inv_p, cudaStream_t stream) {
  const bool batched = blocks.y > 1;
  auto kernel =
      vec ? (batched ? transport_phi_kernel<kJoint, true, true>
                     : transport_phi_kernel<kJoint, true, false>)
          : (batched ? transport_phi_kernel<kJoint, false, true>
                     : transport_phi_kernel<kJoint, false, false>);
  kernel<<<blocks, kThreads, 0, stream>>>(k_own, k_other, g, v, mu, colsum,
                                          out, p, n, row_tiles, c, c_over_p,
                                          neg_inv_p);
}

}  // namespace

// phi [P, n] from K_own, K_other [P, P] (K_other may be null: the marginal
// family), g, v [P, n], mu [n] (may be null) and colsum(K_own) [P]; all
// row-major float32 on the device; c_over_p is float32(c / P). `batch`
// families of a fleet: every operand and phi with a leading [batch] axis
// (1: one family). vec: P % 4 == 0, n % 4 == 0 and every pointer 16-byte
// aligned (16-byte loads and stores); otherwise scalar ones.
DIBS_API int dibs_transport_phi(const float* k_own, const float* k_other,
                                const float* g, const float* v,
                                const float* mu, const float* colsum,
                                float* out, int batch, int p, int n, float c,
                                float c_over_p, int vec,
                                cudaStream_t stream) {
  if (batch < 0 || batch > 65535 || p < 0 || n < 0 ||
      (vec && (p % 4 != 0 || n % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || p == 0 || n == 0) return 0;
  const int row_tiles = (p + kBm - 1) / kBm;
  const int64_t blocks =
      static_cast<int64_t>(row_tiles) * ((n + kBn - 1) / kBn);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  const float neg_inv_p = -1.0f / static_cast<float>(p);
  if (k_other != nullptr) {
    launch<true>(vec, grid, row_tiles, k_own, k_other, g, v, mu, colsum,
                 out, p, n, c, c_over_p, neg_inv_p, stream);
  } else {
    launch<false>(vec, grid, row_tiles, k_own, nullptr, g, v, mu, colsum,
                  out, p, n, c, c_over_p, neg_inv_p, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
