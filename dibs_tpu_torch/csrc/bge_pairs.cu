// BGe determinant pairs for a batch of hard graphs.
//
// Replaces dibs_tpu/ops/bge_kernel.py::bge_logdet_pairs (body
// _bge_pair_kernel). For every graph b and node j, with the parent mask
// m = gs[b, :, j] and node j's posterior matrix R = r_mats[j]:
//   out_pa[b, j]   = logdet R[Pa, Pa]
//   out_full[b, j] = logdet R[Pa u j, Pa u j]
//
// Algorithm (the TPU kernel's bordered-Schur sweep, bge_kernel.py:113-179):
// build A = (m m^T) * R + diag(1 - m m^T), which is R[Pa, Pa] padded with
// identity rows, and eliminate it without pivoting in natural order (R is
// PD, so every pivot is a positive Schur complement; identity rows give
// pivot 1, log 0). Node j's masked row/column v = R[:, j] * m and the scalar
// s = R[j, j] ride along as a border: after the sweep s is the Schur
// complement of (j, j), so logdet R[Pa u j] = logdet R[Pa] + log(s). The
// border is read with plain f32 loads; a lower-precision read of it made
// the Schur chain NaN on collinear data on the TPU (bge_kernel.py:114-119).
//
// Rounding: every float32 product and difference is rounded on its own
// (__fmul_rn / __fsub_rn: no FMA contraction) and the log-pivots are summed
// in float64, so the kernel and its PyTorch twin, which does the same
// operations in the same order, give the same bits on the card and on the
// CPU. The BGe score multiplies these logdets by ~N/2 and subtracts two
// such products, so a one-ulp difference in a logdet would move a node score
// by ~1e-4 at N = 100 and the REINFORCE weights with it.
//
// Shared-memory layout: columns 0..d-1 hold A column by column, column d
// holds the border (it first holds the mask m while A is built). The sweep
// overwrites column i with the multipliers A[r, i] / pivot and then updates
// columns i+1..d (border included) on rows i+1..d-1; rows above the pivot
// are never read again, so the values match the TPU kernel, which updates
// every row.
//
// Two launch shapes of the same elimination:
//   * d <= 32: one thread per (graph, node). A block holds 32 graphs of one
//     node j; the layout is [column][row][thread] with the thread index
//     fastest, so a warp's accesses fall in 32 distinct banks. This mirrors
//     the TPU kernel's batch-on-lanes layout. 32 threads x (d+1) x d floats
//     is 54 KB at d = 20 and 135 KB at d = 32.
//   * 32 < d <= 128: past d ~ 32 the per-thread matrices no longer fit, so
//     one block eliminates one (graph, node) matrix with one thread per
//     column (the border is one more column). An odd column stride keeps
//     the column owners' row walks on distinct banks. 66 KB at d = 128.
//
// Bound on this card: the sweep is d^3 / 3 dependent FMAs per matrix out of
// shared memory, with d^2 mask reads in and two floats out per pair; it is
// bound by shared-memory bandwidth and latency, not device memory.
#include "common.h"

namespace {

constexpr int kGraphsPerBlock = 32;
constexpr int kSmallMaxD = 32;
constexpr int kMaxD = 128;

// ---- shape 1: one thread per (graph, node) -------------------------------

__global__ void bge_pairs_per_thread(const float* __restrict__ r_mats,
                                     const float* __restrict__ gs,
                                     float* __restrict__ out_pa,
                                     float* __restrict__ out_full, int n_graphs,
                                     int d) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int j = blockIdx.y;
  const int b = blockIdx.x * kGraphsPerBlock + t;
  const int gb = b < n_graphs ? b : n_graphs - 1;  // idle lanes redo a graph
  const float* __restrict__ r = r_mats + static_cast<int64_t>(j) * d * d;
  const float* __restrict__ g = gs + static_cast<int64_t>(gb) * d * d;
  auto at = [&](int col, int row) -> float& {
    return smem[(col * d + row) * kGraphsPerBlock + t];
  };

  for (int row = 0; row < d; ++row) at(d, row) = g[row * d + j];
  for (int col = 0; col < d; ++col) {
    const float mc = at(d, col);
    for (int row = 0; row < d; ++row) {
      const float mm = at(d, row) * mc;
      at(col, row) = __fadd_rn(__fmul_rn(r[row * d + col], mm),
                               row == col ? 1.0f - mm : 0.0f);
    }
  }
  for (int row = 0; row < d; ++row) {
    at(d, row) = __fmul_rn(r[row * d + j], at(d, row));
  }

  double acc = 0.0;
  float s = r[j * d + j];
  for (int i = 0; i < d; ++i) {
    const float pivot = at(i, i);
    const float inv = 1.0f / pivot;
    acc += log(static_cast<double>(pivot));
    const float vi = at(d, i);
    s = __fsub_rn(s, __fmul_rn(__fmul_rn(vi, vi), inv));
    for (int row = i + 1; row < d; ++row) at(i, row) = __fmul_rn(at(i, row), inv);
    for (int col = i + 1; col <= d; ++col) {
      const float a_ic = at(col, i);
      for (int row = i + 1; row < d; ++row) {
        at(col, row) = __fsub_rn(at(col, row), __fmul_rn(at(i, row), a_ic));
      }
    }
  }
  if (b < n_graphs) {
    out_pa[static_cast<int64_t>(b) * d + j] = static_cast<float>(acc);
    out_full[static_cast<int64_t>(b) * d + j] =
        static_cast<float>(acc + log(static_cast<double>(s)));
  }
}

// ---- shape 2: one block per (graph, node), one thread per column ---------

__global__ void bge_pairs_per_block(const float* __restrict__ r_mats,
                                    const float* __restrict__ gs,
                                    float* __restrict__ out_pa,
                                    float* __restrict__ out_full, int d) {
  extern __shared__ float smem[];
  const int ld = d | 1;  // odd column stride: no bank conflicts
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const float* __restrict__ r = r_mats + static_cast<int64_t>(j) * d * d;
  const float* __restrict__ g = gs + static_cast<int64_t>(b) * d * d;
  float* border = smem + d * ld;

  for (int row = tid; row < d; row += nt) border[row] = g[row * d + j];
  __syncthreads();
  for (int q = tid; q < d * d; q += nt) {
    const int col = q / d;
    const int row = q - col * d;
    const float mm = border[row] * border[col];
    smem[col * ld + row] = __fadd_rn(__fmul_rn(r[row * d + col], mm),
                                     row == col ? 1.0f - mm : 0.0f);
  }
  __syncthreads();
  for (int row = tid; row < d; row += nt) {
    border[row] = __fmul_rn(r[row * d + j], border[row]);
  }
  __syncthreads();

  double acc = 0.0;
  float s = r[j * d + j];
  for (int i = 0; i < d; ++i) {
    const float pivot = smem[i * ld + i];
    const float inv = 1.0f / pivot;
    if (tid == 0) {
      acc += log(static_cast<double>(pivot));
      const float vi = border[i];
      s = __fsub_rn(s, __fmul_rn(__fmul_rn(vi, vi), inv));
    }
    for (int row = i + 1 + tid; row < d; row += nt) {
      smem[i * ld + row] = __fmul_rn(smem[i * ld + row], inv);
    }
    __syncthreads();
    for (int col = i + 1 + tid; col <= d; col += nt) {
      float* __restrict__ c = smem + col * ld;
      const float* __restrict__ f = smem + i * ld;
      const float a_ic = c[i];
      for (int row = i + 1; row < d; ++row) {
        c[row] = __fsub_rn(c[row], __fmul_rn(f[row], a_ic));
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    out_pa[static_cast<int64_t>(b) * d + j] = static_cast<float>(acc);
    out_full[static_cast<int64_t>(b) * d + j] =
        static_cast<float>(acc + log(static_cast<double>(s)));
  }
}

}  // namespace

DIBS_API int dibs_bge_pairs(const float* r_mats, const float* gs,
                            float* out_pa, float* out_full, int n_graphs,
                            int d, cudaStream_t stream) {
  if (d < 2 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (n_graphs == 0) return 0;
  cudaError_t err;
  if (d <= kSmallMaxD) {
    const size_t smem = sizeof(float) * (d + 1) * d * kGraphsPerBlock;
    err = cudaFuncSetAttribute(bge_pairs_per_thread,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_graphs + kGraphsPerBlock - 1) / kGraphsPerBlock, d);
    bge_pairs_per_thread<<<grid, kGraphsPerBlock, smem, stream>>>(
        r_mats, gs, out_pa, out_full, n_graphs, d);
  } else {
    const size_t smem = sizeof(float) * (d + 1) * (d | 1);
    err = cudaFuncSetAttribute(bge_pairs_per_block,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = ((d + 1 + 31) / 32) * 32;
    const dim3 grid(n_graphs, d);
    bge_pairs_per_block<<<grid, threads, smem, stream>>>(r_mats, gs, out_pa,
                                                         out_full, d);
  }
  return static_cast<int>(cudaGetLastError());
}
