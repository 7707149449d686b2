// Squared-exponential kernel matrix K[i, j] = scale * exp(-||x_i - y_j||^2 / h).
//
// Replaces dibs_tpu/ops/pallas_kernels.py::fused_se_matrix (body
// _se_kernel_body). x is [A, n], y is [B, n], both row-major float32.
//
// Design: one 16 x 16 thread block per output tile; each thread owns one
// output entry. The feature axis is walked in chunks of 32 staged in shared
// memory (rows padded to 33 floats, so a warp's reads hit distinct banks),
// and the thread accumulates sum (x - y)^2 directly in a register. The
// exp epilogue is applied in registers before the single store, so the
// [A, B] distance matrix never exists in device memory.
//
// The TPU kernel accumulated the Gram form ||x||^2 + ||y||^2 - 2 x.y, which
// cancels for nearby particles (pallas_kernels.py:92-95). The difference
// form has no cancellation: a self-distance is exactly 0 and the diagonal of
// K(x, x) is exactly `scale`.
//
// Bound on this card: at the SVGD shape ([30, 30] over 800 features) the
// whole problem is 100 KB and the kernel is launch-latency bound; at large
// P it reads each operand tile once per output tile, 2 * n * 4 bytes per
// 16 x 16 outputs, and is FMA bound in the inner loop.
#include "common.h"

namespace {

constexpr int kTile = 16;
constexpr int kChunk = 32;

__global__ void se_matrix_kernel(const float* __restrict__ x,
                                 const float* __restrict__ y,
                                 float* __restrict__ out, int a, int b, int n,
                                 float h, float scale) {
  __shared__ float xs[kTile][kChunk + 1];
  __shared__ float ys[kTile][kChunk + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int lin = ty * kTile + tx;

  float acc = 0.0f;
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    for (int q = lin; q < kTile * kChunk; q += kTile * kTile) {
      const int r = q / kChunk;
      const int k = q - r * kChunk;
      const int gk = k0 + k;
      const int gi = row0 + r;
      const int gj = col0 + r;
      xs[r][k] = (gi < a && gk < n) ? x[static_cast<int64_t>(gi) * n + gk]
                                    : 0.0f;
      ys[r][k] = (gj < b && gk < n) ? y[static_cast<int64_t>(gj) * n + gk]
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float diff = xs[ty][k] - ys[tx][k];
      acc = fmaf(diff, diff, acc);
    }
    __syncthreads();
  }
  const int i = row0 + ty;
  const int j = col0 + tx;
  if (i < a && j < b) {
    out[static_cast<int64_t>(i) * b + j] = scale * expf(-acc / h);
  }
}

}  // namespace

DIBS_API int dibs_se_matrix(const float* x, const float* y, float* out, int a,
                            int b, int n, float h, float scale,
                            cudaStream_t stream) {
  if (a == 0 || b == 0) return 0;
  const dim3 block(kTile, kTile);
  const dim3 grid((b + kTile - 1) / kTile, (a + kTile - 1) / kTile);
  se_matrix_kernel<<<grid, block, 0, stream>>>(x, y, out, a, b, n, h, scale);
  return static_cast<int>(cudaGetLastError());
}
