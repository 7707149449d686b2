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
// Two launch shapes:
//   * d <= 32 (bge_pairs_warp_kernel): one warp per (graph, node), and only
//     the parents eliminated. A non-parent row of the padded A has pivot
//     exactly 1 (log adds exactly 0 to the float64 sum), multipliers exactly
//     0 (x - 0 * y == x) and stays exactly zero off its diagonal through the
//     sweep, because R is finite and PD; so eliminating the k x k parent
//     block alone, in increasing parent order with the same operations,
//     gives the padded sweep's bits at (k/d)^3 of its work
//     (tests/test_torch_bge_compact.py holds a plain parents-only sweep to
//     the twin bitwise). A block is one graph: its d x d mask is staged in
//     shared memory with coalesced loads, and its 4 warps take its d nodes
//     in turn. A warp finds the parents by a ballot over the mask's column
//     j, gathers C = A[Pa, Pa] and the border v[Pa] with lane c holding
//     column c of C in registers and lane k the border, and runs the sweep
//     with the multipliers and pivots broadcast by shuffles. The row loops
//     are unrolled to 4, 8, 16 or 32 rows by k, so the registers index at
//     compile time and a warp's work follows its own k. With k <= d - 1
//     (a zero diagonal) the k columns and the border fit 32 lanes; a mask
//     with 32 parents at d = 32 (a self-loop on every node of it) has no
//     lane for its border and gives NaN.
//   * 32 < d <= 128 (bge_pairs_per_block): one block eliminates the whole
//     padded matrix with one thread per column (the border is one more
//     column). An odd column stride keeps the column owners' row walks on
//     distinct banks. 66 KB at d = 128.
//
// Bound on this card: the sweep is k^3 / 3 dependent multiply-subtracts per
// (graph, node) with k parents, with d^2 mask reads in and two floats out
// per pair. At the marginal step's d = 20 the bytes bound it (2 us), but the
// work is a chain of shuffles, divisions and float64 logs a warp, so the
// kernel is bound by instruction issue and latency; the warp design spends
// no lane-steps on non-parent rows and keeps 32 warps an SM resident.
#include "common.h"

namespace {

constexpr int kSmallMaxD = 32;
constexpr int kMaxD = 128;
constexpr int kWarps = 4;  // warps a block (one graph a block)
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---- shape 1: one warp per (graph, node), parents only ---------------------

// Eliminates the k x k parent block (k <= kRows, k < 32) of node j and
// writes its pair. `plist` holds the k parents in increasing order, `mcol`
// the mask column of node j (row stride ld), `r` = R_j.
template <int kRows>
__device__ __forceinline__ void parents_pair(const float* __restrict__ r,
                                             const int* __restrict__ plist,
                                             const float* __restrict__ mcol,
                                             int ld, int d, int j, int k,
                                             int lane, float* out_pa,
                                             float* out_full) {
  // lane c < k: column c of C = A[Pa, Pa] (node q = Pa[c]); lane k: the
  // border v[Pa] (node q = j); other lanes idle at zeros
  const bool border = lane == k;
  const int q = lane < k ? plist[lane] : j;
  const float mq = lane < k ? mcol[q * ld] : 0.0f;
  float col[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    col[i] = 0.0f;
    if (i < k && lane <= k) {
      const int p = plist[i];
      const float mp = mcol[p * ld];
      const float rv = __ldg(r + p * d + q);
      if (border) {
        col[i] = __fmul_rn(rv, mp);
      } else {
        const float mm = __fmul_rn(mp, mq);
        col[i] = __fadd_rn(__fmul_rn(rv, mm),
                           i == lane ? __fsub_rn(1.0f, mm) : 0.0f);
      }
    }
  }

  float s = __ldg(r + j * d + j);
  float my_pivot = 1.0f;
  // fully unrolled (registers indexed at compile time); steps and rows
  // past k are skipped by warp-uniform branches
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    if (a < k) {
      const float pivot = __shfl_sync(kFull, col[a], a);
      const float inv = 1.0f / pivot;
      if (lane == a) my_pivot = pivot;
      // meaningful on lane k, whose col[a] is the border's v[Pa[a]]
      s = __fsub_rn(s, __fmul_rn(__fmul_rn(col[a], col[a]), inv));
#pragma unroll
      for (int i = a + 1; i < kRows; ++i) {
        if (i < k) {
          const float l = __fmul_rn(__shfl_sync(kFull, col[i], a), inv);
          col[i] = __fsub_rn(col[i], __fmul_rn(l, col[a]));
        }
      }
    }
  }
  // log-pivots in parallel, summed in parent order (the padded sweep's
  // identity pivots add exactly 0 between them)
  const double lg = lane < k ? log(static_cast<double>(my_pivot)) : 0.0;
  double acc = 0.0;
  for (int a = 0; a < k; ++a) acc += __shfl_sync(kFull, lg, a);
  const float s_border = __shfl_sync(kFull, s, k);
  if (lane == 0) {
    *out_pa = static_cast<float>(acc);
    *out_full = static_cast<float>(acc + log(static_cast<double>(s_border)));
  }
}

__global__ void __launch_bounds__(kWarps * 32, 8)
    bge_pairs_warp_kernel(const float* __restrict__ r_mats,
                          const float* __restrict__ gs,
                          float* __restrict__ out_pa,
                          float* __restrict__ out_full, int d) {
  __shared__ float masks[kSmallMaxD * (kSmallMaxD + 1)];  // [row][ld]
  __shared__ int lists[kWarps][32];
  const int ld = d | 1;  // odd row stride: a column read hits 32 banks
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.x;
  const float* __restrict__ g = gs + b * d * d;
  for (int i = threadIdx.x; i < d * d; i += blockDim.x) {
    const int row = i / d;
    masks[row * ld + (i - row * d)] = g[i];
  }
  __syncthreads();
  int* plist = lists[warp];
  for (int j = warp; j < d; j += kWarps) {
    const float* mcol = masks + j;  // m[row] = mcol[row * ld]
    const float m = lane < d ? mcol[lane * ld] : 0.0f;
    const unsigned bits = __ballot_sync(kFull, m != 0.0f);
    const int k = __popc(bits);
    if (m != 0.0f) plist[__popc(bits & ((1u << lane) - 1u))] = lane;
    __syncwarp();
    const float* __restrict__ r = r_mats + static_cast<int64_t>(j) * d * d;
    float* pa = out_pa + b * d + j;
    float* full = out_full + b * d + j;
    if (k == 0) {
      if (lane == 0) {
        *pa = 0.0f;
        *full = static_cast<float>(log(static_cast<double>(r[j * d + j])));
      }
    } else if (k <= 4) {
      parents_pair<4>(r, plist, mcol, ld, d, j, k, lane, pa, full);
    } else if (k <= 8) {
      parents_pair<8>(r, plist, mcol, ld, d, j, k, lane, pa, full);
    } else if (k <= 16) {
      parents_pair<16>(r, plist, mcol, ld, d, j, k, lane, pa, full);
    } else if (k < 32) {
      parents_pair<32>(r, plist, mcol, ld, d, j, k, lane, pa, full);
    } else if (lane == 0) {  // no lane for the border: see the note above
      *pa = *full = __int_as_float(0x7fc00000);  // NaN
    }
    __syncwarp();  // plist is rewritten by the next node
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
  if (d <= kSmallMaxD) {
    bge_pairs_warp_kernel<<<n_graphs, kWarps * 32, 0, stream>>>(
        r_mats, gs, out_pa, out_full, d);
  } else {
    const size_t smem = sizeof(float) * (d + 1) * (d | 1);
    const cudaError_t err = cudaFuncSetAttribute(
        bge_pairs_per_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = ((d + 1 + 31) / 32) * 32;
    const dim3 grid(n_graphs, d);
    bge_pairs_per_block<<<grid, threads, smem, stream>>>(r_mats, gs, out_pa,
                                                         out_full, d);
  }
  return static_cast<int>(cudaGetLastError());
}
