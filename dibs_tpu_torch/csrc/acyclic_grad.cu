// Fused acyclicity gradient: Monte Carlo mean of d h / d scores over soft
// graph samples, the whole power chain kept on chip.
//
// Replaces benchmarks/bench_acyclic_kernel.py::fused_grad (pallas_call at
// :84, body make_kernel :33-75). For scores [P, d, d] it writes [P, d, d]:
//
//   out[p] = (1/K) sum_m  R_m^T * (alpha g_m (1 - g_m)),
//   g_m = mask / (1 + (1/u - 1) exp(-alpha s))   (= sigmoid(logit(u) + alpha s)),
//   R_m = (I + g_m / d)^(d-1)                    (binary exponentiation),
//
// the gradient of h(G) = tr[(I + G/d)^d] - d through the tau = 1 soft
// sampler, with a zero diagonal (mask). Only tau = 1 is served: the TPU
// kernel draws g in the tau = 1 form whatever tau it is given.
//
// Bound on this card: operations. At the microbenchmark's shape (P=1000,
// d=128, K=8) the chain is 12 non-trivial [d, d] products per sample (the
// first, I M, is a copy), 403 GFLOP against 131 MB of input and output.
//
// Design (a simple first kernel): one block of 256 threads per particle,
// looping over the K samples in order. The chain's result R, its base and
// the sample g live in shared memory as three [d, d|1] float32 matrices
// (198 KB at d = 128; the odd row stride keeps a warp's column reads on
// distinct banks), so no [d, d] intermediate touches device memory. A
// product runs on a 16 x 16 thread grid: thread (ty, tx) owns rows
// ty + 16 a and columns tx + 16 b (a, b < R = ceil(d / 16)), reads R values
// of a column of the left factor (broadcast within a half warp) and R of a
// row of the right one per k, and keeps its R x R outputs in registers; a
// barrier, then the outputs overwrite the factor they replace, so no
// scratch matrix is needed. The same thread owns the same (i, j) of the
// running sum over samples, also in registers, so the mean is
// deterministic. float32 FMAs throughout; tensor cores, wgmma and TMA are
// later work.
//
// No power-of-two rescaling (the TPU kernel has none either): g has entries
// in [0, 1] and a zero diagonal, so every row sum of M = I + g/d is below 2
// and M^(d-1) stays below 2^(d-1), inside float32 up to d = 128 for any soft
// graph. Past d = 128 only a near-saturated, fully cyclic g could overflow;
// the engine's own chain starts rescaling at d >= 160 (ops/acyclic.py).
//
// Shape gate: d <= 139, the largest d whose three [d, d|1] matrices fit the
// 232,448 B of shared memory a block may use (231,852 B); the register tile
// R = ceil(d / 16) <= 9 then holds 81 outputs and 81 running sums a thread.
//
// Noise: the uniform u from dibs::philox_uniform with counter (element,
// sample, particle, stream 0) and key = the 64-bit seed (stream 0 of the
// sampler kernel draws the same uniforms), or the injected Logistic
// eps [P, K, d, d], with g = sigmoid(eps + alpha s). 1/u - 1 is
// IEEE division (the clamp of u keeps it > 0, so exp overflow late in
// annealing gives 1/(1 + inf) = 0, never 0 * inf = NaN).
#include "common.h"

namespace {

constexpr int kSide = 16;
constexpr int kThreads = kSide * kSide;
constexpr int kMaxD = 139;  // three [d, d|1] float32 matrices: 231,852 B

// C = A B for [d, d] matrices with row stride `ld`, into registers.
template <int R>
__device__ __forceinline__ void product(const float* __restrict__ a,
                                        const float* __restrict__ b, int d,
                                        int ld, int ty, int tx,
                                        float (&c)[R][R]) {
  int rows[R], cols[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    // rows and columns past d read row / column d - 1 and are discarded
    rows[i] = min(ty + kSide * i, d - 1) * ld;
    cols[i] = min(tx + kSide * i, d - 1);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) c[i][j] = 0.0f;
  }
  for (int k = 0; k < d; ++k) {
    float av[R], bv[R];
    const float* brow = b + k * ld;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      av[i] = a[rows[i] + k];
      bv[i] = brow[cols[i]];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < R; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
  }
}

template <int R>
__device__ __forceinline__ void store(float* __restrict__ dst, int d, int ld,
                                      int ty, int tx, const float (&c)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty + kSide * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = tx + kSide * j;
      if (row < d && col < d) dst[row * ld + col] = c[i][j];
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    acyclic_grad_kernel(const float* __restrict__ scores,
                        const float* __restrict__ eps, float* __restrict__ out,
                        int d, int n_samples, uint32_t k0, uint32_t k1,
                        float alpha) {
  extern __shared__ float smem[];
  const int ld = d | 1;
  float* res = smem;
  float* base = smem + d * ld;
  float* gmat = smem + 2 * d * ld;
  const int p = blockIdx.x;
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int dd = d * d;
  const float* sp = scores + static_cast<int64_t>(p) * dd;
  const float inv_d = __fdiv_rn(1.0f, static_cast<float>(d));

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;
  }
  float c[R][R];

  for (int m = 0; m < n_samples; ++m) {
    // draw: g, and the chain's base M = I + g / d
    for (int e = threadIdx.x; e < dd; e += kThreads) {
      const int row = e / d;
      const int col = e - row * d;
      float g = 0.0f;
      if (row != col) {
        const float s = sp[e];
        if (eps != nullptr) {
          const float logit = __fadd_rn(
              eps[(static_cast<int64_t>(p) * n_samples + m) * dd + e],
              __fmul_rn(alpha, s));
          g = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-logit)));
        } else {
          const float u = dibs::philox_uniform(
              static_cast<uint32_t>(e), static_cast<uint32_t>(m),
              static_cast<uint32_t>(p), 0u, k0, k1);
          const float r = __fsub_rn(__fdiv_rn(1.0f, u), 1.0f);
          const float e_neg = expf(__fmul_rn(-alpha, s));
          g = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(r, e_neg)));
        }
      }
      gmat[row * ld + col] = g;
      base[row * ld + col] = __fadd_rn(row == col ? 1.0f : 0.0f,
                                       __fmul_rn(g, inv_d));
    }
    __syncthreads();

    // chain: res = base^(d-1) by binary exponentiation; the first product
    // (I times the base) is a copy
    bool identity = true;
    for (int n = d - 1; n > 0;) {
      if (n & 1) {
        if (identity) {
          for (int e = threadIdx.x; e < dd; e += kThreads) {
            const int row = e / d;
            const int col = e - row * d;
            res[row * ld + col] = base[row * ld + col];
          }
          identity = false;
        } else {
          product<R>(res, base, d, ld, ty, tx, c);
          __syncthreads();
          store<R>(res, d, ld, ty, tx, c);
        }
        __syncthreads();
      }
      n >>= 1;
      if (n) {
        product<R>(base, base, d, ld, ty, tx, c);
        __syncthreads();
        store<R>(base, d, ld, ty, tx, c);
        __syncthreads();
      }
    }

    // accumulate R^T * (alpha g (1 - g)); d = 1 has g = 0 and adds nothing
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = tx + kSide * j;
        if (row < d && col < d && !identity) {
          const float g = gmat[row * ld + col];
          const float w = __fmul_rn(__fmul_rn(alpha, g), __fsub_rn(1.0f, g));
          acc[i][j] = fmaf(res[col * ld + row], w, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next draw overwrites gmat, base and res
  }

  const float inv_k = __fdiv_rn(1.0f, static_cast<float>(n_samples));
  float* op = out + static_cast<int64_t>(p) * dd;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty + kSide * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = tx + kSide * j;
      if (row < d && col < d) op[row * d + col] = __fmul_rn(acc[i][j], inv_k);
    }
  }
}

template <int R>
int launch(const float* scores, const float* eps, float* out, int n_particles,
           int d, int n_samples, uint64_t seed, float alpha,
           cudaStream_t cuda_stream) {
  const size_t smem = sizeof(float) * 3 * d * (d | 1);
  const cudaError_t err = cudaFuncSetAttribute(
      acyclic_grad_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  acyclic_grad_kernel<R><<<n_particles, kThreads, smem, cuda_stream>>>(
      scores, eps, out, d, n_samples,
      static_cast<uint32_t>(seed & 0xFFFFFFFFull),
      static_cast<uint32_t>(seed >> 32), alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DIBS_API int dibs_acyclic_grad(const float* scores, const float* eps,
                               float* out, int n_particles, int d,
                               int n_samples, uint64_t seed, float alpha,
                               cudaStream_t cuda_stream) {
  if (d < 1 || d > kMaxD || n_samples < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_particles == 0) return 0;
  using Launch = int (*)(const float*, const float*, float*, int, int, int,
                        uint64_t, float, cudaStream_t);
  constexpr Launch kLaunch[] = {launch<1>, launch<2>, launch<3>,
                                launch<4>, launch<5>, launch<6>,
                                launch<7>, launch<8>, launch<9>};
  return kLaunch[(d + kSide - 1) / kSide - 1](scores, eps, out, n_particles,
                                              d, n_samples, seed, alpha,
                                              cuda_stream);
}
