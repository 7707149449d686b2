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
// One block of 256 threads per particle, looping over the K samples in
// order; the chain's matrices live in shared memory, so no [d, d]
// intermediate touches device memory. Two tiers, chosen by d alone (the
// wrapper's plan, gpu_kernels.acyclic_grad_plan, names the same tile and
// stride; the launcher refuses any other):
//
// * The quad tier, d <= 128 (acyclic_grad_quad_kernel<Q>): a thread owns
//   Q x Q quads of a 16 x 16 thread grid's output, rows 4 (ty + 16 a) + i
//   and columns 4 (tx + 16 b) + j (Q = 1 up to d = 64, 4 x 4 outputs; Q = 2
//   up to 128, 8 x 8). Both factors of a product are read as rows k:
//   the left one is kept transposed, so a thread's fragments are 2Q
//   16-byte loads per k for 16 Q^2 FFMA, loaded one k ahead of the FMAs
//   that use them, from one pointer a factor for each group of four rows
//   (immediate offsets). Three matrices: resT (the running result, transposed),
//   base and baseT. res base is computed as its transpose base^T res^T
//   (left rows from base, right rows from resT) and stored into resT as it
//   is; base^2 is stored into base and, transposed, into baseT. The rows
//   have a stride of 64 Q floats with their column quads swizzled by
//   ((row >> 2) & 7), so that the row reads, the row stores and the
//   transposed stores of a warp (8 ty x 4 tx) all fall on distinct banks.
//   Everything past d is zero (the rows up to a multiple of 4, so the k
//   loop runs in fours, and the columns up to the stride). A thread draws
//   its own outputs, a row of 4 Q at a time as straight-line code. The
//   sample g is not kept in shared memory: the draw writes w = alpha g
//   (1 - g) to a scratch buffer in the threads' order (16-byte accesses,
//   coalesced across the block), and the accumulation reads it back beside
//   resT at the same (i, j).
// * The strided tier, 128 < d <= 139 (acyclic_grad_kernel<9>, the first
//   design): three [d, d|1] matrices (the odd stride keeps a warp's column
//   reads on distinct banks), thread (ty, tx) owns rows ty + 16 a and
//   columns tx + 16 b, reads a column of the left factor and a row of the
//   right one per k. The quad tier stops at d = 128: past it, 16 x 16
//   threads need 3 quads a side, 144 outputs and 144 running sums a thread,
//   past the 255 registers a thread may hold.
//
// Both tiers compute every output as one fmaf chain over k ascending from
// 0, and sum the samples in order, so they give the same bits
// (fmaf(a, b, c) == fmaf(b, a, c), and the zero rows past d add exact
// zeros to sums that are never -0). float32 FMAs throughout; tensor cores,
// wgmma and TMA are later work.
//
// No power-of-two rescaling (the TPU kernel has none either): g has entries
// in [0, 1] and a zero diagonal, so every row sum of M = I + g/d is below 2
// and M^(d-1) stays below 2^(d-1), inside float32 up to d = 128 for any soft
// graph. Past d = 128 only a near-saturated, fully cyclic g could overflow;
// the engine's own chain starts rescaling at d >= 160 (ops/acyclic.py).
//
// Shape gate: d <= 139, the largest d whose three [d, d|1] matrices fit the
// 232,448 B of shared memory a block may use (231,852 B).
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
constexpr int kQuadMaxD = 128;
constexpr int kStridedTile = 9;  // ceil(d / 16) for 128 < d <= 139

// g from injected Logistic noise x and the score s
__device__ __forceinline__ float g_logistic(float x, float s, float alpha) {
  const float logit = __fadd_rn(x, __fmul_rn(alpha, s));
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-logit)));
}

// g from the Philox uniform of element e of sample m of particle p
__device__ __forceinline__ float g_uniform(int e, int m, int p, uint32_t k0,
                                           uint32_t k1, float s,
                                           float alpha) {
  const float u = dibs::philox_uniform(
      static_cast<uint32_t>(e), static_cast<uint32_t>(m),
      static_cast<uint32_t>(p), 0u, k0, k1);
  const float r = __fsub_rn(__fdiv_rn(1.0f, u), 1.0f);
  const float e_neg = expf(__fmul_rn(-alpha, s));
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(r, e_neg)));
}

// g of element e = row * d + col (row != col) of sample m of particle p
__device__ __forceinline__ float draw_g(const float* __restrict__ sp,
                                        const float* __restrict__ eps, int e,
                                        int m, int p, int n_samples, int dd,
                                        uint32_t k0, uint32_t k1,
                                        float alpha) {
  if (eps != nullptr) {
    return g_logistic(eps[(static_cast<int64_t>(p) * n_samples + m) * dd + e],
                      sp[e], alpha);
  }
  return g_uniform(e, m, p, k0, k1, sp[e], alpha);
}

// ---------------------------------------------------------------------------
// The quad tier (d <= 128)
// ---------------------------------------------------------------------------

// Offset of column quad `quad` of row `r` in a swizzled matrix of stride ld.
__device__ __forceinline__ int swz(int r, int ld, int quad) {
  return r * ld + 4 * (quad ^ ((r >> 2) & 7));
}

// Row k's fragment: Q quads starting at `row` (the row's swizzled quad of
// ty or tx, q = 0), the others 16 quads on ((t + 16 q) ^ s == (t ^ s) +
// 16 q for t < 16, s < 8).
template <int Q>
__device__ __forceinline__ void load_frag(const float* __restrict__ row,
                                          float* f) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * kSide * q);
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}

// c[a][b] = sum_k L[row a][k] R[k][col b] over the dr (a multiple of 4)
// rows of lt = L^T and rm = R, rows past d zero: one fmaf chain in
// ascending k from 0. A thread's rows are quads ty + 16 q of lt's rows,
// its columns quads tx + 16 q of rm's; row k + 1's fragments load while
// row k's FMAs issue. One pointer a factor for each group of 4 rows
// (their swizzle is the same), so every load takes an immediate offset.
template <int Q>
__device__ __forceinline__ void quad_product(const float* __restrict__ lt,
                                             const float* __restrict__ rm,
                                             int dr, int ty, int tx,
                                             float (&c)[4 * Q][4 * Q]) {
  constexpr int kT = 4 * Q;
  constexpr int ld = 64 * Q;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
#pragma unroll
    for (int j = 0; j < kT; ++j) c[i][j] = 0.0f;
  }
  float a[2][kT], b[2][kT];
  const float* pa = lt + 4 * ty;  // group 0: the swizzle is 0
  const float* pb = rm + 4 * tx;
  load_frag<Q>(pa, a[0]);
  load_frag<Q>(pb, b[0]);
  for (int k0 = 0; k0 < dr; k0 += 4) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int cur = kk & 1, nxt = cur ^ 1;
      if (kk < 3) {
        load_frag<Q>(pa + (kk + 1) * ld, a[nxt]);
        load_frag<Q>(pb + (kk + 1) * ld, b[nxt]);
      } else {
        // the next group of four rows (the last group reloads its own
        // row 0, unused)
        const int kn = k0 + 4 < dr ? k0 + 4 : k0;
        const int s = (kn >> 2) & 7;
        pa = lt + kn * ld + 4 * (ty ^ s);
        pb = rm + kn * ld + 4 * (tx ^ s);
        load_frag<Q>(pa, a[nxt]);
        load_frag<Q>(pb, b[nxt]);
      }
#pragma unroll
      for (int i = 0; i < kT; ++i) {
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          c[i][j] = fmaf(a[cur][i], b[cur][j], c[i][j]);
        }
      }
    }
  }
}

// dst[row][col] = c for the thread's rows below d (16-byte stores)
template <int Q>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int d,
                                           int ty, int tx,
                                           const float (&c)[4 * Q][4 * Q]) {
  constexpr int ld = 64 * Q;
#pragma unroll
  for (int qa = 0; qa < Q; ++qa) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * (ty + kSide * qa) + i;
      if (row < d) {
#pragma unroll
        for (int qb = 0; qb < Q; ++qb) {
          *reinterpret_cast<float4*>(dst + swz(row, ld, tx + kSide * qb)) =
              make_float4(c[4 * qa + i][4 * qb], c[4 * qa + i][4 * qb + 1],
                          c[4 * qa + i][4 * qb + 2],
                          c[4 * qa + i][4 * qb + 3]);
        }
      }
    }
  }
}

// dst[col][row] = c for the thread's columns below d (16-byte stores)
template <int Q>
__device__ __forceinline__ void store_cols(float* __restrict__ dst, int d,
                                           int ty, int tx,
                                           const float (&c)[4 * Q][4 * Q]) {
  constexpr int ld = 64 * Q;
#pragma unroll
  for (int qb = 0; qb < Q; ++qb) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * (tx + kSide * qb) + j;
      if (col < d) {
#pragma unroll
        for (int qa = 0; qa < Q; ++qa) {
          *reinterpret_cast<float4*>(dst + swz(col, ld, ty + kSide * qa)) =
              make_float4(c[4 * qa][4 * qb + j], c[4 * qa + 1][4 * qb + j],
                          c[4 * qa + 2][4 * qb + j],
                          c[4 * qa + 3][4 * qb + j]);
        }
      }
    }
  }
}

// Draws row `row` (< d) of a thread's outputs: M = I + g / d into base and
// baseT, w = alpha g (1 - g) as Q float4 into wp[(i Q + q) kThreads]. The
// row's scores (and noise) load first, then its 4 Q draws run as
// straight-line code; draws past d or on the diagonal are computed and
// replaced by g = 0.
template <int Q, bool kInjected>
__device__ __forceinline__ void draw_row(
    const float* __restrict__ sp, const float* __restrict__ ep,
    float* __restrict__ base, float* __restrict__ base_t,
    float4* __restrict__ wp, int i, int row, int d, int tx, int m, int p,
    uint32_t k0, uint32_t k1, float alpha, float inv_d) {
  constexpr int kT = 4 * Q;
  constexpr int ld = 64 * Q;
  float s[kT], x[kT], w[kT];
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    const int col = min(4 * (tx + kSide * (j >> 2)) + (j & 3), d - 1);
    s[j] = sp[row * d + col];
    if (kInjected) x[j] = ep[row * d + col];
  }
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    const int col = 4 * (tx + kSide * (j >> 2)) + (j & 3);
    float g = kInjected ? g_logistic(x[j], s[j], alpha)
                        : g_uniform(row * d + col, m, p, k0, k1, s[j], alpha);
    if (row == col || col >= d) g = 0.0f;
    w[j] = __fmul_rn(__fmul_rn(alpha, g), __fsub_rn(1.0f, g));
    if (col < d) {
      const float v = __fadd_rn(row == col ? 1.0f : 0.0f, __fmul_rn(g, inv_d));
      base[swz(row, ld, col >> 2) + (col & 3)] = v;
      base_t[swz(col, ld, row >> 2) + (row & 3)] = v;
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    wp[(i * Q + q) * kThreads] =
        make_float4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads, 1)
    acyclic_grad_quad_kernel(const float* __restrict__ scores,
                             const float* __restrict__ eps,
                             float* __restrict__ out,
                             float4* __restrict__ wbuf, int d,
                             int n_samples, uint32_t k0, uint32_t k1,
                             float alpha) {
  constexpr int kT = 4 * Q;
  constexpr int ld = 64 * Q;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dr = (d + 3) & ~3;
  float* res_t = smem;
  float* base = smem + dr * ld;
  float* base_t = smem + 2 * dr * ld;
  const int p = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // a warp is 8 ty x 4 tx, so that under the swizzle its 16-byte reads
  // and stores fall on distinct banks
  const int ty = (lane & 7) + 8 * (warp & 1);
  const int tx = (lane >> 3) + 4 * (warp >> 1);
  const int dd = d * d;
  const float* sp = scores + static_cast<int64_t>(p) * dd;
  float* op = out + static_cast<int64_t>(p) * dd;
  // the thread's w, Q float4 a row, coalesced across the block
  float4* wp = wbuf + static_cast<int64_t>(p) * kT * Q * kThreads +
               threadIdx.x;
  const float inv_d = __fdiv_rn(1.0f, static_cast<float>(d));

  // everything past d (the rows up to dr, the columns up to ld) stays zero:
  // a product's outputs there are sums of zeros, and the draws write below
  // d only
  for (int e = threadIdx.x; e < 3 * dr * ld / 4; e += kThreads) {
    smem4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  float acc[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = 0.0f;
  }
  float c[kT][kT];

  for (int m = 0; m < n_samples; ++m) {
    // draw the thread's own outputs, a row at a time (the rows stay
    // rolled: a Philox draw is ~100 instructions)
    const float* ep = eps == nullptr
        ? nullptr : eps + (static_cast<int64_t>(p) * n_samples + m) * dd;
#pragma unroll 1
    for (int i = 0; i < kT; ++i) {
      const int row = 4 * (ty + kSide * (i >> 2)) + (i & 3);
      if (row >= d) continue;
      if (ep != nullptr) {
        draw_row<Q, true>(sp, ep, base, base_t, wp, i, row, d, tx, m, p, k0,
                          k1, alpha, inv_d);
      } else {
        draw_row<Q, false>(sp, ep, base, base_t, wp, i, row, d, tx, m, p, k0,
                           k1, alpha, inv_d);
      }
    }
    __syncthreads();

    // chain: res = base^(d-1) by binary exponentiation; the first product
    // (I times the base) is a copy of baseT into resT
    bool identity = true;
    for (int n = d - 1; n > 0;) {
      if (n & 1) {
        if (identity) {
          for (int e = threadIdx.x; e < d * ld / 4; e += kThreads) {
            reinterpret_cast<float4*>(res_t)[e] =
                reinterpret_cast<const float4*>(base_t)[e];
          }
          identity = false;
        } else {
          // (res base)^T = base^T res^T: left rows from base, right from resT
          quad_product<Q>(base, res_t, dr, ty, tx, c);
          __syncthreads();
          store_rows<Q>(res_t, d, ty, tx, c);
        }
        __syncthreads();
      }
      n >>= 1;
      if (n) {
        quad_product<Q>(base_t, base, dr, ty, tx, c);
        __syncthreads();
        store_rows<Q>(base, d, ty, tx, c);
        store_cols<Q>(base_t, d, ty, tx, c);
        __syncthreads();
      }
    }

    // accumulate R^T * w = resT * w at the thread's own outputs; d = 1 has
    // g = 0 and adds nothing
    if (!identity) {
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        const int row = 4 * (ty + kSide * (i / 4)) + i % 4;
        if (row < d) {
#pragma unroll
          for (int qb = 0; qb < Q; ++qb) {
            const float4 r = *reinterpret_cast<const float4*>(
                res_t + swz(row, ld, tx + kSide * qb));
            const float4 w = wp[(i * Q + qb) * kThreads];
            const float rv[4] = {r.x, r.y, r.z, r.w};
            const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (4 * (tx + kSide * qb) + j < d) {
                acc[i][4 * qb + j] = fmaf(rv[j], wv[j], acc[i][4 * qb + j]);
              }
            }
          }
        }
      }
    }
    // the next draw writes base and baseT only; its barrier comes before
    // the next copy into resT
  }

  const float inv_k = __fdiv_rn(1.0f, static_cast<float>(n_samples));
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int row = 4 * (ty + kSide * (i / 4)) + i % 4;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int col = 4 * (tx + kSide * (j / 4)) + j % 4;
      if (row < d && col < d) op[row * d + col] = __fmul_rn(acc[i][j], inv_k);
    }
  }
}

// ---------------------------------------------------------------------------
// The strided tier (128 < d <= 139): the first design
// ---------------------------------------------------------------------------

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
        g = draw_g(sp, eps, e, m, p, n_samples, dd, k0, k1, alpha);
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

    // accumulate R^T * (alpha g (1 - g))
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

// The plan by d: outputs a thread per dimension (4 or 8 in the quad tier,
// 9 in the strided one) and the matrices' row stride in floats.
void plan(int d, int* tile, int* stride) {
  if (d <= 64) {
    *tile = 4;
    *stride = 64;
  } else if (d <= kQuadMaxD) {
    *tile = 8;
    *stride = 128;
  } else {
    *tile = kStridedTile;
    *stride = d | 1;
  }
}

size_t smem_bytes(int d) {
  int tile, stride;
  plan(d, &tile, &stride);
  const int rows = d <= kQuadMaxD ? (d + 3) & ~3 : d;
  return sizeof(float) * 3 * static_cast<size_t>(rows) * stride;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int n_particles, int d, cudaStream_t cuda_stream,
           Args... args) {
  const size_t smem = smem_bytes(d);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_particles, kThreads, smem, cuda_stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DIBS_API size_t dibs_acyclic_grad_smem_bytes(int d) {
  return d < 1 || d > kMaxD ? 0 : smem_bytes(d);
}

// tile and stride: the wrapper's plan, refused unless it is this file's.
// scratch: the quad tier's w, tile * tile * 256 floats a particle (16-byte
// aligned); unused by the strided tier.
DIBS_API int dibs_acyclic_grad(const float* scores, const float* eps,
                               float* out, float* scratch, int n_particles,
                               int d, int n_samples, uint64_t seed,
                               float alpha, int tile, int stride,
                               cudaStream_t cuda_stream) {
  if (d < 1 || d > kMaxD || n_samples < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int want_tile, want_stride;
  plan(d, &want_tile, &want_stride);
  if (tile != want_tile || stride != want_stride ||
      (tile != kStridedTile &&
       (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_particles == 0) return 0;
  const uint32_t k0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  float4* wbuf = reinterpret_cast<float4*>(scratch);
  if (tile == 4) {
    return launch(acyclic_grad_quad_kernel<1>, n_particles, d, cuda_stream,
                  scores, eps, out, wbuf, d, n_samples, k0, k1, alpha);
  }
  if (tile == 8) {
    return launch(acyclic_grad_quad_kernel<2>, n_particles, d, cuda_stream,
                  scores, eps, out, wbuf, d, n_samples, k0, k1, alpha);
  }
  return launch(acyclic_grad_kernel<kStridedTile>, n_particles, d,
                cuda_stream, scores, eps, out, d, n_samples, k0, k1, alpha);
}
