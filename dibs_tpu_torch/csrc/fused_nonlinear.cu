// Fused sample-and-score estimators of the one-hidden-layer MLP likelihood
// (DenseNonlinearGaussian).
//
// Replaces dibs_tpu/inference/fused_nonlinear.py::_fused_nl_call (kernel
// body _make_nl_kernel): for particle p with edge scores s, first-layer
// weights W1_h [d(in i), d(node j)] (h < h1), biases b1, output weights W2_h
// and b2, data x [N, d] and observation weights w = 1 - intervention mask,
// each of the M samples
//   soft:  G = sigmoid(tau (eps_soft + alpha s)),  hard: H = 1[eps_hard + alpha s > 0]
// (zero diagonal) is scored relative to the expected graph
// E[G] = sigmoid(alpha s) (centred scoring). Once per particle:
//   pre_ref_h = x @ (E[G] * W1_h) + b1_h,  resid_ref = x - b2 - sum_h act(pre_ref_h) W2_h
// and per sample only the first-layer delta D_h = x @ ((G - E[G]) * W1_h):
//   pre_h  = pre_ref_h + D_h,  dmean = sum_h (act(pre_h) - act(pre_ref_h)) W2_h
//   dll    = -(1/2 sigma^2) sum w dmean (dmean - 2 resid_ref) + sum (G - E[G]) L1
//   delta  = (resid_ref - dmean) w / sigma^2,  u_h = delta act'(pre_h) W2_h
// with L1[i, j] = sum_h logN(W1[j, i, h]; 0, sig_p) and the activation
// difference of relu in its exact branch form (no cancellation against a
// large pre_ref). The estimates, with the softmax over each stream's dll:
//   dscores = sum_m softmax(dll_soft)_m tau alpha G (1 - G) (L1 + sum_h W1_h x^T u_h)
//   dW1_h   = sum_m softmax(dll_hard)_m H (x^T u_h - W1_h / sig_p^2)
//   db1_h   = sum_m softmax_m sum_n u_h,  dW2_h = ... sum_n delta act(pre_h),
//   db2     = ... sum_n delta.
// The sample-independent prior terms of b1, W2, b2 are added by the wrapper.
// Nothing but the outputs and small scratch (the references, the blocks'
// partial states) touches device memory: no sample or noise is stored.
//
// Noise: as csrc/fused_linear.cu (dibs::philox_logistic, counter (element,
// sample, particle, stream), key = the 64-bit seed; equal streams give the
// hard sample as the threshold of the soft sample's noise), or the injected
// eps_soft / eps_hard [P, M, d, d]. The TPU kernel's fast soft form at
// tau = 1 is not used: drawing a sample is O(d^2) against O(h1 N d^2) of
// scoring, and the plain form matches kernels #1 and #5.
//
// Design: three launches. (1) fused_nl_reference, one block per particle:
// pre_ref and resid_ref into scratch [P, h1 + 1, N, d]. (2) fused_nl_kernel,
// a grid of (particle, sample chunk) blocks (the TPU's sequential loop over
// sample groups split across about two blocks per SM), each keeping an
// online softmax per stream (running max, normaliser, accumulators rescaled
// when the max moves) over its chunk. The [d, d] matrices live in shared
// memory; the data rows, pre_ref and resid_ref stream through shared memory
// in tiles of `tile_rows` rows, and pre = pre_ref + D is recomputed per tile
// instead of being stored. A thread of the forward owns one node column j
// and every (kThreads / d)-th row of a tile, two rows at a time, so its sums
// over the rows (db1, dW2, db2) stay in registers until the block reduces
// them in a fixed order; each thread of x^T u_h computes two outputs of one
// column. (3) fused_nl_merge merges each particle's partial states in a fixed
// order, so the result is deterministic. The per-sample log-likelihoods are
// summed in float64, as in kernels #2 and #5-#7 and the plain version.
//
// Bound on this card: 8 h1 N d^2 float32 FLOPs per sample (two streams, the
// delta product and x^T u), 6.1 GFLOP at P = 30, M = 128, N = 100, d = 20,
// h1 = 5, i.e. ~92 us at 67 TFLOP/s; the inputs and outputs are ~0.2 MB. The
// kernel is bound by operations. Its products run out of shared memory
// without register tiling or tensor cores: that is the next step.
#include <cmath>

#include "common.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRedDoubles = 2 * kWarps + 2;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can use
constexpr int kMaxH = 16;            // widest hidden layer (register arrays)

enum Act : int { kRelu = 0, kTanh = 1, kSigmoid = 2, kLeaky = 3 };

struct Args {
  const float* scores;    // [P, d, d] edge scores
  const float* w1;        // [P, h1, d, d]: W1[p, j, i, h] at [p, h, i, j]
  const float* l1;        // [P, d, d] masked-prior logpdf sums
  const float* w2;        // [P, h1 + 1, d]: W2 rows, row h1 = b2
  const float* x;         // [N, d]
  const float* w;         // [N, d] observation weights
  const float* eps_soft;  // [P, M, d, d] injected noise or nullptr
  const float* eps_hard;  // [P, M, d, d] injected noise or nullptr
  const float* ref;       // [P, h1 + 1, N, d]: pre_ref (h < h1), resid_ref
  float* part;            // [P, S, stride] scratch: partial states
  int n_samples, d, h1, n_obs, tile_rows, n_split, chunk, act;
  uint32_t k0, k1, stream_soft, stream_hard;
  float alpha, tau, inv_varp;
  double inv_var;
};

__host__ __device__ inline int part_stride(int d, int h1) {
  return 4 + (1 + h1) * d * d + (2 * h1 + 1) * d;
}

size_t smem_bytes(int d, int h1, int tile_rows) {
  const size_t dd = static_cast<size_t>(d) * d;
  const size_t tnd = static_cast<size_t>(tile_rows) * d;
  const size_t rows = kThreads / d;
  const size_t u_buf = 2 * h1 * tnd;
  const size_t red_buf = (2 * h1 + 1) * rows * d;
  return sizeof(double) * kRedDoubles +
         sizeof(float) * ((7 + 5 * static_cast<size_t>(h1)) * dd +
                          (3 * static_cast<size_t>(h1) + 1) * d +
                          (3 + static_cast<size_t>(h1)) * tnd +
                          (u_buf > red_buf ? u_buf : red_buf));
}

size_t ref_smem_bytes(int d, int h1) {
  return sizeof(float) * (static_cast<size_t>(h1) * d * d +
                          (2 * static_cast<size_t>(h1) + 1) * d);
}

__device__ __forceinline__ float act_f(int act, float v) {
  switch (act) {
    case kRelu:
      return fmaxf(v, 0.0f);
    case kTanh:
      return tanhf(v);
    case kSigmoid:
      return 1.0f / (1.0f + expf(-v));
    default:
      return v > 0.0f ? v : 0.01f * v;
  }
}

__device__ __forceinline__ float dact_f(int act, float v) {
  switch (act) {
    case kRelu:
      return v > 0.0f ? 1.0f : 0.0f;
    case kTanh: {
      const float t = tanhf(v);
      return 1.0f - t * t;
    }
    case kSigmoid: {
      const float s = 1.0f / (1.0f + expf(-v));
      return s * (1.0f - s);
    }
    default:
      return v > 0.0f ? 1.0f : 0.01f;
  }
}

// act(p + dl) - act(p) with pre = p + dl; relu in its exact branch form.
__device__ __forceinline__ float act_diff(int act, float p, float dl,
                                          float pre) {
  if (act == kRelu) return p >= 0.0f ? fmaxf(dl, -p) : fmaxf(pre, 0.0f);
  return act_f(act, pre) - act_f(act, p);
}

// Sums two per-thread doubles over the block; every thread gets the sums.
__device__ __forceinline__ void block_sum2(double* a, double* b,
                                           double* red) {
  double va = *a, vb = *b;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    va += __shfl_down_sync(0xFFFFFFFFu, va, off);
    vb += __shfl_down_sync(0xFFFFFFFFu, vb, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[2 * warp] = va;
    red[2 * warp + 1] = vb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double sa = 0.0, sb = 0.0;
    for (int k = 0; k < kWarps; ++k) {
      sa += red[2 * k];
      sb += red[2 * k + 1];
    }
    red[2 * kWarps] = sa;
    red[2 * kWarps + 1] = sb;
  }
  __syncthreads();
  *a = red[2 * kWarps];
  *b = red[2 * kWarps + 1];
}

// (1) The centring reference of each particle.
__global__ void __launch_bounds__(kThreads)
    fused_nl_reference(const float* __restrict__ scores,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2,
                       const float* __restrict__ x, float* __restrict__ ref,
                       int d, int h1, int n_obs, float alpha, int act) {
  extern __shared__ float smem_f[];
  const int p = blockIdx.x, tid = threadIdx.x, dd = d * d;
  float* sw = smem_f;           // [h1, d, d] E[G] * W1_h
  float* bb = sw + h1 * dd;     // [h1, d]
  float* ww = bb + h1 * d;      // [h1 + 1, d]
  for (int k = tid; k < h1 * dd; k += kThreads) {
    const int e = k % dd, i = e / d;
    const float s = __fmul_rn(alpha, scores[static_cast<int64_t>(p) * dd + e]);
    const float sg = (i == e - i * d) ? 0.0f : 1.0f / (1.0f + expf(-s));
    sw[k] = sg * w1[static_cast<int64_t>(p) * h1 * dd + k];
  }
  for (int k = tid; k < h1 * d; k += kThreads)
    bb[k] = b1[static_cast<int64_t>(p) * h1 * d + k];
  for (int k = tid; k < (h1 + 1) * d; k += kThreads)
    ww[k] = w2[static_cast<int64_t>(p) * (h1 + 1) * d + k];
  __syncthreads();
  const int64_t nd = static_cast<int64_t>(n_obs) * d;
  float* out = ref + static_cast<int64_t>(p) * (h1 + 1) * nd;
  for (int idx = tid; idx < n_obs * d; idx += kThreads) {
    const int n = idx / d, j = idx - n * d;
    const float* xr = x + static_cast<int64_t>(n) * d;
    float mean = ww[h1 * d + j];  // b2
    for (int h = 0; h < h1; ++h) {
      float pre = 0.0f;
      for (int i = 0; i < d; ++i) pre = fmaf(xr[i], sw[h * dd + i * d + j], pre);
      pre += bb[h * d + j];
      out[h * nd + idx] = pre;
      mean = fmaf(act_f(act, pre), ww[h * d + j], mean);
    }
    out[h1 * nd + idx] = xr[j] - mean;
  }
}

// (2) One pass over a chunk of samples with an online softmax per stream.
template <int kH>
__global__ void __launch_bounds__(kThreads, 2)
    fused_nl_kernel(const Args a) {
  extern __shared__ double smem_d[];
  double* red = smem_d;
  const int d = a.d, dd = d * d, h1 = a.h1, act = a.act;
  const int tn_max = a.tile_rows, tnd = tn_max * d;
  const int rows = kThreads / d;
  float* as_ = reinterpret_cast<float*>(smem_d + kRedDoubles);  // alpha s
  float* sig = as_ + dd;          // E[G], zero diagonal
  float* l1 = sig + dd;
  float* w1 = l1 + dd;            // [h1, d, d]
  float* gs = w1 + h1 * dd;       // soft sample
  float* gh = gs + dd;            // hard sample
  float* am_s = gh + dd;          // [h1, d, d] (G - E[G]) W1_h
  float* am_h = am_s + h1 * dd;   // [h1, d, d] (H - E[G]) W1_h
  float* dg_s = am_h + h1 * dd;   // sum_h W1_h x^T u_h, soft, this sample
  float* xtu_h = dg_s + dd;       // [h1, d, d] x^T u_h, hard, this sample
  float* acc_ds = xtu_h + h1 * dd;
  float* acc_dw1 = acc_ds + dd;   // [h1, d, d]
  float* w2 = acc_dw1 + h1 * dd;  // [h1, d]
  float* acc_sm = w2 + h1 * d;    // [2 h1 + 1, d]: db1, dW2, db2
  float* xt = acc_sm + (2 * h1 + 1) * d;  // data tile [tile_rows, d]
  float* wt = xt + tnd;
  float* rt = wt + tnd;           // resid_ref tile
  float* pt = rt + tnd;           // [h1, tile_rows, d] pre_ref tile
  float* us = pt + h1 * tnd;      // [h1, tile_rows, d] u_h, soft
  float* uh = us + h1 * tnd;      // [h1, tile_rows, d] u_h, hard
  float* red_sm = us;             // [2 h1 + 1, rows, d], after the tiles

  const int p = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int n_obs = a.n_obs, n_smp = a.n_samples;
  const int m_begin = split * a.chunk;
  const int m_end = min(n_smp, m_begin + a.chunk);
  const int64_t ps = static_cast<int64_t>(p) * a.n_split + split;
  const int jr = tid % d, rr = tid / d;  // forward: node column, row lane
  const bool fwd = rr < rows;
  const int64_t nd = static_cast<int64_t>(n_obs) * d;
  const float* refp = a.ref + static_cast<int64_t>(p) * (h1 + 1) * nd;
  const float inv_var_f = static_cast<float>(a.inv_var);
  const float sens_c = a.tau * a.alpha;

  // --- per particle ---
  for (int e = tid; e < dd; e += kThreads) {
    const int i = e / d;
    const float s = __fmul_rn(a.alpha, a.scores[static_cast<int64_t>(p) * dd + e]);
    as_[e] = s;
    sig[e] = (i == e - i * d) ? 0.0f : 1.0f / (1.0f + expf(-s));
    l1[e] = a.l1[static_cast<int64_t>(p) * dd + e];
    acc_ds[e] = 0.0f;
  }
  for (int k = tid; k < h1 * dd; k += kThreads) {
    w1[k] = a.w1[static_cast<int64_t>(p) * h1 * dd + k];
    acc_dw1[k] = 0.0f;
  }
  for (int k = tid; k < h1 * d; k += kThreads)
    w2[k] = a.w2[static_cast<int64_t>(p) * (h1 + 1) * d + k];
  for (int k = tid; k < (2 * h1 + 1) * d; k += kThreads) acc_sm[k] = 0.0f;

  const int n_tiles = (n_obs + tn_max - 1) / tn_max;
  auto load_tile = [&](int t0, int tn) {
    const int64_t base = static_cast<int64_t>(t0) * d;
    for (int idx = tid; idx < tn * d; idx += kThreads) {
      xt[idx] = a.x[base + idx];
      wt[idx] = a.w[base + idx];
      rt[idx] = refp[h1 * nd + base + idx];
    }
    for (int k = tid; k < h1 * tn * d; k += kThreads) {
      const int h = k / (tn * d), rem = k - h * tn * d;
      pt[h * tnd + rem] = refp[h * nd + base + rem];
    }
  };
  if (n_tiles == 1) load_tile(0, n_obs);  // resident for every sample
  __syncthreads();

  float m_s = -INFINITY, z_s = 0.0f, m_h = -INFINITY, z_h = 0.0f;
  for (int m = m_begin; m < m_end; ++m) {
    // --- 1. the sample pair, masked first-layer weights, prior term ---
    double lp_s = 0.0, lp_h = 0.0;
    const int64_t nbase = (static_cast<int64_t>(p) * n_smp + m) * dd;
    for (int e = tid; e < dd; e += kThreads) {
      const int i = e / d;
      float g_soft = 0.0f, g_hard = 0.0f;
      if (i != e - i * d) {
        const float es =
            a.eps_soft != nullptr
                ? a.eps_soft[nbase + e]
                : dibs::philox_logistic(e, m, p, a.stream_soft, a.k0, a.k1);
        float eh;
        if (a.eps_hard != nullptr) {
          eh = a.eps_hard[nbase + e];
        } else if (a.stream_hard == a.stream_soft) {
          eh = es;
        } else {
          eh = dibs::philox_logistic(e, m, p, a.stream_hard, a.k0, a.k1);
        }
        g_soft = 1.0f / (1.0f + expf(-__fmul_rn(a.tau, __fadd_rn(es, as_[e]))));
        g_hard = __fadd_rn(eh, as_[e]) > 0.0f ? 1.0f : 0.0f;
      }
      const float ds = g_soft - sig[e], dh = g_hard - sig[e];
      gs[e] = g_soft;
      gh[e] = g_hard;
      lp_s += static_cast<double>(ds * l1[e]);
      lp_h += static_cast<double>(dh * l1[e]);
      for (int h = 0; h < h1; ++h) {
        am_s[h * dd + e] = ds * w1[h * dd + e];
        am_h[h * dd + e] = dh * w1[h * dd + e];
        xtu_h[h * dd + e] = 0.0f;
      }
      dg_s[e] = 0.0f;
    }
    __syncthreads();

    // --- 2. data tiles: forward, dll terms, u_h, x^T u_h ---
    double ld_s = 0.0, ld_h = 0.0;
    float s_db1[kH], s_dw2[kH], s_db2 = 0.0f;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      s_db1[h] = 0.0f;
      s_dw2[h] = 0.0f;
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int t0 = t * tn_max;
      const int tn = min(tn_max, n_obs - t0);
      if (n_tiles > 1) {
        load_tile(t0, tn);
        __syncthreads();
      }
      // one data row n of node column jr, both streams: the dll terms,
      // u_h into the tiles, and the hard stream's row sums
      auto row_epilogue = [&](int n, const float (&dsv)[kH],
                              const float (&dhv)[kH]) {
        const int nj = n * d + jr;
        const float r = rt[nj], wv = wt[nj];
        float md_s = 0.0f, md_h = 0.0f;
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          if (h < h1) {
            const float pr = pt[h * tnd + nj], wo = w2[h * d + jr];
            md_s += act_diff(act, pr, dsv[h], pr + dsv[h]) * wo;
            md_h += act_diff(act, pr, dhv[h], pr + dhv[h]) * wo;
          }
        }
        ld_s += static_cast<double>(wv * md_s * (md_s - 2.0f * r));
        ld_h += static_cast<double>(wv * md_h * (md_h - 2.0f * r));
        const float del_s = inv_var_f * ((r - md_s) * wv);
        const float del_h = inv_var_f * ((r - md_h) * wv);
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          if (h < h1) {
            const float pr = pt[h * tnd + nj], wo = w2[h * d + jr];
            const float pre_s = pr + dsv[h], pre_h = pr + dhv[h];
            us[h * tnd + nj] = del_s * dact_f(act, pre_s) * wo;
            const float u = del_h * dact_f(act, pre_h) * wo;
            uh[h * tnd + nj] = u;
            s_db1[h] += u;
            s_dw2[h] += del_h * act_f(act, pre_h);
          }
        }
        s_db2 += del_h;
      };
      // first-layer deltas D_h, two rows (n, n + rows) per thread so that
      // each masked-weight load feeds four products
      if (fwd) {
        for (int n = rr; n < tn; n += 2 * rows) {
          const int n2 = n + rows;
          const bool two = n2 < tn;
          float ds0[kH], dh0[kH], ds1[kH], dh1[kH];
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            ds0[h] = 0.0f;
            dh0[h] = 0.0f;
            ds1[h] = 0.0f;
            dh1[h] = 0.0f;
          }
          const float* x0 = xt + n * d;
          const float* x1 = xt + (two ? n2 : n) * d;
          for (int i = 0; i < d; ++i) {
            const float xv0 = x0[i], xv1 = x1[i];
            const float* cs = am_s + i * d + jr;
            const float* ch = am_h + i * d + jr;
#pragma unroll
            for (int h = 0; h < kH; ++h) {
              if (h < h1) {
                const float c_s = cs[h * dd], c_h = ch[h * dd];
                ds0[h] = fmaf(xv0, c_s, ds0[h]);
                dh0[h] = fmaf(xv0, c_h, dh0[h]);
                ds1[h] = fmaf(xv1, c_s, ds1[h]);
                dh1[h] = fmaf(xv1, c_h, dh1[h]);
              }
            }
          }
          row_epilogue(n, ds0, dh0);
          if (two) row_epilogue(n2, ds1, dh1);
        }
      }
      __syncthreads();
      // x^T u_h: two outputs (i0, j), (i0 + 1, j) per work item share the
      // u loads
      const int half = (d + 1) / 2;
      for (int k = tid; k < half * d; k += kThreads) {
        const int ip = k / d, j = k - ip * d;
        const int i0 = 2 * ip, i1 = min(i0 + 1, d - 1);
        float ss0[kH], sh0[kH], ss1[kH], sh1[kH];
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          ss0[h] = 0.0f;
          sh0[h] = 0.0f;
          ss1[h] = 0.0f;
          sh1[h] = 0.0f;
        }
        for (int n = 0; n < tn; ++n) {
          const float xv0 = xt[n * d + i0], xv1 = xt[n * d + i1];
          const int nj = n * d + j;
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            if (h < h1) {
              const float u_s = us[h * tnd + nj], u_h = uh[h * tnd + nj];
              ss0[h] = fmaf(xv0, u_s, ss0[h]);
              sh0[h] = fmaf(xv0, u_h, sh0[h]);
              ss1[h] = fmaf(xv1, u_s, ss1[h]);
              sh1[h] = fmaf(xv1, u_h, sh1[h]);
            }
          }
        }
        const int e0 = i0 * d + j, e1 = i1 * d + j;
        float dg0 = 0.0f, dg1 = 0.0f;
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          if (h < h1) {
            dg0 = fmaf(w1[h * dd + e0], ss0[h], dg0);
            xtu_h[h * dd + e0] += sh0[h];
            if (i1 != i0) {
              dg1 = fmaf(w1[h * dd + e1], ss1[h], dg1);
              xtu_h[h * dd + e1] += sh1[h];
            }
          }
        }
        dg_s[e0] += dg0;
        if (i1 != i0) dg_s[e1] += dg1;
      }
      __syncthreads();  // the next tile (or step 3) overwrites us, uh
    }

    // --- 3. dll of the sample pair (float64 block sums) ---
    double v_s = -0.5 * a.inv_var * ld_s + lp_s;
    double v_h = -0.5 * a.inv_var * ld_h + lp_h;
    block_sum2(&v_s, &v_h, red);
    const float ll_s = static_cast<float>(v_s), ll_h = static_cast<float>(v_h);

    // --- 4. online softmax: exp(-inf) = 0 at the first sample ---
    const float nm_s = fmaxf(m_s, ll_s), nm_h = fmaxf(m_h, ll_h);
    const float sc_s = expf(m_s - nm_s), sc_h = expf(m_h - nm_h);
    const float w_s = expf(ll_s - nm_s), w_h = expf(ll_h - nm_h);
    z_s = z_s * sc_s + w_s;
    z_h = z_h * sc_h + w_h;
    m_s = nm_s;
    m_h = nm_h;

    // --- 5. weight and accumulate ---
    if (fwd) {
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        if (h < h1) {
          red_sm[(h * rows + rr) * d + jr] = s_db1[h];
          red_sm[((h1 + h) * rows + rr) * d + jr] = s_dw2[h];
        }
      }
      red_sm[(2 * h1 * rows + rr) * d + jr] = s_db2;
    }
    __syncthreads();
    for (int k = tid; k < (2 * h1 + 1) * d; k += kThreads) {
      const int q = k / d, j = k - q * d;
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) s += red_sm[(q * rows + r) * d + j];
      acc_sm[k] = acc_sm[k] * sc_h + w_h * s;
    }
    for (int e = tid; e < dd; e += kThreads) {
      const float g = gs[e], hv = gh[e];
      acc_ds[e] = acc_ds[e] * sc_s +
                  w_s * (sens_c * g * (1.0f - g) * (l1[e] + dg_s[e]));
      for (int h = 0; h < h1; ++h) {
        const int k = h * dd + e;
        acc_dw1[k] = acc_dw1[k] * sc_h +
                     w_h * (hv * (xtu_h[k] - w1[k] * a.inv_varp));
      }
    }
    __syncthreads();  // the next sample overwrites gs, gh, am_*, dg_s, xtu_h
  }

  // this block's partial state, merged by fused_nl_merge
  float* out = a.part + ps * part_stride(d, h1);
  if (tid == 0) {
    out[0] = m_s;
    out[1] = z_s;
    out[2] = m_h;
    out[3] = z_h;
  }
  for (int e = tid; e < dd; e += kThreads) out[4 + e] = acc_ds[e];
  for (int k = tid; k < h1 * dd; k += kThreads) out[4 + dd + k] = acc_dw1[k];
  for (int k = tid; k < (2 * h1 + 1) * d; k += kThreads)
    out[4 + (1 + h1) * dd + k] = acc_sm[k];
}

// (3) Merges the S partial states of each particle: running maxima to the
// common maximum, then sums, divided by the merged normalisers.
__global__ void __launch_bounds__(kThreads)
    fused_nl_merge(const float* __restrict__ part, float* __restrict__ out_ds,
                   float* __restrict__ out_dw1, float* __restrict__ out_small,
                   int n_split, int d, int h1) {
  const int p = blockIdx.x, dd = d * d, stride = part_stride(d, h1);
  const float* base = part + static_cast<int64_t>(p) * n_split * stride;
  float g_s = -INFINITY, g_h = -INFINITY;
  for (int k = 0; k < n_split; ++k) {
    g_s = fmaxf(g_s, base[k * stride]);
    g_h = fmaxf(g_h, base[k * stride + 2]);
  }
  float z_s = 0.0f, z_h = 0.0f;
  for (int k = 0; k < n_split; ++k) {
    z_s += base[k * stride + 1] * expf(base[k * stride] - g_s);
    z_h += base[k * stride + 3] * expf(base[k * stride + 2] - g_h);
  }
  const float inv_s = 1.0f / z_s, inv_h = 1.0f / z_h;
  for (int e = threadIdx.x; e < dd; e += kThreads) {
    float acc = 0.0f;
    for (int k = 0; k < n_split; ++k) {
      const float* q = base + k * stride;
      acc += q[4 + e] * expf(q[0] - g_s);
    }
    out_ds[static_cast<int64_t>(p) * dd + e] = acc * inv_s;
  }
  const int n_hard = h1 * dd + (2 * h1 + 1) * d;
  for (int k = threadIdx.x; k < n_hard; k += kThreads) {
    float acc = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float* q = base + s * stride;
      acc += q[4 + dd + k] * expf(q[2] - g_h);
    }
    if (k < h1 * dd) {
      out_dw1[static_cast<int64_t>(p) * h1 * dd + k] = acc * inv_h;
    } else {
      out_small[static_cast<int64_t>(p) * (2 * h1 + 1) * d + k - h1 * dd] =
          acc * inv_h;
    }
  }
}

template <int kH>
int launch_main(const Args& a, int n_particles, size_t smem,
                cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_nl_kernel<kH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_nl_kernel<kH>
      <<<dim3(n_particles, a.n_split), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DIBS_API size_t dibs_fused_nonlinear_smem_bytes(int d, int h1, int tile_rows) {
  return smem_bytes(d, h1, tile_rows);
}

// -> dscores [P, d, d], dW1 [P, h1, d, d] (layout of w1), small [P, 2 h1 + 1,
// d] (db1, dW2, db2 rows), before the wrapper's prior terms. `chunk`
// samples per block; the scratch holds [P, h1 + 1, N, d] (ref) and
// [P, S, 4 + (1 + h1) d^2 + (2 h1 + 1) d] (part) floats, S = ceil(M / chunk).
DIBS_API int dibs_fused_nonlinear(
    const float* scores, const float* w1, const float* l1, const float* b1,
    const float* w2, const float* x, const float* w, const float* eps_soft,
    const float* eps_hard, float* ref, float* part, float* out_ds,
    float* out_dw1, float* out_small, int n_particles, int n_samples, int d,
    int h1, int n_obs, int tile_rows, int chunk, int act, uint64_t seed,
    uint32_t stream_soft, uint32_t stream_hard, float alpha, float tau,
    double inv_var, float inv_varp, cudaStream_t stream) {
  if (d < 1 || d > kThreads || h1 < 1 || h1 > kMaxH || n_obs < 1 ||
      n_samples < 1 || tile_rows < 1 || tile_rows > n_obs || chunk < 1 ||
      act < kRelu || act > kLeaky) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_particles == 0) return 0;
  const size_t smem = smem_bytes(d, h1, tile_rows);
  const size_t smem_ref = ref_smem_bytes(d, h1);
  if (smem > kMaxSmem || smem_ref > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_nl_reference, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_ref));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_nl_reference<<<n_particles, kThreads, smem_ref, stream>>>(
      scores, w1, b1, w2, x, ref, d, h1, n_obs, alpha, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Args a;
  a.scores = scores;
  a.w1 = w1;
  a.l1 = l1;
  a.w2 = w2;
  a.x = x;
  a.w = w;
  a.eps_soft = eps_soft;
  a.eps_hard = eps_hard;
  a.ref = ref;
  a.part = part;
  a.n_samples = n_samples;
  a.d = d;
  a.h1 = h1;
  a.n_obs = n_obs;
  a.tile_rows = tile_rows;
  a.chunk = chunk;
  a.n_split = (n_samples + chunk - 1) / chunk;
  a.act = act;
  a.k0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  a.k1 = static_cast<uint32_t>(seed >> 32);
  a.stream_soft = stream_soft;
  a.stream_hard = stream_hard;
  a.alpha = alpha;
  a.tau = tau;
  a.inv_varp = inv_varp;
  a.inv_var = inv_var;
  int rc;
  if (h1 <= 4) {
    rc = launch_main<4>(a, n_particles, smem, stream);
  } else if (h1 == 5) {  // the repository's configurations
    rc = launch_main<5>(a, n_particles, smem, stream);
  } else if (h1 <= 8) {
    rc = launch_main<8>(a, n_particles, smem, stream);
  } else {
    rc = launch_main<kMaxH>(a, n_particles, smem, stream);
  }
  if (rc != 0) return rc;
  fused_nl_merge<<<n_particles, kThreads, 0, stream>>>(
      part, out_ds, out_dw1, out_small, a.n_split, d, h1);
  return static_cast<int>(cudaGetLastError());
}
