// Fused sample-and-score estimators of the linear-Gaussian likelihood.
//
// Replaces, in dibs_tpu/inference/fused_linear.py (kernel body _make_kernel):
//   mode 0, single pass: _fused_single (online softmax over the samples),
//   mode 1, pass 1:      _fused_pass1 (the [P, M] soft and hard log-lik.),
//   mode 2, pass 2:      _fused_pass2 (replays the samples with weights).
// One template (fused_linear_kernel<kMode, kItems, kFleet, kShard>) serves
// all three for d <= 70, the row tier; kFleet is a fleet's variant (each
// particle its dataset's data and key), kept out of the single-dataset
// kernels, where its indexing cost mode 1 14 registers a thread and mode 2
// 28 bytes of spills; kShard is a particle shard's (the particle counter
// starts at p0), built by csrc/fused_linear_shard.cu (DIBS_FL_SHARD 1, the
// launchers dibs_fused_linear_shard and dibs_fused_linear_wide_shard), so
// that the other kernels are compiled as without it (a run-time p0 cost
// pass 1 3 registers; dibs::draw_counter adds p0 at the draws). Past d =
// 70, where the [d, d] matrices no longer fit one block's shared memory,
// the wide tier (modes 3 and 4, below) computes the same estimand as
// passes 1 and 2 over column tiles; the JAX package's own gate for these
// kernels is d <= 384.
//
// For particle p with edge scores s, weights Theta, data x [N, d] and
// observation weights w = 1 - intervention mask, each of the M samples is
//   soft:  G = sigmoid(tau (eps_soft + alpha s)),  hard: H = 1[eps_hard + alpha s > 0]
// (zero diagonal) and is scored relative to the expected graph
// E[G] = sigmoid(alpha s) (centred scoring): with
//   resid_ref = x - x @ (E[G] * Theta)            (once per particle)
//   delta     = x @ ((G - E[G]) * Theta)
//   dll       = -(1/2 sigma^2) sum w delta (delta - 2 resid_ref)
//               + sum (G - E[G]) logN(Theta; mu_e, sig_e)
//   dW        = x^T ((resid_ref - delta) w) / sigma^2
// the estimates are
//   dscores = sum_m softmax(dll_soft)_m tau alpha G (1 - G) (Theta dW + logN(Theta))
//   dtheta  = sum_m softmax(dll_hard)_m H (dW + (mu_e - Theta) / sig_e^2).
// The softmax is shift-invariant, so the dropped reference log-likelihood
// never matters. Nothing but the [P, d, d] (or [P, M]) outputs and small
// scratch (the blocks' partial states; resid_ref where the rows are tiled)
// touches device memory: no sample, weight matrix or noise tensor is stored.
//
// Noise: eps is Logistic(0, 1) from dibs::philox_logistic with counter
// (element, sample, p0 + particle, stream) and key = the 64-bit seed,
// exactly the uniforms of gpu_kernels.philox_uniform((P, M, d, d), seed,
// stream, particle_offset=p0) (p0 = 0 unless a particle shard); the
// soft branch draws from stream_soft, the hard branch from stream_hard (the
// same stream when they are equal: the hard sample is then the threshold of
// the soft sample's noise). With eps_soft / eps_hard non-null the kernel
// reads the injected noise [P, M, d, d] instead.
//
// The row tier. Bound on this card: 8 N d^2 float32 FLOPs per sample pair in
// modes 0 and 2 (two branches, the delta product and the x^T resid product;
// mode 1 half of it), 1.23 GFLOP at config 2 (P = 30, M = 128, N = 100,
// d = 20), ~18 us at 67 TFLOP/s, and 11 GFLOP (~0.17 ms) at config 4's
// shape (P = 20, d = 30, N = 600); the bytes are ~0.1 MB. It is bound by
// operations, which all run in FP32 FFMA (no TF32: every path held to
// dibs_tpu stays full float32). Design, against that floor:
//  * a grid of (particle, sample chunk) blocks sized to one wave of the
//    blocks the footprint lets an SM hold (fused_linear_row_plan in Python);
//    a second small kernel merges the S partial states of each particle
//    (running maxima, normalisers and [d, d] sums) in a fixed order, so two
//    calls give the same bits;
//  * a block works on groups of kG <= 4 samples: one phase draws the group's
//    matrices A = (G - E[G]) Theta of both branches side by side into
//    shared memory, [d][2 kG][dp] (dp = d rounded up to 4, zero padded), so
//    delta of the whole group is one product x @ [A_0 | A_1 | ...];
//  * the 2 kG (sample, branch) combos each own a team of 256 / (2 kG)
//    threads (whole warps). Both products are register-tiled, 4 x 4 outputs
//    a thread, 16 FFMA per two 16-byte shared loads: delta reads the data
//    tile transposed, x^T [d][ldn], and a row of A; x^T resid reads a row of
//    x [ldn][dp] and a row of the residuals, over chunks of `sub` rows,
//    into accumulators that stay in registers (kItems 4 x 4 tiles a thread)
//    across chunks and tiles;
//  * where all N rows fit one tile (config 2) the data, w and resid_ref stay
//    resident in shared memory for every group; else (config 4) the tiles
//    stream once per group (tiles outer, the group's samples inner) and
//    resid_ref comes from a per-block scratch [N][dp] computed once;
//  * the float64 log-likelihood partials stay in a thread's registers across
//    chunks and tiles (its combo is fixed), are reduced once a group by warp
//    shuffles into per-warp slots and summed in a fixed order; the single
//    pass's online softmax then advances once a group: the group's maximum,
//    one rescale of the [d, d] accumulators, then the kG weighted terms in
//    ascending m;
//  * pass 2 replays only the samples whose two weights are not both exactly
//    0 (such a sample adds exactly 0): warp 0 builds each group from
//    ballots over the particle's weights, 32 samples at a time, taking the
//    set bits in ascending m; a block with none in its chunk writes a zero
//    partial state and skips even resid_ref.
// Measured on an H100 (PERF.md): #5 takes 5.8x the bound at config
// 2 and 3.9x at config 4's shape. What still holds it, from the code (no
// stall reasons without ncu): two barriers a chunk and three or four a
// group; the scalar, transposing tile loads of tiled rows, once a group;
// and rounds of a team that its items fill only in part (at d = 20, delta's
// (dp / 4) x (rows / 4) items of a 64-row chunk take 3 rounds of 32 lanes
// for 80 items, and x^T resid's 25 items use 25 of 32 lanes).
#include <cmath>

#include "common.h"

#ifndef DIBS_FL_SHARD
#define DIBS_FL_SHARD 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRedDoubles = 2 * kWarps + 2;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can use

enum Mode : int { kSingle = 0, kPass1 = 1, kPass2 = 2 };

struct Args {
  const float* scores;    // [P, d, d] edge scores
  const float* theta;     // [P, d, d]
  const float* x;         // [B_ds, N, d] (one dataset: [N, d])
  const float* w;         // [B_ds, N, d] observation weights (1 - mask)
  const int64_t* keys;    // [B_ds] a fleet's keys, or nullptr (k0, k1)
  int per;                // particles a dataset (P for one dataset)
  const float* eps_soft;  // [P, M, d, d] injected noise or nullptr
  const float* eps_hard;  // [P, M, d, d] injected noise or nullptr
  const float* wts_soft;  // [P, M] softmax weights (pass 2)
  const float* wts_hard;  // [P, M]
  float* resid_ref;       // [P, S, N, dp] scratch (tiled rows only)
  float* part;            // [P, S, 4 + 2 d^2] scratch: partial states
  float* out_a;           // dscores [P, d, d]; pass 1: dll_soft [P, M]
  float* out_b;           // dtheta [P, d, d];  pass 1: dll_hard [P, M]
  int n_samples, d, n_obs, tile_rows, n_split, chunk, group, sub_rows;
  uint32_t k0, k1, stream_soft, stream_hard;
  float alpha, tau, mean_edge, sig_edge;
  double inv_var;
  uint32_t p0;  // particle counter of particle 0 (kShard: a shard's first)
};

// The row tier's gate (fused_linear_tile_rows in Python): the footprint of
// its first design, 11 [d, d] matrices, 5 data tiles and the reduction
// slots. The kernel below has a plan of its own (row_smem_bytes); this
// measure stays so that the served (d, N) do not change.
size_t smem_bytes(int d, int tile_rows) {
  return sizeof(double) * kRedDoubles +
         sizeof(float) * (11 * static_cast<size_t>(d) * d +
                          5 * static_cast<size_t>(tile_rows) * d);
}

constexpr int kMaxGroup = 4;
constexpr int kMaxCombos = 2 * kMaxGroup;
// the float64 slots (prior partials [2 parities][kWarps][kMaxCombos], data
// partials [kWarps]), then the group's sample indices, its pass-2 weights
// [2][kMaxGroup] and its size: 1,152 bytes, a multiple of 16
constexpr size_t kRowHeadBytes =
    sizeof(double) * (2 * kWarps * kMaxCombos + kWarps) + 64;

__host__ __device__ inline int row_dp(int d) { return (d + 3) & ~3; }
__host__ __device__ inline int row_ldn(int tile_rows) {
  return (tile_rows + 3) & ~3;
}

// Shared memory of a row-tier block with `group` samples a group, data
// tiles of `tile_rows` rows and x^T resid chunks of `sub_rows` rows
// (Python: fused_linear_row_smem_bytes): the head, the group's A / dW
// [d][2 group][dp], x^T [d][ldn], x, w and resid_ref [ldn][dp], the
// residuals [2 group][sub][dp], then alpha s, E[G], Theta, logN(Theta) and
// the two accumulators [d, d] and the group's soft and hard samples.
size_t row_smem_bytes(int d, int tile_rows, int group, int sub_rows) {
  const size_t dd = static_cast<size_t>(d), dp = row_dp(d),
               ldn = row_ldn(tile_rows), nc = 2 * static_cast<size_t>(group);
  return kRowHeadBytes +
         sizeof(float) * (nc * dd * dp + dd * ldn + 3 * ldn * dp +
                          nc * static_cast<size_t>(sub_rows) * dp +
                          (6 + nc) * dd * dd);
}

// 4 x 4 tiles of x^T resid a thread: ceil((dp / 4)^2 / team), team =
// 256 / (2 group) threads
__host__ __device__ inline int row_items(int d, int group) {
  const int dq = row_dp(d) / 4, team = kThreads / (2 * group);
  return (dq * dq + team - 1) / team;
}

template <int kMode, int kItems, bool kFleet, bool kShard>
__global__ void __launch_bounds__(kThreads, 2)
    fused_linear_kernel(const Args a) {
  extern __shared__ __align__(16) double smem_d[];
  const int d = a.d, dd = d * d, dp = row_dp(d), dq = dp / 4;
  const int kg = a.group, nc = 2 * kg, tn_max = a.tile_rows;
  const int ldn = row_ldn(tn_max), sub = a.sub_rows;
  double* lp_slot = smem_d;                           // [2][kWarps][kMaxCombos]
  double* ld_slot = lp_slot + 2 * kWarps * kMaxCombos;  // [kWarps]
  int* gidx = reinterpret_cast<int*>(ld_slot + kWarps);  // [kMaxGroup]
  float* gwt = reinterpret_cast<float*>(gidx + kMaxGroup);  // [2][kMaxGroup]
  int* gcount = reinterpret_cast<int*>(gwt + 2 * kMaxGroup);
  float* aw = reinterpret_cast<float*>(smem_d) + kRowHeadBytes / 4;
  float* xt = aw + nc * d * dp;   // data tile, transposed [d][ldn]
  float* xr = xt + d * ldn;       // data tile [ldn][dp]
  float* wt = xr + ldn * dp;      // observation weights [ldn][dp]
  float* rt = wt + ldn * dp;      // resid_ref [ldn][dp]
  float* res = rt + ldn * dp;     // weighted residuals [nc][sub][dp]
  float* as_ = res + nc * sub * dp;  // alpha s
  float* sig = as_ + dd;          // E[G] = sigmoid(alpha s), zero diagonal
  float* th = sig + dd;           // Theta
  float* lpd = th + dd;           // logN(Theta; mu_e, sig_e)
  float* acc_s = lpd + dd;        // dscores accumulator
  float* acc_h = acc_s + dd;      // dtheta accumulator
  float* gsv = acc_h + dd;        // the group's soft samples [kg][d, d]
  float* ghv = gsv + kg * dd;     // the group's hard samples

  const int p = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  // a fleet (kFleet): particle p of dataset p / per reads that dataset's
  // data and draws with its key, at the particle counter p % per; a shard
  // (kShard) draws at the counter p0 + p (dibs::draw_counter)
  const float* xd = a.x;
  const float* wd = a.w;
  uint32_t pk = p, k0 = a.k0, k1 = a.k1;
  if constexpr (kFleet) {
    const int ds = p / a.per;
    const int64_t data0 = static_cast<int64_t>(ds) * a.n_obs * d;
    xd += data0;
    wd += data0;
    const uint64_t key = static_cast<uint64_t>(a.keys[ds]);
    pk = p - ds * a.per;
    k0 = static_cast<uint32_t>(key & 0xFFFFFFFFull);
    k1 = static_cast<uint32_t>(key >> 32);
  }
  const int warp = tid / 32, lane = tid % 32;
  const int wpc = kWarps / nc;          // warps of a combo's team
  const int combo = warp / wpc;         // (sample g = combo / 2, branch)
  const int tl = (warp % wpc) * 32 + lane, team = 32 * wpc;
  const int n_obs = a.n_obs, n_smp = a.n_samples;
  const int m_begin = split * a.chunk;
  const int m_end = min(n_smp, m_begin + a.chunk);
  const int n_tiles = (n_obs + tn_max - 1) / tn_max;
  const int64_t ps = static_cast<int64_t>(p) * a.n_split + split;
  const float* sc = a.scores + static_cast<int64_t>(p) * dd;
  const float* tp = a.theta + static_cast<int64_t>(p) * dd;
  float* rr = n_tiles > 1 ? a.resid_ref + ps * n_obs * dp : nullptr;
  // log(sig_e) + 0.5 log(2 pi)
  const float log_norm_e = logf(a.sig_edge) + 0.918938533204672742f;
  const float inv_var_f = static_cast<float>(a.inv_var);
  const float inv_sig2_e = 1.0f / (a.sig_edge * a.sig_edge);

  if (kMode == kPass2) {  // a chunk with nothing to replay adds exactly 0
    int live = 0;
    for (int m = m_begin + tid; m < m_end; m += kThreads) {
      const int64_t o = static_cast<int64_t>(p) * n_smp + m;
      live |= a.wts_soft[o] != 0.0f || a.wts_hard[o] != 0.0f;
    }
    if (!__syncthreads_or(live)) {
      float* out = a.part + ps * (4 + 2 * dd);
      for (int e = tid; e < 4 + 2 * dd; e += kThreads) out[e] = 0.0f;
      return;
    }
  }

  // --- per particle: hoisted transcendentals and the centring reference ---
  for (int e = tid; e < dd; e += kThreads) {
    const int i = e / d, j = e - i * d;
    const float s = __fmul_rn(a.alpha, sc[e]);
    as_[e] = s;
    const float ref = i == j ? 0.0f : 1.0f / (1.0f + expf(-s));
    sig[e] = ref;
    const float th_e = tp[e];
    th[e] = th_e;
    const float zt = (th_e - a.mean_edge) / a.sig_edge;
    lpd[e] = -0.5f * zt * zt - log_norm_e;
    aw[i * dp + j] = ref * th_e;  // E[G] * Theta, for resid_ref
    if (kMode != kPass1) {
      acc_s[e] = 0.0f;
      acc_h[e] = 0.0f;
    }
  }
  __syncthreads();
  // resid_ref, zero past row N and column d: resident in rt where one tile
  // holds every row, else into this block's scratch
  {
    float* dst = rr != nullptr ? rr : rt;
    const int rows = rr != nullptr ? n_obs : ldn;
    for (int idx = tid; idx < rows * dp; idx += kThreads) {
      const int n = idx / dp, j = idx - n * dp;
      float r = 0.0f;
      if (n < n_obs && j < d) {
        const float* xg = xd + static_cast<int64_t>(n) * d;
        float mean = 0.0f;
        for (int i = 0; i < d; ++i) mean = fmaf(xg[i], aw[i * dp + j], mean);
        r = xg[j] - mean;
      }
      dst[idx] = r;
    }
  }
  // rows t0 .. t0 + tn of x (both layouts), w and, where tiled, resid_ref;
  // zero past row tn and column d
  auto load_tile = [&](int t0, int tn) {
    for (int idx = tid; idx < ldn * dp; idx += kThreads) {
      const int n = idx / dp, j = idx - n * dp;
      float xv = 0.0f, wv = 0.0f, rv = 0.0f;
      if (n < tn && j < d) {
        const int64_t g = static_cast<int64_t>(t0 + n) * d + j;
        xv = xd[g];
        wv = wd[g];
        if (rr != nullptr) rv = rr[static_cast<int64_t>(t0 + n) * dp + j];
      }
      xr[idx] = xv;
      wt[idx] = wv;
      if (rr != nullptr) rt[idx] = rv;
      if (j < d) xt[j * ldn + n] = xv;
    }
  };
  if (n_tiles == 1) load_tile(0, n_obs);  // resident for every group
  __syncthreads();

  float m_s = -INFINITY, z_s = 0.0f, m_h = -INFINITY, z_h = 0.0f;
  int cur = m_begin;  // pass 2: where warp 0's scan resumes
  for (int m0 = m_begin, par = 0;; m0 += kg, par ^= 1) {
    // --- 0. the group's samples (pass 2: the next kg whose weights are
    //        not both exactly 0, found by warp 0's ballots) ---
    int gl;
    if (kMode == kPass2) {
      if (warp == 0) {
        const float* ws_p = a.wts_soft + static_cast<int64_t>(p) * n_smp;
        const float* wh_p = a.wts_hard + static_cast<int64_t>(p) * n_smp;
        int found = 0;
        while (found < kg && cur < m_end) {
          const int m = cur + lane;
          const float ws = m < m_end ? ws_p[m] : 0.0f;
          const float wh = m < m_end ? wh_p[m] : 0.0f;
          unsigned live = __ballot_sync(0xFFFFFFFFu, ws != 0.0f || wh != 0.0f);
          while (live != 0u && found < kg) {
            const int b = __ffs(live) - 1;
            live &= live - 1u;
            if (lane == b) {
              gidx[found] = m;
              gwt[found] = ws;
              gwt[kMaxGroup + found] = wh;
            }
            ++found;
          }
          cur = live != 0u ? cur + __ffs(live) - 1 : cur + 32;
        }
        if (lane == 0) *gcount = found;
      }
      __syncthreads();
      gl = *gcount;
      if (gl == 0) break;
    } else {
      if (m0 >= m_end) break;
      gl = min(kg, m_end - m0);
    }
    double* lp_out = lp_slot + par * kWarps * kMaxCombos;
    const bool active = combo < 2 * gl;  // uniform over a warp

    // --- 1. the group's A matrices, samples and prior terms ---
    for (int g = 0; g < gl; ++g) {
      const int m = kMode == kPass2 ? gidx[g] : m0 + g;
      const int64_t nbase = (static_cast<int64_t>(p) * n_smp + m) * dd;
      double lp_s = 0.0, lp_h = 0.0;
      for (int idx = tid; idx < d * dp; idx += kThreads) {
        const int i = idx / dp, j = idx - i * dp;
        float a_s = 0.0f, a_h = 0.0f;
        if (j < d) {
          const int e = i * d + j;
          float g_soft = 0.0f, g_hard = 0.0f;
          if (i != j) {
            const float es =
                a.eps_soft != nullptr
                    ? a.eps_soft[nbase + e]
                    : dibs::philox_logistic(
                          e, m, dibs::draw_counter<kShard>(pk, a.p0),
                          a.stream_soft, k0, k1);
            float eh;
            if (a.eps_hard != nullptr) {
              eh = a.eps_hard[nbase + e];
            } else if (a.stream_hard == a.stream_soft) {
              eh = es;
            } else {
              eh = dibs::philox_logistic(
                  e, m, dibs::draw_counter<kShard>(pk, a.p0), a.stream_hard,
                  k0, k1);
            }
            g_soft =
                1.0f / (1.0f + expf(-__fmul_rn(a.tau, __fadd_rn(es, as_[e]))));
            g_hard = __fadd_rn(eh, as_[e]) > 0.0f ? 1.0f : 0.0f;
          }
          const float th_e = th[e];
          const float ds = g_soft - sig[e], dh = g_hard - sig[e];
          a_s = ds * th_e;
          a_h = dh * th_e;
          lp_s += static_cast<double>(ds * lpd[e]);
          lp_h += static_cast<double>(dh * lpd[e]);
          if (kMode != kPass1) {
            gsv[g * dd + e] = g_soft;
            ghv[g * dd + e] = g_hard;
          }
        }
        float* row = aw + (i * nc + 2 * g) * dp + j;
        row[0] = a_s;
        row[dp] = a_h;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lp_s += __shfl_down_sync(0xFFFFFFFFu, lp_s, off);
        lp_h += __shfl_down_sync(0xFFFFFFFFu, lp_h, off);
      }
      if (lane == 0) {
        lp_out[warp * kMaxCombos + 2 * g] = lp_s;
        lp_out[warp * kMaxCombos + 2 * g + 1] = lp_h;
      }
    }
    __syncthreads();

    // --- 2. data tiles and row chunks: delta, the data term, residuals,
    //        x^T resid (modes 0 and 2) ---
    float dw[kItems][16];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
#pragma unroll
      for (int u = 0; u < 16; ++u) dw[k][u] = 0.0f;
    }
    double v = 0.0;  // this thread's share of its combo's data term
    const float* ap = aw + combo * dp;
    float* rs = res + combo * sub * dp;
    for (int t = 0; t < n_tiles; ++t) {
      const int t0 = t * tn_max, tn = min(tn_max, n_obs - t0);
      if (n_tiles > 1) {
        load_tile(t0, tn);
        __syncthreads();
      }
      const int n_rq = (tn + 3) / 4;
      for (int c0 = 0; c0 < 4 * n_rq; c0 += sub) {
        const int ch_rq = min(sub / 4, n_rq - c0 / 4);  // row quads here
        if (active) {
          for (int it = tl; it < ch_rq * dq; it += team) {
            const int rq = it / dq, cq = it - rq * dq;
            const float* xp = xt + c0 + 4 * rq;
            const float* apq = ap + 4 * cq;
            float acc[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
            }
#pragma unroll 4
            for (int i = 0; i < d; ++i) {
              const float4 x4 = *reinterpret_cast<const float4*>(xp + i * ldn);
              const float4 a4 =
                  *reinterpret_cast<const float4*>(apq + i * nc * dp);
              const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
              const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  acc[r][q] = fmaf(xv[r], av[q], acc[r][q]);
                }
              }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {  // zero past row tn and column d
              const int idx = (c0 + 4 * rq + r) * dp + 4 * cq;
              const float4 r4 = *reinterpret_cast<const float4*>(rt + idx);
              const float4 w4 = *reinterpret_cast<const float4*>(wt + idx);
              const float rf[4] = {r4.x, r4.y, r4.z, r4.w};
              const float wf[4] = {w4.x, w4.y, w4.z, w4.w};
              float out[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float del = acc[r][q];
                if (kMode != kPass2) {
                  v += static_cast<double>(wf[q] * del * (del - 2.0f * rf[q]));
                }
                out[q] = (rf[q] - del) * wf[q];
              }
              if (kMode != kPass1) {
                *reinterpret_cast<float4*>(rs + (4 * rq + r) * dp + 4 * cq) =
                    make_float4(out[0], out[1], out[2], out[3]);
              }
            }
          }
        }
        if (kMode != kPass1) {
          __syncthreads();  // the chunk's residuals are in
          if (active) {
#pragma unroll
            for (int k = 0; k < kItems; ++k) {
              const int item = tl + k * team;
              if (item >= dq * dq) break;
              const int iq = item / dq, jq = item - iq * dq;
              const float* xp = xr + c0 * dp + 4 * iq;
              const float* rp = rs + 4 * jq;
#pragma unroll 4
              for (int n = 0; n < 4 * ch_rq; ++n) {
                const float4 x4 = *reinterpret_cast<const float4*>(xp + n * dp);
                const float4 r4 = *reinterpret_cast<const float4*>(rp + n * dp);
                const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
                const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
                for (int r = 0; r < 4; ++r) {
#pragma unroll
                  for (int q = 0; q < 4; ++q) {
                    dw[k][4 * r + q] = fmaf(xv[r], rv[q], dw[k][4 * r + q]);
                  }
                }
              }
            }
          }
          __syncthreads();  // the next chunk overwrites the residuals
        }
      }
      if (kMode == kPass1 && n_tiles > 1) __syncthreads();  // next tile
    }

    // --- 3. the group's log-likelihoods (float64, fixed order) and x^T
    //        resid, which replaces A in shared memory as dW [nc][d][dp] ---
    if (kMode != kPass2) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xFFFFFFFFu, v, off);
      }
      if (lane == 0) ld_slot[warp] = v;
    }
    if (kMode != kPass1 && active) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int item = tl + k * team;
        if (item >= dq * dq) break;
        const int iq = item / dq, jq = item - iq * dq;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * iq + r;
          if (i < d) {
            *reinterpret_cast<float4*>(aw + (combo * d + i) * dp + 4 * jq) =
                make_float4(dw[k][4 * r], dw[k][4 * r + 1], dw[k][4 * r + 2],
                            dw[k][4 * r + 3]);
          }
        }
      }
    }
    __syncthreads();
    // the group's log-likelihood of combo c: -(1/2 sigma^2) (its team's data
    // partials) + (the prior partials of every warp), in a fixed order
    auto group_ll = [&](int c) {
      double ld = 0.0, lp = 0.0;
      for (int k = 0; k < wpc; ++k) ld += ld_slot[c * wpc + k];
      for (int k = 0; k < kWarps; ++k) lp += lp_out[k * kMaxCombos + c];
      return static_cast<float>(-0.5 * a.inv_var * ld + lp);
    };
    if (kMode == kPass1) {
      if (tid < 2 * gl) {
        const int64_t o = static_cast<int64_t>(p) * n_smp + m0 + tid / 2;
        (tid % 2 == 0 ? a.out_a : a.out_b)[o] = group_ll(tid);
      }
      continue;  // the next group's prior slots are the other parity's
    }

    // --- 4. weight and accumulate, the samples in ascending m ---
    float w_s[kMaxGroup], w_h[kMaxGroup], sc_s = 1.0f, sc_h = 1.0f;
    if (kMode == kSingle) {  // online softmax: exp(-inf) = 0 at the start
      float ll[kMaxCombos], nm_s = m_s, nm_h = m_h;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        ll[2 * g] = g < gl ? group_ll(2 * g) : -INFINITY;
        ll[2 * g + 1] = g < gl ? group_ll(2 * g + 1) : -INFINITY;
        nm_s = fmaxf(nm_s, ll[2 * g]);
        nm_h = fmaxf(nm_h, ll[2 * g + 1]);
      }
      sc_s = expf(m_s - nm_s);
      sc_h = expf(m_h - nm_h);
      z_s *= sc_s;
      z_h *= sc_h;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        w_s[g] = g < gl ? expf(ll[2 * g] - nm_s) : 0.0f;
        w_h[g] = g < gl ? expf(ll[2 * g + 1] - nm_h) : 0.0f;
        z_s += w_s[g];
        z_h += w_h[g];
      }
      m_s = nm_s;
      m_h = nm_h;
    } else {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        w_s[g] = g < gl ? gwt[g] : 0.0f;
        w_h[g] = g < gl ? gwt[kMaxGroup + g] : 0.0f;
      }
    }
    for (int e = tid; e < dd; e += kThreads) {
      const int i = e / d, j = e - i * d;
      const float th_e = th[e], lpdf = lpd[e];
      float a_s = acc_s[e] * sc_s, a_h = acc_h[e] * sc_h;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= gl) break;
        const float dw_s = aw[(2 * g * d + i) * dp + j];
        const float dw_h = aw[((2 * g + 1) * d + i) * dp + j];
        const float gg = gsv[g * dd + e];
        const float c_s = a.tau * a.alpha * gg * (1.0f - gg) *
                          (th_e * (dw_s * inv_var_f) + lpdf);
        const float c_h = ghv[g * dd + e] *
                          (dw_h * inv_var_f + (a.mean_edge - th_e) * inv_sig2_e);
        a_s += w_s[g] * c_s;
        a_h += w_h[g] * c_h;
      }
      acc_s[e] = a_s;
      acc_h[e] = a_h;
    }
    __syncthreads();  // the next group overwrites A, the samples and slots
  }

  if (kMode != kPass1) {  // this block's partial state, merged below
    float* out = a.part + ps * (4 + 2 * dd);
    if (tid == 0) {
      out[0] = kMode == kSingle ? m_s : 0.0f;
      out[1] = z_s;
      out[2] = kMode == kSingle ? m_h : 0.0f;
      out[3] = z_h;
    }
    for (int e = tid; e < dd; e += kThreads) {
      out[4 + e] = acc_s[e];
      out[4 + dd + e] = acc_h[e];
    }
  }
}

// Merges the S partial states of each particle: running maxima to the
// common maximum, then sum (pass 2: plain sums of the weighted partials).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    fused_linear_merge(const float* __restrict__ part, float* __restrict__ out_a,
                       float* __restrict__ out_b, int n_split, int d) {
  const int p = blockIdx.x, dd = d * d, stride = 4 + 2 * dd;
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
  const float inv_s = kMode == kSingle ? 1.0f / z_s : 1.0f;
  const float inv_h = kMode == kSingle ? 1.0f / z_h : 1.0f;
  for (int e = threadIdx.x; e < dd; e += kThreads) {
    float acc_s = 0.0f, acc_h = 0.0f;
    for (int k = 0; k < n_split; ++k) {
      const float* q = base + k * stride;
      acc_s += q[4 + e] * expf(q[0] - g_s);
      acc_h += q[4 + dd + e] * expf(q[2] - g_h);
    }
    out_a[static_cast<int64_t>(p) * dd + e] = acc_s * inv_s;
    out_b[static_cast<int64_t>(p) * dd + e] = acc_h * inv_h;
  }
}


// ---------------------------------------------------------------------------
// The wide tier (d > 70): column-tiled pass 1 and pass 2.
//
// The linear SEM factorizes over node columns: for column j, delta[:, j] =
// x @ ((G - E[G])[:, j] Theta[:, j]), resid[:, j], dW[:, j] = x^T resid[:, j]
// and the G logN(Theta) terms are local to j. A block owns one particle and
// a tile of kCols columns, so it keeps [d, kCols] slabs in shared memory
// instead of [d, d] matrices, which serves d up to ~600.
// A sample's softmax weight needs its log-likelihood summed over all
// columns, so the tier runs as two passes:
//   pass 1 (mode 3, fused_linear_wide_pass1_kernel) writes the float64
//     partial dll of each (particle, sample, column tile); the wrapper sums
//     the tiles in a fixed order and forms the softmax in PyTorch;
//   pass 2 (mode 4, fused_linear_wide_kernel) replays the same samples (the
//     same Philox counters: element i d + j, sample, particle, stream) per
//     column tile into d scores[:, :, tile] and d Theta[:, :, tile] with
//     those weights.
// No float atomics: every output element is written by one block.
// Both passes take the row tier's two compile-time variants, exclusive:
// kShard (a shard's counters p0 + p, the DIBS_FL_SHARD build) and kFleet (a
// fleet's B_ds datasets in one launch: block p reads dataset p / per's x
// and w and draws with its key at the counter p % per; launched only where
// the launcher gets keys), so the single-dataset kernels compile as
// without either.
// ---------------------------------------------------------------------------

constexpr int kCols = 8;  // columns per block
enum WideMode : int { kWide1 = 3, kWide2 = 4 };

struct WideArgs {
  const float* scores;    // [P, d, d]
  const float* theta;     // [P, d, d]
  const float* x;         // [B_ds, N, d] (one dataset: [N, d])
  const float* w;         // [B_ds, N, d]
  const float* eps_soft;  // [P, M, d, d] injected noise or nullptr
  const float* eps_hard;  // [P, M, d, d] injected noise or nullptr
  const float* wts_soft;  // [P, M] softmax weights (pass 2)
  const float* wts_hard;  // [P, M]
  float* resid_ref;       // [P, n_ct, N, kCols] scratch (tiled rows only)
  double* dll_soft;       // [P, M, n_ct] pass 1 partials
  double* dll_hard;       // [P, M, n_ct]
  float* out_a;           // dscores [P, d, d] (pass 2)
  float* out_b;           // dtheta [P, d, d]
  int n_samples, d, n_obs, tile_rows, n_ct;
  uint32_t k0, k1, stream_soft, stream_hard;
  float alpha, tau, mean_edge, sig_edge;
  double inv_var;
  uint32_t p0;  // particle counter of particle 0 (kShard: a shard's first)
  // last, so that the single-dataset kernels' parameters keep their places
  const int64_t* keys;  // [B_ds] a fleet's keys (kFleet), or nullptr
  int per;              // particles a dataset (P for one dataset)
  unsigned long long* replayed;  // pass 2's replay counter, or nullptr
};

// The soft and hard sample of element (i, j) (global index eg = i d + j) of
// sample m: Logistic noise from the injected tensors or the Philox streams
// (the hard sample thresholds the soft sample's noise on a shared stream);
// a shard (kShard) draws at the particle counter p0 + p.
template <bool kShard>
__device__ __forceinline__ void wide_sample_pair(const WideArgs& a,
                                                 int64_t nbase, uint32_t eg,
                                                 int m, int p, float as,
                                                 float* g_soft,
                                                 float* g_hard) {
  const uint32_t pk =
      dibs::draw_counter<kShard>(static_cast<uint32_t>(p), a.p0);
  const float es =
      a.eps_soft != nullptr
          ? a.eps_soft[nbase + eg]
          : dibs::philox_logistic(eg, m, pk, a.stream_soft, a.k0, a.k1);
  float eh;
  if (a.eps_hard != nullptr) {
    eh = a.eps_hard[nbase + eg];
  } else if (a.stream_hard == a.stream_soft) {
    eh = es;
  } else {
    eh = dibs::philox_logistic(eg, m, pk, a.stream_hard, a.k0, a.k1);
  }
  *g_soft = 1.0f / (1.0f + expf(-__fmul_rn(a.tau, __fadd_rn(es, as))));
  *g_hard = __fadd_rn(eh, as) > 0.0f ? 1.0f : 0.0f;
}

// Rows t0 .. t0 + tn of the data tile, transposed into xt [d][ldn], and of
// the w and resid_ref tiles [ldn][kCols] (resid_ref from `rr` if `with_rr`),
// zero past row tn and past column d. Both wide passes load their tiles
// through it. A warp reads 16 rows x 2 column quads of x with 16-byte loads
// where d % 4 == 0 and x is 16-byte aligned, else 4 rows x 8 columns: whole
// 32-byte sectors, and its transposed stores fall into 32 distinct banks
// where ldn % 8 == 4 (pass 2; two ways where ldn % 8 == 0). kBatch loads
// are in flight per thread before their stores.
__device__ void wide_load_tile(const WideArgs& a, const float* rr, float* xt,
                               float* wt, float* rt, int ldn, int j0, int cw,
                               int t0, int tn, bool with_rr) {
  constexpr int kBatch = 4;
  const int d = a.d, tid = threadIdx.x;
  const bool x_vec = (d % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(a.x) % 16 == 0);
  if (x_vec) {
    const int d4 = d / 4, blk = 16 * d4, total = (ldn + 15) / 16 * blk;
    for (int base = tid; base < total; base += kBatch * kThreads) {
      float4 v[kBatch];
      int off[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads, nb = idx / blk;
        const int r = idx - nb * blk, i = 4 * (r / 16), n = 16 * nb + r % 16;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        off[u] = idx < total && n < ldn ? i * ldn + n : -1;
        if (off[u] >= 0 && n < tn) {
          v[u] = *reinterpret_cast<const float4*>(
              a.x + static_cast<int64_t>(t0 + n) * d + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (off[u] < 0) continue;
        xt[off[u]] = v[u].x;
        xt[off[u] + ldn] = v[u].y;
        xt[off[u] + 2 * ldn] = v[u].z;
        xt[off[u] + 3 * ldn] = v[u].w;
      }
    }
  } else {
    const int blk = 4 * d, total = (ldn + 3) / 4 * blk;
    for (int base = tid; base < total; base += kBatch * kThreads) {
      float v[kBatch];
      int off[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kThreads, nb = idx / blk;
        const int r = idx - nb * blk, i = r / 4, n = 4 * nb + r % 4;
        v[u] = 0.0f;
        off[u] = idx < total && n < ldn ? i * ldn + n : -1;
        if (off[u] >= 0 && n < tn) {
          v[u] = a.x[static_cast<int64_t>(t0 + n) * d + i];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (off[u] >= 0) xt[off[u]] = v[u];
      }
    }
  }
  for (int idx = tid; idx < ldn * kCols; idx += kThreads) {
    const int n = idx / kCols, jj = idx - n * kCols;
    wt[idx] = n < tn && jj < cw
                  ? a.w[static_cast<int64_t>(t0 + n) * d + j0 + jj]
                  : 0.0f;
    rt[idx] = with_rr && n < tn ? rr[static_cast<int64_t>(t0) * kCols + idx]
                                : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Wide pass 1: fused_linear_wide_pass1_kernel.
//
// Replaces dibs_tpu/inference/fused_linear.py::_fused_pass1 (:617,
// pallas_call :642) past d = 70: the float64 partial dll of every (particle,
// sample, column tile).
//
// What bounds it on this card: the delta product, 2 branches x 2 N d kCols
// FLOPs per (particle, sample, tile) in FP32 FFMA (~3.3 G warp-instructions
// at config 5: P=1000, d=128, N=100, M=32), plus the noise: one Philox4x32-10
// Logistic draw per element (ten rounds of two 32 x 32 -> 64-bit integer
// multiplies and xors, then logf and log1pf: ~105 SASS instructions; the
// sigmoid's expf and division, the threshold, the slab stores and the
// float64 prior terms: ~75 more), P M d (d - 1) = 520 M draws, ~2.9 G
// warp-instructions. So the kernel is bound by instruction issue, ~7 G
// warp-instructions at config 5, where the operation bound counts the
// product alone. The noise stays bit-for-bit the tier's (same counters, the
// same expressions), since a changed last bit flips hard samples at ties.
//
// Design, against that floor:
//  * groups of kG samples: one phase draws the group's slabs A = (G - E[G])
//    Theta of both branches (and their prior terms) into shared memory, one
//    barrier, then one phase runs the product over the whole group; two
//    barriers per group instead of four per sample;
//  * the product is register-tiled: a thread owns 4 data rows x 4 columns of
//    one (sample, branch) and reads, per step of the inner dimension, one
//    float4 of the transposed data tile x^T [d][ldn] and one float4 of A
//    for 16 FFMA. A warp covers min(16, 4 kG) (sample, branch, column quad)
//    combos x the rest in row quads: its x reads are broadcasts, its A reads
//    one contiguous run;
//  * shared memory holds only what pass 1 reads: alpha s, E[G], Theta and
//    logN(Theta) slabs (computed once a block), the w and resid_ref tiles,
//    x^T and the group's slabs; wide1_group picks the largest kG <= 4 for
//    which two blocks share an SM (kG = 4 at config 5: 111,744 B);
//  * float64 partials are reduced once per group: warp shuffles, then one
//    shared slot per (row block, sample, branch), summed in a fixed order
//    (double-buffered by group parity, so the sums need no extra barrier).
// ---------------------------------------------------------------------------

constexpr int kGroupMax = 4;
constexpr size_t kTwoPerSm = 233472 / 2 - 1024;  // two blocks in 228 KB

__host__ __device__ inline int wide1_ldn(int tile_rows) {
  return (tile_rows + 7) & ~7;
}

size_t wide1_smem_bytes(int d, int tile_rows, int group) {
  const size_t ldn = wide1_ldn(tile_rows), dd = static_cast<size_t>(d);
  return sizeof(double) * 4 * group * (kWarps + ldn / 8) +
         sizeof(float) * (4 * kCols * dd + 2 * kCols * ldn + dd * ldn +
                          2 * kCols * static_cast<size_t>(group) * dd);
}

int wide1_group(int d, int tile_rows) {
  for (int g = kGroupMax; g > 1; g /= 2) {
    if (wide1_smem_bytes(d, tile_rows, g) <= kTwoPerSm) return g;
  }
  return 1;
}

template <int kG, bool kShard, bool kFleet>
__global__ void __launch_bounds__(kThreads, 2)
    fused_linear_wide_pass1_kernel(const WideArgs a) {
  static_assert(!(kShard && kFleet), "a fleet does not shard its particles");
  constexpr int kSlots = 2 * kG;                 // (sample, branch) pairs
  constexpr int kLaneCombos = kG >= 4 ? 16 : 4 * kG;  // combos of a warp
  constexpr int kLaneRows = 32 / kLaneCombos;    // row quads of a warp
  constexpr int kAStride = 2 * kCols * kG;       // A row: [kG][2][kCols]
  extern __shared__ __align__(16) double smem_1[];
  const int d = a.d, tn_max = a.tile_rows, ldn = wide1_ldn(tn_max);
  const int n_rb = ldn / 8;  // slots reserved per parity (>= row blocks)
  double* lpart = smem_1;                      // [2][kWarps][kSlots] prior
  double* part = lpart + 2 * kWarps * kSlots;  // [2][n_rb][kSlots] data
  float* as_ = reinterpret_cast<float*>(part + 2 * n_rb * kSlots);
  float* sig = as_ + d * kCols;   // E[G], zero diagonal and past column d
  float* th = sig + d * kCols;    // Theta
  float* lpd = th + d * kCols;    // logN(Theta; mu_e, sig_e)
  float* wt = lpd + d * kCols;    // observation weights [ldn][kCols]
  float* rt = wt + ldn * kCols;   // resid_ref [ldn][kCols]
  float* xt = rt + ldn * kCols;   // data tile, transposed [d][ldn]
  float* aa = xt + d * ldn;       // the group's slabs [d][kG][2][kCols]

  const int p = blockIdx.x, ct = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int j0 = ct * kCols, cw = min(kCols, d - j0);
  const int n_obs = a.n_obs, n_smp = a.n_samples;
  // a fleet (kFleet): block p of dataset ds = p / per reads that dataset's
  // x and w and draws with its key at the particle counter p - ds per. The
  // helpers read these from `ar`: for a fleet a copy of the arguments with
  // the dataset's pointers and key, for one dataset the arguments
  // themselves, so that those kernels compile as before the fleet builds.
  WideArgs af = a;
  int pc = p;
  if constexpr (kFleet) {
    const int ds = p / a.per;
    const int64_t data0 = static_cast<int64_t>(ds) * n_obs * d;
    const uint64_t key = static_cast<uint64_t>(a.keys[ds]);
    af.x += data0;
    af.w += data0;
    af.k0 = static_cast<uint32_t>(key & 0xFFFFFFFFull);
    af.k1 = static_cast<uint32_t>(key >> 32);
    pc = p - ds * a.per;
  }
  const WideArgs& ar = kFleet ? af : a;
  const int64_t pdd = static_cast<int64_t>(p) * d * d;
  const float log_norm_e = logf(a.sig_edge) + 0.918938533204672742f;
  const int n_tiles = (n_obs + tn_max - 1) / tn_max;
  float* rr = a.resid_ref == nullptr
                  ? nullptr
                  : a.resid_ref +
                        (static_cast<int64_t>(p) * a.n_ct + ct) * n_obs * kCols;

  // --- per particle and column tile: the slabs, then resid_ref ---
  for (int e = tid; e < d * kCols; e += kThreads) {
    const int i = e / kCols, jj = e - i * kCols, j = j0 + jj;
    float s = 0.0f, ref = 0.0f, t = 0.0f;
    if (jj < cw) {
      s = __fmul_rn(a.alpha, a.scores[pdd + i * d + j]);
      ref = i == j ? 0.0f : 1.0f / (1.0f + expf(-s));
      t = a.theta[pdd + i * d + j];
    }
    as_[e] = s;
    sig[e] = ref;
    th[e] = t;
    const float zt = (t - a.mean_edge) / a.sig_edge;
    lpd[e] = -0.5f * zt * zt - log_norm_e;
    aa[e] = ref * t;  // E[G] * Theta, for resid_ref
  }
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * tn_max, tn = min(tn_max, n_obs - t0);
    wide_load_tile(ar, rr, xt, wt, rt, ldn, j0, cw, t0, tn, false);
    __syncthreads();
    for (int idx = tid; idx < tn * kCols; idx += kThreads) {
      const int n = idx / kCols, jj = idx - n * kCols;
      float mean = 0.0f;
      for (int i = 0; i < d; ++i) {
        mean = fmaf(xt[i * ldn + n], aa[i * kCols + jj], mean);
      }
      const float r = jj < cw ? xt[(j0 + jj) * ldn + n] - mean : 0.0f;
      if (n_tiles == 1) {
        rt[idx] = r;  // resident for every sample
      } else {
        rr[static_cast<int64_t>(t0) * kCols + idx] = r;
      }
    }
    __syncthreads();
  }

  const int combo = lane % kLaneCombos;  // (sample, branch, column quad)
  const int cq = combo & 1;
  for (int m0 = 0, par = 0; m0 < n_smp; m0 += kG, par ^= 1) {
    const int gl = min(kG, n_smp - m0);  // samples in this group
    double* lp_out = lpart + par * kWarps * kSlots;
    double* ld_out = part + par * n_rb * kSlots;

    // --- 1. the group's slabs and prior terms ---
    for (int g = 0; g < gl; ++g) {
      const int m = m0 + g;
      const int64_t nbase = (static_cast<int64_t>(p) * n_smp + m) * d * d;
      double lp_s = 0.0, lp_h = 0.0;
      for (int e = tid; e < d * kCols; e += kThreads) {
        const int i = e / kCols, jj = e - i * kCols, j = j0 + jj;
        float g_soft = 0.0f, g_hard = 0.0f;
        if (jj < cw && i != j) {
          wide_sample_pair<kShard>(ar, nbase,
                                   static_cast<uint32_t>(i * d + j), m, pc,
                                   as_[e], &g_soft, &g_hard);
        }
        const float ds = g_soft - sig[e], dh = g_hard - sig[e];
        float* row = aa + i * kAStride + g * 2 * kCols + jj;
        row[0] = ds * th[e];
        row[kCols] = dh * th[e];
        lp_s += static_cast<double>(ds * lpd[e]);
        lp_h += static_cast<double>(dh * lpd[e]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lp_s += __shfl_down_sync(0xFFFFFFFFu, lp_s, off);
        lp_h += __shfl_down_sync(0xFFFFFFFFu, lp_h, off);
      }
      if (lane == 0) {
        lp_out[warp * kSlots + 2 * g] = lp_s;
        lp_out[warp * kSlots + 2 * g + 1] = lp_h;
      }
    }
    for (int idx = tid; idx < n_rb * kSlots; idx += kThreads) {
      ld_out[idx] = 0.0;
    }
    __syncthreads();

    // --- 2. data tiles: delta and the data term, 4 x 4 per thread ---
    for (int t = 0; t < n_tiles; ++t) {
      const int t0 = t * tn_max, tn = min(tn_max, n_obs - t0);
      if (n_tiles > 1) {
        wide_load_tile(ar, rr, xt, wt, rt, ldn, j0, cw, t0, tn, true);
        __syncthreads();
      }
      const int n_rq = (tn + 3) / 4;
      const int n_blocks = (n_rq + kLaneRows - 1) / kLaneRows;
      for (int rb = warp; rb < n_blocks; rb += kWarps) {
        const int rq = rb * kLaneRows + lane / kLaneCombos;
        double v = 0.0;
        if (combo < 4 * gl && rq < n_rq) {
          const float* xp = xt + 4 * rq;
          const float* ap = aa + 4 * combo;
          float acc[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
          }
#pragma unroll 4
          for (int i = 0; i < d; ++i) {
            const float4 x4 = *reinterpret_cast<const float4*>(xp + i * ldn);
            const float4 a4 =
                *reinterpret_cast<const float4*>(ap + i * kAStride);
            const float xr[4] = {x4.x, x4.y, x4.z, x4.w};
            const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                acc[r][q] = fmaf(xr[r], ar[q], acc[r][q]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int idx = (4 * rq + r) * kCols + 4 * cq;
            const float4 w4 = *reinterpret_cast<const float4*>(wt + idx);
            const float4 r4 = *reinterpret_cast<const float4*>(rt + idx);
            const float wr[4] = {w4.x, w4.y, w4.z, w4.w};
            const float rf[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {  // 0 past column d and row tn
              const float del = acc[r][q];
              v += static_cast<double>(wr[q] * del * (del - 2.0f * rf[q]));
            }
          }
        }
        // lanes of one combo, then the combo's two column quads
#pragma unroll
        for (int off = 16; off >= kLaneCombos; off >>= 1) {
          v += __shfl_down_sync(0xFFFFFFFFu, v, off);
        }
        v += __shfl_down_sync(0xFFFFFFFFu, v, 1);
        if (lane < kLaneCombos && cq == 0 && combo < 4 * gl) {
          ld_out[rb * kSlots + combo / 2] += v;
        }
      }
      __syncthreads();  // the next tile or group overwrites xt, rt, aa
    }

    // --- 3. the group's partial dll (float64, fixed order) ---
    if (tid < 2 * gl) {
      double ld = 0.0, lp = 0.0;
      for (int rb = 0; rb < n_rb; ++rb) ld += ld_out[rb * kSlots + tid];
      for (int k = 0; k < kWarps; ++k) lp += lp_out[k * kSlots + tid];
      const int64_t o =
          (static_cast<int64_t>(p) * n_smp + m0 + tid / 2) * a.n_ct + ct;
      (tid % 2 == 0 ? a.dll_soft : a.dll_hard)[o] = -0.5 * a.inv_var * ld + lp;
    }
  }
}

// ---------------------------------------------------------------------------
// Wide pass 2: fused_linear_wide_kernel (replaces _fused_pass2 past d = 70).
//
// Replays the samples per column tile with the softmax weights into the
// block's [d, kCols] slabs of d scores and d Theta. A sample whose two
// weights are both exactly 0 adds exactly 0 and is skipped. Given a
// counter (`replayed`, while a profiler records), column tile 0 adds each
// 32-sample chunk's replayed samples to it, one atomic a chunk.
//
// What bounds it on this card: float32 FFMA, 2 branches x (the delta product
// + the x^T resid product) = 8 N d kCols FLOPs per replayed (particle,
// sample, tile), plus 2 N d kCols once a block for resid_ref (0.36 ms at
// config 5, where 1,598 of 32,000 samples are replayed). That is about 1.6
// replayed samples for each of the 16,000 (particle, column tile) blocks, so
// what a block does once (the weight scan, the tile load, resid_ref) costs
// as much as its products and is designed like them:
//  * the replay list: every warp reads the particle's weights 32 samples at
//    a time and takes the ballot of the non-zero pairs; the block loops over
//    the set bits in ascending m (one load round trip per 32 samples, the
//    branch uniform over the block);
//  * the data tile transposed, [d][ldn], with 16-byte loads of x
//    (wide_load_tile, shared with pass 1), and the slab loads batched four
//    a thread, so that load latencies overlap;
//  * delta and resid_ref run through one register-tiled routine
//    (wide_tile_product): a thread owns 4 data rows x 4 columns of one
//    (branch, column quad) and a share of the inner dimension d, so 200 of
//    256 threads work at N = 100; the shares are combined by warp shuffles;
//  * x^T resid reads 4 data rows of the transposed tile as one float4, the
//    residual rows as broadcasts, and the sample's weighted gradient terms
//    are added where its last tile ends (no separate pass over the slab). A
//    4 x 4 register tiling of x^T resid over two shares of N measured slower
//    on an H100 (PERF.md, kernel #7).
// Shared memory (wide2_smem_bytes): 10 [d, kCols] slabs, the w, resid_ref
// and residual tiles and the transposed data tile; E[G] is recomputed from
// alpha s where it is needed. The plan (Python: fused_linear_wide_pass2_plan)
// keeps up to 128 rows resident while two blocks share an SM.
// ---------------------------------------------------------------------------

// rows rounded up to 4 (16-byte rows), odd in units of 4 (ldn % 8 == 4):
// the tile load's transposed stores then meet no bank twice
__host__ __device__ inline int wide2_ldn(int tile_rows) {
  return ((tile_rows + 3) & ~3) | 4;
}

size_t wide2_smem_bytes(int d, int tile_rows) {
  const size_t ldn = wide2_ldn(tile_rows), dd = static_cast<size_t>(d);
  return sizeof(float) * (10 * kCols * dd + 4 * kCols * ldn + dd * ldn);
}

// out[n][c] = sum_i xt[i][n] A[i][c] over the tn rows of one data tile,
// register-tiled. A thread owns 4 rows x 4 columns of one combo (branch,
// column quad) and one of kSplit shares of the inner dimension d (i = s mod
// kSplit: the shares' loads fall into distinct banks); the shares of a tile
// sit in lanes of one warp and are summed by xor shuffles, which give every
// lane the same bits (commutative adds in a fixed tree).
// kBr = 2: A is [d][2][kCols] (both branches, two shares); kBr = 1: A is
// [d][kCols] (four shares). A warp covers 4 row quads, the 8 warps 128
// rows (the largest tile). epi(n, combo, v) gets the 4 sums of row n, each
// row from one lane, for every row of the tile's row quads (the rows past
// tn sum the tile's zero rows).
template <int kBr, typename Epi>
__device__ __forceinline__ void wide_tile_product(const float* xt, int ldn,
                                                  const float* A, int d,
                                                  int tn, Epi epi) {
  constexpr int kCombos = 2 * kBr;
  constexpr int kSplit = 8 / kCombos;
  constexpr int kRowsEach = 4 / kSplit;
  constexpr int kAStride = kBr * kCols;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int combo = lane % kCombos, s = (lane / kCombos) % kSplit;
  const int rq = 4 * warp + lane / 8, n_rq = (tn + 3) / 4;
  if (4 * warp >= n_rq) return;  // uniform over the warp
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
  }
  if (rq < n_rq) {
    const float* xp = xt + 4 * rq;
    const float* ap = A + 4 * combo;
#pragma unroll 4
    for (int i = s; i < d; i += kSplit) {
      const float4 x4 = *reinterpret_cast<const float4*>(xp + i * ldn);
      const float4 a4 = *reinterpret_cast<const float4*>(ap + i * kAStride);
      const float xr[4] = {x4.x, x4.y, x4.z, x4.w};
      const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(xr[r], ar[q], acc[r][q]);
      }
    }
  }
#pragma unroll
  for (int off = kCombos; off < 8; off *= 2) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[r][q] += __shfl_xor_sync(0xFFFFFFFFu, acc[r][q], off);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r / kRowsEach == s && rq < n_rq) {
      epi(4 * rq + r, combo,
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    }
  }
}

template <bool kShard, bool kFleet>
__global__ void __launch_bounds__(kThreads, 2)
    fused_linear_wide_kernel(const WideArgs a) {
  static_assert(!(kShard && kFleet), "a fleet does not shard its particles");
  extern __shared__ __align__(16) float smem_w[];
  const int d = a.d, slab = d * kCols, tn_max = a.tile_rows;
  const int ldn = wide2_ldn(tn_max);
  float* as_ = smem_w;          // alpha s
  float* th = as_ + slab;       // Theta
  float* aa = th + slab;        // [d][2][kCols]: (G - E[G]) Theta, (H - E[G]) Theta
  float* gs = aa + 2 * slab;    // soft sample
  float* gh = gs + slab;        // hard sample
  float* dws = gh + slab;       // x^T resid_soft of the tiles so far
  float* dwh = dws + slab;      // x^T resid_hard
  float* acc_s = dwh + slab;    // dscores accumulator
  float* acc_h = acc_s + slab;  // dtheta accumulator
  float* wt = acc_h + slab;     // observation weights [ldn][kCols]
  float* rt = wt + ldn * kCols;      // resid_ref [ldn][kCols]
  float* rs = rt + ldn * kCols;      // weighted residuals [ldn][2][kCols]
  float* xt = rs + 2 * ldn * kCols;  // data tile, transposed [d][ldn]

  const int p = blockIdx.x, ct = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32;
  const int j0 = ct * kCols, cw = min(kCols, d - j0);
  const int n_obs = a.n_obs, n_smp = a.n_samples;
  // a fleet (kFleet): block p of dataset ds = p / per reads that dataset's
  // x and w and draws with its key at the particle counter p - ds per. The
  // helpers read these from `ar`: for a fleet a copy of the arguments with
  // the dataset's pointers and key, for one dataset the arguments
  // themselves, so that those kernels compile as before the fleet builds.
  WideArgs af = a;
  int pc = p;
  if constexpr (kFleet) {
    const int ds = p / a.per;
    const int64_t data0 = static_cast<int64_t>(ds) * n_obs * d;
    const uint64_t key = static_cast<uint64_t>(a.keys[ds]);
    af.x += data0;
    af.w += data0;
    af.k0 = static_cast<uint32_t>(key & 0xFFFFFFFFull);
    af.k1 = static_cast<uint32_t>(key >> 32);
    pc = p - ds * a.per;
  }
  const WideArgs& ar = kFleet ? af : a;
  const int64_t pdd = static_cast<int64_t>(p) * d * d;
  const float log_norm_e = logf(a.sig_edge) + 0.918938533204672742f;
  const float inv_var_f = static_cast<float>(a.inv_var);
  const float inv_sig2_e = 1.0f / (a.sig_edge * a.sig_edge);
  const int n_tiles = (n_obs + tn_max - 1) / tn_max;
  float* rr = a.resid_ref == nullptr
                  ? nullptr
                  : a.resid_ref +
                        (static_cast<int64_t>(p) * a.n_ct + ct) * n_obs * kCols;

  // the first chunk of weights, loaded before the prologue (its latency
  // overlaps the slabs)
  const float* wts_s = a.wts_soft + static_cast<int64_t>(p) * n_smp;
  const float* wts_h = a.wts_hard + static_cast<int64_t>(p) * n_smp;
  float w_lane_s = lane < n_smp ? wts_s[lane] : 0.0f;
  float w_lane_h = lane < n_smp ? wts_h[lane] : 0.0f;

  // --- per particle and column tile: the slabs and resid_ref ---
  constexpr int kBatch = 4;  // loads in flight per thread
  for (int e0 = tid; e0 < slab; e0 += kBatch * kThreads) {
    float sc[kBatch], tv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads, i = e / kCols, jj = e - i * kCols;
      sc[u] = 0.0f;
      tv[u] = 0.0f;
      if (e < slab && jj < cw) {
        sc[u] = a.scores[pdd + i * d + j0 + jj];
        tv[u] = a.theta[pdd + i * d + j0 + jj];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads, i = e / kCols, jj = e - i * kCols;
      if (e >= slab) break;
      float s = 0.0f, ref = 0.0f;
      if (jj < cw) {
        s = __fmul_rn(a.alpha, sc[u]);
        ref = i == j0 + jj ? 0.0f : 1.0f / (1.0f + expf(-s));
      }
      as_[e] = s;
      th[e] = tv[u];
      aa[e] = ref * tv[u];  // E[G] * Theta as [d][kCols], for resid_ref
      acc_s[e] = 0.0f;
      acc_h[e] = 0.0f;
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * tn_max, tn = min(tn_max, n_obs - t0);
    wide_load_tile(ar, rr, xt, wt, rt, ldn, j0, cw, t0, tn, false);
    __syncthreads();
    float* rr_t = n_tiles == 1 ? rt : rr + static_cast<int64_t>(t0) * kCols;
    wide_tile_product<1>(xt, ldn, aa, d, tn, [&](int n, int cq, float4 v) {
      if (n >= tn) return;
      const float mean[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jj = 4 * cq + q;  // resident for every sample if one tile
        rr_t[n * kCols + jj] =
            jj < cw ? xt[(j0 + jj) * ldn + n] - mean[q] : 0.0f;
      }
    });
    __syncthreads();
  }

  for (int m0 = 0; m0 < n_smp; m0 += 32) {
    // the chunk's replay list: every warp takes the same ballot
    if (m0 > 0) {
      w_lane_s = m0 + lane < n_smp ? wts_s[m0 + lane] : 0.0f;
      w_lane_h = m0 + lane < n_smp ? wts_h[m0 + lane] : 0.0f;
    }
    unsigned live = __ballot_sync(0xFFFFFFFFu,
                                  w_lane_s != 0.0f || w_lane_h != 0.0f);
    if (a.replayed != nullptr && blockIdx.y == 0 && threadIdx.x == 0) {
      // the chunk's replayed samples, counted once a particle (column
      // tile 0), one atomic a 32-sample ballot
      atomicAdd(a.replayed, static_cast<unsigned long long>(__popc(live)));
    }
    while (live != 0u) {
      const int b = __ffs(live) - 1;
      live &= live - 1u;
      const int m = m0 + b;
      const float w_s = __shfl_sync(0xFFFFFFFFu, w_lane_s, b);
      const float w_h = __shfl_sync(0xFFFFFFFFu, w_lane_h, b);

      // --- 1. the sample pair on this slab ---
      const int64_t nbase = (static_cast<int64_t>(p) * n_smp + m) * d * d;
      for (int e = tid; e < slab; e += kThreads) {
        const int i = e / kCols, jj = e - i * kCols, j = j0 + jj;
        float g_soft = 0.0f, g_hard = 0.0f, ref = 0.0f;
        if (jj < cw && i != j) {
          const float s = as_[e];
          wide_sample_pair<kShard>(ar, nbase,
                                   static_cast<uint32_t>(i * d + j), m, pc,
                                   s, &g_soft, &g_hard);
          ref = 1.0f / (1.0f + expf(-s));  // E[G]
        }
        const float th_e = th[e];
        aa[i * 2 * kCols + jj] = (g_soft - ref) * th_e;
        aa[i * 2 * kCols + kCols + jj] = (g_hard - ref) * th_e;
        gs[e] = g_soft;
        gh[e] = g_hard;
        dws[e] = 0.0f;
        dwh[e] = 0.0f;
      }
      __syncthreads();

      // --- 2. data tiles: delta, residuals, x^T resid, then the terms ---
      for (int t = 0; t < n_tiles; ++t) {
        const int t0 = t * tn_max, tn = min(tn_max, n_obs - t0);
        const bool last = t + 1 == n_tiles;
        if (n_tiles > 1) {
          wide_load_tile(ar, rr, xt, wt, rt, ldn, j0, cw, t0, tn, true);
          __syncthreads();
        }
        wide_tile_product<2>(
            xt, ldn, aa, d, tn, [&](int n, int combo, float4 v) {
              const int c = n * kCols + 4 * (combo & 1);
              const float4 r4 = *reinterpret_cast<const float4*>(rt + c);
              const float4 w4 = *reinterpret_cast<const float4*>(wt + c);
              *reinterpret_cast<float4*>(rs + n * 2 * kCols + 4 * combo) =
                  make_float4((r4.x - v.x) * w4.x, (r4.y - v.y) * w4.y,
                              (r4.z - v.z) * w4.z, (r4.w - v.w) * w4.w);
            });
        __syncthreads();
        const int n_q = (tn + 3) / 4;
        for (int item = tid; item < 2 * d; item += kThreads) {
          const int i = item >> 1, c0 = (item & 1) * 4;
          const float* xr = xt + i * ldn;
          float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float s2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int nq = 0; nq < n_q; ++nq) {
            const float4 x4 = *reinterpret_cast<const float4*>(xr + 4 * nq);
            const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float* row = rs + (4 * nq + k) * 2 * kCols;
              const float4 r4 = *reinterpret_cast<const float4*>(row + c0);
              const float4 q4 =
                  *reinterpret_cast<const float4*>(row + kCols + c0);
              s1[0] = fmaf(xv[k], r4.x, s1[0]);
              s1[1] = fmaf(xv[k], r4.y, s1[1]);
              s1[2] = fmaf(xv[k], r4.z, s1[2]);
              s1[3] = fmaf(xv[k], r4.w, s1[3]);
              s2[0] = fmaf(xv[k], q4.x, s2[0]);
              s2[1] = fmaf(xv[k], q4.y, s2[1]);
              s2[2] = fmaf(xv[k], q4.z, s2[2]);
              s2[3] = fmaf(xv[k], q4.w, s2[3]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = i * kCols + c0 + q;
            const float dw_s = dws[e] + s1[q], dw_h = dwh[e] + s2[q];
            if (!last) {
              dws[e] = dw_s;
              dwh[e] = dw_h;
              continue;
            }
            // --- 3. weight and accumulate this thread's elements ---
            const float th_e = th[e];
            const float zt = (th_e - a.mean_edge) / a.sig_edge;
            const float lpdf = -0.5f * zt * zt - log_norm_e;
            const float g = gs[e];
            const float c_s = a.tau * a.alpha * g * (1.0f - g) *
                              (th_e * (dw_s * inv_var_f) + lpdf);
            const float c_h =
                gh[e] * (dw_h * inv_var_f + (a.mean_edge - th_e) * inv_sig2_e);
            acc_s[e] += w_s * c_s;
            acc_h[e] += w_h * c_h;
          }
        }
        __syncthreads();  // the next tile or sample overwrites xt, rt, rs, aa
      }
    }
  }

  for (int e = tid; e < slab; e += kThreads) {
    const int i = e / kCols, jj = e - i * kCols;
    if (jj < cw) {
      a.out_a[pdd + i * d + j0 + jj] = acc_s[e];
      a.out_b[pdd + i * d + j0 + jj] = acc_h[e];
    }
  }
}

// The wide tier's gate (fused_linear_wide_tile_rows in Python): the
// footprint of its first pass-2 design, 11 [d, kCols] slabs, 4 [tile_rows,
// kCols] tiles, the data tile at an odd row stride and the reduction head.
// Both passes now have smaller plans of their own; this measure stays so
// that the served shapes do not change.
__host__ __device__ inline int wide_ldx(int d) { return d | 1; }

size_t wide_smem_bytes(int d, int tile_rows) {
  return sizeof(double) * kRedDoubles +
         sizeof(float) * (11 * static_cast<size_t>(d) * kCols +
                          4 * static_cast<size_t>(tile_rows) * kCols +
                          static_cast<size_t>(tile_rows) * wide_ldx(d));
}

template <int kG>
int launch_wide1(const WideArgs& a, int n_particles, size_t smem,
                 cudaStream_t stream) {
  // one dataset, a fleet (keys), or, in the DIBS_FL_SHARD build, a shard
  constexpr bool kShard = DIBS_FL_SHARD != 0;
  auto kernel = fused_linear_wide_pass1_kernel<kG, kShard, false>;
  if constexpr (!kShard) {
    if (a.keys != nullptr) {
      kernel = fused_linear_wide_pass1_kernel<kG, false, true>;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_particles, a.n_ct), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const WideArgs& a, int mode, int n_particles,
                cudaStream_t stream) {
  if (mode == kWide1) {
    const int group = wide1_group(a.d, a.tile_rows);
    const size_t smem = wide1_smem_bytes(a.d, a.tile_rows, group);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    switch (group) {
      case 4:
        return launch_wide1<4>(a, n_particles, smem, stream);
      case 2:
        return launch_wide1<2>(a, n_particles, smem, stream);
      default:
        return launch_wide1<1>(a, n_particles, smem, stream);
    }
  }
  if (mode != kWide2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wide2_smem_bytes(a.d, a.tile_rows);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool kShard = DIBS_FL_SHARD != 0;
  auto kernel = fused_linear_wide_kernel<kShard, false>;
  if constexpr (!kShard) {
    if (a.keys != nullptr) kernel = fused_linear_wide_kernel<false, true>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_particles, a.n_ct), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, int kItems>
int launch_row(const Args& a, int n_particles, size_t smem,
               cudaStream_t stream) {
  // one dataset, a fleet (keys), or, in the DIBS_FL_SHARD build, a shard
  constexpr bool kShard = DIBS_FL_SHARD != 0;
  auto kernel = fused_linear_kernel<kMode, kItems, false, kShard>;
  if constexpr (!kShard) {
    if (a.keys != nullptr) kernel = fused_linear_kernel<kMode, kItems, true,
                                                        false>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_particles, a.n_split), kThreads, smem, stream>>>(a);
  if (kMode != kPass1) {
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
    fused_linear_merge<kMode><<<n_particles, kThreads, 0, stream>>>(
        a.part, a.out_a, a.out_b, a.n_split, a.d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The x^T resid accumulators a thread holds: 1, 2 or 4 tiles of 4 x 4.
template <int kMode>
int launch(const Args& a, int n_particles, cudaStream_t stream) {
  const size_t smem = row_smem_bytes(a.d, a.tile_rows, a.group, a.sub_rows);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int items = row_items(a.d, a.group);
  if (items <= 1) return launch_row<kMode, 1>(a, n_particles, smem, stream);
  if (items <= 2) return launch_row<kMode, 2>(a, n_particles, smem, stream);
  if (items <= 4) return launch_row<kMode, 4>(a, n_particles, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#if !DIBS_FL_SHARD
DIBS_API size_t dibs_fused_linear_smem_bytes(int d, int tile_rows) {
  return smem_bytes(d, tile_rows);
}

// The row tier's footprint with `group` samples a group, `tile_rows` data
// rows a tile and `sub_rows` rows an x^T resid chunk, and the 4 x 4 tiles
// of x^T resid a thread holds (the kernel takes at most 4).
DIBS_API size_t dibs_fused_linear_row_smem_bytes(int d, int tile_rows,
                                                 int group, int sub_rows) {
  return row_smem_bytes(d, tile_rows, group, sub_rows);
}

DIBS_API int dibs_fused_linear_row_items(int d, int group) {
  return row_items(d, group);
}
#endif

// mode 0: single pass -> (dscores, dtheta); mode 1: pass 1 -> (dll_soft,
// dll_hard) [P, M]; mode 2: pass 2 with weights -> (dscores, dtheta). The
// plan (Python: fused_linear_row_plan) gives `tile_rows`, `group` (1, 2 or
// 4), `sub_rows` (a multiple of 4, at most tile_rows rounded up to 4) and
// `chunk` (samples a block); the scratch holds [P, S, N, dp] floats of
// resid_ref where tile_rows < N (else `resid_ref` may be null) and [P, S,
// 4 + 2 d^2] floats of partial states, S = ceil(M / chunk), dp = d rounded
// up to 4. A fleet (dibs_tpu_torch/fleet.py) passes B_ds = P / `per`
// datasets' x and w [B_ds, N, d] and their keys [B_ds] (device int64):
// particle p reads dataset p / per and draws with its key at the particle
// counter p % per; one dataset: per = P, keys null (the key is `seed`).
// dibs_fused_linear_shard (the DIBS_FL_SHARD build) launches a particle
// shard: one dataset whose particle counters start at `p0`, its first
// global particle; dibs_fused_linear takes p0 = 0.
#if DIBS_FL_SHARD
DIBS_API int dibs_fused_linear_shard(
#else
DIBS_API int dibs_fused_linear(
#endif
    int mode, const float* scores, const float* theta, const float* x,
    const float* w, const int64_t* keys, int per, uint32_t p0,
    const float* eps_soft,
    const float* eps_hard,
    const float* wts_soft, const float* wts_hard, float* resid_ref,
    float* part, float* out_a, float* out_b, int n_particles, int n_samples,
    int d, int n_obs, int tile_rows, int chunk, int group, int sub_rows,
    uint64_t seed,
    uint32_t stream_soft, uint32_t stream_hard, float alpha, float tau, double inv_var,
    float mean_edge, float sig_edge, cudaStream_t stream) {
  if (d < 1 || n_obs < 1 || n_samples < 1 || tile_rows < 1 ||
      tile_rows > n_obs || chunk < 1 ||
      (group != 1 && group != 2 && group != kMaxGroup) || sub_rows < 4 ||
      sub_rows % 4 != 0 || sub_rows > row_ldn(tile_rows) ||
      (tile_rows < n_obs && resid_ref == nullptr) || per < 1 ||
      n_particles % per != 0 ||
      (DIBS_FL_SHARD != 0 ? keys != nullptr : p0 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_particles == 0) return 0;
  Args a;
  a.scores = scores;
  a.theta = theta;
  a.x = x;
  a.w = w;
  a.keys = keys;
  a.per = per;
  a.eps_soft = eps_soft;
  a.eps_hard = eps_hard;
  a.wts_soft = wts_soft;
  a.wts_hard = wts_hard;
  a.resid_ref = resid_ref;
  a.part = part;
  a.out_a = out_a;
  a.out_b = out_b;
  a.n_samples = n_samples;
  a.d = d;
  a.n_obs = n_obs;
  a.tile_rows = tile_rows;
  a.chunk = chunk;
  a.group = group;
  a.sub_rows = sub_rows;
  a.n_split = (n_samples + chunk - 1) / chunk;
  a.k0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  a.k1 = static_cast<uint32_t>(seed >> 32);
  a.stream_soft = stream_soft;
  a.stream_hard = stream_hard;
  a.p0 = p0;
  a.alpha = alpha;
  a.tau = tau;
  a.mean_edge = mean_edge;
  a.sig_edge = sig_edge;
  a.inv_var = inv_var;
  switch (mode) {
    case kSingle:
      return launch<kSingle>(a, n_particles, stream);
    case kPass1:
      return launch<kPass1>(a, n_particles, stream);
    case kPass2:
      return launch<kPass2>(a, n_particles, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#if !DIBS_FL_SHARD
DIBS_API size_t dibs_fused_linear_wide_smem_bytes(int d, int tile_rows) {
  return wide_smem_bytes(d, tile_rows);
}

// Pass 1's footprint with `group` samples a group, and the group it takes
// for (d, tile_rows): the largest of 4, 2, 1 that leaves two blocks an SM.
DIBS_API size_t dibs_fused_linear_wide_pass1_smem_bytes(int d, int tile_rows,
                                                        int group) {
  return wide1_smem_bytes(d, tile_rows, group);
}

DIBS_API int dibs_fused_linear_wide_pass1_group(int d, int tile_rows) {
  return wide1_group(d, tile_rows);
}

// Pass 2's footprint with `tile_rows` data rows a tile (the wrapper's
// fused_linear_wide_pass2_plan picks them).
DIBS_API size_t dibs_fused_linear_wide_pass2_smem_bytes(int d, int tile_rows) {
  return wide2_smem_bytes(d, tile_rows);
}
#endif

// The wide tier. mode 3: pass 1 -> float64 partial dll [P, M, n_ct] per
// column tile (n_ct = ceil(d / 8)); mode 4: pass 2 with weights ->
// (dscores, dtheta). `resid_ref` is [P, n_ct, N, 8] floats of scratch when
// the rows are tiled (tile_rows < N), else nullptr. `p0`: the particle
// counter of particle 0, a shard's first global particle in
// dibs_fused_linear_wide_shard (the DIBS_FL_SHARD build), else 0. A fleet
// passes B_ds = P / `per` datasets' x and w [B_ds, N, d] and their keys
// [B_ds] (device int64; dibs_fused_linear_wide only): particle p reads
// dataset p / per and draws with its key at the particle counter p % per
// (the kFleet builds); one dataset: keys null, per = P (the key is `seed`).
// `replayed`: null, or a counter to which pass 2 adds the (particle,
// sample) pairs it replays (those whose two weights are not both 0).
#if DIBS_FL_SHARD
DIBS_API int dibs_fused_linear_wide_shard(
#else
DIBS_API int dibs_fused_linear_wide(
#endif
    int mode, const float* scores, const float* theta, const float* x,
    const float* w, const float* eps_soft, const float* eps_hard,
    const float* wts_soft, const float* wts_hard, float* resid_ref,
    double* dll_soft, double* dll_hard, float* out_a, float* out_b,
    int n_particles, int n_samples, int d, int n_obs, int tile_rows,
    uint64_t seed, uint32_t p0, uint32_t stream_soft, uint32_t stream_hard,
    float alpha, float tau, double inv_var, float mean_edge, float sig_edge,
    cudaStream_t stream, const int64_t* keys, int per,
    unsigned long long* replayed) {
  if (d < 1 || n_obs < 1 || n_samples < 1 || tile_rows < 1 ||
      tile_rows > n_obs || tile_rows > kThreads / 2 ||
      (tile_rows < n_obs && resid_ref == nullptr) || per < 1 ||
      n_particles % per != 0 ||
      (DIBS_FL_SHARD != 0 ? keys != nullptr : p0 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_particles == 0) return 0;
  WideArgs a;
  a.scores = scores;
  a.theta = theta;
  a.x = x;
  a.w = w;
  a.eps_soft = eps_soft;
  a.eps_hard = eps_hard;
  a.wts_soft = wts_soft;
  a.wts_hard = wts_hard;
  a.resid_ref = tile_rows < n_obs ? resid_ref : nullptr;
  a.dll_soft = dll_soft;
  a.dll_hard = dll_hard;
  a.out_a = out_a;
  a.out_b = out_b;
  a.n_samples = n_samples;
  a.d = d;
  a.n_obs = n_obs;
  a.tile_rows = tile_rows;
  a.n_ct = (d + kCols - 1) / kCols;
  a.k0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  a.k1 = static_cast<uint32_t>(seed >> 32);
  a.stream_soft = stream_soft;
  a.stream_hard = stream_hard;
  a.p0 = p0;
  a.alpha = alpha;
  a.tau = tau;
  a.mean_edge = mean_edge;
  a.sig_edge = sig_edge;
  a.inv_var = inv_var;
  a.keys = keys;
  a.per = per;
  a.replayed = mode == kWide2 ? replayed : nullptr;
  return launch_wide(a, mode, n_particles, stream);
}
