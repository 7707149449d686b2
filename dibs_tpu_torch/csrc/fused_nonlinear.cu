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
// Three launches. (1) fused_nl_reference, one block per particle: pre_ref
// and resid_ref into scratch [P, h1 + 1, N, d]. (2) fused_nl_kernel, a grid
// of (particle, sample chunk) work items that fills one wave, each run by
// `ranks` blocks (one, or a thread-block cluster of 2, 4 or 8) that keep
// an online softmax per stream over its chunk. (3) fused_nl_merge merges
// each particle's partial states in a fixed order, so the result is
// deterministic. The per-sample log-likelihoods are summed in float64, as
// in kernels #2 and #5-#7 and the plain version.
//
// Bound on this card: 8 h1 N d^2 float32 FLOPs per sample (two streams, the
// delta product and x^T u), 6.1 GFLOP at P = 30, M = 128, N = 100, d = 20,
// h1 = 5 (config 3), i.e. ~92 us at 67 TFLOP/s; 322.5 GFLOP, 4.81 ms, at
// P = 1000, M = 32, N = 100, d = 50, h1 = 5 (config 7). The inputs and
// outputs are small (~0.2 MB at config 3). The kernel is bound by
// operations, in FP32 FFMA (no TF32).
//
// Design of fused_nl_kernel<kH, kPad, kAct, kFleet, kShard, kCluster>,
// blocks of 512 threads, one an SM (their registers fill the SM's; the
// grid is one wave of such blocks):
//  * the node columns: node column j's mean reads only column j of G, W1,
//    E[G], L1 and node j's b1, W2, b2, and the whole of x, so the `ranks`
//    blocks of a work item split the particle's node columns: rank r holds
//    columns [r d / ranks, (r + 1) d / ranks) of every [d, d] slab, of the
//    data tile's w, resid_ref and pre_ref, of the u_h stage and of the
//    accumulators, and all of x. Every rank runs the schedule below on its
//    columns, with the same Philox counters, so the same noise. One block
//    (ranks = 1) holds all d columns;
//  * the data rows stay in shared memory across the block's samples: x
//    (transposed for the delta product, row-major for x^T u), w, resid_ref
//    and every pre_ref_h, in one tile of `tile_rows` rows. Where all N rows
//    fit (configs 3 and 7: N = 100) they are loaded once per block; else a
//    tile is loaded once per group of samples, its row-major x double-
//    buffered so that x^T u of one tile runs beside the next tile's delta
//    product;
//  * samples run in groups of `group` (<= 2): one phase draws the group's
//    G - E[G] and H - E[G] and their prior terms, then both products run on
//    every (sample, stream) of the group at once; the float64 log-
//    likelihoods and the softmax update are reduced once per group. A group
//    takes sub-tiles + 4 block barriers (9 at config 3, for 2 samples);
//  * the delta product is register-tiled: a thread owns one (sample,
//    stream, node column j) and 4 data rows, for kH hidden units (4 kH
//    accumulators), and per input i reads one float4 of x^T, the sample's
//    difference and kH weights for 4 kH FFMA. It forms the masked weights
//    (G - E[G]) W1_h on the fly, so no [h1, d, d] slab is stored per
//    sample. The epilogue of each row (activation differences, the float64
//    data term, delta, u_h and the hard stream's row sums of db1, dW2, db2)
//    runs on those registers; the row sums stay in registers until the
//    group ends and are reduced in a fixed order;
//  * u_h of `sub_rows` rows at a time is staged in shared memory, double-
//    buffered: the delta product of one sub-tile runs beside x^T u of the
//    one before, one barrier apart. x^T u is register-tiled too: a thread
//    owns 4 inputs i x kH of one (sample, stream, node column) and per row
//    reads one float4 of x and kH values of u for 4 kH FFMA; its sums are
//    added to the sample's x^T u_h (hard) or sum_h W1_h x^T u_h (soft) in
//    shared memory, each element by one thread. Its tasks are dealt from
//    the last thread down, so the two products spread over all the warps;
//  * the exchange (ranks > 1): the log-likelihood of each (sample, stream)
//    sums over all columns, so each rank puts its float64 partial into its
//    slot of `xch` (double-buffered by group parity), arrives at the
//    cluster barrier, folds its sample terms into their weight-free form
//    while the others arrive, then reads the `ranks` partials over
//    distributed shared memory and adds them in rank order: every rank
//    holds the same dll, bit for bit, and runs the same online softmax on
//    its columns. Each rank writes its columns of the partial state that
//    fused_nl_merge reads. One block's dll is its own float64 sum, cast
//    once, and it folds each term as it weights it: there is no barrier
//    for a separate fold to hide behind;
//  * the cluster is the compile-time kCluster: with kCluster = false the
//    rank is 0 and the count of ranks 1, and the build reads no cluster
//    register, holds no exchange slots and reaches no cluster barrier;
//  * W1, pre_ref and u_h keep the hidden unit innermost, at the odd stride
//    h1 | 1, so a thread's kH values sit at fixed offsets from one pointer
//    and a warp's 32 node columns fall in distinct banks;
//  * the activation is a template parameter and the hidden width kH a
//    compile-time bound: kH = 5 exactly for h1 = 5 (configs 3 and 7), else
//    h1 is rounded up to 4, 8 or 16 and the units past h1 carry zero
//    weights.
// The plan (inference/fused_nonlinear.py: fused_nonlinear_plan) takes one
// block where the gate's one-block measure fits, else the fewest ranks
// that keep every data row resident: at config 7 on an H100 SXM (700 W) a
// call takes 23.4 ms with clusters of 4 (every row resident), 27.8 with 2
// (12-row tiles) and 25.9 with 8.
// ---------------------------------------------------------------------------
#include <cmath>

// Fleets (dibs_tpu_torch/fleet.py): csrc/fused_nonlinear_fleet.cu compiles
// this file again with DIBS_NL_FLEET 1, which instantiates the main kernel
// with kFleet = true and exports dibs_fused_nonlinear_fleet. A fleet's
// particle p of dataset p / per reads that dataset's x and w and draws
// with its key at the particle counter p % per. Kept out of the
// single-dataset kernels' code (a run-time branch there added registers to
// the kH = 16 kernels, whose spills grew and which then failed on the card
// with an illegal instruction), and in its own translation unit so that
// both sets build in parallel. Particle shards likewise:
// csrc/fused_nonlinear_shard.cu builds it with DIBS_NL_SHARD 1 (kShard:
// the particle counter starts at the launch's p0; launcher
// dibs_fused_nonlinear_shard; the counter added at the draws,
// dibs::draw_counter). A run-time p0 in the single-dataset kernels grew
// the kH = 16 sigmoid kernel's spills (316 / 1136 to 400 / 1396 B) and its
// launches died with an illegal instruction.
#ifndef DIBS_NL_FLEET
#define DIBS_NL_FLEET 0
#endif
#ifndef DIBS_NL_SHARD
#define DIBS_NL_SHARD 0
#endif

#include "common.h"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupMax = 2;                 // samples a group
constexpr int kSlotsMax = 2 * kGroupMax;     // (sample, stream) slots
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can use
constexpr int kMaxH = 16;            // widest hidden layer

enum Act : int { kRelu = 0, kTanh = 1, kSigmoid = 2, kLeaky = 3 };

struct Args {
  const float* scores;    // [P, d, d] edge scores
  const float* w1;        // [P, h1, d, d]: W1[p, j, i, h] at [p, h, i, j]
  const float* l1;        // [P, d, d] masked-prior logpdf sums
  const float* w2;        // [P, h1 + 1, d]: W2 rows, row h1 = b2
  const float* x;         // [B_ds, N, d] (one dataset: [N, d])
  const float* w;         // [B_ds, N, d] observation weights
  const int64_t* keys;    // [B_ds] a fleet's keys, or nullptr (k0, k1)
  int per;                // particles a dataset (P for one dataset)
  const float* eps_soft;  // [P, M, d, d] injected noise or nullptr
  const float* eps_hard;  // [P, M, d, d] injected noise or nullptr
  const float* ref;       // [P, h1 + 1, N, d]: pre_ref (h < h1), resid_ref
  float* part;            // [P, S, stride] scratch: partial states
  int n_samples, d, h1, n_obs, tile_rows, sub_rows, group, n_split, chunk;
  uint32_t k0, k1, stream_soft, stream_hard;
  float alpha, tau, inv_varp;
  double inv_var;
  uint32_t p0;  // particle counter of particle 0 (kShard: a shard's first)
};

__host__ __device__ inline int round_up(int v, int k) {
  return (v + k - 1) / k * k;
}

__host__ __device__ inline int part_stride(int d, int h1) {
  return 4 + (1 + h1) * d * d + (2 * h1 + 1) * d;
}

// A rank's shared memory, region by region in the kernel's order: the
// exchange slots first where ranks > 1 (at the same offset in every rank),
// then the regions with the node columns cut to ceil(d / ranks)
// (inference/fused_nonlinear.py mirrors it: fused_nonlinear_plan_smem_bytes).
size_t smem_bytes(int d, int h1, int ranks, int group, int sub_rows,
                  int tile_rows, int n_obs) {
  const size_t cols = (d + ranks - 1) / ranks, dc = d * cols;
  const size_t hh = h1, hs = h1 | 1, g = group, t = tile_rows;
  const size_t ldt = round_up(tile_rows, 4), ldx = round_up(d, 4);
  const size_t x_bufs = tile_rows < n_obs ? 2 : 1;
  const size_t doubles =
      (ranks > 1 ? 2 * kSlotsMax : 0) + kThreads + kWarps * kSlotsMax;
  const size_t tile = d * ldt + x_bufs * t * ldx + (2 + hs) * t * cols;
  const size_t stage = 2 * 2 * g * sub_rows * cols * hs;
  const size_t particle = (3 + hs) * dc + hh * cols;
  const size_t accs = (1 + hh) * dc + (2 * hh + 1) * cols;
  const size_t samples = g * (3 + hh) * dc;
  const size_t sums = (2 * hh + 1) * (kThreads / 2) + kSlotsMax;
  return sizeof(double) * doubles +
         sizeof(float) * (tile + stage + particle + accs + samples + sums);
}

size_t ref_smem_bytes(int d, int h1) {
  return sizeof(float) * (static_cast<size_t>(h1) * d * d +
                          (2 * static_cast<size_t>(h1) + 1) * d);
}

template <int kAct>
__device__ __forceinline__ float act_f(float v) {
  if constexpr (kAct == kRelu) {
    return fmaxf(v, 0.0f);
  } else if constexpr (kAct == kTanh) {
    return tanhf(v);
  } else if constexpr (kAct == kSigmoid) {
    return 1.0f / (1.0f + expf(-v));
  } else {
    return v > 0.0f ? v : 0.01f * v;
  }
}

template <int kAct>
__device__ __forceinline__ float dact_f(float v) {
  if constexpr (kAct == kRelu) {
    return v > 0.0f ? 1.0f : 0.0f;
  } else if constexpr (kAct == kTanh) {
    const float t = tanhf(v);
    return 1.0f - t * t;
  } else if constexpr (kAct == kSigmoid) {
    const float s = 1.0f / (1.0f + expf(-v));
    return s * (1.0f - s);
  } else {
    return v > 0.0f ? 1.0f : 0.01f;
  }
}

// act(p + dl) - act(p) with pre = p + dl; relu in its exact branch form.
template <int kAct>
__device__ __forceinline__ float act_diff(float p, float dl, float pre) {
  if constexpr (kAct == kRelu) {
    return p >= 0.0f ? fmaxf(dl, -p) : fmaxf(pre, 0.0f);
  } else {
    return act_f<kAct>(pre) - act_f<kAct>(p);
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  }
  return v;
}

// (1) The centring reference of each particle.
template <int kAct>
__global__ void __launch_bounds__(kThreads)
    fused_nl_reference(const float* __restrict__ scores,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2,
                       const float* __restrict__ x, float* __restrict__ ref,
                       int d, int h1, int n_obs, int per, float alpha) {
  extern __shared__ float smem_f[];
  const int p = blockIdx.x, tid = threadIdx.x, dd = d * d;
  if constexpr (DIBS_NL_FLEET != 0) {  // the particle's dataset
    x += static_cast<int64_t>(p / per) * n_obs * d;
  }
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
      mean = fmaf(act_f<kAct>(pre), ww[h * d + j], mean);
    }
    out[h1 * nd + idx] = xr[j] - mean;
  }
}

// A block's place in its thread-block cluster, the cluster's barrier and
// loads from another block's shared memory (kCluster builds only).
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The double at `local` (an address of this block's shared memory) in the
// shared memory of block `rank` of the cluster.
__device__ __forceinline__ double cluster_load(const double* local,
                                               uint32_t rank) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];"
               : "=d"(v) : "r"(remote) : "memory");
  return v;
}

// (2) One pass over a chunk of samples, in groups, with an online softmax
// per stream, by one rank of the work item's `ranks` blocks (kCluster:
// gridDim.x = P x ranks, clusters of `ranks` blocks along x; else one block
// a particle). kH: the register arrays' hidden width; kPad: h1 < kH
// possible (units past h1 read as zero), else h1 = kH.
template <int kH, bool kPad, int kAct, bool kFleet, bool kShard,
          bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
    fused_nl_kernel(const Args a) {
  extern __shared__ __align__(16) double smem_d[];
  const int ranks = kCluster ? static_cast<int>(cluster_nctarank()) : 1;
  const uint32_t rank = kCluster ? cluster_ctarank() : 0;
  const int d = a.d, dd = d * d, h1 = kPad ? a.h1 : kH;
  // this rank's node columns j0 .. j0 + dc: [d, dc] slabs, dl elements
  const int j0 = static_cast<int>(rank) * d / ranks;
  const int dc = (static_cast<int>(rank) + 1) * d / ranks - j0, dl = d * dc;
  const int G = a.group, T = a.tile_rows, R = a.sub_rows;
  const int n_obs = a.n_obs, n_tiles = (n_obs + T - 1) / T;
  const int ldt = round_up(T, 4), ldx = round_up(d, 4);
  const int NC = 2 * G * dc, L = kThreads / NC;  // delta product: combos x lanes
  const int GD = G * dc;                         // hard combos a lane
  const int hs = h1 | 1;  // odd stride of the [.., h] rows: no bank conflicts
  const int stage = R * dc * hs;                 // one (sample, stream) slot
  double* xch = smem_d;  // [2][kSlotsMax] dll partials (kCluster only)
  double* ldp = xch + (kCluster ? 2 * kSlotsMax : 0);  // [kThreads] data terms
  double* lpp = ldp + kThreads;                  // [kWarps][kSlotsMax] prior
  float* xT = reinterpret_cast<float*>(lpp + kWarps * kSlotsMax);  // [d][ldt]
  float* xr = xT + d * ldt;          // [1 or 2][T][ldx], 2 when tiled
  float* ub = xr + (n_tiles > 1 ? 2 : 1) * T * ldx;  // [2][2 G][R][dc][hs]
  float* wt = ub + 2 * 2 * G * stage;  // [T][dc]
  float* rt = wt + T * dc;             // resid_ref [T][dc]
  float* pt = rt + T * dc;             // pre_ref [T][dc][hs]
  float* as_ = pt + T * dc * hs;       // alpha s [d][dc]
  float* sig = as_ + dl;               // E[G], zero diagonal
  float* l1 = sig + dl;
  float* w1 = l1 + dl;                 // [d][dc][hs]
  float* w2 = w1 + dl * hs;            // [h1][dc]
  float* acc_ds = w2 + h1 * dc;
  float* acc_dw1 = acc_ds + dl;        // [h1][d][dc]
  float* acc_sm = acc_dw1 + h1 * dl;   // [2 h1 + 1][dc]: db1, dW2, db2
  float* dsm = acc_sm + (2 * h1 + 1) * dc;  // [G][d][dc] G - E[G]
  float* dhm = dsm + G * dl;           // [G][d][dc] H - E[G]
  float* dgs = dhm + G * dl;           // [G][d][dc] sum_h W1_h x^T u_h, soft
  float* xtu = dgs + G * dl;           // [G][h1][d][dc] x^T u_h, hard
  float* rs = xtu + G * h1 * dl;       // [2 h1 + 1][kThreads / 2] row sums
  float* sll = rs + (2 * h1 + 1) * (kThreads / 2);  // [kSlotsMax] dll

  const int p = blockIdx.x / ranks, split = blockIdx.y, tid = threadIdx.x;
  // data, key and particle counter: a fleet's dataset p / per (see the
  // note at the top), else the launch's own; a shard (kShard) counts from
  // p0 (dibs::draw_counter)
  const float* xd = a.x;
  const float* wd = a.w;
  uint32_t pk = p, k0 = a.k0, k1 = a.k1;
  if constexpr (kFleet) {
    const int ds = p / a.per;
    const int64_t data0 = static_cast<int64_t>(ds) * a.n_obs * a.d;
    xd += data0;
    wd += data0;
    const uint64_t key = static_cast<uint64_t>(a.keys[ds]);
    pk = p - ds * a.per;
    k0 = static_cast<uint32_t>(key & 0xFFFFFFFFull);
    k1 = static_cast<uint32_t>(key >> 32);
  }
  const int warp = tid / 32, lane = tid % 32;
  const int n_smp = a.n_samples;
  const int m_begin = split * a.chunk;
  const int m_end = min(n_smp, m_begin + a.chunk);
  const int64_t ps = static_cast<int64_t>(p) * a.n_split + split;
  const int64_t nd = static_cast<int64_t>(n_obs) * d;
  const int64_t pdd = static_cast<int64_t>(p) * dd;
  const float* refp = a.ref + static_cast<int64_t>(p) * (h1 + 1) * nd;
  const float inv_var_f = static_cast<float>(a.inv_var);
  // this thread's (sample, stream, local node column) and row lane in the
  // delta product; slot = 2 sample + stream (0 soft, 1 hard)
  const bool fwd = tid < NC * L;
  const int cmb = tid % NC, lane_r = tid / NC;
  const int slot_f = cmb / dc, jq = cmb - slot_f * dc, gq = slot_f >> 1;
  const int hr = lane_r * GD + gq * dc + jq;  // row-sum index (hard)
  // x plus the index in a [rows, d] whole of element e, in row r, of a
  // [rows, dc] slice of this rank's columns. One block indexes its rows
  // directly (x + e): left to fold, the slice's arithmetic changed the
  // one-block build's registers and grew its kH = 16 fleet spills. The
  // same choice, where the slice's index is not in this form: pe, w2, rt.
  auto at = [&](auto x, int e, int r) {
    if constexpr (kCluster) {
      return x + r * d + j0 + e - r * dc;
    } else {
      return x + e;
    }
  };

  // --- per particle: this rank's columns ---
  for (int e = tid; e < dl; e += kThreads) {
    const int i = e / dc, j = j0 + e - i * dc;
    const int64_t pe =
        kCluster ? pdd + i * d + j : static_cast<int64_t>(p) * dd + e;
    const float s = __fmul_rn(a.alpha, a.scores[pe]);
    as_[e] = s;
    sig[e] = i == j ? 0.0f : 1.0f / (1.0f + expf(-s));
    l1[e] = a.l1[pe];
    acc_ds[e] = 0.0f;
  }
  for (int k = tid; k < h1 * dl; k += kThreads) {  // [h][i][j] -> [i][j][h]
    const int h = k / dl, e = k - h * dl, i = e / dc;
    w1[e * hs + h] = a.w1[at((static_cast<int64_t>(p) * h1 + h) * dd, e, i)];
    acc_dw1[k] = 0.0f;
  }
  for (int k = tid; k < h1 * dc; k += kThreads) {
    const int h = k / dc;
    w2[k] = a.w2[kCluster ? (static_cast<int64_t>(p) * (h1 + 1) + h) * d +
                                j0 + k - h * dc
                          : static_cast<int64_t>(p) * (h1 + 1) * d + k];
  }
  for (int k = tid; k < (2 * h1 + 1) * dc; k += kThreads) acc_sm[k] = 0.0f;

  // rows t0 .. t0 + tn: all of x (transposed and row-major, the latter
  // into buffer xb), this rank's columns of w, resid_ref and pre_ref
  auto load_tile = [&](int t0, int tn, int xb) {
    const int64_t base = static_cast<int64_t>(t0) * d;
    float* xo = xr + xb * T * ldx;
    for (int idx = tid; idx < ldt * d; idx += kThreads) {
      const int n = idx / d, i = idx - n * d;
      xT[i * ldt + n] = n < tn ? xd[base + idx] : 0.0f;
    }
    for (int idx = tid; idx < T * ldx; idx += kThreads) {
      const int n = idx / ldx, i = idx - n * ldx;
      xo[idx] = n < tn && i < d ? xd[base + n * d + i] : 0.0f;
    }
    for (int idx = tid; idx < tn * dc; idx += kThreads) {
      const int n = idx / dc;
      const int64_t g = at(base, idx, n);
      wt[idx] = wd[g];
      rt[idx] = refp[kCluster ? h1 * nd + g : h1 * nd + base + idx];
    }
    for (int k = tid; k < h1 * tn * dc; k += kThreads) {
      const int h = k / (tn * dc), rem = k - h * tn * dc, n = rem / dc;
      pt[rem * hs + h] = refp[at(h * nd + base, rem, n)];
    }
  };
  if (n_tiles == 1) load_tile(0, n_obs, 0);  // resident for every sample
  __syncthreads();

  float w2r[kH];  // W2[h][jq], zero past h1
#pragma unroll
  for (int h = 0; h < kH; ++h) w2r[h] = (!kPad || h < h1) ? w2[h * dc + jq] : 0.0f;

  float m_s = -INFINITY, z_s = 0.0f, m_h = -INFINITY, z_h = 0.0f;
  int parity = 0;  // the group's exchange buffer
  for (int m0 = m_begin; m0 < m_end; m0 += G, parity ^= 1) {
    const int gl = min(G, m_end - m0);  // samples in this group
    const bool fwd_g = fwd && gq < gl;

    // --- 1. this rank's columns of the group's samples; prior terms ---
    double lp0s = 0.0, lp0h = 0.0, lp1s = 0.0, lp1h = 0.0;
    for (int idx = tid; idx < gl * dl; idx += kThreads) {
      const int g = idx / dl, e = idx - g * dl, m = m0 + g, i = e / dc;
      const int j = j0 + e - i * dc, eg = i * d + j;
      const int64_t nbase = (static_cast<int64_t>(p) * n_smp + m) * dd;
      float g_soft = 0.0f, g_hard = 0.0f;
      if (i != j) {
        const float es =
            a.eps_soft != nullptr
                ? a.eps_soft[nbase + eg]
                : dibs::philox_logistic(
                      eg, m, dibs::draw_counter<kShard>(pk, a.p0),
                      a.stream_soft, k0, k1);
        float eh;
        if (a.eps_hard != nullptr) {
          eh = a.eps_hard[nbase + eg];
        } else if (a.stream_hard == a.stream_soft) {
          eh = es;
        } else {
          eh = dibs::philox_logistic(
              eg, m, dibs::draw_counter<kShard>(pk, a.p0), a.stream_hard,
              k0, k1);
        }
        g_soft = 1.0f / (1.0f + expf(-__fmul_rn(a.tau, __fadd_rn(es, as_[e]))));
        g_hard = __fadd_rn(eh, as_[e]) > 0.0f ? 1.0f : 0.0f;
      }
      const float ds = g_soft - sig[e], dh = g_hard - sig[e];
      dsm[idx] = ds;
      dhm[idx] = dh;
      const double ts = static_cast<double>(ds * l1[e]);
      const double th = static_cast<double>(dh * l1[e]);
      if (g == 0) {
        lp0s += ts;
        lp0h += th;
      } else {
        lp1s += ts;
        lp1h += th;
      }
    }
    for (int k = tid; k < G * (1 + h1) * dl; k += kThreads) dgs[k] = 0.0f;
    lp0s = warp_sum(lp0s);
    lp0h = warp_sum(lp0h);
    lp1s = warp_sum(lp1s);
    lp1h = warp_sum(lp1h);
    if (lane == 0) {
      lpp[warp * kSlotsMax + 0] = lp0s;
      lpp[warp * kSlotsMax + 1] = lp0h;
      lpp[warp * kSlotsMax + 2] = lp1s;
      lpp[warp * kSlotsMax + 3] = lp1h;
    }
    __syncthreads();

    // --- 2. per sub-tile: the delta product and its row epilogue (u_h
    // staged), beside x^T u of the sub-tile before ---
    double ld = 0.0;
    float s_db1[kH], s_dw2[kH], s_db2 = 0.0f;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      s_db1[h] = 0.0f;
      s_dw2[h] = 0.0f;
    }

    // delta product of rows c0 .. c0 + rc of the tile into stage buffer buf
    auto forward = [&](int c0, int rc, int buf) {
      if (!fwd_g) return;
      const int nq = (rc + 3) / 4;
      const float* dgm = ((slot_f & 1) ? dhm : dsm) + gq * dl + jq;
      float* uo = ub + (buf * 2 * G + slot_f) * stage + jq * hs;
      for (int q = lane_r; q < nq; q += L) {
        const int r0 = c0 + 4 * q;
        float f[kH][4];
#pragma unroll
        for (int h = 0; h < kH; ++h) {
#pragma unroll
          for (int r = 0; r < 4; ++r) f[h][r] = 0.0f;
        }
        const float* xp = xT + r0;         // x^T[i][r0 ..]
        const float* cp = dgm;             // (G - E[G])[i][jq]
        const float* wp = w1 + jq * hs;    // W1[i][jq][0 ..]
#pragma unroll 2
        for (int i = 0; i < d; ++i, xp += ldt, cp += dc, wp += dc * hs) {
          const float4 x4 = *reinterpret_cast<const float4*>(xp);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
          const float cg = *cp;
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            const float av = (!kPad || h < h1) ? cg * wp[h] : 0.0f;
#pragma unroll
            for (int r = 0; r < 4; ++r) f[h][r] = fmaf(xv[r], av, f[h][r]);
          }
        }
        // row epilogue: data row n, node column jq, this thread's stream
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = r0 + r;
          if (n >= c0 + rc) break;
          const int nj = n * dc + jq;
          const float rv = rt[nj], wv = wt[nj];
          const float* pp = pt + nj * hs;
          float pr[kH];
          float md = 0.0f;
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            pr[h] = (!kPad || h < h1) ? pp[h] : 0.0f;
            md += act_diff<kAct>(pr[h], f[h][r], pr[h] + f[h][r]) * w2r[h];
          }
          ld += static_cast<double>(wv * md * (md - 2.0f * rv));
          const float del = inv_var_f * ((rv - md) * wv);
          float* un = uo + (n - c0) * dc * hs;
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            if (!kPad || h < h1) {
              const float pre = pr[h] + f[h][r];
              const float u = del * dact_f<kAct>(pre) * w2r[h];
              un[h] = u;
              s_db1[h] += u;  // kept for the hard stream only
              s_dw2[h] += del * act_f<kAct>(pre);
            }
          }
          s_db2 += del;
        }
      }
    };

    // x^T u of rows c0 .. c0 + rc from stage buffer buf and x buffer xb,
    // into dgs / xtu
    auto xtu_product = [&](int c0, int rc, int buf, int xb) {
      const int n_iq = (d + 3) / 4;
      const int n_tasks = 2 * gl * n_iq * dc;
      // tasks from the last thread down: the threads past the delta
      // product's combos take x^T u first, so the two spread over the warps
      for (int k = kThreads - 1 - tid; k < n_tasks; k += kThreads) {
        const int j = k % dc, rest = k / dc;
        const int iq = rest % n_iq, slot = rest / n_iq;
        float acc[kH][4];
#pragma unroll
        for (int h = 0; h < kH; ++h) {
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[h][r] = 0.0f;
        }
        const float* xp = xr + xb * T * ldx + c0 * ldx + 4 * iq;
        const float* up = ub + (buf * 2 * G + slot) * stage + j * hs;
#pragma unroll 2
        for (int n = 0; n < rc; ++n, xp += ldx, up += dc * hs) {
          const float4 x4 = *reinterpret_cast<const float4*>(xp);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            const float uv = (!kPad || h < h1) ? up[h] : 0.0f;
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[h][r] = fmaf(xv[r], uv, acc[h][r]);
          }
        }
        const int g = slot >> 1;
        const bool hard = slot & 1;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * iq + r;
          if (i >= d) break;
          const int e = i * dc + j;
          if (hard) {
#pragma unroll
            for (int h = 0; h < kH; ++h) {
              if (!kPad || h < h1) xtu[(g * h1 + h) * dl + e] += acc[h][r];
            }
          } else {
            float dg = 0.0f;
#pragma unroll
            for (int h = 0; h < kH; ++h) {
              if (!kPad || h < h1) dg = fmaf(w1[e * hs + h], acc[h][r], dg);
            }
            dgs[g * dl + e] += dg;
          }
        }
      }
    };

    // sub-tiles in order over the tiles; the x^T u of each runs in the
    // next interval, beside the next delta product (of the next tile
    // too: x is double-buffered by tile where the rows are tiled)
    int c_all = 0, p_c0 = 0, p_rc = 0, p_buf = 0, p_xb = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int t0 = t * T, tn = min(T, n_obs - t0), xb = t & 1;
      if (n_tiles > 1) {
        load_tile(t0, tn, xb);
        __syncthreads();
      }
      const int n_sub = (tn + R - 1) / R;
      for (int c = 0; c < n_sub; ++c, ++c_all) {
        const int c0 = c * R, rc = min(R, tn - c0), buf = c_all & 1;
        forward(c0, rc, buf);
        if (c_all > 0) xtu_product(p_c0, p_rc, p_buf, p_xb);
        if (t == n_tiles - 1 && c == n_sub - 1 && fwd_g) {
          ldp[tid] = ld;  // the group's row partials
          if (slot_f & 1) {
#pragma unroll
            for (int h = 0; h < kH; ++h) {
              if (!kPad || h < h1) {
                rs[h * (kThreads / 2) + hr] = s_db1[h];
                rs[(h1 + h) * (kThreads / 2) + hr] = s_dw2[h];
              }
            }
            rs[2 * h1 * (kThreads / 2) + hr] = s_db2;
          }
        }
        p_c0 = c0;
        p_rc = rc;
        p_buf = buf;
        p_xb = xb;
        __syncthreads();
      }
    }
    xtu_product(p_c0, p_rc, p_buf, p_xb);
    __syncthreads();

    // --- 3. this rank's float64 part of each (sample, stream)'s dll; one
    // block's part is the whole dll, cast once ---
    double* slots = xch + parity * kSlotsMax;
    if (warp < 2 * gl) {
      double v = 0.0;
      for (int k = lane; k < L * dc; k += 32) {
        const int l = k / dc, j = k - l * dc;
        v += ldp[l * NC + warp * dc + j];
      }
      v = warp_sum(v);
      if (lane == 0) {
        double lp = 0.0;
        for (int k = 0; k < kWarps; ++k) lp += lpp[k * kSlotsMax + warp];
        if constexpr (kCluster) {
          slots[warp] = -0.5 * a.inv_var * v + lp;
        } else {
          sll[warp] = static_cast<float>(-0.5 * a.inv_var * v + lp);
        }
      }
    }

    if constexpr (kCluster) {
      cluster_arrive();

      // --- 4. while the other ranks arrive: each sample's terms without
      // their softmax weights (each element by the thread that weights it
      // in 7), the hard stream's row sums over the lanes ---
      const float sens_c = a.tau * a.alpha;
      for (int e = tid; e < dl; e += kThreads) {
        const float sg = sig[e];
        for (int g = 0; g < gl; ++g) {
          const float gv = dsm[g * dl + e] + sg;
          dgs[g * dl + e] = sens_c * gv * (1.0f - gv) * (l1[e] + dgs[g * dl + e]);
          const float hv = dhm[g * dl + e] + sg > 0.5f ? 1.0f : 0.0f;
          for (int h = 0; h < h1; ++h) {
            float* xq = xtu + (g * h1 + h) * dl + e;
            *xq = hv * (*xq - w1[e * hs + h] * a.inv_varp);
          }
        }
      }
      for (int k = tid; k < (2 * h1 + 1) * dc; k += kThreads) {
        const int qq = k / dc, j = k - qq * dc;
        for (int g = 0; g < gl; ++g) {
          float* rq = rs + qq * (kThreads / 2) + g * dc + j;
          float s = 0.0f;
          for (int l = 0; l < L; ++l) s += rq[l * GD];
          *rq = s;
        }
      }

      // --- 5. the whole dll: the ranks' parts in rank order ---
      cluster_wait();
      if (tid < 2 * gl) {
        double v = 0.0;
        for (int r = 0; r < ranks; ++r) v += cluster_load(slots + tid, r);
        sll[tid] = static_cast<float>(v);
      }
    }
    __syncthreads();

    // --- 6. online softmax: exp(-inf) = 0 at the first group ---
    float nm_s = m_s, nm_h = m_h;
    for (int g = 0; g < gl; ++g) {
      nm_s = fmaxf(nm_s, sll[2 * g]);
      nm_h = fmaxf(nm_h, sll[2 * g + 1]);
    }
    const float sc_s = expf(m_s - nm_s), sc_h = expf(m_h - nm_h);
    float w_s[kGroupMax], w_h[kGroupMax];
    z_s *= sc_s;
    z_h *= sc_h;
#pragma unroll
    for (int g = 0; g < kGroupMax; ++g) {
      w_s[g] = g < gl ? expf(sll[2 * g] - nm_s) : 0.0f;
      w_h[g] = g < gl ? expf(sll[2 * g + 1] - nm_h) : 0.0f;
      z_s += w_s[g];
      z_h += w_h[g];
    }
    m_s = nm_s;
    m_h = nm_h;

    // --- 7. weight and accumulate the group: the terms folded in 4, or
    // (one block: no barrier to fold behind) formed as they are weighted ---
    const float sens_c = a.tau * a.alpha;
    for (int e = tid; e < dl; e += kThreads) {
      const float sg = sig[e];
      float v = acc_ds[e] * sc_s;
      float hv[kGroupMax];
#pragma unroll
      for (int g = 0; g < kGroupMax; ++g) {
        if (g < gl) {
          if constexpr (kCluster) {
            v += w_s[g] * dgs[g * dl + e];
          } else {
            const float gv = dsm[g * dl + e] + sg;
            v += w_s[g] * (sens_c * gv * (1.0f - gv) * (l1[e] + dgs[g * dl + e]));
            hv[g] = dhm[g * dl + e] + sg > 0.5f ? 1.0f : 0.0f;
          }
        }
      }
      acc_ds[e] = v;
      for (int h = 0; h < h1; ++h) {
        const int k = h * dl + e;
        float u = acc_dw1[k] * sc_h;
#pragma unroll
        for (int g = 0; g < kGroupMax; ++g) {
          if (g < gl) {
            if constexpr (kCluster) {
              u += w_h[g] * xtu[(g * h1 + h) * dl + e];
            } else {
              u += w_h[g] * (hv[g] * (xtu[(g * h1 + h) * dl + e] -
                                      w1[e * hs + h] * a.inv_varp));
            }
          }
        }
        acc_dw1[k] = u;
      }
    }
    for (int k = tid; k < (2 * h1 + 1) * dc; k += kThreads) {
      const int qq = k / dc, j = k - qq * dc;
      float v = acc_sm[k] * sc_h;
#pragma unroll
      for (int g = 0; g < kGroupMax; ++g) {
        if (g < gl) {
          if constexpr (kCluster) {
            v += w_h[g] * rs[qq * (kThreads / 2) + g * dc + j];
          } else {
            const float* rq = rs + qq * (kThreads / 2) + g * dc + j;
            float s = 0.0f;
            for (int l = 0; l < L; ++l) s += rq[l * GD];
            v += w_h[g] * s;
          }
        }
      }
      acc_sm[k] = v;
    }
    __syncthreads();  // the next group overwrites the samples and sums
  }

  // this rank's columns of the block's partial state, merged by
  // fused_nl_merge
  float* out = a.part + ps * part_stride(d, h1);
  if (rank == 0 && tid == 0) {
    out[0] = m_s;
    out[1] = z_s;
    out[2] = m_h;
    out[3] = z_h;
  }
  for (int e = tid; e < dl; e += kThreads) {
    const int i = e / dc;
    out[at(4, e, i)] = acc_ds[e];
  }
  for (int k = tid; k < h1 * dl; k += kThreads) {
    const int h = k / dl, e = k - h * dl, i = e / dc;
    out[at(4 + dd + h * dd, e, i)] = acc_dw1[k];
  }
  for (int k = tid; k < (2 * h1 + 1) * dc; k += kThreads) {
    const int qq = k / dc;
    out[at(4 + (1 + h1) * dd, k, qq)] = acc_sm[k];
  }
  if constexpr (kCluster) {
    // no rank leaves while another may still read its exchange slots
    cluster_arrive();
    cluster_wait();
  }
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

using PassKernel = void (*)(Args);
using RefKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, float*, int, int, int,
                           int, float);

// kH = 5 exactly for config 3's width, else h1 rounded up to 4, 8 or 16
template <int kAct, bool kCluster>
PassKernel pass_kernel_for(int h1) {
  constexpr bool kFleet = DIBS_NL_FLEET != 0, kShard = DIBS_NL_SHARD != 0;
  if (h1 == 5) return fused_nl_kernel<5, false, kAct, kFleet, kShard, kCluster>;
  if (h1 <= 4) return fused_nl_kernel<4, true, kAct, kFleet, kShard, kCluster>;
  if (h1 <= 8) return fused_nl_kernel<8, true, kAct, kFleet, kShard, kCluster>;
  return fused_nl_kernel<kMaxH, true, kAct, kFleet, kShard, kCluster>;
}

template <bool kCluster>
PassKernel pass_kernel_of(int h1, int act) {
  switch (act) {
    case kRelu:
      return pass_kernel_for<kRelu, kCluster>(h1);
    case kTanh:
      return pass_kernel_for<kTanh, kCluster>(h1);
    case kSigmoid:
      return pass_kernel_for<kSigmoid, kCluster>(h1);
    default:
      return pass_kernel_for<kLeaky, kCluster>(h1);
  }
}

// the cluster build where a particle's columns span `ranks` > 1 blocks
PassKernel pass_kernel(int h1, int act, int ranks) {
  return ranks > 1 ? pass_kernel_of<true>(h1, act)
                   : pass_kernel_of<false>(h1, act);
}

RefKernel ref_kernel(int act) {
  switch (act) {
    case kRelu:
      return fused_nl_reference<kRelu>;
    case kTanh:
      return fused_nl_reference<kTanh>;
    case kSigmoid:
      return fused_nl_reference<kSigmoid>;
    default:
      return fused_nl_reference<kLeaky>;
  }
}

// one block, or a cluster of 2, 4 or 8 ranks (the portable sizes), each
// with a column
bool plan_ok(int d, int h1, int n_obs, int ranks, int group, int sub_rows,
             int tile_rows) {
  return (ranks == 1 || ranks == 2 || ranks == 4 || ranks == 8) &&
         d >= ranks && h1 >= 1 && h1 <= kMaxH && n_obs >= 1 && group >= 1 &&
         group <= kGroupMax &&
         2 * group * ((d + ranks - 1) / ranks) <= kThreads && sub_rows >= 4 &&
         sub_rows % 4 == 0 && tile_rows >= 1 && tile_rows <= n_obs &&
         (tile_rows == n_obs || tile_rows % sub_rows == 0) &&
         smem_bytes(d, h1, ranks, group, sub_rows, tile_rows, n_obs) <=
             kMaxSmem;
}

}  // namespace

#if !DIBS_NL_FLEET && !DIBS_NL_SHARD
DIBS_API size_t dibs_fused_nonlinear_smem_bytes(int d, int h1, int ranks,
                                                int group, int sub_rows,
                                                int tile_rows, int n_obs) {
  return smem_bytes(d, h1, ranks, group, sub_rows, tile_rows, n_obs);
}
#endif

// -> dscores [P, d, d], dW1 [P, h1, d, d] (layout of w1), small [P, 2 h1 + 1,
// d] (db1, dW2, db2 rows), before the wrapper's prior terms. `chunk`
// samples per block in groups of `group`; data tiles of `tile_rows` rows
// (all n_obs: resident), u_h staged `sub_rows` rows at a time; the scratch
// holds [P, h1 + 1, N, d] (ref) and [P, S, 4 + (1 + h1) d^2 + (2 h1 + 1) d]
// (part) floats, S = ceil(M / chunk). dibs_fused_nonlinear_fleet (the
// DIBS_NL_FLEET build) takes B_ds = P / `per` datasets' x and w [B_ds, N,
// d] and their keys [B_ds] (device int64); dibs_fused_nonlinear one
// dataset: per = P, keys null, p0 = 0; dibs_fused_nonlinear_shard (the
// DIBS_NL_SHARD build) a particle shard of one dataset, `p0` the particle
// counter of its first particle (its global index). `ranks` blocks a
// particle's work item (the plan: fused_nonlinear_plan): 1 runs the
// kCluster = false build, 2, 4 or 8 the cluster build on clusters of
// `ranks` blocks.
#if DIBS_NL_FLEET
DIBS_API int dibs_fused_nonlinear_fleet(
#elif DIBS_NL_SHARD
DIBS_API int dibs_fused_nonlinear_shard(
#else
DIBS_API int dibs_fused_nonlinear(
#endif
    const float* scores, const float* w1, const float* l1, const float* b1,
    const float* w2, const float* x, const float* w, const int64_t* keys,
    int per, uint32_t p0, const float* eps_soft,
    const float* eps_hard, float* ref, float* part, float* out_ds,
    float* out_dw1, float* out_small, int n_particles, int n_samples, int d,
    int h1, int n_obs, int ranks, int tile_rows, int sub_rows, int group,
    int chunk, int act, uint64_t seed, uint32_t stream_soft, uint32_t stream_hard,
    float alpha, float tau, double inv_var, float inv_varp,
    cudaStream_t stream) {
  if (!plan_ok(d, h1, n_obs, ranks, group, sub_rows, tile_rows) ||
      n_samples < 1 ||
      chunk < 1 || act < kRelu || act > kLeaky || per < 1 ||
      n_particles % per != 0 || (keys != nullptr) != (DIBS_NL_FLEET != 0) ||
      (DIBS_NL_SHARD == 0 && p0 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_particles == 0) return 0;
  const size_t smem =
      smem_bytes(d, h1, ranks, group, sub_rows, tile_rows, n_obs);
  const size_t smem_ref = ref_smem_bytes(d, h1);
  if (smem_ref > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const RefKernel reference = ref_kernel(act);
  cudaError_t err = cudaFuncSetAttribute(
      reference, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_ref));
  if (err != cudaSuccess) return static_cast<int>(err);
  reference<<<n_particles, kThreads, smem_ref, stream>>>(
      scores, w1, b1, w2, x, ref, d, h1, n_obs, per, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Args a;
  a.scores = scores;
  a.w1 = w1;
  a.l1 = l1;
  a.w2 = w2;
  a.x = x;
  a.w = w;
  a.keys = keys;
  a.per = per;
  a.eps_soft = eps_soft;
  a.eps_hard = eps_hard;
  a.ref = ref;
  a.part = part;
  a.n_samples = n_samples;
  a.d = d;
  a.h1 = h1;
  a.n_obs = n_obs;
  a.tile_rows = tile_rows;
  a.sub_rows = sub_rows;
  a.group = group;
  a.chunk = chunk;
  a.n_split = (n_samples + chunk - 1) / chunk;
  a.k0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  a.k1 = static_cast<uint32_t>(seed >> 32);
  a.stream_soft = stream_soft;
  a.stream_hard = stream_hard;
  a.p0 = p0;
  a.alpha = alpha;
  a.tau = tau;
  a.inv_varp = inv_varp;
  a.inv_var = inv_var;
  const PassKernel kernel = pass_kernel(h1, act, ranks);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = ranks;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_particles * ranks, a.n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = dims;
  cfg.numAttrs = ranks > 1 ? 1 : 0;  // one block: no cluster
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_nl_merge<<<n_particles, kThreads, 0, stream>>>(
      part, out_ds, out_dw1, out_small, a.n_split, d, h1);
  return static_cast<int>(cudaGetLastError());
}
