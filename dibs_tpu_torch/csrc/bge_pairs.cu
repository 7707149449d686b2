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
// (__fmul_rn / __fsub_rn: no FMA contraction), 1 / pivot is IEEE division,
// and the log-pivots are summed in float64 in parent order, so the kernel
// and its PyTorch twin, which does the same operations in the same order,
// give the same bits on the card and on the CPU. The BGe score multiplies
// these logdets by ~N/2 and subtracts two such products, so a one-ulp
// difference in a logdet would move a node score by ~1e-4 at N = 100 and
// the REINFORCE weights with it.
//
// Parents only. A non-parent row of the padded A has pivot exactly 1 (log
// adds exactly 0 to the float64 sum), multipliers exactly 0 (x - 0 * y ==
// x) and stays exactly zero off its diagonal through the sweep, because R
// is finite and PD; so eliminating the k x k parent block C = A[Pa, Pa]
// with its border column v[Pa], in increasing parent order with the same
// operations, gives the padded sweep's bits at (k/d)^3 of its work
// (tests/test_torch_bge_compact.py holds a plain parents-only sweep to the
// twin bitwise up to d = 128). Each element's sequence of updates is that
// of the twin, whatever the schedule, so any layout of the work keeps the
// bits.
//
// Fleets (dibs_tpu_torch/fleet.py): r_mats holds one [d, d, d] set a
// dataset, [n_graphs / gpd, d, d, d], and graph b reads the set of its
// dataset b / gpd (gpd = graphs a dataset). Every route resolves R_j
// through node_r; a single dataset is gpd = n_graphs, so its pointers and
// bits are those of the unbatched launch. The dataset lookup is a
// compile-time variant (kFleet) of every route, so that the single-dataset
// kernels compile as they did without it.
//
// Shapes of the work:
//   * d <= 32 (bge_pairs_warp_kernel): one block (4 warps) per graph, its
//     d x d mask staged in shared memory, one warp per (graph, node): the
//     parents by a ballot over the mask's column j; lane c holds column c of
//     C in registers and lane k the border; multipliers and pivots go by
//     shuffles; row loops unrolled to 4, 8, 16 or 32 rows by k. A mask with
//     32 parents at d = 32 (a self-loop on every node of it) has no lane for
//     its border and gives NaN.
//   * 32 < d <= 128, each pair routed by its parent count k (the plan is
//     gpu_kernels.bge_pairs_plan, checked by the launcher):
//     - bge_pairs_bits_kernel, one block per graph, reads the mask once
//       with coalesced loads and writes each node's parent set as four
//       32-bit words (bit r of word w: m[32 w + r, j] != 0), node-major
//       ([j][b], 16 bytes a pair), and a flag for graphs with a mask value
//       other than 0 and 1 (only then are mask values read again);
//     - k <= 15: bge_pairs_warp_route_kernel, the d <= 32 routine
//       (parents_pair) with the parent list from the words;
//     - 16 <= k <= 127: bge_pairs_block_kernel<TR, TC, AR, AC>, one block
//       of TR x TC threads per pair, C and v in registers: thread (ty, tx)
//       holds the AR x AC tile of rows ty + TR a and columns tx + TC b of
//       the parent block placed at the end of a W x W frame (W = TR AR =
//       TC AC, offset o = W - k - 1; the border is column W - 1). Per
//       pivot t the owners of row t and column t publish them to shared
//       memory (double-buffered: one barrier a step), every thread forms
//       its multipliers from the published column and the pivot's IEEE
//       reciprocal and updates its tile. Rows and columns already
//       eliminated stay in the registers as garbage that no later step
//       reads; the unrolled loop over phases of TR pivots updates only the
//       slots that can still be live (a >= phase, b >= phase TR / TC), and
//       enters at the phase of the first pivot, so the work follows k.
//       Five frames: one warp, 4 x 8 threads of 8 x 4 (W = 32) for k <=
//       31 and of 12 x 6 (W = 48) for k <= 47, 8 x 8 of 8 x 8 (W = 64) for
//       k <= 63, 8 x 8 of 12 x 12 (W = 96) for k <= 95, 16 x 16 of 8 x 8
//       (W = 128) above; k = 128 (d = 128 with a self-loop on j) has no
//       border column and gives NaN. Each block takes the next chunk of TR
//       x TC consecutive (node-major) pairs from a counter, keeps those of
//       its k range and eliminates them in turn, so the blocks in flight
//       share a few R_j in L1 and L2 and the work balances whatever the
//       mix of k.
//
// Bound on this card: the sweep is k^3 / 3 dependent multiply-subtracts per
// (graph, node) with k parents, with d^2 mask reads in and two floats out
// per pair. At the marginal step's d = 20 the bytes bound it (2 us), but the
// work is a chain of shuffles, divisions and float64 logs a warp, so the
// kernel is bound by instruction issue and latency; the warp design spends
// no lane-steps on non-parent rows and keeps 32 warps an SM resident. At
// d = 128 with ~30-55 parents a node (config 6 early in a run) the
// operations bound it; separate multiplies and subtractions (no FMA, for
// the twin's bits) put the issue floor at twice the operation bound. The
// block route issues about 50 instructions of publication, buffer
// addresses, barrier and reciprocal a step beside its updates (125 in all
// at the W = 32 frame's first phase), so the wider tiles amortize it over
// more updates; its loads of R_j are all issued before any is used, so a
// pair waits for memory once, not once a slot.
#include "common.h"

namespace {

constexpr int kSmallMaxD = 32;
constexpr int kMaxD = 128;
constexpr int kWarps = 4;  // warps a block of the warp routes
constexpr unsigned kFull = 0xFFFFFFFFu;
// The routes past d = 32, by the parent count k: the warp route, then the
// block route's frames (the largest k of each).
constexpr int kWarpRouteMaxK = 15;
constexpr int kFrame32MaxK = 31;    // 4 x 8 threads of 8 x 4, W = 32
constexpr int kFrame48MaxK = 47;    // 4 x 8 threads of 12 x 6, W = 48
constexpr int kFrame64MaxK = 63;    // 8 x 8 threads of 8 x 8, W = 64
constexpr int kFrame96MaxK = 95;    // 8 x 8 threads of 12 x 12, W = 96
constexpr int kFrame128MaxK = 127;  // 16 x 16 threads of 8 x 8, W = 128
// the kernels: d <= 32, the warp route, the five frames
constexpr int kRoutes = 7;

// R_j of graph b: a fleet's set of b's dataset (gpd graphs a dataset), or
// the one set.
template <bool kFleet>
__device__ __forceinline__ const float* node_r(const float* r_mats,
                                               int64_t b, int gpd, int j,
                                               int d) {
  if constexpr (kFleet) {
    return r_mats + ((b / gpd) * d + j) * static_cast<int64_t>(d) * d;
  } else {
    return r_mats + static_cast<int64_t>(j) * d * d;
  }
}

// ---- the warp routine: one warp per (graph, node), parents only ----------

// Eliminates the k x k parent block (k <= kRows, k < 32) of node j and
// writes its pair. `plist` holds the k parents in increasing order, `mcol`
// the mask values of node j's parents (mcol[q * ld] for node q), `r` = R_j.
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


// ---- d <= 32: one block per graph, the mask staged as floats -------------

template <bool kFleet>
__global__ void __launch_bounds__(kWarps * 32, 8)
    bge_pairs_warp_kernel(const float* __restrict__ r_mats,
                          const float* __restrict__ gs,
                          float* __restrict__ out_pa,
                          float* __restrict__ out_full, int gpd, int d,
                          unsigned long long* __restrict__ parents) {
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
    const float* __restrict__ r = node_r<kFleet>(r_mats, b, gpd, j, d);
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
  if (parents != nullptr) {
    // the block's histogram of k, recounted from the staged mask into the
    // parent lists' memory once every warp is done with it (nothing is
    // held across the loop above), then added to the counter
    __syncthreads();
    int* hist = &lists[0][0];
    for (int k = threadIdx.x; k <= d; k += blockDim.x) hist[k] = 0;
    __syncthreads();
    for (int j = warp; j < d; j += kWarps) {
      const float m = lane < d ? masks[lane * ld + j] : 0.0f;
      const int k = __popc(__ballot_sync(kFull, m != 0.0f));
      if (lane == 0) atomicAdd(hist + k, 1);
    }
    __syncthreads();
    for (int k = threadIdx.x; k <= d; k += blockDim.x) {
      if (hist[k] != 0) {
        atomicAdd(parents + k, static_cast<unsigned long long>(hist[k]));
      }
    }
  }
}

// ---- d > 32: parent sets as bits, then each pair routed by k -------------

// Node j's parent set in graph b: bit r of word w <=> m[32 w + r, j] != 0.
__device__ __forceinline__ int parent_count(uint4 w) {
  return __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
}

// Node q's rank among node j's parents (set w), or -1 if q is none.
__device__ __forceinline__ int parent_rank(uint4 w, int q) {
  const int c = q >> 5;
  const unsigned word = c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w;
  const unsigned bit = 1u << (q & 31);
  if (!(word & bit)) return -1;
  return (c > 0 ? __popc(w.x) : 0) + (c > 1 ? __popc(w.y) : 0) +
         (c > 2 ? __popc(w.z) : 0) + __popc(word & (bit - 1u));
}

__global__ void __launch_bounds__(256)
    bge_pairs_bits_kernel(const float* __restrict__ gs,
                          uint4* __restrict__ words, int* __restrict__ soft,
                          int* __restrict__ counters, int n_graphs, int d,
                          unsigned long long* __restrict__ parents) {
  __shared__ unsigned rows[kMaxD][4];  // bit l of rows[r][c]: m[r, 32c + l]
  __shared__ int hist[kMaxD + 1];  // the block's pairs by parent count k
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.x;
  const float* __restrict__ g = gs + b * d * d;
  if (parents != nullptr) {
    for (int k = threadIdx.x; k <= d; k += blockDim.x) hist[k] = 0;
  }
  int nonbinary = 0;
  for (int r = warp; r < kMaxD; r += 8) {
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = 32 * c + lane;
      v[c] = r < d && q < d ? g[r * d + q] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned bits = __ballot_sync(kFull, v[c] != 0.0f);
      if (lane == 0) rows[r][c] = bits;
      nonbinary |= v[c] != 0.0f && v[c] != 1.0f;
    }
  }
  const int any_soft = __syncthreads_or(nonbinary);
  if (warp < 4) {  // warp c transposes the 32 columns 32c .. 32c + 31
    const int c = warp;
    unsigned mine[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const unsigned row_bits = rows[32 * w + lane][c];
      mine[w] = 0u;
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        const unsigned col = __ballot_sync(kFull, (row_bits >> jj) & 1u);
        if (lane == jj) mine[w] = col;
      }
    }
    const int q = 32 * c + lane;
    if (q < d) {
      words[static_cast<int64_t>(q) * n_graphs + b] =
          make_uint4(mine[0], mine[1], mine[2], mine[3]);
      if (parents != nullptr) {
        atomicAdd(hist + parent_count(
                             make_uint4(mine[0], mine[1], mine[2], mine[3])),
                  1);
      }
    }
  }
  if (parents != nullptr) {  // the block's histogram, added to the counter
    __syncthreads();
    for (int k = threadIdx.x; k <= d; k += blockDim.x) {
      if (hist[k] != 0) {
        atomicAdd(parents + k, static_cast<unsigned long long>(hist[k]));
      }
    }
  }
  if (threadIdx.x == 0) soft[b] = any_soft;
  // the routes' chunk counters, read by the kernels launched after this one
  if (b == 0 && threadIdx.x < kRoutes - 1) counters[threadIdx.x] = 0;
}

struct WarpRouteSmem {
  uint4 words[kWarps * 32];  // their parent sets
  int64_t items[kWarps * 32];  // this chunk's pairs with k <= 15
  float mval[kWarps][kMaxD];  // mask values by node
  int plist[kWarps][32];  // parents in increasing order
  int count;
  int chunk;
};

// k <= 15 past d = 32: a block takes the next chunk of 128 consecutive
// pairs from a counter, lists those with k <= 15 and its 4 warps eliminate
// them in turn.
template <bool kFleet>
__global__ void __launch_bounds__(kWarps * 32, 8)
    bge_pairs_warp_route_kernel(const float* __restrict__ r_mats,
                                const float* __restrict__ gs,
                                const uint4* __restrict__ words,
                                const int* __restrict__ soft,
                                float* __restrict__ out_pa,
                                float* __restrict__ out_full,
                                int* __restrict__ next_chunk, int n_graphs,
                                int gpd, int d) {
  __shared__ WarpRouteSmem sm;
  constexpr int kChunk = kWarps * 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n_items = static_cast<int64_t>(n_graphs) * d;
  for (;;) {
    if (threadIdx.x == 0) {
      sm.count = 0;
      sm.chunk = atomicAdd(next_chunk, 1);
    }
    __syncthreads();
    const int64_t base = static_cast<int64_t>(sm.chunk) * kChunk;
    if (base >= n_items) break;
    const int64_t mine = base + threadIdx.x;
    if (mine < n_items) {
      const uint4 w = words[mine];
      if (parent_count(w) <= kWarpRouteMaxK) {
        const int slot = atomicAdd(&sm.count, 1);
        sm.items[slot] = mine;
        sm.words[slot] = w;
      }
    }
    __syncthreads();
    const int n = sm.count;
    int* plist = sm.plist[warp];
    float* mval = sm.mval[warp];
    for (int e = warp; e < n; e += kWarps) {
      const int64_t item = sm.items[e];
      const int j = static_cast<int>(item / n_graphs);
      const int64_t b = item - static_cast<int64_t>(j) * n_graphs;
      const uint4 w = sm.words[e];
      const int k = parent_count(w);
      const bool sft = soft[b] != 0;
      const int64_t mrow0 = b * d * d + j;  // m[q, j] = gs[mrow0 + q d]
      for (int q = lane; q < d; q += 32) {
        const int rank = parent_rank(w, q);
        if (rank >= 0) {
          plist[rank] = q;
          mval[q] = sft ? gs[mrow0 + static_cast<int64_t>(q) * d] : 1.0f;
        }
      }
      __syncwarp();
      const float* __restrict__ r = node_r<kFleet>(r_mats, b, gpd, j, d);
      float* pa = out_pa + b * d + j;
      float* full = out_full + b * d + j;
      if (k == 0) {
        if (lane == 0) {
          *pa = 0.0f;
          *full = static_cast<float>(log(static_cast<double>(r[j * d + j])));
        }
      } else if (k <= 4) {
        parents_pair<4>(r, plist, mval, 1, d, j, k, lane, pa, full);
      } else if (k <= 8) {
        parents_pair<8>(r, plist, mval, 1, d, j, k, lane, pa, full);
      } else {
        parents_pair<16>(r, plist, mval, 1, d, j, k, lane, pa, full);
      }
      __syncwarp();  // plist is rewritten by the next pair
    }
    __syncthreads();  // the list is rewritten by the next chunk
  }
}

// ---- the block routine: one block per pair, C and v in registers ---------

template <int TR, int TC, int AR, int AC>
struct BlockFrame {
  static constexpr int kThreads = TR * TC;
  static constexpr int kW = TR * AR;  // rows and columns of the frame
  static constexpr int kACP = (AC + 3) / 4 * 4;  // row buffer stride
  static_assert(TR * AR == TC * AC, "square frame");
  static_assert(TC % TR == 0, "column phases follow row phases");
  static_assert(AR % 4 == 0, "16-byte column buffer reads");
};

template <int TR, int TC, int AR, int AC>
struct __align__(16) BlockSmem {
  uint4 words[TR * TC];  // the parent sets of this chunk's pairs
  double lg[TR * AR];  // log-pivots
  float col[2][TR * AR];  // column t of the frame, [ty][a]
  float row[2][TC * BlockFrame<TR, TC, AR, AC>::kACP];  // row t, [tx][b]
  float piv[TR * AR];  // pivots, in parent order
  float ivs[TR * AR];  // their reciprocals
  float vb[TR * AR];  // the border's v[i] at step i
  float mval[TR * AR];  // mask values of the parents
  float inv[2];
  int plist[TR * AR];  // parents in increasing order
  int64_t items[TR * TC];  // this chunk's pairs of the block's k range
  int count;
  int chunk;
};

// One pivot step t (in phase P: t in [P TR, P TR + TR)): the owners of row t
// and column t publish them, then every thread updates its live slots.
template <int TR, int TC, int AR, int AC, int P>
__device__ __forceinline__ void block_step(BlockSmem<TR, TC, AR, AC>& sm,
                                           float (&c)[AR][AC], int t, int o,
                                           int tx, int ty) {
  constexpr int kACP = BlockFrame<TR, TC, AR, AC>::kACP;
  constexpr int BM = P * TR / TC;  // the first column slot still live
  const int buf = t & 1;
  const int ts_r = t - P * TR;  // ty of row t's owners
  const int ts_c = t - BM * TC;  // tx of column t's owners
  if (tx == ts_c) {
#pragma unroll
    for (int g = P / 4; g < AR / 4; ++g) {
      reinterpret_cast<float4*>(&sm.col[buf][ty * AR])[g] = make_float4(
          c[4 * g][BM], c[4 * g + 1][BM], c[4 * g + 2][BM], c[4 * g + 3][BM]);
    }
  }
  if (ty == ts_r) {
#pragma unroll
    for (int g = BM / 4; g < kACP / 4; ++g) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = 4 * g + e < AC ? c[P][min(4 * g + e, AC - 1)] : 0.0f;
      }
      reinterpret_cast<float4*>(&sm.row[buf][tx * kACP])[g] =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    if (tx == ts_c) {
      const float pivot = c[P][BM];
      const float inv = 1.0f / pivot;
      sm.inv[buf] = inv;
      sm.piv[t - o] = pivot;
      sm.ivs[t - o] = inv;
    }
    if (tx == TC - 1) sm.vb[t - o] = c[P][AC - 1];
  }
  __syncthreads();
  const float inv = sm.inv[buf];
  float cv[AR], rv[kACP];
#pragma unroll
  for (int g = P / 4; g < AR / 4; ++g) {
    const float4 v = reinterpret_cast<const float4*>(&sm.col[buf][ty * AR])[g];
    cv[4 * g] = v.x;
    cv[4 * g + 1] = v.y;
    cv[4 * g + 2] = v.z;
    cv[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int g = BM / 4; g < kACP / 4; ++g) {
    const float4 v = reinterpret_cast<const float4*>(&sm.row[buf][tx * kACP])[g];
    rv[4 * g] = v.x;
    rv[4 * g + 1] = v.y;
    rv[4 * g + 2] = v.z;
    rv[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int a = P; a < AR; ++a) {
    const float f = __fmul_rn(cv[a], inv);
#pragma unroll
    for (int bb = BM; bb < AC; ++bb) {
      c[a][bb] = __fsub_rn(c[a][bb], __fmul_rn(f, rv[bb]));
    }
  }
}

// Blocks an SM the launch bounds ask for: a register budget of the tile,
// the published column and row and ~40 more a thread.
constexpr int frame_min_blocks(int threads, int ar, int ac) {
  return 65536 / (threads * ((ar * ac + ar + (ac + 3) / 4 * 4 + 47) / 8 * 8));
}

template <int TR, int TC, int AR, int AC, int P>
__device__ __forceinline__ void block_phases(BlockSmem<TR, TC, AR, AC>& sm,
                                             float (&c)[AR][AC], int& t,
                                             int o, int tx, int ty) {
  if constexpr (P < AR) {
    constexpr int W = TR * AR;
    if (t < (P + 1) * TR) {  // the sweep has reached this phase
      const int t_hi = min((P + 1) * TR, W - 1);
      for (; t < t_hi; ++t) block_step<TR, TC, AR, AC, P>(sm, c, t, o, tx, ty);
    }
    block_phases<TR, TC, AR, AC, P + 1>(sm, c, t, o, tx, ty);
  }
}

template <int TR, int TC, int AR, int AC, bool kFleet>
__global__ void __launch_bounds__(TR * TC, frame_min_blocks(TR * TC, AR, AC))
    bge_pairs_block_kernel(const float* __restrict__ r_mats,
                           const float* __restrict__ gs,
                           const uint4* __restrict__ words,
                           const int* __restrict__ soft,
                           float* __restrict__ out_pa,
                           float* __restrict__ out_full,
                           int* __restrict__ next_chunk, int n_graphs,
                           int gpd, int d, int k_lo, int k_hi) {
  constexpr int NT = TR * TC;
  constexpr int W = TR * AR;
  __shared__ BlockSmem<TR, TC, AR, AC> sm;
  const int tid = threadIdx.x;
  const int tx = tid % TC;
  const int ty = tid / TC;
  const int64_t n_items = static_cast<int64_t>(n_graphs) * d;
  for (;;) {
    if (tid == 0) {
      sm.count = 0;
      sm.chunk = atomicAdd(next_chunk, 1);
    }
    __syncthreads();
    const int64_t base = static_cast<int64_t>(sm.chunk) * NT;
    if (base >= n_items) break;
    const int64_t mine = base + tid;
    if (mine < n_items) {
      const uint4 w = words[mine];
      const int k = parent_count(w);
      if (k >= k_lo && k <= k_hi) {
        const int slot = atomicAdd(&sm.count, 1);
        sm.items[slot] = mine;
        sm.words[slot] = w;
      }
    }
    __syncthreads();
    const int n = sm.count;
    for (int e = 0; e < n; ++e) {
      const int64_t item = sm.items[e];
      const int j = static_cast<int>(item / n_graphs);
      const int64_t b = item - static_cast<int64_t>(j) * n_graphs;
      const uint4 w = sm.words[e];
      const int k = parent_count(w);
      float* pa = out_pa + b * d + j;
      float* full = out_full + b * d + j;
      if (k >= W) {  // no column for the border: see the note above
        if (tid == 0) *pa = *full = __int_as_float(0x7fc00000);  // NaN
        continue;
      }
      const bool sft = soft[b] != 0;
      const int64_t mrow0 = b * d * d + j;
      for (int q = tid; q < d; q += NT) {
        const int rank = parent_rank(w, q);
        if (rank >= 0) {
          sm.plist[rank] = q;
          sm.mval[rank] = sft ? gs[mrow0 + static_cast<int64_t>(q) * d] : 1.0f;
        }
      }
      __syncthreads();
      const float* __restrict__ r = node_r<kFleet>(r_mats, b, gpd, j, d);
      const int o = W - (k + 1);  // frame index of parent 0
      // the tile: C[ri][ci] = A[Pa[ri], Pa[ci]], column k the border
      int qc[AC];
      float mc[AC];
#pragma unroll
      for (int bb = 0; bb < AC; ++bb) {
        const int ci = tx + TC * bb - o;
        const bool in = ci >= 0 && ci < k;
        qc[bb] = in ? sm.plist[ci] : j;
        mc[bb] = in ? sm.mval[ci] : 0.0f;
      }
      // every slot's load is issued before any is used (one memory latency
      // a pair, not one a slot); padding slots read R_j[j, q] or R_j[j, j],
      // valid addresses, and are zeroed below
      int prow[AR];
      float c[AR][AC];
#pragma unroll
      for (int a = 0; a < AR; ++a) {
        const int ri = ty + TR * a - o;
        prow[a] = ri >= 0 && ri < k ? sm.plist[ri] : j;
#pragma unroll
        for (int bb = 0; bb < AC; ++bb) {
          c[a][bb] = TR * (a + 1) > o && TC * (bb + 1) > o
                         ? __ldg(r + prow[a] * d + qc[bb])
                         : 0.0f;
        }
      }
      // C = A[Pa, Pa] and the border; 0/1 masks have mm = 1, so the
      // entries are R + 0 and the border R, the general form's bits
#pragma unroll
      for (int a = 0; a < AR; ++a) {
        const int ri = ty + TR * a - o;
        const bool rin = ri >= 0 && ri < k;
        const float mr = rin ? sm.mval[ri] : 0.0f;
#pragma unroll
        for (int bb = 0; bb < AC; ++bb) {
          const int ci = tx + TC * bb - o;
          const float rv = c[a][bb];
          float v = 0.0f;
          if (rin && ci >= 0 && ci <= k) {
            if (ci == k) {
              v = sft ? __fmul_rn(rv, mr) : rv;
            } else if (!sft) {
              v = __fadd_rn(rv, 0.0f);
            } else {
              const float mm = __fmul_rn(mr, mc[bb]);
              v = __fadd_rn(__fmul_rn(rv, mm),
                            ri == ci ? __fsub_rn(1.0f, mm) : 0.0f);
            }
          }
          c[a][bb] = v;
        }
      }
      int t = o;
      block_phases<TR, TC, AR, AC, 0>(sm, c, t, o, tx, ty);
      // log-pivots in parallel, then the float64 sum and the border's
      // Schur chain in parent order
      for (int i = tid; i < k; i += NT) {
        sm.lg[i] = log(static_cast<double>(sm.piv[i]));
      }
      __syncthreads();
      if (tid == 0) {
        double acc = 0.0;
        float s = __ldg(r + j * d + j);
        for (int i0 = 0; i0 < k; i0 += 8) {  // loads batched ahead of the
          double lg[8];                      // two dependent chains
          float vi[8], iv[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = min(i0 + e, k - 1);
            lg[e] = sm.lg[i];
            vi[e] = sm.vb[i];
            iv[e] = sm.ivs[i];
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (i0 + e < k) {
              acc += lg[e];
              s = __fsub_rn(s, __fmul_rn(__fmul_rn(vi[e], vi[e]), iv[e]));
            }
          }
        }
        *pa = static_cast<float>(acc);
        *full = static_cast<float>(acc + log(static_cast<double>(s)));
      }
    }
    __syncthreads();  // the list is rewritten by the next chunk
  }
}

using Frame32 = BlockSmem<4, 8, 8, 4>;
using Frame48 = BlockSmem<4, 8, 12, 6>;
using Frame64 = BlockSmem<8, 8, 8, 8>;
using Frame96 = BlockSmem<8, 8, 12, 12>;
using Frame128 = BlockSmem<16, 16, 8, 8>;
constexpr int kSmallSmem = sizeof(float) * kSmallMaxD * (kSmallMaxD + 1) +
                           sizeof(int) * kWarps * 32;

// Threads and shared bytes a block of each route: the d <= 32 kernel, the
// warp route, the five frames (gpu_kernels.bge_pairs_plan names the same).
constexpr int kPlan[kRoutes][2] = {{kWarps * 32, kSmallSmem},
                             {kWarps * 32, sizeof(WarpRouteSmem)},
                             {32, sizeof(Frame32)},
                             {32, sizeof(Frame48)},
                             {64, sizeof(Frame64)},
                             {64, sizeof(Frame96)},
                             {256, sizeof(Frame128)}};

// Blocks of each route: one per chunk of pairs, at most as many as an SM
// can hold (32) on every SM. The blocks take chunks from a counter, so the
// ones the card cannot hold at once start when others are done, find the
// chunks taken, and return.
int route_grid(int threads, int64_t items, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t chunks = (items + threads - 1) / threads;
  const int64_t most = static_cast<int64_t>(sms) * 32;
  *grid = static_cast<int>(chunks < most ? chunks : most);
  return 0;
}

template <typename Kernel, typename... Args>
int launch_route(Kernel kernel, int threads, int64_t items,
                 cudaStream_t stream, Args... args) {
  int grid = 0;
  const int rc = route_grid(threads, items, &grid);
  if (rc != 0) return rc;
  kernel<<<grid, threads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Every route of one launch; kFleet: graphs read their dataset's R_j.
template <bool kFleet>
int launch_routes(const float* r_mats, const float* gs, float* out_pa,
                  float* out_full, void* words, int* soft, int* counters,
                  int n_graphs, int gpd, int d, cudaStream_t stream,
                  unsigned long long* parents) {
  if (d <= kSmallMaxD) {
    bge_pairs_warp_kernel<kFleet><<<n_graphs, kWarps * 32, 0, stream>>>(
        r_mats, gs, out_pa, out_full, gpd, d, parents);
    return static_cast<int>(cudaGetLastError());
  }
  uint4* w = static_cast<uint4*>(words);
  bge_pairs_bits_kernel<<<n_graphs, 256, 0, stream>>>(gs, w, soft, counters,
                                                      n_graphs, d, parents);
  int rc = static_cast<int>(cudaGetLastError());
  const int64_t items = static_cast<int64_t>(n_graphs) * d;
  if (rc == 0) {
    rc = launch_route(bge_pairs_warp_route_kernel<kFleet>, kWarps * 32,
                      items, stream, r_mats, gs, w, soft, out_pa, out_full,
                      counters, n_graphs, gpd, d);
  }
  // the frames, by k: [k_lo, k_hi] each
  if (rc == 0) {
    rc = launch_route(bge_pairs_block_kernel<4, 8, 8, 4, kFleet>, 32, items,
                      stream, r_mats, gs, w, soft, out_pa, out_full,
                      counters + 1, n_graphs, gpd, d, kWarpRouteMaxK + 1,
                      kFrame32MaxK);
  }
  if (rc == 0) {
    rc = launch_route(bge_pairs_block_kernel<4, 8, 12, 6, kFleet>, 32, items,
                      stream, r_mats, gs, w, soft, out_pa, out_full,
                      counters + 2, n_graphs, gpd, d, kFrame32MaxK + 1,
                      kFrame48MaxK);
  }
  if (rc == 0) {
    rc = launch_route(bge_pairs_block_kernel<8, 8, 8, 8, kFleet>, 64, items,
                      stream, r_mats, gs, w, soft, out_pa, out_full,
                      counters + 3, n_graphs, gpd, d, kFrame48MaxK + 1,
                      kFrame64MaxK);
  }
  if (rc == 0) {
    rc = launch_route(bge_pairs_block_kernel<8, 8, 12, 12, kFleet>, 64,
                      items, stream, r_mats, gs, w, soft, out_pa, out_full,
                      counters + 4, n_graphs, gpd, d, kFrame64MaxK + 1,
                      kFrame96MaxK);
  }
  if (rc == 0) {
    rc = launch_route(bge_pairs_block_kernel<16, 16, 8, 8, kFleet>, 256,
                      items, stream, r_mats, gs, w, soft, out_pa, out_full,
                      counters + 5, n_graphs, gpd, d, kFrame96MaxK + 1,
                      kMaxD);
  }
  return rc;
}

}  // namespace

// Shared bytes a block of the route serving (d, k) uses (-1 where no route
// serves it); the tests hold gpu_kernels.bge_pairs_plan to it.
DIBS_API int dibs_bge_pairs_smem_bytes(int d, int k) {
  if (d < 2 || d > kMaxD || k < 0 || k > d) return -1;
  if (d <= kSmallMaxD) return k < 32 ? kPlan[0][1] : -1;
  if (k <= kWarpRouteMaxK) return kPlan[1][1];
  if (k <= kFrame32MaxK) return kPlan[2][1];
  if (k <= kFrame48MaxK) return kPlan[3][1];
  if (k <= kFrame64MaxK) return kPlan[4][1];
  if (k <= kFrame96MaxK) return kPlan[5][1];
  if (k <= kFrame128MaxK) return kPlan[6][1];
  return -1;
}

// `plan`: threads and shared bytes a block of each route the wrapper
// planned, in the order of kPlan; any other plan is refused. Past d = 32,
// `words` ([d][n_graphs] x 16 bytes), `soft` ([n_graphs]) and `counters`
// ([kRoutes] ints, zeroed by the bits pass) are the wrapper's scratch.
// `gpd`: graphs a dataset (r_mats is [n_graphs / gpd, d, d, d]); n_graphs
// for one dataset. `parents`: null, or a [d + 1] counter to which each
// (graph, node) pair adds 1 at its parent count k (the kernel that reads
// the pair's parent set counts it: one shared histogram a block).
DIBS_API int dibs_bge_pairs(const float* r_mats, const float* gs,
                            float* out_pa, float* out_full, void* words,
                            int* soft, int* counters, int n_graphs, int gpd,
                            int d, const int* plan, cudaStream_t stream,
                            unsigned long long* parents) {
  if (d < 2 || d > kMaxD || gpd < 1 || n_graphs % gpd != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < kRoutes; ++i) {
    if (plan[2 * i] != kPlan[i][0] || plan[2 * i + 1] != kPlan[i][1]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (n_graphs == 0) return 0;
  return gpd < n_graphs
             ? launch_routes<true>(r_mats, gs, out_pa, out_full, words, soft,
                                   counters, n_graphs, gpd, d, stream,
                                   parents)
             : launch_routes<false>(r_mats, gs, out_pa, out_full, words,
                                    soft, counters, n_graphs, gpd, d, stream,
                                    parents);
}
