// Squared-exponential kernel matrix K[a, b] = scale * exp(-||x_a - y_b||^2 / h).
//
// Replaces dibs_tpu/ops/pallas_kernels.py::fused_se_matrix (body
// _se_kernel_body). x is [A, n], y is [B, n], both row-major float32.
//
// Difference form. The TPU kernel accumulated the Gram form
// ||x||^2 + ||y||^2 - 2 x.y, which cancels for nearby particles
// (pallas_kernels.py:92-95). Here every feature costs one FSUB and one FFMA
// per output, with no cancellation: a self-distance is exactly 0, the
// diagonal of K(x, x) is exactly `scale`, and (x_a - x_b)^2 == (x_b - x_a)^2
// summed in the same order makes K(x, x) exactly symmetric.
//
// What bounds it on the H100: the FP32 pipes. Two FP32 instructions per
// (a, b, feature), 2 A B n in all, against 128 lanes per SM per clock; at
// config 5 (A = B = 1000, n = 32,768) that is 65.5 G instructions, 1.96 ms
// for the full matrix at the 1.98 GHz boost clock (the 3 A B n flops at
// 67 TFLOP/s give 1.47 ms), and the operands (131 MB) are 0.04 ms of HBM.
// The first design (one output per thread, two 4-byte shared loads per
// FSUB + FFMA) was bound by shared-memory issue at 7.6x that.
//
// The design:
// - Register tile: 256 threads, each owning kTm x kTm outputs. Per feature a
//   thread reads its kTm x-values and kTm y-values with float4 (or float2)
//   shared loads and does kTm^2 FSUB + FFMA: at kTm = 8 that is 128 FP32
//   instructions per four 16-byte loads, so the FP32 pipes, not shared
//   memory, are the limit. A 128 x 128 block tile (kTm = 8, 8 features a
//   stage) serves the large calls; a 32 x 32 tile (kTm = 2, 32 features a
//   stage) the d = 20 ones ([30, 30] over 800), where a 128-row tile would
//   be 95% padding and the time is the latency of the feature loop.
// - Copies overlap the math: two shared stages; the next stage's operands
//   are fetched into registers (one float4 per thread and operand, 16-byte
//   global loads in the aligned instantiation, four scalar loads in the
//   other) before the current stage's FFMAs, and stored transposed
//   (feature-major, rows padded by 4 floats so the stores hit distinct
//   banks) after them; one barrier per stage.
// - Symmetric calls (the caller passes the same matrix as x and y) launch
//   only the tiles with row tile <= column tile and write each off-diagonal
//   value to both places.
// - A split over features fills the card when the tiles alone do not (at
//   P = 1000 the triangle has 36 tiles of 128): block (tile, slice) writes
//   its float32 partial sums to scratch [S, A, B]; a second launch adds the
//   S slices in a fixed order (no atomics: bitwise reproducible), applies
//   scale * exp(-acc / h), mirrors, and writes the diagonal as `scale`.
//   With S = 1 that epilogue is fused into the first launch. The wrapper
//   (gpu_kernels.se_matrix) chooses the tile, S and the instantiation.
// - Fleets (dibs_tpu_torch/fleet.py): `batch` independent matrices, x
//   [batch, A, n], y [batch, B, n], out [batch, A, B] (scratch [batch, S,
//   A, B]), one a gridDim.y slice. Each dataset's blocks do exactly the
//   work of an unbatched launch on its operands, with the tile and S the
//   wrapper chose for one dataset's shape, so each matrix has the bits of
//   that launch. The dataset offsets are a compile-time variant (kBatched)
//   of the tile kernel: in the single-matrix kernels they cost 5-9
//   registers and, at the 128 tile, 48 bytes of spills.
#include "common.h"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kRed = 32;       // the reduction's output tile

// Tile index t -> (row tile ta, column tile tb). Symmetric calls enumerate
// the upper triangle column by column, t = tb (tb + 1) / 2 + ta with
// ta <= tb; the others go row-major over `tiles_b` columns. Mirrored in
// Python by gpu_kernels.se_tile_of.
__device__ __forceinline__ void tile_of(int t, int sym, int tiles_b, int& ta,
                                        int& tb) {
  if (sym) {
    int c = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
    while (c > 0 && c * (c + 1) / 2 > t) --c;
    while ((c + 1) * (c + 2) / 2 <= t) ++c;
    tb = c;
    ta = t - c * (c + 1) / 2;
  } else {
    ta = t / tiles_b;
    tb = t - ta * tiles_b;
  }
}

// Four consecutive features of one row from k (zeros past k_end or for a
// row outside the matrix). kVec: one 16-byte load (the row and k are
// 16-byte aligned and k_end is a multiple of 4).
template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ row,
                                            int k, int k_end) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row == nullptr) return v;
  if constexpr (kVec) {
    if (k < k_end) v = __ldg(reinterpret_cast<const float4*>(row + k));
  } else {
    if (k < k_end) v.x = __ldg(row + k);
    if (k + 1 < k_end) v.y = __ldg(row + k + 1);
    if (k + 2 < k_end) v.z = __ldg(row + k + 2);
    if (k + 3 < k_end) v.w = __ldg(row + k + 3);
  }
  return v;
}

// Output row (or column) of register r of thread index idx: groups of kV
// consecutive rows, 16 kV apart.
template <int kV>
__device__ __forceinline__ int frag_index(int idx, int r) {
  return (r / kV) * 16 * kV + idx * kV + (r % kV);
}

template <int kTm, int kV>
__device__ __forceinline__ void load_frag(const float* row, int idx,
                                          float (&f)[kTm]) {
#pragma unroll
  for (int g = 0; g < kTm / kV; ++g) {
    const float* p = row + g * 16 * kV + idx * kV;
    if constexpr (kV == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      f[4 * g] = q.x;
      f[4 * g + 1] = q.y;
      f[4 * g + 2] = q.z;
      f[4 * g + 3] = q.w;
    } else {
      const float2 q = *reinterpret_cast<const float2*>(p);
      f[2 * g] = q.x;
      f[2 * g + 1] = q.y;
    }
  }
}

template <int kTm, int kBk, bool kVec, bool kBatched>
__global__ void __launch_bounds__(kThreads, 2)
    se_matrix_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     float* __restrict__ out, float* __restrict__ part, int a,
                     int b, int n, int slice, int tiles, int tiles_b, int sym,
                     float h, float scale) {
  constexpr int kTile = 16 * kTm;
  constexpr int kV = kTm < 4 ? kTm : 4;
  constexpr int kLd = kTile + 4;
  constexpr int kQuads = kBk / 4;  // float4 loads per tile row and stage
  static_assert(kTile * kQuads == kThreads,
                "one float4 per thread and operand per stage");
  __shared__ __align__(16) float xs[2][kBk][kLd];
  __shared__ __align__(16) float ys[2][kBk][kLd];

  if constexpr (kBatched) {  // this block's dataset
    const int64_t ds = blockIdx.y;
    x += ds * a * n;
    y += ds * b * n;
    if (part != nullptr) part += ds * (gridDim.x / tiles) * a * b;
    if (out != nullptr) out += ds * a * b;
  }
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int t = blockIdx.x % tiles;
  const int s = blockIdx.x / tiles;
  int ta, tb;
  tile_of(t, sym, tiles_b, ta, tb);
  const int a0 = ta * kTile;
  const int b0 = tb * kTile;
  const int k_begin = s * slice;
  const int k_end = min(n, k_begin + slice);
  const int stages = k_end > k_begin ? (k_end - k_begin + kBk - 1) / kBk : 0;

  // loader role: tile row lr, features lq..lq+3 of each stage
  const int lr = tid / kQuads;
  const int lq = (tid % kQuads) * 4;
  const float* xrow =
      a0 + lr < a ? x + static_cast<int64_t>(a0 + lr) * n : nullptr;
  const float* yrow =
      b0 + lr < b ? y + static_cast<int64_t>(b0 + lr) * n : nullptr;

  float acc[kTm][kTm];
#pragma unroll
  for (int r = 0; r < kTm; ++r) {
#pragma unroll
    for (int q = 0; q < kTm; ++q) acc[r][q] = 0.0f;
  }

  float4 px = load_quad<kVec>(xrow, k_begin + lq, k_end);
  float4 py = load_quad<kVec>(yrow, k_begin + lq, k_end);
  xs[0][lq][lr] = px.x;
  xs[0][lq + 1][lr] = px.y;
  xs[0][lq + 2][lr] = px.z;
  xs[0][lq + 3][lr] = px.w;
  ys[0][lq][lr] = py.x;
  ys[0][lq + 1][lr] = py.y;
  ys[0][lq + 2][lr] = py.z;
  ys[0][lq + 3][lr] = py.w;
  __syncthreads();

  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    const bool more = st + 1 < stages;
    if (more) {  // next stage's operands, in flight during the math
      const int k = k_begin + (st + 1) * kBk + lq;
      px = load_quad<kVec>(xrow, k, k_end);
      py = load_quad<kVec>(yrow, k, k_end);
    }
#pragma unroll
    for (int k = 0; k < kBk; ++k) {
      float xa[kTm], yb[kTm];
      load_frag<kTm, kV>(&xs[buf][k][0], ty, xa);
      load_frag<kTm, kV>(&ys[buf][k][0], tx, yb);
#pragma unroll
      for (int r = 0; r < kTm; ++r) {
#pragma unroll
        for (int q = 0; q < kTm; ++q) {
          const float d = xa[r] - yb[q];
          acc[r][q] = fmaf(d, d, acc[r][q]);
        }
      }
    }
    if (more) {
      const int nb = buf ^ 1;
      xs[nb][lq][lr] = px.x;
      xs[nb][lq + 1][lr] = px.y;
      xs[nb][lq + 2][lr] = px.z;
      xs[nb][lq + 3][lr] = px.w;
      ys[nb][lq][lr] = py.x;
      ys[nb][lq + 1][lr] = py.y;
      ys[nb][lq + 2][lr] = py.z;
      ys[nb][lq + 3][lr] = py.w;
    }
    __syncthreads();  // one barrier a stage: stores visible, reads done
  }

  float* plane = part == nullptr
                     ? nullptr
                     : part + static_cast<int64_t>(s) * a * b;
#pragma unroll
  for (int r = 0; r < kTm; ++r) {
    const int i = a0 + frag_index<kV>(ty, r);
    if (i >= a) continue;
#pragma unroll
    for (int q = 0; q < kTm; ++q) {
      const int j = b0 + frag_index<kV>(tx, q);
      if (j >= b) continue;
      const int64_t off = static_cast<int64_t>(i) * b + j;
      if (plane != nullptr) {
        plane[off] = acc[r][q];
      } else {
        const float val =
            (sym && i == j) ? scale : scale * expf(-acc[r][q] / h);
        out[off] = val;
        if (sym && ta != tb) out[static_cast<int64_t>(j) * b + i] = val;
      }
    }
  }
}

// Sums the S partial planes of one 32 x 32 output tile in slice order,
// applies the exp epilogue, and (symmetric, off-diagonal tiles) writes the
// mirrored tile through shared memory so both stores are coalesced.
__global__ void __launch_bounds__(kRed * 8)
    se_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int a, int b, int splits, int tiles_b, int sym, float h,
                     float scale) {
  __shared__ float tile[kRed][kRed + 1];
  int ta, tb;
  tile_of(blockIdx.x, sym, tiles_b, ta, tb);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t plane = static_cast<int64_t>(a) * b;
  part += static_cast<int64_t>(blockIdx.y) * splits * plane;  // the dataset
  out += static_cast<int64_t>(blockIdx.y) * plane;
#pragma unroll
  for (int rr = 0; rr < kRed / 8; ++rr) {
    const int r = ty + 8 * rr;
    const int i = ta * kRed + r;
    const int j = tb * kRed + tx;
    float val = 0.0f;
    if (i < a && j < b) {
      const int64_t off = static_cast<int64_t>(i) * b + j;
      float acc = 0.0f;
      for (int s = 0; s < splits; ++s) acc += part[s * plane + off];
      val = (sym && i == j) ? scale : scale * expf(-acc / h);
      out[off] = val;
    }
    tile[r][tx] = val;
  }
  if (sym && ta != tb) {
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRed / 8; ++rr) {
      const int r = ty + 8 * rr;
      const int i = tb * kRed + r;
      const int j = ta * kRed + tx;
      if (i < a && j < b) out[static_cast<int64_t>(i) * b + j] = tile[tx][r];
    }
  }
}

int tile_count(int a, int b, int tile, int sym) {
  const int ta = (a + tile - 1) / tile;
  const int tb = (b + tile - 1) / tile;
  return sym ? ta * (ta + 1) / 2 : ta * tb;
}

template <int kTm, int kBk>
cudaError_t launch_tiles(const float* x, const float* y, float* out,
                         float* part, int batch, int a, int b, int n,
                         int splits, int sym, int vec, float h, float scale,
                         cudaStream_t stream) {
  constexpr int kTile = 16 * kTm;
  const int tiles = tile_count(a, b, kTile, sym);
  const int tiles_b = (b + kTile - 1) / kTile;
  const int per = (n + splits - 1) / splits;
  const int slice = n == 0 ? kBk : (per + kBk - 1) / kBk * kBk;
  const int64_t blocks = static_cast<int64_t>(tiles) * splits;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  float* o = splits > 1 ? nullptr : out;
  float* p = splits > 1 ? part : nullptr;
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  auto kernel = vec ? (batch > 1 ? se_matrix_kernel<kTm, kBk, true, true>
                                 : se_matrix_kernel<kTm, kBk, true, false>)
                    : (batch > 1 ? se_matrix_kernel<kTm, kBk, false, true>
                                 : se_matrix_kernel<kTm, kBk, false, false>);
  kernel<<<grid, kThreads, 0, stream>>>(x, y, o, p, a, b, n, slice, tiles,
                                        tiles_b, sym, h, scale);
  return cudaGetLastError();
}

}  // namespace

// K [batch, A, B] from x [batch, A, n] and y [batch, B, n] (batch = 1: one
// matrix). tile: 128 or 32 (output rows and columns per block). splits:
// feature slices S; S > 1 needs the scratch part [batch, S, A, B] and adds
// the reduction launch. sym: x and y are the same matrices (A == B); only
// the upper tiles are computed. vec: n % 4 == 0 and x, y 16-byte aligned
// (16-byte loads); otherwise scalar loads.
DIBS_API int dibs_se_matrix(const float* x, const float* y, float* out,
                            float* part, int batch, int a, int b, int n,
                            int tile, int splits, int sym, int vec, float h,
                            float scale, cudaStream_t stream) {
  if (batch < 0 || batch > 65535 || a < 0 || b < 0 || n < 0 || splits < 1 ||
      (tile != 128 && tile != 32) || (splits > 1 && part == nullptr) ||
      (sym && (a != b || x != y)) || (vec && n % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || a == 0 || b == 0) return 0;
  cudaError_t err =
      tile == 128 ? launch_tiles<8, 8>(x, y, out, part, batch, a, b, n,
                                       splits, sym, vec, h, scale, stream)
                  : launch_tiles<2, 32>(x, y, out, part, batch, a, b, n,
                                        splits, sym, vec, h, scale, stream);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int tiles = tile_count(a, b, kRed, sym);
  se_reduce_kernel<<<dim3(tiles, batch), dim3(kRed, 8), 0, stream>>>(
      part, out, a, b, splits, (b + kRed - 1) / kRed, sym, h, scale);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the tile-`tile` kernel that the current device holds at once
// (SMs x resident blocks per SM): the wave size the split is chosen for.
DIBS_API int dibs_se_matrix_slots(int tile, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = tile == 128
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, se_matrix_kernel<8, 8, true, false>, kThreads,
                    0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, se_matrix_kernel<2, 32, true, false>,
                    kThreads, 0);
  }
  *slots = sms * per_sm;
  return static_cast<int>(err);
}
