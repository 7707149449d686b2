// Gumbel graph sampler: hard (Gumbel-max) and soft (Gumbel-softmax) modes.
//
// Replaces dibs_tpu/ops/pallas_kernels.py::gumbel_soft_graphs_pallas (body
// _make_gumbel_kernel). For scores [B, d, d] it writes [B, M, d, d]:
//   soft: sigmoid(tau * (eps + alpha * s)),   hard: 1[eps + alpha * s > 0],
// with a zero diagonal and eps ~ Logistic(0, 1).
//
// Bound on this card: instruction issue, not bytes. At config 5's soft
// shape [1000, 8, 128, 128] the output is 524 MB (0.16 ms at 3.35 TB/s),
// but every element of every sample takes one Philox4x32-10 draw (ten
// rounds of two 32 x 32 -> 64-bit products), about 130 M draws. The TPU
// kernel kept the noise out of device memory with the hardware PRNG; here
// the hand-written Philox of common.h does the same, and the design keeps
// everything else off the issue slots:
//   * a thread owns `kVec` adjacent elements (4 where d * d % 4 == 0, with
//     16-byte loads and stores; else 1) of one particle's d x d block and
//     loops over a group of samples. The particle and the element come from
//     one 32-bit division a thread; the diagonal test is e % (d + 1) == 0.
//     No 64-bit division anywhere.
//   * the score is read once and alpha * s formed once an element; the soft
//     fast form below takes its exp once an element too. Only the Philox
//     draw and the fast form's one division are per sample.
//   * the kVec draws of a thread are independent chains, so the scheduler
//     has ILP across them; the round keys are uniform across the grid.
// The wrapper (gpu_kernels.gumbel_plan) picks kVec, the block size and the
// samples a thread so that small batches (the marginal step's [30, 128, 20,
// 20]) still fill the card: the samples are split over gridDim.y.
//
// Noise contract (unchanged, bit for bit): the uniform u of element e,
// sample m, particle b on `stream` is dibs::philox_uniform (word 0 of
// Philox4x32-10 at counter (e, m, b, stream), key = the 64-bit seed; top 24
// bits, half-ulp offset, clamp at 1 - 2^-23), which the PyTorch twin
// (gpu_kernels.philox_uniform) reproduces exactly. Three forms use it:
//   * hard, and soft with tau != 1: eps = log(u) - log1p(-u), then the
//     formulas above, as the twin computes them;
//   * soft with tau = 1 (the engine's setting): the fast form
//     g = u / (u + (1 - u) exp(-alpha s)), which is sigmoid(eps + alpha s)
//     without the two logs and with one division. 1 - u is exact for
//     u >= 1/2, so every step has a small relative error and g is within a
//     few float32 ulps of the twin's log form. (Kernel #9's form
//     1 / (1 + (1/u - 1) exp(-alpha s)) cancels in 1/u - 1 for u near 1 and
//     is 2e-5 off there, past this kernel's 1e-5 bar.) The clamp keeps
//     1 - u > 0, so where exp(-alpha s) overflows g is
//     u / inf = 0, never 0 * inf (alpha s < -88.72; the twin's log form
//     gives below 1e-30 there).
// With `eps` non-null the kernel reads the injected noise [B, M, d, d]
// instead (the debug_noise convention of fused_linear.py) in the log form,
// which makes exact comparison with the reference possible.
//
// Fleets (dibs_tpu_torch/fleet.py): the batch is B_ds datasets of `per`
// particles each, and `keys` ([B_ds] int64 on the device) holds one key a
// dataset. Particle b then draws with the key of its dataset b / per and
// the particle counter b % per, its index within the dataset, so dataset i
// of a fleet gets the noise of a single run keyed keys[i]. With `keys` null
// the key is `seed` and the counter b, as before. The fleet's indexing is a
// compile-time variant (kFleet), so that the single-run kernels keep their
// registers: a run-time branch there cost 8-19 registers a thread.
//
// Sample shards (the ("p", "mc") mesh of dibs_tpu_torch/parallel): a rank
// holding samples m0 .. m0 + n_samples - 1 of every particle draws its
// local sample m at the counter m0 + m, so its [B, n_samples, d, d] block
// is bitwise that slice of one launch over all the samples. The offset is
// a compile-time variant too (kMc), taken only where m0 != 0, so the
// unsharded and particle-shard kernels keep their registers; a fleet has
// no sample shards (m0 = 0 there).
#include <climits>

#include "common.h"

namespace {

constexpr int kHard = 0;
constexpr int kSoftLog = 1;   // sigmoid(tau * (eps + alpha s))
constexpr int kSoftFast = 2;  // tau = 1, in-kernel noise

template <int kVec>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int kVec>
__device__ __forceinline__ void store(float* __restrict__ p,
                                      const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// One thread: elements e0 .. e0 + kVec - 1 of particle b0 + unit / upp, for
// samples blockIdx.y * group .. + group - 1, drawn at the sample counters
// m_off + m with kMc. `units` = particles of this launch x upp (< 2^31, the
// launcher slices the batch). m_off comes last, so the other parameters
// keep their offsets (and the kernels without kMc their registers).
template <int kVec, int kMode, bool kFleet, bool kMc>
__global__ void __launch_bounds__(256) gumbel_graphs_kernel(
    const float* __restrict__ scores, const float* __restrict__ eps,
    float* __restrict__ out, const int64_t* __restrict__ keys, int per,
    int units, int upp, int d, int n_samples, int group, uint32_t b0,
    uint32_t k0, uint32_t k1, uint32_t stream, float alpha, float tau,
    uint32_t m_off) {
  const int unit = blockIdx.x * blockDim.x + threadIdx.x;
  if (unit >= units) return;
  const int bl = unit / upp;
  const int e0 = (unit - bl * upp) * kVec;
  const int dd = d * d;
  uint32_t b = b0 + static_cast<uint32_t>(bl);
  if constexpr (kFleet) {  // the dataset's key, the index within it
    const uint32_t ds = b / static_cast<uint32_t>(per);
    const uint64_t key = static_cast<uint64_t>(__ldg(keys + ds));
    b -= ds * static_cast<uint32_t>(per);
    k0 = static_cast<uint32_t>(key & 0xFFFFFFFFull);
    k1 = static_cast<uint32_t>(key >> 32);
  }

  float as[kVec];  // alpha * s
  float en[kVec];  // exp(-alpha s), the fast form's factor
  bool off[kVec];  // off the diagonal
  load<kVec>(scores + static_cast<int64_t>(bl) * dd + e0, as);
  int diag = e0 % (d + 1);  // element e is diagonal iff e % (d + 1) == 0
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    off[v] = diag != 0;
    diag = diag == d ? 0 : diag + 1;
    as[v] = __fmul_rn(alpha, as[v]);
    if constexpr (kMode == kSoftFast) en[v] = expf(-as[v]);
  }

  const int m0 = blockIdx.y * group;
  const int m1 = min(n_samples, m0 + group);
  const int64_t first = (static_cast<int64_t>(bl) * n_samples + m0) * dd + e0;
  float* __restrict__ op = out + first;
  const float* __restrict__ ep = eps == nullptr ? nullptr : eps + first;
  for (int m = m0; m < m1; ++m, op += dd) {
    const uint32_t mc =
        kMc ? static_cast<uint32_t>(m) + m_off : static_cast<uint32_t>(m);
    float g[kVec];
    if constexpr (kMode == kSoftFast) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float u = dibs::philox_uniform(static_cast<uint32_t>(e0 + v),
                                             mc, b, stream, k0, k1);
        g[v] = __fdiv_rn(
            u, __fadd_rn(u, __fmul_rn(__fsub_rn(1.0f, u), en[v])));
      }
    } else {
      if (ep != nullptr) {
        load<kVec>(ep, g);
        ep += dd;
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          g[v] = dibs::philox_logistic(static_cast<uint32_t>(e0 + v), mc,
                                       b, stream, k0, k1);
        }
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float logit = __fadd_rn(g[v], as[v]);
        if constexpr (kMode == kHard) {
          g[v] = logit > 0.0f ? 1.0f : 0.0f;
        } else {
          g[v] = 1.0f / (1.0f + expf(-__fmul_rn(tau, logit)));
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) g[v] = off[v] ? g[v] : 0.0f;
    store<kVec>(op, g);
  }
}

template <int kVec>
cudaError_t launch(int mode, dim3 grid, int threads, cudaStream_t stream,
                   const float* scores, const float* eps, float* out,
                   const int64_t* keys, int per, int units, int upp, int d,
                   int n_samples, int group, uint32_t b0, uint32_t m_off,
                   uint32_t k0, uint32_t k1, uint32_t rng_stream, float alpha,
                   float tau) {
  constexpr bool F = false, T = true;
  auto kernel =
      keys != nullptr
          ? (mode == kHard ? gumbel_graphs_kernel<kVec, kHard, T, F>
             : mode == kSoftFast
                 ? gumbel_graphs_kernel<kVec, kSoftFast, T, F>
                 : gumbel_graphs_kernel<kVec, kSoftLog, T, F>)
      : m_off != 0
          ? (mode == kHard ? gumbel_graphs_kernel<kVec, kHard, F, T>
             : mode == kSoftFast
                 ? gumbel_graphs_kernel<kVec, kSoftFast, F, T>
                 : gumbel_graphs_kernel<kVec, kSoftLog, F, T>)
          : (mode == kHard ? gumbel_graphs_kernel<kVec, kHard, F, F>
             : mode == kSoftFast
                 ? gumbel_graphs_kernel<kVec, kSoftFast, F, F>
                 : gumbel_graphs_kernel<kVec, kSoftLog, F, F>);
  kernel<<<grid, threads, 0, stream>>>(scores, eps, out, keys, per, units,
                                       upp, d, n_samples, group, b0, k0, k1,
                                       rng_stream, alpha, tau, m_off);
  return cudaGetLastError();
}

}  // namespace

// `vec`, `threads` and `group` (samples a thread) come from the wrapper's
// plan (gpu_kernels.gumbel_plan); vec = 4 needs d * d % 4 == 0 and 16-byte
// aligned scores and eps. `keys` ([batch / per] int64, device) keys each
// dataset of `per` particles of a fleet; null: `seed` keys the batch.
// `p0` is the particle counter of the batch's first particle: a shard of
// a particle-sharded run holding particles p0 .. p0 + batch - 1 draws what
// those particles draw in one launch over all of them (0 for a fleet).
// `m0` is the sample counter of the first sample: a sample shard holding
// samples m0 .. m0 + n_samples - 1 draws that slice of one launch over all
// the samples (0 for a fleet; the counters must stay below 2^32).
DIBS_API int dibs_gumbel_graphs(const float* scores, const float* eps,
                                float* out, int64_t batch, int n_samples,
                                int d, uint64_t seed, const int64_t* keys,
                                int per, uint32_t p0, uint32_t m0,
                                uint32_t stream,
                                float alpha, float tau, int hard, int vec,
                                int threads, int group,
                                cudaStream_t cuda_stream) {
  if (batch == 0 || n_samples == 0 || d == 0) return 0;
  const int groups = group > 0 ? (n_samples + group - 1) / group : 0;
  if (d < 0 || d > 46340 || batch > (int64_t{1} << 32) || n_samples < 0 ||
      (vec != 1 && vec != 4) || (d * d) % vec != 0 || threads < 32 ||
      threads > 256 || groups < 1 || groups > 65535 ||
      static_cast<uint64_t>(m0) + static_cast<uint64_t>(n_samples) >
          (uint64_t{1} << 32) ||
      (keys != nullptr &&
       (per < 1 || batch % per != 0 || p0 != 0 || m0 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dd = d * d;
  const int upp = dd / vec;
  const int mode = hard ? kHard
                   : (eps == nullptr && tau == 1.0f) ? kSoftFast
                                                     : kSoftLog;
  const uint32_t k0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  // particles a launch: unit indices stay below 2^31 in 32-bit arithmetic
  const int64_t per_launch = (INT_MAX - threads) / upp;
  for (int64_t b0 = 0; b0 < batch; b0 += per_launch) {
    const int64_t nb = batch - b0 < per_launch ? batch - b0 : per_launch;
    const int units = static_cast<int>(nb * upp);
    const dim3 grid((units + threads - 1) / threads, groups);
    const int64_t off = b0 * n_samples * dd;
    const float* e = eps == nullptr ? nullptr : eps + off;
    const cudaError_t err =
        vec == 4 ? launch<4>(mode, grid, threads, cuda_stream,
                             scores + b0 * dd, e, out + off, keys, per, units,
                             upp, d, n_samples, group,
                             static_cast<uint32_t>(b0) + p0, m0, k0, k1,
                             stream, alpha, tau)
                 : launch<1>(mode, grid, threads, cuda_stream,
                             scores + b0 * dd, e, out + off, keys, per, units,
                             upp, d, n_samples, group,
                             static_cast<uint32_t>(b0) + p0, m0, k0, k1,
                             stream, alpha, tau);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

DIBS_API const char* dibs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
