// Gumbel graph sampler: hard (Gumbel-max) and soft (Gumbel-softmax) modes.
//
// Replaces dibs_tpu/ops/pallas_kernels.py::gumbel_soft_graphs_pallas (body
// _make_gumbel_kernel). For scores [B, d, d] it writes [B, M, d, d]:
//   soft: sigmoid(tau * (eps + alpha * s)),   hard: 1[eps + alpha * s > 0],
// with a zero diagonal and eps ~ Logistic(0, 1).
//
// Bound on this card: a pure elementwise pass, so device-memory bandwidth on
// the 4-byte-per-element output (and the injected eps, when given). The TPU
// kernel kept the noise out of HBM by drawing it from the hardware PRNG;
// here a hand-written Philox4x32-10 does the same: one thread per output
// element, counter (element, sample, particle, stream), key = the 64-bit
// seed. Nothing but the output touches device memory.
//
// The uniform keeps the TPU kernel's contract (pallas_kernels.py:163-175):
// top 24 bits of the first Philox word, a half-ulp offset, and the clamp at
// 1 - 2^-23; then eps = log(u) - log1p(-u). The PyTorch twin
// (gumbel_graphs_plain) runs the same Philox, so both produce the same
// noise up to the last ulp of log/log1p.
//
// With `eps` non-null the kernel reads the injected noise [B, M, d, d]
// instead (the debug_noise convention of fused_linear.py), which makes
// exact comparison with the reference possible.
#include "common.h"

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint32_t mulhilo(uint32_t a, uint32_t b,
                                            uint32_t* hi) {
  const uint64_t p = static_cast<uint64_t>(a) * static_cast<uint64_t>(b);
  *hi = static_cast<uint32_t>(p >> 32);
  return static_cast<uint32_t>(p);
}

// Philox4x32-10: ten rounds, the key bumped before every round but the first.
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    uint32_t hi0, hi1;
    const uint32_t lo0 = mulhilo(kPhiloxM0, c0, &hi0);
    const uint32_t lo1 = mulhilo(kPhiloxM1, c2, &hi1);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

__global__ void gumbel_graphs_kernel(const float* __restrict__ scores,
                                     const float* __restrict__ eps,
                                     float* __restrict__ out, int n_samples,
                                     int d, int64_t total, uint32_t k0,
                                     uint32_t k1, uint32_t stream, float alpha,
                                     float tau, int hard) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int dd = d * d;
  const int e = static_cast<int>(idx % dd);
  const int64_t bm = idx / dd;
  const int m = static_cast<int>(bm % n_samples);
  const int64_t b = bm / n_samples;
  const int row = e / d;
  const int col = e - row * d;

  float val = 0.0f;
  if (row != col) {
    float noise;
    if (eps != nullptr) {
      noise = eps[idx];
    } else {
      const uint32_t bits = philox_word0(static_cast<uint32_t>(e),
                                         static_cast<uint32_t>(m),
                                         static_cast<uint32_t>(b), stream, k0,
                                         k1);
      // exact products and explicit rounding: the twin computes the same
      float u = __fadd_rn(__fmul_rn(static_cast<float>(bits >> 8),
                                    5.9604644775390625e-08f),   // 2^-24
                          2.98023223876953125e-08f);            // 2^-25
      u = fminf(u, 0.99999988079071044921875f);                 // 1 - 2^-23
      noise = logf(u) - log1pf(-u);
    }
    const float logit = __fadd_rn(noise, __fmul_rn(alpha, scores[b * dd + e]));
    if (hard) {
      val = logit > 0.0f ? 1.0f : 0.0f;
    } else {
      val = 1.0f / (1.0f + expf(-__fmul_rn(tau, logit)));
    }
  }
  out[idx] = val;
}

}  // namespace

DIBS_API int dibs_gumbel_graphs(const float* scores, const float* eps,
                                float* out, int64_t batch, int n_samples,
                                int d, uint64_t seed, uint32_t stream,
                                float alpha, float tau, int hard,
                                cudaStream_t cuda_stream) {
  const int64_t total = batch * n_samples * static_cast<int64_t>(d) * d;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  gumbel_graphs_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         cuda_stream>>>(
      scores, eps, out, n_samples, d, total,
      static_cast<uint32_t>(seed & 0xFFFFFFFFull),
      static_cast<uint32_t>(seed >> 32), stream, alpha, tau, hard);
  return static_cast<int>(cudaGetLastError());
}

DIBS_API const char* dibs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
