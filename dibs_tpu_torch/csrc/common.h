// Shared helpers of the dibs_tpu_torch CUDA kernels.
//
// Every launcher is an `extern "C"` function loaded through ctypes
// (dibs_tpu_torch/ops/gpu_kernels.py). It launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() so that a refused launch
// (too many threads, too much shared memory) raises in the Python wrapper.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define DIBS_API extern "C" __attribute__((visibility("default")))

namespace dibs {

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

// Uniform(0, 1) of element e of sample m of batch entry b on `stream`: the
// TPU kernels' contract (top 24 bits of the first Philox word, a half-ulp
// offset, the clamp at 1 - 2^-23), with exact products and explicit
// rounding so the PyTorch twin (gpu_kernels.philox_uniform) computes the
// same uniform. The clamp keeps 1/u - 1 > 0, so the fast soft form
// (1/u - 1) exp(-alpha s) never computes 0 * inf.
__device__ __forceinline__ float philox_uniform(uint32_t e, uint32_t m,
                                                uint32_t b, uint32_t stream,
                                                uint32_t k0, uint32_t k1) {
  const uint32_t bits = philox_word0(e, m, b, stream, k0, k1);
  const float u = __fadd_rn(__fmul_rn(static_cast<float>(bits >> 8),
                                      5.9604644775390625e-08f),   // 2^-24
                            2.98023223876953125e-08f);            // 2^-25
  return fminf(u, 0.99999988079071044921875f);                    // 1 - 2^-23
}

// Logistic(0, 1) noise: logit of philox_uniform.
__device__ __forceinline__ float philox_logistic(uint32_t e, uint32_t m,
                                                 uint32_t b, uint32_t stream,
                                                 uint32_t k0, uint32_t k1) {
  const float u = philox_uniform(e, m, b, stream, k0, k1);
  return logf(u) - log1pf(-u);
}

}  // namespace dibs
