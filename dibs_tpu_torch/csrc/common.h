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
