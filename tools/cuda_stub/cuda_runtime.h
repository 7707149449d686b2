// A host-only stand-in for <cuda_runtime.h>: just enough of CUDA's
// keywords, types and intrinsics for g++ to parse and type-check the
// kernel sources (tools/cuda_host_check.py). Nothing here runs.
#pragma once
#include <cmath>
#include <math.h>
#include <cstddef>
#include <cstdint>
#include <algorithm>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
extern uint3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize, cudaFuncAttributePreferredSharedMemoryCarveout };
enum { cudaSharedmemCarveoutMaxShared = 100 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
cudaError_t cudaGetLastError();
const char* cudaGetErrorString(cudaError_t);
cudaError_t cudaGetDevice(int*);
cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int);
template <class T> cudaError_t cudaFuncSetAttribute(T* entry, cudaFuncAttribute attr, int value);
template <class T> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, T* func, int blockSize, size_t smem);
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __int_as_float(int);
inline int __popc(unsigned);
inline int __ffs(int);
void __syncthreads();
int __syncthreads_or(int);
void __syncwarp(unsigned mask = 0xffffffffu);
unsigned __ballot_sync(unsigned, int);
template <class T> T __ldg(const T*);
template <class T> T __shfl_sync(unsigned, T, int, int w = 32);
template <class T> T __shfl_down_sync(unsigned, T, unsigned, int w = 32);
template <class T> T __shfl_xor_sync(unsigned, T, int, int w = 32);
template <class T> T atomicAdd(T*, T);
template <class A, class B> inline auto min(A a, B b) { return a < b ? a : b; }
template <class A, class B> inline auto max(A a, B b) { return a < b ? b : a; }
size_t __cvta_generic_to_shared(const void*);
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
union cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t { dim3 gridDim; dim3 blockDim; size_t dynamicSmemBytes; cudaStream_t stream; cudaLaunchAttribute* attrs; unsigned numAttrs; };
template <class... E, class... A> cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t*, void (*)(E...), A&&...);
