// Shared helpers for the port's kernels: dtype conversion and warp sums.
//
// Every kernel file exposes a plain C entry point (built with nvcc into its
// own shared library and bound with ctypes). Entry points take raw device
// pointers, sizes, a dtype code and the CUDA stream, launch on that stream,
// allocate nothing, and return cudaGetLastError() so the Python wrapper
// raises on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes, mirrored by eamg_tpu_torch/ops/_build.py
enum { EAMG_F32 = 0, EAMG_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// round to nearest even, as torch's and XLA's f32 -> bf16 casts do
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Max or sum over all threads of the block, the same value in every thread.
// The warps' results are combined by every thread in warp order, so the
// result does not depend on timing. Called by the whole block in uniform
// control flow, with a block size that is a multiple of 32; `scratch` holds
// one float per warp (at most 32).
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();  // scratch is free of an earlier call's readers
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < nw; ++w) r = fmaxf(r, scratch[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < nw; ++w) r += scratch[w];
  return r;
}

// x rounded to T and back: where a TPU kernel casts an f32 value to the
// cache dtype before a matrix product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// a block may use up to 227 KB of shared memory on sm_90, above 48 KB only
// after the opt-in below
constexpr size_t EAMG_MAX_SMEM = 232448;

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > EAMG_MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
