// Shared helpers for the port's kernels: dtype conversion, warp sums,
// staging, cluster launches and the bf16 tensor-core product.
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

#include <mutex>
#include <type_traits>

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

// x rounded to T and back: where a TPU kernel casts an f32 value to the
// cache dtype before a matrix product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// 16 bytes of T at p (16-byte aligned, shared or device memory) as floats
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
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

// What a cluster kernel has been let take on each device: clusters of 16
// blocks (a non-portable size) and `bytes` of shared memory, set once per
// device and per larger size, so a steady launch makes no CUDA call but the
// launch itself. Host threads may launch at once.
struct ClusterAllowance {
  std::mutex mu;
  size_t bytes[64] = {};   // per device; 0: nothing set on it yet
};

template <typename K>
inline cudaError_t allow_cluster(K kernel, size_t bytes, ClusterAllowance& a) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(a.mu);
  if (a.bytes[dev] >= bytes) return cudaSuccess;
  if (a.bytes[dev] == 0) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  a.bytes[dev] = bytes;
  return cudaSuccess;
}

// Grid (C, rows) of blocks of `threads`, clusters of (C, 1, 1); attr is
// where the cluster size lives
inline cudaLaunchConfig_t cluster_config(int C, int rows, int threads,
                                         size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, rows, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Split cluster barrier, called by every thread of the cluster in uniform
// control flow: arriving at entry and waiting before the first write into
// another block's shared memory makes sure that block runs. The release
// arrival also publishes what the block wrote before it; the relaxed one
// does not wait for anything in flight (a release waits for bulk copies).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// compile-time values for dispatching a runtime dtype, Dh or flag
template <bool B>
using Bool = std::integral_constant<bool, B>;
template <int N>
using Int = std::integral_constant<int, N>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// staging by every thread: 16-byte asynchronous copies (16-byte aligned
// source and destination), committed in groups and waited on by count
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// staging with a zero fill: the 16 bytes at src where `valid`, else zeros
// (nothing is read then; src must still be a device address)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// two bf16 at p (4-byte aligned) as one register of an mma operand
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b on tensor cores: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, transposed: lane i names
// the row address of row i % 8 of matrix i / 8; r[m] is this lane's pair
// of matrix m (the B operand of mma_bf16 from a row-major [k][n] tile)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// two floats as the bf16 pair of one mma register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Phase stamps, in builds with -DEAMG_PHASE_TIMING only (ops/_build.py
// VARIANTS, loaded by chip_smoke.py alone): thread 0 of a block writes
// %globaltimer and clock64 at boundary i of n into the buffer that the
// library's eamg_set_stamps names, at block index y * gridDim.x + x.
#ifdef EAMG_PHASE_TIMING
namespace {
__device__ unsigned long long* g_stamps = nullptr;
}
__device__ __forceinline__ void phase_stamp(int i, int n) {
  if (threadIdx.x == 0 && g_stamps != nullptr) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    unsigned long long* at =
        g_stamps +
        2 * (((size_t)blockIdx.y * gridDim.x + blockIdx.x) * n + i);
    at[0] = ns;
    at[1] = (unsigned long long)clock64();
  }
}
#define PHASE_STAMP(i, n) phase_stamp(i, n)
// stamps: 2 * n u64 per block of the library's stamped kernel (null: off)
extern "C" int eamg_set_stamps(void* stamps) {
  return (int)cudaMemcpyToSymbol(g_stamps, &stamps, sizeof(stamps));
}
#else
#define PHASE_STAMP(i, n) ((void)0)
#endif

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
