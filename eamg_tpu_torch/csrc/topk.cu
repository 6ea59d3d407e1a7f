// K4 — exact k-th largest value per row (the top-k sampling threshold).
//
// Replaces eamg_tpu/ops/topk.py::kth_value_pallas (_threshold_kernel); the
// JAX sampler (decode/sampling.py) runs its XLA twin kth_value_bitsearch,
// which gives the same output, on every sampled decode step.
//
// Maps each f32 logit to an order-preserving uint32 key (sign bit set for
// x >= 0, all bits flipped for x < 0) and finds, most significant bit
// first, the largest key t with count(keys >= t) >= k: 32 compare-and-count
// passes. Integer counts make it exact and bit-equal to the plain version
// and to lax.top_k(...)[0][..., -1], ties included.
//
// What bounds it: it reads V * 4 bytes per row once (36 KB at V 8892), so
// the bound is bytes, but at one row a launch is latency-bound. Design: one
// block per row; the row's keys are loaded into shared memory once and all
// 32 passes run on chip (the TPU kernel kept the row in VMEM the same way);
// each pass is a strided count per thread, a warp shuffle sum and one
// cross-warp sum.
#include "common.cuh"

namespace {

constexpr int NT = 1024;

__global__ void __launch_bounds__(NT)
kth_value_kernel(const float* __restrict__ logits, float* __restrict__ out,
                 int V, int k) {
  extern __shared__ uint32_t keys[];
  __shared__ int warp_cnt[NT / 32];
  __shared__ uint32_t t_shared;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* row = logits + (size_t)blockIdx.x * V;
  for (int i = tid; i < V; i += NT) {
    const uint32_t b = __float_as_uint(row[i]);
    keys[i] = (b >= 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  __syncthreads();
  uint32_t t = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = t | (1u << bit);
    int c = 0;
    for (int i = tid; i < V; i += NT) c += keys[i] >= cand;
    c = warp_sum_int(c);
    if (lane == 0) warp_cnt[warp] = c;
    __syncthreads();
    if (warp == 0) {
      int x = warp_cnt[lane];  // NT / 32 == 32 warps
      x = warp_sum_int(x);
      if (lane == 0) t_shared = (x >= k) ? cand : t;
    }
    __syncthreads();
    t = t_shared;
  }
  if (tid == 0) {
    const uint32_t b = (t >= 0x80000000u) ? (t & 0x7FFFFFFFu) : ~t;
    out[blockIdx.x] = __uint_as_float(b);
  }
}

}  // namespace

extern "C" int eamg_kth_value(const float* logits, float* out, int B, int V,
                              int k, void* stream) {
  if (k <= 0 || k > V) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * (size_t)V;
  if (smem > 40 * 1024) {  // beside the static arrays, past the default 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        kth_value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kth_value_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(logits, out, V, k);
  return (int)cudaGetLastError();
}
