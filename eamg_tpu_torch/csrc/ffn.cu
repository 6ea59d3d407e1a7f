// K2 — fused FFN: out = act(x W1^T + b1) W2^T + b2, with the [rows, FF]
// intermediate kept on chip.
//
// Replaces eamg_tpu/ops/ffn.py::fused_ffn (_ffn_kernel), which the JAX
// model reaches from models/gpt.py::_mlp in every layer, in prefill and in
// every decode step.
//
// Layouts are torch's: x [rows, D], w1 [FF, D], w2 [D, FF]; b1 [FF] and
// b2 [D] arrive as f32 (added in f32, as the Pallas kernel adds them to its
// f32 accumulator). The arithmetic follows the Pallas kernel: f32
// accumulation, + b1, activation (relu or exact gelu), cast of h to the
// input dtype, second product with f32 accumulation, + b2, cast.
//
// What bounds it: in decode (rows = 1) the two weight matrices are the
// whole traffic, 2 * D * FF elements (4 MB in bf16 for D 512, FF 2048)
// against 2 * 2 * D * FF flops, so it is bound by bytes. Design: the FF
// axis is cut into slices of FS columns, one block per (FF slice, tile of
// BR rows), so a single decode row still spreads the weights over FF / FS
// blocks. A block computes its [BR, FS] slice of h into shared memory
// (never to device memory), multiplies it by the matching [D, FS] slice of
// W2, and writes an f32 partial [BR, D]. A second launch sums the partials
// in a fixed order and adds b2, so results are deterministic (no atomics).
// Tiles are staged through shared memory in f32 and multiplied on CUDA
// cores; tensor cores and a persistent, pipelined schedule are later steps.
#include "common.cuh"

namespace {

constexpr int BR = 16;   // rows per block
constexpr int FS = 64;   // FF columns of h held on chip per block
constexpr int DC = 64;   // depth of one shared-memory tile (== FS)
constexpr int NT = 256;  // threads per block
constexpr int PER = BR * FS / NT;  // outputs per thread in each phase

template <int ACT>
__device__ __forceinline__ float activation(float h) {
  if (ACT == 1) return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
  return fmaxf(h, 0.f);
}

template <typename T, int ACT>
__global__ void __launch_bounds__(NT)
ffn_partial_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const float* __restrict__ b1, const T* __restrict__ w2,
                   float* __restrict__ ws, int rows, int D, int FF) {
  __shared__ float xs[BR][DC + 1];
  __shared__ float wt[FS][DC + 1];  // W1 tile [FS][DC], then W2 tile [DC][FS]
  __shared__ float hs[BR][FS + 1];
  const int f0 = blockIdx.x * FS;
  const int r0 = blockIdx.y * BR;
  const int tid = threadIdx.x;

  // phase 1: h[r][f] for this block's FF slice
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += DC) {
    __syncthreads();
    for (int e = tid; e < BR * DC; e += NT) {
      const int r = e / DC, d = e % DC;
      xs[r][d] = (r0 + r < rows) ? to_f32(x[(size_t)(r0 + r) * D + d0 + d])
                                 : 0.f;
    }
    for (int e = tid; e < FS * DC; e += NT) {
      const int f = e / DC, d = e % DC;
      wt[f][d] = to_f32(w1[(size_t)(f0 + f) * D + d0 + d]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int p = tid + i * NT, r = p / FS, f = p % FS;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < DC; ++d) s += xs[r][d] * wt[f][d];
      acc[i] += s;
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int p = tid + i * NT, r = p / FS, f = p % FS;
    const float h = activation<ACT>(acc[i] + b1[f0 + f]);
    hs[r][f] = to_f32(from_f32<T>(h));  // h in the input dtype
  }

  // phase 2: partial[r][d] = sum over this slice of h[r][f] * w2[d][f0 + f]
  for (int d0 = 0; d0 < D; d0 += DC) {
    __syncthreads();
    for (int e = tid; e < DC * FS; e += NT) {
      const int d = e / FS, f = e % FS;
      wt[d][f] = to_f32(w2[(size_t)(d0 + d) * FF + f0 + f]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int p = tid + i * NT, r = p / DC, d = p % DC;
      float s = 0.f;
#pragma unroll 16
      for (int f = 0; f < FS; ++f) s += hs[r][f] * wt[d][f];
      if (r0 + r < rows)
        ws[((size_t)blockIdx.x * rows + r0 + r) * D + d0 + d] = s;
    }
  }
}

template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ ws,
                                  const float* __restrict__ b2,
                                  T* __restrict__ out, int n_split, int rows,
                                  int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * D) return;
  float s = 0.f;
  for (int sp = 0; sp < n_split; ++sp) s += ws[(size_t)sp * rows * D + i];
  out[i] = from_f32<T>(s + b2[i % D]);
}

template <typename T>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, void* out, float* ws, int rows, int D, int FF,
           int act, cudaStream_t stream) {
  const dim3 grid(FF / FS, (rows + BR - 1) / BR);
  if (act == 1)
    ffn_partial_kernel<T, 1><<<grid, NT, 0, stream>>>(
        (const T*)x, (const T*)w1, b1, (const T*)w2, ws, rows, D, FF);
  else
    ffn_partial_kernel<T, 0><<<grid, NT, 0, stream>>>(
        (const T*)x, (const T*)w1, b1, (const T*)w2, ws, rows, D, FF);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int n = rows * D;
  ffn_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      ws, b2, (T*)out, FF / FS, rows, D);
  return (int)cudaGetLastError();
}

}  // namespace

// ws: f32 scratch of (FF / 64) * rows * D elements, from the caller.
extern "C" int eamg_fused_ffn(const void* x, const void* w1, const float* b1,
                              const void* w2, const float* b2, void* out,
                              float* ws, int rows, int D, int FF, int act,
                              int dtype, void* stream) {
  if (D % DC != 0 || FF % FS != 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EAMG_F32)
    return launch<float>(x, w1, b1, w2, b2, out, ws, rows, D, FF, act, s);
  if (dtype == EAMG_BF16)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, ws, rows, D, FF, act,
                                 s);
  return (int)cudaErrorInvalidValue;
}
