// Stream reduce: a read-rate probe over a position-major cache.
//
// Replaces eamg_tpu/ops/decode_fold.py::stream_reduce (_stream_kernel),
// which the JAX package uses to measure how fast a cache of the fold
// kernels' block shape can be read at all: the fold kernels' speed of
// light.
//
// kv [B, M, W] is read as [B * M, W] in groups of `rows` batch rows
// (rows * M lines each). Every group is read and summed over its lines in
// f32. What comes back, [1, W] in the input dtype, is the sum of the LAST
// group only: in the Pallas kernel every grid step writes the same output
// block, so the last step wins. It is a probe, not a reduction of the
// whole array, and this kernel returns the same thing; but it reads every
// group, which is the point of it.
//
// What bounds it: bytes, B * M * W elements read once. Design: one block
// per (slab of RS lines, group); a thread owns a column, walks the slab's
// lines (neighbouring threads on neighbouring addresses) and writes one f32
// partial per slab, which keeps every group's loads alive. A second launch
// sums the last group's partials in slab order: deterministic, no atomics.
#include "common.cuh"

namespace {

constexpr int RS = 16;    // lines per block
constexpr int NT = 128;   // threads per block

template <typename T>
__global__ void __launch_bounds__(NT)
stream_partial_kernel(const T* __restrict__ kv, float* __restrict__ part,
                      int lines, int W, int n_slab) {
  const int slab = blockIdx.x, grp = blockIdx.y;
  const int r0 = slab * RS;
  const int n = min(RS, lines - r0);
  const T* p = kv + ((size_t)grp * lines + r0) * W;
  float* out = part + ((size_t)grp * n_slab + slab) * W;
  for (int c = threadIdx.x; c < W; c += NT) {
    float a = 0.f;
    for (int r = 0; r < n; ++r) a += to_f32(p[(size_t)r * W + c]);
    out[c] = a;
  }
}

template <typename T>
__global__ void stream_final_kernel(const float* __restrict__ part,
                                    T* __restrict__ o, int W, int n_slab) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= W) return;
  float a = 0.f;
  for (int s = 0; s < n_slab; ++s) a += part[(size_t)s * W + c];
  o[c] = from_f32<T>(a);
}

template <typename T>
int launch(const void* kv, void* o, float* part, int groups, int lines, int W,
           cudaStream_t stream) {
  const int n_slab = (lines + RS - 1) / RS;
  stream_partial_kernel<T><<<dim3(n_slab, groups), NT, 0, stream>>>(
      (const T*)kv, part, lines, W, n_slab);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  stream_final_kernel<T><<<(W + NT - 1) / NT, NT, 0, stream>>>(
      part + (size_t)(groups - 1) * n_slab * W, (T*)o, W, n_slab);
  return (int)cudaGetLastError();
}

}  // namespace

// kv: `groups` groups of `lines` lines of W elements; part: f32 scratch of
// groups * ceil(lines / 16) * W elements, from the caller; o: W elements.
extern "C" int eamg_stream_reduce(const void* kv, void* o, float* part,
                                  int groups, int lines, int W, int dtype,
                                  void* stream) {
  if (groups <= 0 || lines <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EAMG_F32) return launch<float>(kv, o, part, groups, lines, W, s);
  if (dtype == EAMG_BF16)
    return launch<__nv_bfloat16>(kv, o, part, groups, lines, W, s);
  return (int)cudaErrorInvalidValue;
}
