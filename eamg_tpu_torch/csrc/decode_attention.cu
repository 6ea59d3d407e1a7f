// K3 — flash-decode: one new query per head against the KV cache, GQA-native.
//
// Replaces eamg_tpu/ops/decode_attention.py::flash_decode_sp
// (_decode_sp_kernel), which the JAX model reaches from
// models/gpt.py::decode_step in every decode step.
//
// Computes o[b, h] = softmax(q[b, h] k[b, h // g, 0..t[b]]^T / sqrt(Dh))
// v[b, h // g, 0..t[b]] for q [B, H, 1, Dh] and caches [B, Hkv, M, Dh],
// with the newest valid position t [B] per row. Any M is taken: the last
// split is masked, so the flagship's M = 511 needs no padding (the JAX
// kernel asserts M % block_k == 0).
//
// What bounds it: the bytes of the valid cache prefix, 2 * (t + 1) * Dh *
// Hkv elements per row, against 4 * H * (t + 1) * Dh flops: bound by bytes.
// Design: split-K. One block per (split of CH keys, KV head, row) loads its
// keys and values once for all g = H / Hkv query heads of the group (no
// repeat of K/V heads), computes the g x CH scores, a split-local max and
// sum, and the split's unnormalised g x Dh partial product. Splits past
// t[b] exit at once, so the bytes read scale with t, not M. A second launch
// merges the splits of each (row, head) in a fixed order with the usual
// max-rescaling, so results are deterministic (no atomics). Statistics and
// accumulators are f32.
#include "common.cuh"

namespace {

constexpr int CH = 64;   // keys per split
constexpr int NT = 256;  // threads per block

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ t,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int H, int Hkv, int M,
                      float scale, int n_split) {
  extern __shared__ float sm[];
  constexpr int KS = DH + 1;  // padded key row: conflict-free score reads
  const int g = H / Hkv;
  float* qs = sm;               // [g][DH]
  float* ks = qs + g * DH;      // [CH][KS]
  float* vs = ks + CH * KS;     // [CH][DH]
  float* sc = vs + CH * DH;     // [g][CH]
  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tb = min(t[b], M - 1);
  const int j0 = s * CH;
  if (j0 > tb) return;  // this split lies past the newest key
  const int n = min(CH, tb + 1 - j0);

  const T* qp = q + ((size_t)b * H + hk * g) * DH;
  for (int e = tid; e < g * DH; e += NT) qs[e] = to_f32(qp[e]);
  const size_t kv0 = (((size_t)b * Hkv + hk) * M + j0) * DH;
  for (int e = tid; e < n * DH; e += NT) {
    ks[(e / DH) * KS + e % DH] = to_f32(k[kv0 + e]);
    vs[e] = to_f32(v[kv0 + e]);
  }
  __syncthreads();

  for (int e = tid; e < g * CH; e += NT) {
    const int hi = e / CH, j = e % CH;
    float sv = -INFINITY;
    if (j < n) {
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) a += qs[hi * DH + d] * ks[j * KS + d];
      sv = a * scale;
    }
    sc[e] = sv;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int hi = warp; hi < g; hi += NT / 32) {
    float mx = -INFINITY;
    for (int j = lane; j < CH; j += 32) mx = fmaxf(mx, sc[hi * CH + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < CH; j += 32) {
      const float p = (j < n) ? expf(sc[hi * CH + j] - mx) : 0.f;
      sc[hi * CH + j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const size_t pi = ((size_t)b * H + hk * g + hi) * n_split + s;
      part_m[pi] = mx;
      part_l[pi] = sum;
    }
  }
  __syncthreads();

  for (int e = tid; e < g * DH; e += NT) {
    const int hi = e / DH, d = e % DH;
    float a = 0.f;
    for (int j = 0; j < n; ++j) a += sc[hi * CH + j] * vs[j * DH + d];
    part_acc[(((size_t)b * H + hk * g + hi) * n_split + s) * DH + d] = a;
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      const int* __restrict__ t,
                                      T* __restrict__ o, int H, int M, int Dh,
                                      int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int tb = min(t[b], M - 1);
  const int ns = tb < 0 ? 0 : tb / CH + 1;
  const size_t base = ((size_t)b * H + h) * n_split;
  float mx = -INFINITY;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, part_m[base + s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float c = expf(part_m[base + s] - mx);
    L += part_l[base + s] * c;
    A += part_acc[(base + s) * Dh + d] * c;
  }
  o[((size_t)b * H + h) * Dh + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, const int* t,
              void* o, float* part, int B, int H, int Hkv, int M, float scale,
              cudaStream_t stream) {
  const int n_split = (M + CH - 1) / CH;
  const int g = H / Hkv;
  const size_t smem =
      sizeof(float) * (g * DH + CH * (DH + 1) + CH * DH + g * CH);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_partial_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t np = (size_t)B * H * n_split;
  float* part_m = part;
  float* part_l = part + np;
  float* part_acc = part + 2 * np;
  decode_partial_kernel<T, DH><<<dim3(n_split, Hkv, B), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, t, part_m, part_l, part_acc, H,
      Hkv, M, scale, n_split);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  decode_combine_kernel<T><<<dim3(H, B), DH, 0, stream>>>(
      part_m, part_l, part_acc, t, (T*)o, H, M, DH, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* t, void* o,
           float* part, int B, int H, int Hkv, int M, int Dh, float scale,
           cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch_dh<T, 16>(q, k, v, t, o, part, B, H, Hkv, M, scale, stream);
    case 32: return launch_dh<T, 32>(q, k, v, t, o, part, B, H, Hkv, M, scale, stream);
    case 64: return launch_dh<T, 64>(q, k, v, t, o, part, B, H, Hkv, M, scale, stream);
    case 128: return launch_dh<T, 128>(q, k, v, t, o, part, B, H, Hkv, M, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// part: f32 scratch of B * H * ceil(M / 64) * (Dh + 2) elements, from the
// caller.
extern "C" int eamg_flash_decode(const void* q, const void* k, const void* v,
                                 const int* t, void* o, float* part, int B,
                                 int H, int Hkv, int M, int Dh, float scale,
                                 int dtype, void* stream) {
  if (H % Hkv != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EAMG_F32)
    return launch<float>(q, k, v, t, o, part, B, H, Hkv, M, Dh, scale, s);
  if (dtype == EAMG_BF16)
    return launch<__nv_bfloat16>(q, k, v, t, o, part, B, H, Hkv, M, Dh, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}
