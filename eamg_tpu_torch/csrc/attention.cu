// K1 — prefill flash attention, GQA-native.
//
// Replaces eamg_tpu/ops/attention.py::flash_attention (_attn_kernel), which
// the JAX model reaches from models/gpt.py::attention in prefill.
//
// Computes o = softmax(q k^T / sqrt(Dh) + mask) v for q [B, H, T, Dh] and
// k, v [B, Hkv, T, Dh] (H a multiple of Hkv), with a per-row count of valid
// keys valid_len [B] and an optional causal mask. Statistics and the
// accumulator are f32; the output keeps the input dtype (f32 or bf16).
//
// What bounds it: at the served shapes (T = the prompt bucket, 16-64 rows,
// Dh 64) the work is a few MFLOP and the bytes a few hundred KB, so a launch
// is latency-bound, not bound by bytes or operations. Design: one block per
// (query tile of BQ positions, KV head, batch row) holds the g = H / Hkv
// query heads that share that KV head, so each K/V tile is read from
// device memory once per group (no repeat of K/V heads) and staged through
// shared memory in f32. Each thread owns one (head, position) query row in
// registers and folds keys into an online softmax (running max, sum and
// accumulator). Key tiles past valid_len, and past the causal frontier of
// the tile, are never loaded; the ragged T edge is masked in the kernel, so
// no padding is needed. The matrix products run on CUDA cores: tensor
// cores (wgmma) are a later step.
#include "common.cuh"

namespace {

constexpr int BQ = 32;  // query positions per block
constexpr int BK = 32;  // keys per shared-memory tile

template <typename T, int DH>
__global__ void attn_fwd_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ o,
                                const int* __restrict__ valid_len, int H,
                                int Hkv, int T_len, int causal, float scale) {
  __shared__ float ks[BK][DH];
  __shared__ float vs[BK][DH];
  const int g = H / Hkv;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int h = hk * g + tid / BQ;
  const int qi = q0 + tid % BQ;
  const bool active = qi < T_len;

  int kend = min(valid_len[b], T_len);
  if (causal) kend = min(kend, q0 + BQ);

  float qr[DH], acc[DH];
  const T* qp = q + (((size_t)b * H + h) * T_len + (active ? qi : 0)) * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? to_f32(qp[d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const T* kp = k + ((size_t)b * Hkv + hk) * T_len * DH;
  const T* vp = v + ((size_t)b * Hkv + hk) * T_len * DH;

  for (int j0 = 0; j0 < kend; j0 += BK) {
    const int n = min(BK, kend - j0);
    __syncthreads();
    for (int e = tid; e < n * DH; e += blockDim.x) {
      ks[e / DH][e % DH] = to_f32(kp[(size_t)j0 * DH + e]);
      vs[e / DH][e % DH] = to_f32(vp[(size_t)j0 * DH + e]);
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      if (causal && j0 + j > qi) break;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) s += qr[d] * ks[j][d];
      s *= scale;
      if (s > m) {
        const float c = expf(m - s);  // m == -inf: c == 0, acc is still 0
        l *= c;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= c;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] += p * vs[j][d];
    }
  }
  if (active) {
    const float den = fmaxf(l, 1e-30f);
    T* op = o + (((size_t)b * H + h) * T_len + qi) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = from_f32<T>(acc[d] / den);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* valid_len, int B, int H, int Hkv, int T_len, int Dh,
           int causal, float scale, cudaStream_t stream) {
  const dim3 grid((T_len + BQ - 1) / BQ, Hkv, B);
  const dim3 block((H / Hkv) * BQ);
#define EAMG_ATTN(DHV)                                                    \
  attn_fwd_kernel<T, DHV><<<grid, block, 0, stream>>>(                    \
      (const T*)q, (const T*)k, (const T*)v, (T*)o, valid_len, H, Hkv,    \
      T_len, causal, scale)
  switch (Dh) {
    case 16: EAMG_ATTN(16); break;
    case 32: EAMG_ATTN(32); break;
    case 64: EAMG_ATTN(64); break;
    case 128: EAMG_ATTN(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef EAMG_ATTN
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int eamg_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, const int* valid_len, int B, int H,
                                  int Hkv, int T_len, int Dh, int causal,
                                  float scale, int dtype, void* stream) {
  if (H % Hkv != 0 || (H / Hkv) * BQ > 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EAMG_F32)
    return launch<float>(q, k, v, o, valid_len, B, H, Hkv, T_len, Dh, causal,
                         scale, s);
  if (dtype == EAMG_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, valid_len, B, H, Hkv, T_len, Dh,
                                 causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
