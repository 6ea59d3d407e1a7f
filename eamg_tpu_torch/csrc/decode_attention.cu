// Single-query cached attention over a head-major cache: three kernels.
//
// All three compute, for q [B, H, 1, Dh] and caches [B, Hkv, M, Dh],
//   o[b, h] = softmax(q[b, h] k[b, h / g, 0..t]^T / sqrt(Dh)) v[b, h / g, 0..t]
// and take any M (the flagship's is 511; the JAX kernels assert
// M % block_k == 0). All are bound by bytes: 4 * H * (t + 1) * Dh flops
// against the cache bytes they read. Statistics and accumulators are f32.
//
// K3, flash_decode_sp, replaces
// eamg_tpu/ops/decode_attention.py::flash_decode_sp (_decode_sp_kernel),
// which the JAX model reaches from models/gpt.py::decode_step. GQA-native,
// the newest valid position t [B] per row.
// What bounds it: the bytes of the valid cache prefix, 2 * (t + 1) * Dh *
// Hkv elements per row. Design: split-K. One block per (split of CH keys,
// KV head, row) loads its keys and values once for all g = H / Hkv query
// heads of the group (no repeat of K/V heads), computes the g x CH scores,
// a split-local max and sum, and the split's unnormalised g x Dh partial
// product. Splits past t[b] exit at once, so the bytes read scale with t,
// not M. A second launch merges the splits of each (row, head) in a fixed
// order with the usual max-rescaling, so results are deterministic (no
// atomics).
//
// flash_decode replaces eamg_tpu/ops/decode_attention.py::flash_decode
// (_decode_kernel): MHA only, one scalar t for the whole batch, one program
// per (row, head) that copies 256-key blocks from device memory by hand up
// to cdiv(t + 1, 256) and runs an online softmax over them.
// What bounds it: the bytes of min(M, 256 * cdiv(t + 1, 256)) keys and
// values per (row, head). Design: one block per (row, head), ONE launch, no
// split and no combine. The loop over key blocks is bounded by t; a block's
// keys and values are staged in shared memory in the cache dtype with
// coalesced loads (key rows padded to an odd word stride), one thread per
// key takes its score, the block reduces max and sum, the probabilities are
// rounded to the cache dtype before p.v as the TPU kernel rounds them, and
// the running (max, sum, accumulator) are rescaled per block. The ragged
// last block is masked, so M need not be a block multiple. With B * H
// blocks (64 at batch 8) half the card stays empty and each block's loop is
// a chain of dependent loads: cp.async double-buffering is the later design.
//
// flash_decode_vmem replaces ::flash_decode_vmem (_decode_vmem_kernel): the
// same function as a one-pass softmax that reads the WHOLE cache whatever t
// is and masks past t.
// What bounds it: 2 * M * Dh elements per (row, head), always. Design: one
// block per (row, head), one launch. Warps walk the keys with their lanes
// along Dh (a key's row is one coalesced segment), the scores of all M keys
// stay in shared memory (4 * M bytes), max, exp and sum run over them once,
// the probabilities are rounded to the cache dtype, and p.v reads the
// values straight from device memory with Dh consecutive threads on one
// key's row.
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

// ------------------------------------- flash_decode: blocks of keys up to t

constexpr int BK = 256;   // keys per block of the loop; one thread per key

template <typename T, int DH>
__global__ void __launch_bounds__(BK)
decode_blocks_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int M, int t,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int KS = DH + 4 / (int)sizeof(T);  // odd stride in 32-bit words
  constexpr int G = BK / DH;                   // key groups of p.v
  T* ks = reinterpret_cast<T*>(smem_raw);      // [BK][KS]
  T* vs = ks + BK * KS;                        // [BK][DH]
  float* qs = reinterpret_cast<float*>(vs + BK * DH);  // [DH]
  float* prob = qs + DH;                       // [BK] rounded
  float* red = prob + BK;                      // [G][DH] = [BK]
  float* scratch = red + BK;                   // [32]
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int tb = min(t, M - 1);
  const int n_blocks = tb < 0 ? 0 : tb / BK + 1;   // cdiv(t + 1, BK)
  const T* kp = k + (size_t)bh * M * DH;
  const T* vp = v + (size_t)bh * M * DH;
  if (tid < DH) qs[tid] = to_f32(q[(size_t)bh * DH + tid]);
  const int d = tid % DH, grp = tid / DH;
  float acc = 0.f, m_run = -1e30f, l_run = 0.f;
  for (int kb = 0; kb < n_blocks; ++kb) {
    const int j0 = kb * BK;
    const int n = min(BK, M - j0);   // the ragged last block holds fewer
    __syncthreads();                 // the last block's readers are done
    for (int e = tid; e < n * DH; e += BK) {
      ks[(e / DH) * KS + e % DH] = kp[(size_t)j0 * DH + e];
      vs[e] = vp[(size_t)j0 * DH + e];
    }
    __syncthreads();
    const bool valid = tid < n && j0 + tid <= tb;
    float s = -INFINITY;
    if (valid) {
      float a = 0.f;
#pragma unroll 16
      for (int e = 0; e < DH; ++e) a += qs[e] * to_f32(ks[tid * KS + e]);
      s = a * scale;
    }
    const float m_new = fmaxf(m_run, block_max(s, scratch));
    const float p = valid ? expf(s - m_new) : 0.f;
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + block_sum(p, scratch);
    prob[tid] = round_to<T>(p);
    __syncthreads();
    float a = 0.f;
    for (int j = grp; j < n; j += G) a += prob[j] * to_f32(vs[j * DH + d]);
    red[tid] = a;
    __syncthreads();
    if (tid < DH) {
      float sum = 0.f;
      for (int gi = 0; gi < G; ++gi) sum += red[gi * DH + tid];
      acc = acc * alpha + sum;
    }
    m_run = m_new;
  }
  if (tid < DH)
    o[(size_t)bh * DH + tid] = from_f32<T>(acc / fmaxf(l_run, 1e-30f));
}

template <typename T, int DH>
size_t blocks_smem() {
  return sizeof(T) * (size_t)BK * (2 * DH + 4 / sizeof(T)) +
         sizeof(float) * (DH + 2 * BK + 32);
}

template <typename T, int DH>
int launch_blocks(const void* q, const void* k, const void* v, void* o,
                  int BH, int M, int t, float scale, cudaStream_t stream) {
  const size_t smem = blocks_smem<T, DH>();
  const cudaError_t e = allow_smem(decode_blocks_kernel<T, DH>, smem);
  if (e != cudaSuccess) return (int)e;
  decode_blocks_kernel<T, DH><<<BH, BK, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, M, t, scale);
  return (int)cudaGetLastError();
}

// --------------------------------- flash_decode_vmem: the whole cache, once

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
decode_whole_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int M, int t,
                    float scale) {
  extern __shared__ float sm[];
  constexpr int G = NT / DH;      // key groups of p.v
  float* qs = sm;                 // [DH]
  float* sc = qs + DH;            // [M] scores, then rounded probabilities
  float* red = sc + M;            // [G][DH] = [NT]
  float* scratch = red + NT;      // [32]
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tb = min(t, M - 1);
  const T* kp = k + (size_t)bh * M * DH;
  const T* vp = v + (size_t)bh * M * DH;
  if (tid < DH) qs[tid] = to_f32(q[(size_t)bh * DH + tid]);
  __syncthreads();
  // every key of the cache, valid or not: a warp per key, lanes along Dh
#pragma unroll 4
  for (int j = warp; j < M; j += NT / 32) {
    float a = 0.f;
#pragma unroll
    for (int e = lane; e < DH; e += 32)
      a += qs[e] * to_f32(kp[(size_t)j * DH + e]);
    a = warp_sum(a);
    if (lane == 0) sc[j] = j <= tb ? a * scale : -INFINITY;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int j = tid; j < M; j += NT) mx = fmaxf(mx, sc[j]);
  mx = block_max(mx, scratch);
  float sum = 0.f;
  for (int j = tid; j < M; j += NT) {
    const float p = j <= tb ? expf(sc[j] - mx) : 0.f;
    sc[j] = round_to<T>(p);
    sum += p;
  }
  const float l = block_sum(sum, scratch);   // its barriers publish sc too
  const int d = tid % DH, grp = tid / DH;
  float a = 0.f;
#pragma unroll 8
  for (int j = grp; j < M; j += G) a += sc[j] * to_f32(vp[(size_t)j * DH + d]);
  red[tid] = a;
  __syncthreads();
  if (tid < DH) {
    float s = 0.f;
    for (int gi = 0; gi < G; ++gi) s += red[gi * DH + tid];
    o[(size_t)bh * DH + tid] = from_f32<T>(s / fmaxf(l, 1e-30f));
  }
}

template <typename T, int DH>
int launch_whole(const void* q, const void* k, const void* v, void* o, int BH,
                 int M, int t, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)DH + M + NT + 32);
  const cudaError_t e = allow_smem(decode_whole_kernel<T, DH>, smem);
  if (e != cudaSuccess) return (int)e;
  decode_whole_kernel<T, DH><<<BH, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, M, t, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scalar_t(int variant, const void* q, const void* k, const void* v,
                    void* o, int BH, int M, int Dh, int t, float scale,
                    cudaStream_t stream) {
#define EAMG_DH(DH)                                                       \
  case DH:                                                                \
    return variant == 0                                                   \
               ? launch_blocks<T, DH>(q, k, v, o, BH, M, t, scale, stream) \
               : launch_whole<T, DH>(q, k, v, o, BH, M, t, scale, stream);
  switch (Dh) {
    EAMG_DH(16)
    EAMG_DH(32)
    EAMG_DH(64)
    EAMG_DH(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef EAMG_DH
}

}  // namespace

// part: f32 scratch of B * H * ceil(M / 64) * (Dh + 2) elements, from the
// caller.
extern "C" int eamg_flash_decode_sp(const void* q, const void* k,
                                    const void* v,
                                    const int* t, void* o, float* part, int B,
                                    int H, int Hkv, int M, int Dh,
                                    float scale, int dtype, void* stream) {
  if (H % Hkv != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EAMG_F32)
    return launch<float>(q, k, v, t, o, part, B, H, Hkv, M, Dh, scale, s);
  if (dtype == EAMG_BF16)
    return launch<__nv_bfloat16>(q, k, v, t, o, part, B, H, Hkv, M, Dh, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}

// flash_decode (variant 0) and flash_decode_vmem (variant 1): MHA caches
// [B * H, M, Dh], one scalar t by value. Returns cudaErrorInvalidValue when
// a block's shared memory would exceed what the card allows.
extern "C" int eamg_flash_decode_scalar_t(const void* q, const void* k,
                                          const void* v, void* o, int BH,
                                          int M, int Dh, int t, float scale,
                                          int variant, int dtype,
                                          void* stream) {
  if (BH <= 0 || M <= 0 || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EAMG_F32)
    return launch_scalar_t<float>(variant, q, k, v, o, BH, M, Dh, t, scale, s);
  if (dtype == EAMG_BF16)
    return launch_scalar_t<__nv_bfloat16>(variant, q, k, v, o, BH, M, Dh, t,
                                          scale, s);
  return (int)cudaErrorInvalidValue;
}
