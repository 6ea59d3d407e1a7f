// Fold decode: one new query per row against a position-major fused KV
// cache, all heads, per-row lengths, GQA-native.
//
// Replaces eamg_tpu/ops/decode_fold.py::flash_decode_fold_sp
// (_fold_sp_kernel) and ::flash_decode_fold3_sp (_fold3_sp_kernel), the
// decode attention of the ragged decode and the continuous-batching engine.
//
// Computes, for q [B, 1, D] in concat-heads order, kv [B, M, 2 * KVD] with
// K at [..., :KVD] and V at [..., KVD:], and the newest valid position
// t [B] per row,
//   o[b, h*Dh:(h+1)*Dh] = softmax(q[b, h] . K[b, 0..t[b], h / g] / sqrt(Dh))
//                         V[b, 0..t[b], h / g]
// into o [B, 1, D], concat-heads order again: no head split or merge
// outside the kernel. Any M is taken (the flagship's is 511); t is clamped
// to M - 1, and t = 0 over a zero cache row gives zeros.
//
// On the TPU both kernels phrase the per-head dots as 2-D matrix products
// against a block-diagonal expansion of q, and differ in the axis their
// softmax reduces along ([keys, H] against [H, keys]). Here the KV head is
// indexed directly, and the counterpart of that distinction is which way
// the threads lie:
//   variant 0 (flash_decode_fold_sp): keys across the threads of a block.
//     The split's keys and values are staged in shared memory, one thread
//     per (head, key) computes a score, a warp per head reduces max and
//     sum, one thread per (head, d) accumulates the values.
//   variant 1 (flash_decode_fold3_sp): keys walked serially by a warp whose
//     lanes span Dh. A key's row is read straight from device memory (one
//     coalesced segment per warp), the dot is a lane reduction, the softmax
//     runs online in registers; the block's four warps interleave the keys
//     of the split and are merged in warp order.
//
// What bounds it: the bytes of the valid prefix, 2 * (t + 1) * KVD elements
// per row, against 4 * H * (t + 1) * Dh flops: bound by bytes. A
// position-major row keeps one KV head's Dh elements contiguous (128 B in
// bf16 at Dh 64), so lanes along the feature axis load whole segments.
// Design: split-K. One block per (split of CH keys, KV head, row) reads its
// keys and values once for all g = H / Hkv query heads of the group. Splits
// past t[b] exit at once, so the bytes read scale with t[b], not with M. A
// second launch merges each (row, head)'s splits in a fixed order with
// max-rescaling. Split boundaries and every summation order depend on the
// key position alone, never on B, on the row's slot or on another row's t,
// so a row's output has the same bits alone and inside any batch.
// Statistics and accumulators are f32; only the output is rounded.
//
// Three more kernels, one launch each, read the WHOLE cache whatever t is
// (the uniform batched decode selects them by name):
//   flash_decode_fold  replaces ::flash_decode_fold  (_fold_kernel),
//   flash_decode_fold2 replaces ::flash_decode_fold2 (_fold2_kernel),
//   flash_decode_fold3 replaces ::flash_decode_fold3 (_fold3_kernel).
// What bounds them: 2 * M * KVD elements per row, always (8.4 MB at batch 8,
// M 511, KVD 512 in bf16), against 4 * H * M * Dh flops: bound by bytes.
// Design: a group of threads takes one batch row with all its heads. Warps
// walk the (key, KV head) pairs with their lanes along Dh, so a key's row is
// read as coalesced segments, and leave the scores of all H heads and M keys
// in shared memory (4 * H * M bytes). The softmax runs over them in place,
// and p.v reads the values straight from device memory, consecutive threads
// on consecutive features, a fixed share of the keys per thread, the shares
// summed in a fixed order. What keeps the three apart is what keeps the TPU
// kernels apart:
//   fold:  scores lie [M][H] (keys major). A head's max and sum are taken by
//     the threads whose index is that head modulo H, each over a stripe of
//     keys, and merged in stripe order. p is rounded to the cache dtype
//     UNNORMALISED; the sum divides after p.v. One block of 1024 threads per
//     row: B blocks on 132 SMs.
//   fold2: fold's arithmetic with `rows` batch rows per block, grid
//     B / rows. Every row has its own 128 threads and its own slice of shared
//     memory whatever `rows` is, and no sum crosses rows, so the result is
//     bit-equal for every `rows` (the TPU kernel masks cross-row terms off a
//     joint matrix product and is only close). At rows 4, batch 8, two
//     blocks run: the card is nearly empty. That is this kernel.
//   fold3: scores lie [H][M] (heads major). A warp takes a head with its
//     lanes along the keys, as the TPU's lane-major softmax, and p is divided
//     by the sum BEFORE it is rounded to the cache dtype and multiplied with
//     the values: in bf16 it rounds at another place than fold.
#include "common.cuh"

namespace {

constexpr int CH = 64;    // keys per split
constexpr int NT = 256;   // threads per block, variant 0
constexpr int NW = 4;     // warps per block, variant 1

// ------------------------------------------------- variant 0: block-wide

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
fold_partial_block_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                          const int* __restrict__ t,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l,
                          float* __restrict__ part_acc, int H, int Hkv, int M,
                          int q_stride, float scale, int n_split) {
  extern __shared__ float sm[];
  constexpr int KS = DH + 1;  // padded key row: conflict-free score reads
  const int g = H / Hkv;
  const int KVD = Hkv * DH;
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

  const T* qp = q + (size_t)b * q_stride + hk * g * DH;
  for (int e = tid; e < g * DH; e += NT) qs[e] = to_f32(qp[e]);
  const T* kp = kv + ((size_t)b * M + j0) * 2 * KVD + hk * DH;
  for (int e = tid; e < n * DH; e += NT) {
    const int j = e / DH, d = e % DH;
    ks[j * KS + d] = to_f32(kp[(size_t)j * 2 * KVD + d]);
    vs[e] = to_f32(kp[(size_t)j * 2 * KVD + KVD + d]);
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

// -------------------------------------------- variant 1: a warp per key

template <typename T, int DH, int G>
__global__ void __launch_bounds__(NW * 32)
fold_partial_warp_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                         const int* __restrict__ t,
                         float* __restrict__ part_m,
                         float* __restrict__ part_l,
                         float* __restrict__ part_acc, int H, int Hkv, int M,
                         int q_stride, float scale, int n_split) {
  constexpr int EPL = DH / 32;  // elements of Dh per lane
  __shared__ float wm[NW][G];
  __shared__ float wl[NW][G];
  __shared__ float wacc[NW][G][DH];
  const int KVD = Hkv * DH;
  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tb = min(t[b], M - 1);
  const int j0 = s * CH;
  if (j0 > tb) return;
  const int n = min(CH, tb + 1 - j0);

  float qr[G][EPL], acc[G][EPL], m[G], l[G];
  const T* qp = q + (size_t)b * q_stride + hk * G * DH + lane * EPL;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[gi][e] = to_f32(qp[gi * DH + e]) * scale;
      acc[gi][e] = 0.f;
    }
  }
  const T* kp = kv + ((size_t)b * M + j0) * 2 * KVD + hk * DH + lane * EPL;
  for (int j = warp; j < n; j += NW) {
    float kf[EPL], vf[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kf[e] = to_f32(kp[(size_t)j * 2 * KVD + e]);
      vf[e] = to_f32(kp[(size_t)j * 2 * KVD + KVD + e]);
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) a += qr[gi][e] * kf[e];
      const float sv = warp_sum(a);
      const float mn = fmaxf(m[gi], sv);
      const float alpha = expf(m[gi] - mn);   // 0 on the first key
      const float p = expf(sv - mn);
      l[gi] = l[gi] * alpha + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[gi][e] = acc[gi][e] * alpha + p * vf[e];
      m[gi] = mn;
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      wm[warp][gi] = m[gi];
      wl[warp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) wacc[warp][gi][lane * EPL + e] = acc[gi][e];
  }
  __syncthreads();

  // merge the warps in warp order; warp 0 always holds a key
  for (int e = threadIdx.x; e < G * DH; e += NW * 32) {
    const int gi = e / DH, d = e % DH;
    float mx = wm[0][gi];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, wm[w][gi]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(wm[w][gi] - mx);   // 0 for a warp with no key
      L += wl[w][gi] * c;
      A += wacc[w][gi][d] * c;
    }
    const size_t pi = ((size_t)b * H + hk * G + gi) * n_split + s;
    part_acc[pi * DH + d] = A;
    if (d == 0) {
      part_m[pi] = mx;
      part_l[pi] = L;
    }
  }
}

// ------------------------------------------------------- merge the splits

template <typename T>
__global__ void fold_combine_kernel(const float* __restrict__ part_m,
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

struct Args {
  const void* q;
  const void* kv;
  const int* t;
  void* o;
  float* part;
  int B, H, Hkv, M, q_stride;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DH>
int launch_block(const Args& a, float* pm, float* pl, float* pa, int n_split) {
  const int g = a.H / a.Hkv;
  const size_t smem =
      sizeof(float) * (g * DH + CH * (DH + 1) + CH * DH + g * CH);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fold_partial_block_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fold_partial_block_kernel<T, DH>
      <<<dim3(n_split, a.Hkv, a.B), NT, smem, a.stream>>>(
          (const T*)a.q, (const T*)a.kv, a.t, pm, pl, pa, a.H, a.Hkv, a.M,
          a.q_stride, a.scale, n_split);
  return (int)cudaGetLastError();
}

template <typename T, int DH, int G>
int launch_warp_g(const Args& a, float* pm, float* pl, float* pa,
                  int n_split) {
  fold_partial_warp_kernel<T, DH, G>
      <<<dim3(n_split, a.Hkv, a.B), NW * 32, 0, a.stream>>>(
          (const T*)a.q, (const T*)a.kv, a.t, pm, pl, pa, a.H, a.Hkv, a.M,
          a.q_stride, a.scale, n_split);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_warp(const Args& a, float* pm, float* pl, float* pa, int n_split) {
  switch (a.H / a.Hkv) {
    case 1: return launch_warp_g<T, DH, 1>(a, pm, pl, pa, n_split);
    case 2: return launch_warp_g<T, DH, 2>(a, pm, pl, pa, n_split);
    case 4: return launch_warp_g<T, DH, 4>(a, pm, pl, pa, n_split);
    case 8: return launch_warp_g<T, DH, 8>(a, pm, pl, pa, n_split);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int DH>
int launch_dh(const Args& a, int variant) {
  const int n_split = (a.M + CH - 1) / CH;
  const size_t np = (size_t)a.B * a.H * n_split;
  float* pm = a.part;
  float* pl = a.part + np;
  float* pa = a.part + 2 * np;
  // variant 1 folds the scale into q; variant 0 scales the scores
  const int err = variant == 0 ? launch_block<T, DH>(a, pm, pl, pa, n_split)
                               : launch_warp<T, DH>(a, pm, pl, pa, n_split);
  if (err) return err;
  fold_combine_kernel<T><<<dim3(a.H, a.B), DH, 0, a.stream>>>(
      pm, pl, pa, a.t, (T*)a.o, a.H, a.M, DH, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int Dh, int variant) {
  switch (Dh) {
    case 32: return launch_dh<T, 32>(a, variant);
    case 64: return launch_dh<T, 64>(a, variant);
    case 128: return launch_dh<T, 128>(a, variant);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------- one launch over the whole cache: fold, fold2, fold3

constexpr int NT_ROW = 1024;  // threads on a batch row: fold, fold3
constexpr int TPR = 128;      // threads on each batch row: fold2

// shared floats a batch row needs when n threads work on it
__host__ __device__ inline size_t row_floats(int H, int M, int Dh, int n) {
  const int D = H * Dh;
  return (size_t)D + (size_t)H * M + (size_t)(n > D ? n : D) + 2 * H;
}

// One batch row: q row qp [H * DH], cache row kvp [M, 2 * KVD], output op
// [H * DH], newest valid position tb (already clamped to M - 1), by the n
// threads tid = 0..n-1 of one group, on the group's shared slice sm. Every
// group of a block runs this in step: the barriers are the block's, and all
// loops that hold one are bounded by M and H alone.
template <typename T, int DH, bool HEADS_MAJOR>
__device__ __forceinline__ void fold_row(const T* __restrict__ qp,
                                         const T* __restrict__ kvp,
                                         T* __restrict__ op, int tb, int H,
                                         int Hkv, int M, float scale,
                                         float* sm, int tid, int n) {
  constexpr int EPL = DH / 32;  // elements of Dh per lane
  const int g = H / Hkv, KVD = Hkv * DH, D = H * DH;
  float* qs = sm;                        // [D]
  float* sc = qs + D;                    // [M][H] or [H][M]
  float* red = sc + (size_t)H * M;       // [max(n, D)]
  float* stat = red + (n > D ? n : D);   // max [H], sum [H]
  const int warp = tid / 32, lane = tid % 32, nw = n / 32;

  for (int e = tid; e < D; e += n) qs[e] = to_f32(qp[e]);
  __syncthreads();

  // scores of every key, valid or not: a warp per (key, KV head)
#pragma unroll 2
  for (int it = warp; it < M * Hkv; it += nw) {
    const int j = it / Hkv, hk = it % Hkv;
    const T* kr = kvp + (size_t)j * 2 * KVD + hk * DH + lane;
    float kf[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) kf[i] = to_f32(kr[32 * i]);
    for (int gi = 0; gi < g; ++gi) {
      const int h = hk * g + gi;
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) a += qs[h * DH + lane + 32 * i] * kf[i];
      a = warp_sum(a);
      if (lane == 0)
        sc[HEADS_MAJOR ? (size_t)h * M + j : (size_t)j * H + h] =
            j <= tb ? a * scale : -INFINITY;
    }
  }
  __syncthreads();

  if (HEADS_MAJOR) {
    // a warp per head, lanes along the keys; p normalised, then rounded
    for (int h = warp; h < H; h += nw) {
      float* row = sc + (size_t)h * M;
      float mx = -INFINITY;
      for (int j = lane; j < M; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < M; j += 32) {
        const float p = j <= tb ? expf(row[j] - mx) : 0.f;
        row[j] = p;
        sum += p;
      }
      const float l = fmaxf(warp_sum(sum), 1e-30f);
      for (int j = lane; j < M; j += 32) row[j] = round_to<T>(row[j] / l);
    }
    __syncthreads();
  } else {
    // thread tid serves head tid % H over the keys tid / H, + n / H, ...
    const int h = tid % H, stripe = tid / H, ns = n / H;
    float mx = -INFINITY;
    for (int j = stripe; j < M; j += ns) mx = fmaxf(mx, sc[(size_t)j * H + h]);
    red[tid] = mx;
    __syncthreads();
    if (tid < H) {
      float r = red[tid];
      for (int s = 1; s < ns; ++s) r = fmaxf(r, red[s * H + tid]);
      stat[tid] = r;
    }
    __syncthreads();
    mx = stat[h];
    float sum = 0.f;
    for (int j = stripe; j < M; j += ns) {
      const float p = j <= tb ? expf(sc[(size_t)j * H + h] - mx) : 0.f;
      sc[(size_t)j * H + h] = round_to<T>(p);   // unnormalised
      sum += p;
    }
    red[tid] = sum;
    __syncthreads();
    if (tid < H) {
      float r = 0.f;
      for (int s = 0; s < ns; ++s) r += red[s * H + tid];
      stat[H + tid] = r;
    }
    __syncthreads();
  }

  // p.v: G shares of the keys for each of the D outputs
  const int G = n > D ? n / D : 1;
  for (int e = tid; e < G * D; e += n) {
    const int grp = e / D, c = e % D, h = c / DH;
    const T* vp = kvp + KVD + (h / g) * DH + c % DH;
    float a = 0.f;
#pragma unroll 8
    for (int j = grp; j < M; j += G)
      a += sc[HEADS_MAJOR ? (size_t)h * M + j : (size_t)j * H + h] *
           to_f32(vp[(size_t)j * 2 * KVD]);
    red[e] = a;
  }
  __syncthreads();
  for (int c = tid; c < D; c += n) {
    float a = 0.f;
    for (int gi = 0; gi < G; ++gi) a += red[gi * D + c];
    if (!HEADS_MAJOR) a /= fmaxf(stat[H + c / DH], 1e-30f);
    op[c] = from_f32<T>(a);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT_ROW)
fold_whole_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                  const int* __restrict__ t, T* __restrict__ o, int H,
                  int Hkv, int M, int q_stride, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  fold_row<T, DH, false>(q + (size_t)b * q_stride,
                         kv + (size_t)b * M * 2 * Hkv * DH,
                         o + (size_t)b * H * DH, min(t[b], M - 1), H, Hkv, M,
                         scale, sm, threadIdx.x, NT_ROW);
}

template <typename T, int DH>
__global__ void __launch_bounds__(1024)
fold2_rows_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                  const int* __restrict__ t, T* __restrict__ o, int H,
                  int Hkv, int M, int q_stride, float scale, int rows) {
  extern __shared__ float sm[];
  const int r = threadIdx.x / TPR;
  const int b = blockIdx.x * rows + r;
  fold_row<T, DH, false>(q + (size_t)b * q_stride,
                         kv + (size_t)b * M * 2 * Hkv * DH,
                         o + (size_t)b * H * DH, min(t[b], M - 1), H, Hkv, M,
                         scale, sm + r * row_floats(H, M, DH, TPR),
                         threadIdx.x % TPR, TPR);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT_ROW)
fold3_whole_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                   const int* __restrict__ t, T* __restrict__ o, int H,
                   int Hkv, int M, int q_stride, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  fold_row<T, DH, true>(q + (size_t)b * q_stride,
                        kv + (size_t)b * M * 2 * Hkv * DH,
                        o + (size_t)b * H * DH, min(t[b], M - 1), H, Hkv, M,
                        scale, sm, threadIdx.x, NT_ROW);
}

template <typename T, int DH>
int launch_whole_dh(const Args& a, int mode, int rows) {
  const T* q = (const T*)a.q;
  const T* kv = (const T*)a.kv;
  T* o = (T*)a.o;
  if (mode == 1) {
    if (rows <= 0 || a.B % rows != 0 || rows * TPR > 1024 || TPR % a.H != 0)
      return (int)cudaErrorInvalidValue;
    const size_t smem =
        sizeof(float) * rows * row_floats(a.H, a.M, DH, TPR);
    const cudaError_t e = allow_smem(fold2_rows_kernel<T, DH>, smem);
    if (e != cudaSuccess) return (int)e;
    fold2_rows_kernel<T, DH><<<a.B / rows, rows * TPR, smem, a.stream>>>(
        q, kv, a.t, o, a.H, a.Hkv, a.M, a.q_stride, a.scale, rows);
    return (int)cudaGetLastError();
  }
  if (NT_ROW % a.H != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * row_floats(a.H, a.M, DH, NT_ROW);
  if (mode == 0) {
    const cudaError_t e = allow_smem(fold_whole_kernel<T, DH>, smem);
    if (e != cudaSuccess) return (int)e;
    fold_whole_kernel<T, DH><<<a.B, NT_ROW, smem, a.stream>>>(
        q, kv, a.t, o, a.H, a.Hkv, a.M, a.q_stride, a.scale);
  } else {
    const cudaError_t e = allow_smem(fold3_whole_kernel<T, DH>, smem);
    if (e != cudaSuccess) return (int)e;
    fold3_whole_kernel<T, DH><<<a.B, NT_ROW, smem, a.stream>>>(
        q, kv, a.t, o, a.H, a.Hkv, a.M, a.q_stride, a.scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_whole(const Args& a, int Dh, int mode, int rows) {
  switch (Dh) {
    case 32: return launch_whole_dh<T, 32>(a, mode, rows);
    case 64: return launch_whole_dh<T, 64>(a, mode, rows);
    case 128: return launch_whole_dh<T, 128>(a, mode, rows);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q_stride: elements between the rows of q (a row's D elements are
// contiguous), so q may be the head of a fused QKV projection. part: f32
// scratch of B * H * ceil(M / 64) * (Dh + 2) elements, from the caller.
// variant 0: keys across a block's threads; 1: a warp per key.
extern "C" int eamg_fold_decode(const void* q, const void* kv, const int* t,
                                void* o, float* part, int B, int H, int Hkv,
                                int M, int Dh, int q_stride, float scale,
                                int variant, int dtype, void* stream) {
  if (H % Hkv != 0 || M <= 0 || B <= 0 || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  const Args a = {q, kv, t, o, part, B, H, Hkv, M, q_stride, scale,
                  (cudaStream_t)stream};
  if (dtype == EAMG_F32) return launch<float>(a, Dh, variant);
  if (dtype == EAMG_BF16) return launch<__nv_bfloat16>(a, Dh, variant);
  return (int)cudaErrorInvalidValue;
}

// The one-launch kernels over the whole cache. mode 0: flash_decode_fold,
// 1: flash_decode_fold2 with `rows` batch rows per block (B % rows == 0,
// rows <= 8), 2: flash_decode_fold3. q_stride as above; no scratch. Returns
// cudaErrorInvalidValue when a block's shared memory (4 * H * M bytes of
// scores and a little more, per batch row of the block) would exceed what
// the card allows.
extern "C" int eamg_fold_decode_whole(const void* q, const void* kv,
                                      const int* t, void* o, int B, int H,
                                      int Hkv, int M, int Dh, int q_stride,
                                      float scale, int mode, int rows,
                                      int dtype, void* stream) {
  if (H % Hkv != 0 || M <= 0 || B <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const Args a = {q, kv, t, o, nullptr, B, H, Hkv, M, q_stride, scale,
                  (cudaStream_t)stream};
  if (dtype == EAMG_F32) return launch_whole<float>(a, Dh, mode, rows);
  if (dtype == EAMG_BF16) return launch_whole<__nv_bfloat16>(a, Dh, mode, rows);
  return (int)cudaErrorInvalidValue;
}
