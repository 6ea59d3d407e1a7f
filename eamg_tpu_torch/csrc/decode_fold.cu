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
// One more kernel, one launch, for the uniform batched decode, which
// selects it by name. What bounds it: the bytes of the prefix 0..t of each
// row, 2 * (t + 1) * KVD elements (4.9 MB at batch 8, t 300, KVD 512 in
// bf16), against 4 * H * (t + 1) * Dh flops, about one flop a byte at MHA:
// bound by bytes, far below where tensor cores would matter. It is
// fold_cluster_kernel, and it replaces three TPU kernels:
//   ::flash_decode_fold (_fold_kernel) and ::flash_decode_fold2
//     (_fold2_kernel), which compute one function with one rounding and
//     differ only in the batch rows of a program: p is rounded to the cache
//     dtype UNNORMALISED and the f32 sum divides after p.v;
//   ::flash_decode_fold3 (_fold3_kernel), which divides p by the sum BEFORE
//     it rounds p, so in bf16 it rounds at another place.
// The cluster design puts many SMs and many bytes in flight on each row:
//   - a cluster of C blocks per batch row (B * C blocks: 128 at batch 8 and
//     C 16, where a block per row gave 8 on 132 SMs). C is 16 (a
//     non-portable size) wherever the card can place a cluster of 16
//     blocks of the shape, else 8: the wrapper asks
//     eamg_fold_cluster_occupancy (ops/decode_fold.py::cluster_size).
//     The row's valid keys 0..t[b] are cut into C ranges in rank order,
//     ceil((t[b] + 1) / C) keys each (fewer at the end): every block of the
//     row stages an equal share of the prefix, so the bytes read scale with
//     t and spread over the whole cluster (at t 300 and M 511 a block with
//     ranges fixed by M left 6 of 16 blocks idle and gave the others 64 KB
//     each: the staging time follows a block's bytes, PERF.md). The ranges
//     depend on the row's own t alone; a block with no key still joins
//     every cluster barrier, with max -inf, sum 0 and partials 0 (fold2's
//     two barriers, fold3's three);
//   - the block's keys are one contiguous slab of the position-major row, K
//     and V together. It is staged in shared memory in chunks by 16-byte
//     cp.async copies of every thread, all in flight at once where the slab
//     fits (then p.v reads V from there too), else in a ring of slots with V
//     read again from device memory;
//   - a score: the lanes of a (key, KV head) row load 16 bytes each (8 lanes
//     at Dh 64 in bf16, so a warp scores 4 rows a load) and sum in a shuffle
//     tree within the row's lanes, for all g query heads of the KV head;
//   - the softmax across the cluster, through distributed shared memory
//     by stores only (a remote store is fire and forget, a remote load a
//     round trip): each block pushes its per-head max into row `rank` of
//     every block's table, and after a cluster barrier each reads the C rows
//     in rank order, so all hold the same global max; the sums go the same
//     way (fold3 with a barrier of their own, before it rounds p); each
//     block accumulates its f32 partial [H, Dh] with lanes along Dh and
//     pushes each output into the inbox of the block that owns it, block r
//     owning a share ceil(D / C) of the outputs; after the cluster's last
//     barrier block r sums its inbox in rank order (fold2 divides by the C
//     sums in rank order) and rounds once. No block reads or writes
//     another's memory after that barrier, so none waits for the others to
//     leave. q is loaded beside t, and the slab copies are issued as
//     soon as t is read.
// Every order depends on the rank, the key position and the row's own t
// alone, never on B, on `rows` or on another row, so flash_decode_fold2 is
// bit-equal for every `rows` and a row gets the same bits alone and inside
// a batch.
//
// Built a second time with -DEAMG_PHASE_TIMING (ops/_build.py, library
// decode_fold_timed) for chip_smoke.py's kernel phase alone, which no path
// of the port loads: thread 0 of every block of fold_cluster_kernel then
// records %globaltimer and clock64 at each phase boundary (common.cuh,
// PHASE_STAMP), and two empty kernels (one block; B clusters of C blocks
// with a given number of cluster barriers) give the floor of that way of
// timing.
#include <cooperative_groups.h>

#include <algorithm>

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

// -- flash_decode_fold, _fold2 and _fold3: a cluster of blocks per row

constexpr int NT_CL = 256;             // threads of a cluster's block
constexpr int NW_CL = NT_CL / 32;
// blocks in a batch row's cluster, at most: 16 is the most a cluster may
// hold on sm_90 (non-portable); the tables every block pushes into have a
// row for each
constexpr int CL_MAX = 16;
constexpr int QPF = 4;                 // elements of q a thread prefetches
constexpr size_t CHUNK_BYTES = 16384;  // a staged chunk of keys, at most
// the staging slots of a block, at most: at the batched decode's shape the
// rest of its shared memory is small enough that two blocks fit on an SM.
// A shape whose block needs more fits one; the cluster size follows what
// the card reports (eamg_fold_cluster_occupancy).
constexpr size_t SLOT_BUDGET = 96 * 1024;

// the phase boundaries of fold_cluster_kernel that a timed build stamps:
// entry, t read and the slab issued and q loaded, first chunk staged,
// scores (every chunk staged and scored), max exchanged, p (fold3: sums
// exchanged), p.v partials pushed, output barrier, outputs stored
constexpr int N_STAMP = 9;
#define FOLD_STAMP(i) PHASE_STAMP(i, N_STAMP)

// Byte offsets into a cluster block's shared memory; the launcher and the
// kernel compute them from the same arguments. xm, xs and inbox are written
// by the other blocks of the cluster (each pushes its values into row
// `rank` of every block, or of the block that owns them).
struct ClusterSmem {
  size_t slots, qs, sc, red, xm, xs, gm, gs, inbox, total;
  __host__ __device__ ClusterSmem(int D, int H, int R, int KG,
                                  size_t slot_bytes, int nslot) {
    size_t off = 0;
    slots = off;
    off += (size_t)nslot * slot_bytes;  // [nslot][NK keys][2 * KVD] of T
    qs = off;
    off += sizeof(float) * D;           // q row, f32
    sc = off;
    off += sizeof(float) * H * R;       // [H][R] scores, then p
    red = off;
    off += sizeof(float) * KG * D;      // p.v of each key group
    xm = off;
    off += sizeof(float) * CL_MAX * H;  // every block's max [C][H]
    xs = off;
    off += sizeof(float) * CL_MAX * H;  // every block's sum [C][H]
    gm = off;
    off += sizeof(float) * H;           // global max [H]
    gs = off;
    off += sizeof(float) * H;           // global sum [H] (fold3)
    inbox = off;                        // every block's partial of this
    off += sizeof(float) * (D + CL_MAX);  // block's share [C][ceil(D / C)]
    total = off;
  }
};

// wait until at most n of this thread's groups are in flight (7 if more)
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Grid (C, B), clusters of (C, 1, 1): block rank r of batch row b takes the
// keys [r * Rt, (r + 1) * Rt) of the row's t[b] + 1 valid ones, Rt =
// ceil((t[b] + 1) / C), cut at t[b] + 1, R = ceil(M / C) of them at most; NK keys a staged chunk,
// nslot chunk slots. BEFORE: fold3's rounding (p / sum rounded), else
// fold2's.
template <typename T, int DH, bool BEFORE>
__global__ void __launch_bounds__(NT_CL)
fold_cluster_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                    const int* __restrict__ t, T* __restrict__ o, int H,
                    int Hkv, int M, int q_stride, float scale,
                    int R, int NK, int nslot) {
  namespace cg = cooperative_groups;
  constexpr int VE = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int LPR = DH / VE;        // lanes on a (key, KV head) row
  constexpr int RPW = 32 / LPR;       // such rows a warp loads at once
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), b = blockIdx.y;
  const int C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = H / Hkv, KVD = Hkv * DH, D = H * DH, RW = 2 * KVD;
  const int KG = max(1, NT_CL / (D / VE));  // key groups of p.v
  const ClusterSmem L(D, H, R, KG, (size_t)NK * RW * sizeof(T), nslot);
  T* slot = reinterpret_cast<T*>(smem + L.slots);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* xm = reinterpret_cast<float*>(smem + L.xm);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* gm = reinterpret_cast<float*>(smem + L.gm);
  float* gs = reinterpret_cast<float*>(smem + L.gs);
  float* inbox = reinterpret_cast<float*>(smem + L.inbox);

  FOLD_STAMP(0);
  // another block's memory may be written only once it runs: arrive now,
  // wait before the first push
  cluster_arrive();
  // q's loads in flight beside t's (the first QPF * NT_CL elements)
  const T* qp = q + (size_t)b * q_stride;
  float qv[QPF];
#pragma unroll
  for (int i = 0; i < QPF; ++i) {
    const int e = tid + i * NT_CL;
    qv[i] = e < D ? to_f32(qp[e]) : 0.f;
  }
  // this block's valid keys: [s0, s0 + n), n = 0 past t[b]
  const int tb = min(t[b], M - 1);
  const int nv = tb + 1, Rt = (nv + C - 1) / C;
  const int s0 = min(r * Rt, nv);
  const int n = min(s0 + Rt, nv) - s0;
  const int nch = (n + NK - 1) / NK;
  const bool resident = nch <= nslot;   // the whole slab stays in place
  const T* src = kv + ((size_t)b * M + s0) * RW;

  // chunk c: keys [c * NK, min(n, (c + 1) * NK)) into slot c % nslot
  auto issue = [&](int c) {
    const uint32_t bytes =
        (uint32_t)(min(NK, n - c * NK) * RW * (int)sizeof(T));
    char* dst = reinterpret_cast<char*>(slot + (size_t)(c % nslot) * NK * RW);
    const char* from = reinterpret_cast<const char*>(src + (size_t)c * NK * RW);
    for (uint32_t p = tid; p < bytes / 16; p += NT_CL)
      cp_async16(dst + 16 * p, from + 16 * p);
    cp_async_commit();
  };
  int issued = 0;
  for (; issued < min(nch, nslot); ++issued) issue(issued);
  // q, read after the first wait's barrier
#pragma unroll
  for (int i = 0; i < QPF; ++i)
    if (tid + i * NT_CL < D) qs[tid + i * NT_CL] = qv[i];
  for (int e = tid + QPF * NT_CL; e < D; e += NT_CL) qs[e] = to_f32(qp[e]);
  FOLD_STAMP(1);

  // scores: the RPW rows of a warp load lie on lanes [LPR * i, LPR * (i+1))
  for (int c = 0; c < nch; ++c) {
    cp_async_wait_pending(issued - c - 1);
    __syncthreads();
    if (c == 0) FOLD_STAMP(2);
    const T* ks = slot + (size_t)(c % nslot) * NK * RW;
    const int pairs = min(NK, n - c * NK) * Hkv;
    const int sub = lane % LPR;
    for (int base = warp * RPW; base < pairs; base += NW_CL * RPW) {
      const int it = base + lane / LPR;
      const bool ok = it < pairs;
      const int jj = ok ? it / Hkv : 0, hk = ok ? it % Hkv : 0;
      float kf[VE];
      load16(ks + (size_t)jj * RW + hk * DH + sub * VE, kf);
      for (int gi = 0; gi < g; ++gi) {
        const int h = hk * g + gi;
        const float* qh = qs + h * DH + sub * VE;
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < VE; ++e) a += qh[e] * kf[e];
#pragma unroll
        for (int w = LPR / 2; w > 0; w >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, w);
        if (ok && sub == 0) sc[(size_t)h * R + c * NK + jj] = a * scale;
      }
    }
    __syncthreads();   // slot c % nslot is free again
    if (issued < nch) issue(issued++);
  }
  FOLD_STAMP(3);

  // the global max of each head, the same in every block of the cluster:
  // each block pushes its max into row r of every block's xm, then reads
  // the C rows in rank order
  cluster_wait();
  for (int h = warp; h < H; h += NW_CL) {
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sc[(size_t)h * R + j]);
    mx = warp_max(mx);
    if (lane < C) *cluster.map_shared_rank(xm + r * H + h, lane) = mx;
  }
  cluster.sync();
  for (int h = tid; h < H; h += NT_CL) {
    float m = xm[h];
    for (int k = 1; k < C; ++k) m = fmaxf(m, xm[k * H + h]);
    gm[h] = m;
  }
  __syncthreads();
  FOLD_STAMP(4);

  // p = exp(s - max): rounded now (fold2), or after the global sum (fold3);
  // each block's sums pushed into row r of every block's xs
  for (int h = warp; h < H; h += NW_CL) {
    const float mx = gm[h];
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sc[(size_t)h * R + j] - mx);
      sc[(size_t)h * R + j] = BEFORE ? p : round_to<T>(p);
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane < C) *cluster.map_shared_rank(xs + r * H + h, lane) = sum;
  }
  if (BEFORE) {
    cluster.sync();
    for (int h = tid; h < H; h += NT_CL) {
      float a = 0.f;
      for (int k = 0; k < C; ++k) a += xs[k * H + h];
      gs[h] = fmaxf(a, 1e-30f);
    }
    __syncthreads();
    for (int e = tid; e < H * n; e += NT_CL) {
      const int h = e / n, j = e % n;
      sc[(size_t)h * R + j] = round_to<T>(sc[(size_t)h * R + j] / gs[h]);
    }
  }
  __syncthreads();
  FOLD_STAMP(5);

  // the block's partial [H, Dh]: KG groups of keys, VE outputs a thread,
  // V from the resident slab or again from device memory
  const int NV = D / VE;
  const T* vbase = (resident ? slot : src) + KVD;
  for (int e = tid; e < KG * NV; e += NT_CL) {
    const int grp = e / NV, c0 = (e % NV) * VE, h = c0 / DH;
    const T* vp = vbase + (h / g) * DH + c0 % DH;
    const float* ph = sc + (size_t)h * R;
    float acc[VE];
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[i] = 0.f;
    for (int j = grp; j < n; j += KG) {
      float vf[VE];
      load16(vp + (size_t)j * RW, vf);
      const float p = ph[j];
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[i] += p * vf[i];
    }
#pragma unroll
    for (int i = 0; i < VE; ++i) red[(size_t)grp * D + c0 + i] = acc[i];
  }
  __syncthreads();
  // output c belongs to block c / per: pushed into row r of its inbox
  const int per = (D + C - 1) / C;
  for (int c = tid; c < D; c += NT_CL) {
    float a = 0.f;
    for (int k = 0; k < KG; ++k) a += red[(size_t)k * D + c];
    const int owner = c / per;
    *cluster.map_shared_rank(inbox + r * per + c - owner * per, owner) = a;
  }
  FOLD_STAMP(6);
  // every push is in place; no block touches another's memory after this,
  // so none waits for the others to leave
  cluster.sync();
  FOLD_STAMP(7);

  // block r: its share of the outputs, the C partials summed in rank order
  // (fold2 divides by the C sums in rank order)
  const int c_end = min(D, (r + 1) * per);
  for (int c = r * per + tid; c < c_end; c += NT_CL) {
    float a = 0.f;
    for (int k = 0; k < C; ++k) a += inbox[k * per + c - r * per];
    if (!BEFORE) {
      float sum = 0.f;
      for (int k = 0; k < C; ++k) sum += xs[k * H + c / DH];
      a /= fmaxf(sum, 1e-30f);
    }
    o[(size_t)b * D + c] = from_f32<T>(a);
  }
  FOLD_STAMP(8);
}

// How a cluster block of the kernel stages R keys: NK keys a chunk, nslot
// slots, and its shared memory in bytes.
struct ClusterShape {
  int NK, nslot;
  size_t smem;
};

template <typename T, int DH>
ClusterShape cluster_shape(int H, int Hkv, int R) {
  constexpr int VE = 16 / sizeof(T);
  const int D = H * DH;
  const size_t row_bytes = (size_t)2 * Hkv * DH * sizeof(T);
  const int NK = std::max(1, std::min(R, (int)(CHUNK_BYTES / row_bytes)));
  const int nch = (R + NK - 1) / NK;
  const int nslot = std::min(
      nch, std::max(2, (int)(SLOT_BUDGET / ((size_t)NK * row_bytes))));
  const int KG = std::max(1, NT_CL / (D / VE));
  return {NK, nslot,
          ClusterSmem(D, H, R, KG, (size_t)NK * row_bytes, nslot).total};
}

// Lets the kernel take `bytes` of shared memory and clusters of 16 blocks
template <typename T, int DH, bool BEFORE>
cudaError_t prepare_cluster(size_t bytes) {
  static ClusterAllowance allowed;
  return allow_cluster(fold_cluster_kernel<T, DH, BEFORE>, bytes, allowed);
}

template <typename T, int DH, bool BEFORE>
int launch_cluster_k(const Args& a, int C, int R) {
  const ClusterShape s = cluster_shape<T, DH>(a.H, a.Hkv, R);
  cudaError_t e = prepare_cluster<T, DH, BEFORE>(s.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(C, a.B, NT_CL, s.smem,
                                                a.stream, &attr);
  e = cudaLaunchKernelEx(&cfg, fold_cluster_kernel<T, DH, BEFORE>,
                         (const T*)a.q, (const T*)a.kv, a.t, (T*)a.o, a.H,
                         a.Hkv, a.M, a.q_stride, a.scale, R, s.NK,
                         s.nslot);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of C blocks, R keys a block, the card keeps resident at
// once (0 where a block's shared memory would exceed what it allows).
template <typename T, int DH, bool BEFORE>
int occupancy_k(int H, int Hkv, int C, int R, int* active) {
  const ClusterShape s = cluster_shape<T, DH>(H, Hkv, R);
  *active = 0;
  if (s.smem > EAMG_MAX_SMEM) return 0;
  cudaError_t e = prepare_cluster<T, DH, BEFORE>(s.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(C, 1, NT_CL, s.smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      active, fold_cluster_kernel<T, DH, BEFORE>, &cfg);
}

// f(T{}, Int<DH>{}, Bool<BEFORE>{}) for the runtime dtype, Dh and rounding
template <typename F>
int by_instance(int dtype, int Dh, bool before, F&& f) {
  auto with_t = [&](auto t) {
    auto with_dh = [&](auto dh) {
      return before ? f(t, dh, Bool<true>{}) : f(t, dh, Bool<false>{});
    };
    switch (Dh) {
      case 32: return with_dh(Int<32>{});
      case 64: return with_dh(Int<64>{});
      case 128: return with_dh(Int<128>{});
      default: return (int)cudaErrorInvalidValue;
    }
  };
  if (dtype == EAMG_F32) return with_t(float{});
  if (dtype == EAMG_BF16) return with_t(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
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

// flash_decode_fold and _fold2 (before 0) and flash_decode_fold3 (before
// 1): a cluster of C blocks per batch row (C 1, 2, 4, 8 or 16); block rank
// r of row b takes the keys [r * Rt, (r + 1) * Rt) of the row's valid
// t[b] + 1, Rt = ceil((t[b] + 1) / C), cut at t[b] + 1, staged by every thread's 16-byte copies. q_stride as above; kv 16-byte
// aligned. Returns cudaErrorInvalidValue when a block's shared memory (the
// staging slots, 4 * H * ceil(M / C) bytes of scores and a little more)
// would exceed what the card allows; a cluster the card cannot place comes
// back as CUDA's own error.
extern "C" int eamg_fold_decode_cluster(const void* q, const void* kv,
                                        const int* t, void* o, int B, int H,
                                        int Hkv, int M, int Dh, int q_stride,
                                        float scale, int before, int C,
                                        int dtype, void* stream) {
  if (H % Hkv != 0 || M <= 0 || B <= 0 || C < 1 || C > CL_MAX ||
      (C & (C - 1)))
    return (int)cudaErrorInvalidValue;
  const Args a = {q, kv, t, o, nullptr, B, H, Hkv, M, q_stride, scale,
                  (cudaStream_t)stream};
  return by_instance(dtype, Dh, before != 0, [&](auto t_, auto dh, auto bf) {
    return launch_cluster_k<decltype(t_), decltype(dh)::value,
                            decltype(bf)::value>(a, C, (M + C - 1) / C);
  });
}

// How many clusters of flash_decode_fold2 (before 0) or _fold3 (before 1)
// the card keeps resident at once, at the shape (H, Hkv, Dh, dtype) and R
// keys a block, with C blocks a cluster: into *active (0 where a block
// would need more shared memory than the card allows).
extern "C" int eamg_fold_cluster_occupancy(int H, int Hkv, int Dh, int R,
                                           int before, int C, int dtype,
                                           int* active) {
  if (Hkv <= 0 || H % Hkv != 0 || R < 1 || C < 1 || C > CL_MAX ||
      (C & (C - 1)))
    return (int)cudaErrorInvalidValue;
  return by_instance(dtype, Dh, before != 0, [&](auto t_, auto dh, auto bf) {
    return occupancy_k<decltype(t_), decltype(dh)::value,
                       decltype(bf)::value>(H, Hkv, C, R, active);
  });
}

#ifdef EAMG_PHASE_TIMING
namespace {

__global__ void empty_kernel() {}

__global__ void empty_cluster_kernel(int barriers) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  for (int i = 0; i < barriers; ++i) cluster.sync();
}

}  // namespace

// The shared memory of a cluster block of fold_cluster_kernel at the shape,
// R keys a block, into *bytes (as the launcher computes it).
extern "C" int eamg_fold_cluster_smem(int H, int Hkv, int Dh, int R,
                                      int dtype, long long* bytes) {
  if (Hkv <= 0 || H % Hkv != 0 || R < 1) return (int)cudaErrorInvalidValue;
  return by_instance(dtype, Dh, false, [&](auto t_, auto dh, auto) {
    *bytes = (long long)cluster_shape<decltype(t_), decltype(dh)::value>(
                 H, Hkv, R).smem;
    return 0;
  });
}

// C 0: one empty block of 32 threads. Else B clusters of C empty blocks of
// 256 threads and `smem` bytes of shared memory, each block passing
// `barriers` cluster barriers.
extern "C" int eamg_empty_launch(int C, int B, long long smem, int barriers,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 0) {
    empty_kernel<<<1, 32, 0, s>>>();
    return (int)cudaGetLastError();
  }
  if (C < 1 || C > CL_MAX || B < 1 || smem < 1)
    return (int)cudaErrorInvalidValue;
  static ClusterAllowance allowed;
  cudaError_t e = allow_cluster(empty_cluster_kernel, (size_t)smem, allowed);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(C, B, NT_CL, (size_t)smem, s, &attr);
  e = cudaLaunchKernelEx(&cfg, empty_cluster_kernel, barriers);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
#endif
