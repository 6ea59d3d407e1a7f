// Single-query cached attention over a head-major cache: K3 (two kernels)
// and the scalar-t cluster kernel.
//
// All compute, for q [B, H, 1, Dh] and caches [B, Hkv, M, Dh],
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
// flash_decode and flash_decode_vmem: one kernel, decode_cluster_kernel,
// with a template flag, BLOCKED, for where the probabilities are rounded.
// Both take MHA caches and one scalar t by value, and compute the same
// function with statistics in f32. The flag replaces:
//   - BLOCKED (flash_decode): eamg_tpu/ops/decode_attention.py::
//     flash_decode (_decode_kernel), an online softmax over 256-key blocks
//     copied by hand up to cdiv(t + 1, 256): for a key of block kb,
//     p = exp(s - m_cur) with m_cur the running max after block kb (the max
//     over keys 0..min(t, 256 (kb + 1) - 1)), p rounded to the cache dtype
//     before p.v, the sum l from the unrounded p;
//   - !BLOCKED (flash_decode_vmem): ::flash_decode_vmem
//     (_decode_vmem_kernel), one pass over the whole cache with the global
//     max. It reads all M keys and masks past t; this kernel reads keys
//     0..t only. A masked key's p is exactly 0 there, so the function is
//     the same for any finite cache contents; one exception: a non-finite
//     value past t gives NaN in JAX's kernel (0 * inf) and not here.
// What bounds it: the bytes of keys and values 0..t, q and o, 2 (t + 1) Dh
// elements per (row, head) (4.9 MB at the batched decode's B 8, H 8, t 300
// in bf16, 1.5 us at 3.35 TB/s), against 4 (t + 1) Dh flops: bound by
// bytes. At that size the time goes to the launch, to the first bytes'
// latency and to the steps after they land, so the design puts every
// byte in flight at entry on several SMs per (row, head) and keeps the
// steps after few:
//   - a thread-block cluster of C blocks of 256 threads per (row, head):
//     B * H * C blocks (C 2 up to M 1024, 4 up to M 4096, then 16,
//     ops/decode_attention.py::scalar_t_cluster_size);
//     the valid keys 0..min(t, M - 1) spread evenly over the C blocks (spans
//     differ by at most one key), known at entry since t is a launch
//     argument;
//   - staging by TMA: in the head-major layout a block's keys are one
//     contiguous run of span * Dh elements, and its values another. One
//     thread issues a 1D bulk copy of each run (cp.async.bulk, completing
//     on an mbarrier) at entry, q riding with the first. Every Dh
//     taken (16, 32, 64, 128) times 2 or 4 bytes is a multiple of 16, so
//     run sizes and offsets meet the copy's 16-byte rule (the launcher
//     checks that q, k and v start on 16-byte boundaries). A span longer
//     than a 16 KB slot goes through a ring of two slots, each with its own
//     mbarrier, keys first, then values: any M is taken;
//   - scores in f32, the lanes of a key's row loading 16 bytes each; the
//     blocks exchange their maxima once through distributed shared memory:
//     each block stores one max per 256-key block (BLOCKED; -inf where its
//     keys miss it), or one max (!BLOCKED), into its row of every block's
//     table and arrives on every block's maxima mbarrier; the running max
//     over the key blocks is the rounding reference m_ref;
//   - p.v, with each key's weight taken where it is used: p = exp(s -
//     m_ref) rounded to T, times exp(m_ref - m_fin), the TPU loop's chain
//     of rescalings by alpha (the same function, the f32 sums associated
//     differently); l from the unrounded p in the same loop;
//   - the combine: each block pushes its partial acc [Dh] and l into the
//     leader's inbox and arrives on the leader's inbox mbarrier; the leader
//     sums the C partials in rank order (deterministic, no atomics) and
//     stores o once, the others leave. A row's result depends on its own
//     (row, head), t and positions alone, so its bits are the same at any
//     B. The cluster barrier at entry is relaxed: a release there waited
//     for the copies in flight (the mbarriers' init has a fence of its own).
// Measured (PERF.md; chip_smoke.py, chip_sweep.py): at B 8, H 8, M 511,
// Dh 64, bf16, cold, t 300, ~12 us against ~11 us of one library call: the
// launch (~5.5 us), the first bytes (~2 us after the issue) and the steps
// after them, two of them exchanges between the blocks, take most of it.
// Clusters of 16 took ~1.5x as long as 2 there (their blocks started up to
// ~9 us apart). Chunks of 8 KB in a ring of eight slots, all issued at
// entry, and 2 KB pieces issued by 32 lanes landed no sooner than one copy
// a run.
//
// Built a second time with -DEAMG_PHASE_TIMING (ops/_build.py, library
// decode_attention_timed) for chip_smoke.py's kernel phase alone: thread 0
// of every block records %globaltimer and clock64 at each phase boundary
// (common.cuh, PHASE_STAMP); an empty cluster launch of the same grid
// (decode_fold_timed's eamg_empty_launch, blocks of 256 threads too) gives
// the floor.
#include <cooperative_groups.h>

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

// -------- flash_decode and flash_decode_vmem: one kernel, a cluster a row

constexpr int NT_CL = 256;          // threads of a cluster's block
constexpr int NW_CL = NT_CL / 32;
constexpr int CL_MAX = 16;          // blocks in a cluster, at most (sm_90)
constexpr int BK_TPU = 256;         // keys of a block of flash_decode's loop
// bytes of a staging slot, at most: at the batched decode's M 511 (C 2)
// two 16 KB chunks of keys landed sooner than one of 32 KB (PERF.md)
constexpr size_t SLOT_MAX = 16384;

// the phase boundaries a timed build stamps (common.cuh): entry, barriers
// set, copies issued, the cluster joined, first chunk landed, scores,
// maxima exchanged, p.v, partials pushed, output stored
constexpr int N_STAMP = 10;
#define DEC_STAMP(i) PHASE_STAMP(i, N_STAMP)

// Byte offsets into a block's shared memory; the launcher and the kernel
// compute them from the same arguments. xm and inbox are written by the
// other blocks of the cluster.
struct ClusterSmem {
  int R, NK, NB;
  size_t bar, slot, qs, sc, xm, pm, red, scratch, inbox, total;
  __host__ __device__ ClusterSmem(int M, int DH, int C, int es, bool blocked)
      : R((M + C - 1) / C),
        NK(R < (int)(SLOT_MAX / (DH * es)) ? R : (int)(SLOT_MAX / (DH * es))),
        NB(blocked ? (M + BK_TPU - 1) / BK_TPU : 1) {
    size_t off = 0;
    bar = off;           // four mbarriers: one a slot, the leader's inbox,
    off += 128;          // the maxima
    slot = off;          // [2][NK][DH] of T: the ring of two chunks
    off += 2 * (size_t)NK * DH * es;
    qs = off;            // q, as it lies in device memory
    off += (size_t)DH * es;
    sc = off;            // [R] scores, then the weights of p.v
    off += sizeof(float) * R;
    xm = off;            // [CL_MAX][NB] every block's maxima, by key block
    off += sizeof(float) * CL_MAX * NB;
    pm = off;            // [NB] the reference maxima
    off += sizeof(float) * NB;
    red = off;           // [NT_CL / (DH / VE)][DH] p.v of each key group
    off += sizeof(float) * NT_CL * (16 / es);
    scratch = off;       // [NT_CL] each thread's share of the sum l
    off += sizeof(float) * NT_CL;
    inbox = off;         // [CL_MAX][DH + 1] every block's partial and sum
    off += sizeof(float) * CL_MAX * (DH + 1);
    total = off;
  }
};

// mbarriers and the 1D bulk copy (TMA) that completes on them
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// the barriers' init, and a slot's reads by the threads, ordered before the
// bulk copies that follow (the async proxy)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// bytes (a multiple of 16) from src to dst, both 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// the same for a barrier that other blocks of the cluster arrive on: what
// they wrote before arriving is visible after
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// one arrival on the barrier at `bar` in block `rank`'s shared memory,
// releasing what this block wrote before (at cluster scope)
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// Grid (C, B * H), clusters of (C, 1, 1). Block rank r of row bh takes the
// keys [s0, s0 + n) of the nv = min(t, M - 1) + 1 valid ones, spread evenly
// (ops/decode_attention.py::key_spans): n = nv / C, one more for the first
// nv % C ranks. BLOCKED: flash_decode's rounding reference (the running
// max of its 256-key loop), else flash_decode_vmem's (the global max).
template <typename T, int DH, bool BLOCKED>
__global__ void __launch_bounds__(NT_CL)
decode_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int M,
                      int t, float scale) {
  namespace cg = cooperative_groups;
  constexpr int VE = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int LPR = DH / VE;        // lanes on a key's row
  constexpr int RPW = 32 / LPR;       // key rows a warp scores at once
  constexpr int KG = NT_CL / LPR;     // key groups of p.v
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int bh = blockIdx.y, tid = threadIdx.x, warp = tid / 32;
  const int lane = tid % 32, sub = tid % LPR, grp = tid / LPR;
  const ClusterSmem L(M, DH, C, (int)sizeof(T), BLOCKED);
  // barriers: 0 and 1 the slots', 2 the leader's inbox, 3 the maxima's
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  T* slot = reinterpret_cast<T*>(smem + L.slot);
  T* qs = reinterpret_cast<T*>(smem + L.qs);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* xm = reinterpret_cast<float*>(smem + L.xm);
  float* pm = reinterpret_cast<float*>(smem + L.pm);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  float* inbox = reinterpret_cast<float*>(smem + L.inbox);

  DEC_STAMP(0);
  // this block's keys, known at entry: t is a launch argument
  const int nv = max(0, min(t, M - 1) + 1);
  const int n = nv / C + (r < nv % C), s0 = r * (nv / C) + min(r, nv % C);
  const int nch = (n + L.NK - 1) / L.NK, nload = 2 * nch;
  const int nbv = BLOCKED ? (nv + BK_TPU - 1) / BK_TPU : (nv > 0);
  const T* kp = k + ((size_t)bh * M + s0) * DH;
  const T* vp = v + ((size_t)bh * M + s0) * DH;
  // load i: the keys of chunk i (i < nch), else the values of chunk
  // i - nch; one contiguous run of the head-major row, into slot i % 2, on
  // barrier i % 2, by one bulk copy (cut into 2 KB copies issued by the 32
  // lanes at once, it landed no sooner). q rides with the first.
  auto issue = [&](int i) {
    const int c = i < nch ? i : i - nch;
    const uint32_t bytes =
        (uint32_t)(min(L.NK, n - c * L.NK) * DH * (int)sizeof(T));
    const uint32_t qb = i == 0 ? DH * sizeof(T) : 0;
    mbar_expect_tx(bar + i % 2, bytes + qb);
    if (qb) bulk_copy(qs, q + (size_t)bh * DH, qb, bar);
    bulk_copy(slot + (size_t)(i % 2) * L.NK * DH,
              (i < nch ? kp : vp) + (size_t)c * L.NK * DH, bytes,
              bar + i % 2);
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    mbar_init(bar + 2, C);   // the leader's inbox: one arrival a block
    mbar_init(bar + 3, C);   // the maxima: one arrival a block
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async();
  }
  __syncthreads();   // the barriers are set for every thread
  DEC_STAMP(1);
  if (tid == 0)
    for (int i = 0; i < min(2, nload); ++i) issue(i);
  DEC_STAMP(2);
  cluster_arrive_relaxed();
  DEC_STAMP(3);

  // scores, f32: the LPR lanes of a key's row load 16 bytes each and sum
  // in a shuffle tree
  float qv[VE];
  for (int c = 0; c < nch; ++c) {
    mbar_wait(bar + c % 2, (c / 2) & 1);
    if (c == 0) {
      DEC_STAMP(4);
      load16(qs + sub * VE, qv);
    }
    const T* ks = slot + (size_t)(c % 2) * L.NK * DH;
    const int keys = min(L.NK, n - c * L.NK);
    for (int j0 = warp * RPW; j0 < keys; j0 += NW_CL * RPW) {
      const int j = j0 + lane / LPR;
      float a = 0.f;
      if (j < keys) {
        float kf[VE];
        load16(ks + (size_t)j * DH + sub * VE, kf);
#pragma unroll
        for (int e = 0; e < VE; ++e) a += qv[e] * kf[e];
      }
#pragma unroll
      for (int w = LPR / 2; w > 0; w >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, w);
      if (j < keys && sub == 0) sc[c * L.NK + j] = a * scale;
    }
    __syncthreads();   // slot c % 2 is read
    if (tid == 0 && c + 2 < nload) {
      fence_async();
      issue(c + 2);
    }
  }
  DEC_STAMP(5);

  // the maxima, by remote stores: this block's max over its keys in each
  // 256-key block (BLOCKED; else over all its keys), -inf for a block its
  // keys miss, into row r of every block's table, then one arrival on
  // every block's maxima barrier
  cluster_wait();
  for (int kb = warp; kb < nbv; kb += NW_CL) {
    const int lo = BLOCKED ? max(s0, kb * BK_TPU) - s0 : 0;
    const int hi = BLOCKED ? min(s0 + n, (kb + 1) * BK_TPU) - s0 : n;
    float mx = -INFINITY;
    for (int j = lo + lane; j < hi; j += 32) mx = fmaxf(mx, sc[j]);
    mx = warp_max(mx);
    if (lane < C) *cluster.map_shared_rank(xm + r * L.NB + kb, lane) = mx;
  }
  __syncthreads();   // every push of the block is issued
  if (tid < C) mbar_arrive_remote(bar + 3, tid);
  mbar_wait_cluster(bar + 3, 0);
  // pm[kb]: the reference max of key block kb, the same in every block;
  // max is exact, so no order matters. BLOCKED: the running max over key
  // blocks 0..kb, which is the TPU loop's m_cur for block kb
  for (int kb = tid; kb < nbv; kb += NT_CL) {
    float m = xm[kb];
    for (int c = 1; c < C; ++c) m = fmaxf(m, xm[c * L.NB + kb]);
    pm[kb] = m;
  }
  __syncthreads();
  if (BLOCKED && tid == 0)
    for (int kb = 1; kb < nbv; ++kb) pm[kb] = fmaxf(pm[kb], pm[kb - 1]);
  __syncthreads();
  const float m_fin = nbv > 0 ? pm[nbv - 1] : 0.f;
  DEC_STAMP(6);

  // p.v: KG groups of keys, VE outputs a thread, the values from the ring.
  // The LPR lanes of a group each take a key's weight: p = exp(s - m_ref)
  // rounded to T, times exp(m_ref - m_fin). The TPU loop rescales acc and
  // l by that factor over its blocks (its chain of alphas); here each
  // key's weight and share of l carry it, the same function with the f32
  // sums associated differently. l sums the unrounded p.
  float acc[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) acc[e] = 0.f;
  float lpart = 0.f;
  for (int c = 0; c < nch; ++c) {
    const int i = nch + c;
    mbar_wait(bar + i % 2, (i / 2) & 1);
    const T* vs = slot + (size_t)(i % 2) * L.NK * DH;
    const int keys = min(L.NK, n - c * L.NK);
    for (int j = grp; j < keys; j += KG) {
      const int jj = c * L.NK + j;
      const float mr = BLOCKED ? pm[(s0 + jj) / BK_TPU] : m_fin;
      const float p = expf(sc[jj] - mr);
      const float f = BLOCKED ? expf(mr - m_fin) : 1.f;
      const float w = BLOCKED ? round_to<T>(p) * f : round_to<T>(p);
      lpart += BLOCKED ? p * f : p;
      float vf[VE];
      load16(vs + (size_t)j * DH + sub * VE, vf);
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[e] += w * vf[e];
    }
    __syncthreads();   // slot i % 2 is read
    if (tid == 0 && i + 2 < nload) {
      fence_async();
      issue(i + 2);
    }
  }
#pragma unroll
  for (int e = 0; e < VE; ++e) red[grp * DH + sub * VE + e] = acc[e];
  scratch[tid] = sub == 0 ? lpart : 0.f;   // a group's l, once
  __syncthreads();
  DEC_STAMP(7);

  // the block's partial, the key groups in order, and its sum l (warp 0:
  // the groups' shares in a fixed order) pushed into row r of the leader's
  // inbox; then one arrival on the leader's barrier. No block touches
  // another's memory after that, so the others leave at once
  if (tid < DH) {
    float a = 0.f;
    for (int gi = 0; gi < KG; ++gi) a += red[gi * DH + tid];
    *cluster.map_shared_rank(inbox + r * (DH + 1) + tid, 0) = a;
  }
  if (warp == 0) {
    float ls = 0.f;
    for (int i = lane; i < NT_CL; i += 32) ls += scratch[i];
    ls = warp_sum(ls);
    if (lane == 0) *cluster.map_shared_rank(inbox + r * (DH + 1) + DH, 0) = ls;
  }
  __syncthreads();   // every push of the block is issued
  if (tid == 0) mbar_arrive_remote(bar + 2, 0);
  DEC_STAMP(8);
  if (r != 0) return;
  // the leader: the C partials and sums in rank order, one rounding
  mbar_wait_cluster(bar + 2, 0);
  if (tid < DH) {
    float a = 0.f, ls = 0.f;
    for (int c = 0; c < C; ++c) {
      a += inbox[c * (DH + 1) + tid];
      ls += inbox[c * (DH + 1) + DH];
    }
    o[(size_t)bh * DH + tid] = from_f32<T>(a / fmaxf(ls, 1e-30f));
  }
  DEC_STAMP(9);
}

// Lets the kernel take `bytes` of shared memory and clusters of 16 blocks
template <typename T, int DH, bool BLOCKED>
cudaError_t prepare_cluster(size_t bytes) {
  static ClusterAllowance allowed;
  return allow_cluster(decode_cluster_kernel<T, DH, BLOCKED>, bytes, allowed);
}

template <typename T, int DH, bool BLOCKED>
int launch_cluster(const void* q, const void* k, const void* v, void* o,
                   int BH, int M, int t, float scale, int C,
                   cudaStream_t stream) {
  const ClusterSmem L(M, DH, C, (int)sizeof(T), BLOCKED);
  if (L.total > EAMG_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare_cluster<T, DH, BLOCKED>(L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(C, BH, NT_CL, L.total, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, decode_cluster_kernel<T, DH, BLOCKED>,
                         (const T*)q, (const T*)k, (const T*)v, (T*)o, M, t,
                         scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of C blocks the card keeps resident at once at the
// shape (0 where a block's shared memory would exceed what it allows).
template <typename T, int DH, bool BLOCKED>
int occupancy_k(int M, int C, int* active) {
  const ClusterSmem L(M, DH, C, (int)sizeof(T), BLOCKED);
  *active = 0;
  if (L.total > EAMG_MAX_SMEM) return 0;
  cudaError_t e = prepare_cluster<T, DH, BLOCKED>(L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(C, 1, NT_CL, L.total, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      active, decode_cluster_kernel<T, DH, BLOCKED>, &cfg);
}

// f(T{}, Int<DH>{}, Bool<BLOCKED>{}) for the runtime dtype, Dh and flag
template <typename F>
int by_instance(int dtype, int Dh, bool blocked, F&& f) {
  auto with_t = [&](auto t) {
    auto with_dh = [&](auto dh) {
      return blocked ? f(t, dh, Bool<true>{}) : f(t, dh, Bool<false>{});
    };
    switch (Dh) {
      case 16: return with_dh(Int<16>{});
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

bool valid_cluster(int C) { return C >= 1 && C <= CL_MAX && !(C & (C - 1)); }

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

// flash_decode (blocked 1) and flash_decode_vmem (blocked 0): MHA caches
// [B * H, M, Dh], one scalar t by value, a cluster of C blocks (1, 2, 4, 8
// or 16) per (row, head). q, k and v start on 16-byte boundaries: every
// key's row is Dh * 2 or 4 bytes, a multiple of 16 at the Dh taken (16, 32,
// 64, 128), so each block's run of keys, and of values, is one bulk copy's
// worth of 16-byte units. Returns cudaErrorInvalidValue for what it does
// not take, and where a block's shared memory would exceed what the card
// allows (4 * ceil(M / C) bytes of scores, 64 * ceil(M / 256) of maxima and
// 32 KB of slots at most); a cluster the card cannot place comes back as
// CUDA's own error.
extern "C" int eamg_flash_decode_scalar_t(const void* q, const void* k,
                                          const void* v, void* o, int BH,
                                          int M, int Dh, int t, float scale,
                                          int blocked, int C, int dtype,
                                          void* stream) {
  if (BH <= 0 || M <= 0 || (blocked != 0 && blocked != 1) ||
      !valid_cluster(C) || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  return by_instance(dtype, Dh, blocked != 0, [&](auto t_, auto dh, auto bl) {
    return launch_cluster<decltype(t_), decltype(dh)::value,
                          decltype(bl)::value>(q, k, v, o, BH, M, t, scale, C,
                                               (cudaStream_t)stream);
  });
}

// How many clusters of C blocks of the kernel (blocked as above) the card
// keeps resident at once at (M, Dh, dtype): into *active (0 where a block
// would need more shared memory than the card allows).
extern "C" int eamg_decode_cluster_occupancy(int M, int Dh, int blocked,
                                             int C, int dtype, int* active) {
  if (M <= 0 || (blocked != 0 && blocked != 1) || !valid_cluster(C))
    return (int)cudaErrorInvalidValue;
  return by_instance(dtype, Dh, blocked != 0, [&](auto t_, auto dh, auto bl) {
    return occupancy_k<decltype(t_), decltype(dh)::value,
                       decltype(bl)::value>(M, C, active);
  });
}

#ifdef EAMG_PHASE_TIMING
// The shared memory of a block of the kernel at the shape, into *bytes (as
// the launcher computes it).
extern "C" int eamg_decode_cluster_smem(int M, int Dh, int blocked, int C,
                                        int dtype, long long* bytes) {
  if (M <= 0 || !valid_cluster(C)) return (int)cudaErrorInvalidValue;
  return by_instance(dtype, Dh, blocked != 0, [&](auto t_, auto dh, auto bl) {
    *bytes = (long long)ClusterSmem(M, decltype(dh)::value, C,
                                    (int)sizeof(t_), decltype(bl)::value)
                 .total;
    return 0;
  });
}
#endif
