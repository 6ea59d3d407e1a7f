// Single-query cached attention over a head-major cache: K3 and rows 5
// and 6, one cluster kernel.
//
// All compute, for q [B, H, 1, Dh] and caches [B, Hkv, M, Dh],
//   o[b, h] = softmax(q[b, h] k[b, h / g, 0..t]^T / sqrt(Dh)) v[b, h / g, 0..t]
// and take any M (the flagship's is 511; the JAX kernels assert
// M % block_k == 0). Statistics and accumulators are f32. One kernel,
// decode_cluster_kernel, serves three wrappers; a launch argument, bk, is
// the length of the key blocks whose running max p is rounded against (0:
// the global max), as each TPU kernel rounds it:
//   - K3, flash_decode_sp, replaces eamg_tpu/ops/decode_attention.py::
//     flash_decode_sp (_decode_sp_kernel), which the JAX model reaches from
//     models/gpt.py::decode_step: GQA-native (g = H / Hkv query heads a
//     KV head, 1, 2, 4 or 8), the newest valid position per row, t [B],
//     read from device memory, bk 128 (block_k = min(128, M));
//   - flash_decode (row 5) replaces ::flash_decode (_decode_kernel): MHA
//     caches, one scalar t by value, bk 256;
//   - flash_decode_vmem (row 6) replaces ::flash_decode_vmem
//     (_decode_vmem_kernel): the same with the global max (bk 0). JAX's
//     kernel reads all M keys and masks past t; this one reads keys 0..t
//     only. A masked key's p is exactly 0 there, so the function is the
//     same for any finite cache contents; one exception: a non-finite
//     value past t gives NaN in JAX's kernel (0 * inf) and not here.
// The TPU loops' rounding: for a key of block kb, p = exp(s - m_cur) with
// m_cur the running max after block kb (the max over keys 0..min(t,
// bk (kb + 1) - 1)), p rounded to the cache dtype before p.v, the sum l
// from the unrounded p. In f32 rounding p is the identity.
// What bounds it: the bytes of keys and values 0..t, q and o, 2 (t + 1) Dh
// elements per (row, KV head) (4.9 MB at the batched decode's B 8, H 8, t
// 300 in bf16, 1.5 us at 3.35 TB/s), against 4 g (t + 1) Dh flops: bound
// by bytes. At that size the time goes to the launch, to the first bytes'
// latency and to the steps after they land, so the design puts every
// byte in flight at entry on several SMs per (row, KV head) and keeps the
// steps after few:
//   - a thread-block cluster of C blocks of 256 threads per (row, KV
//     head): B * Hkv * C blocks, C from M and g alone
//     (ops/decode_attention.py::cluster_size);
//     the valid keys 0..min(t, M - 1) spread evenly over the C blocks
//     (spans differ by at most one key; ops/decode_attention.py::
//     key_spans). With t [B] a block reads t[b] at entry, a dependent
//     load, then computes its span; t stays on the device;
//   - staging by TMA: in the head-major layout a block's keys are one
//     contiguous run of span * Dh elements, and its values another. One
//     thread issues a 1D bulk copy of each run (cp.async.bulk, completing
//     on an mbarrier), the g query heads' q riding with the first. Every
//     Dh taken (16, 32, 48, 64, 128) times 2 or 4 bytes is a multiple of
//     16, so run sizes and offsets meet the copy's 16-byte rule (the
//     launcher checks that q, k and v start on 16-byte boundaries). A span
//     longer than a 16 KB slot goes through a ring of two slots, each with
//     its own mbarrier, keys first, then values: any M is taken;
//   - scores in f32 for the g heads at once, the lanes of a key's row
//     loading 16 bytes each (each key read once for the group); the blocks
//     exchange their maxima once through distributed shared memory: each
//     block stores, per head, the max of its keys in each key block they
//     touch into its row of every block's table (a table of C rows of
//     ceil(span / bk) + 1 entries: no block writes a slot another does, so
//     nothing needs initialising and the cluster's arrival at entry can be
//     relaxed), then arrives on every block's maxima mbarrier; in each
//     block a warp per head then takes each key block's max over the ranks
//     whose keys it holds and the running max over the key blocks (a
//     shuffle scan): the rounding reference m_ref;
//   - p.v, with each key's weight taken where it is used: p = exp(s -
//     m_ref) rounded to T, times exp(m_ref - m_fin) (one factor a key
//     block), the TPU loop's chain of rescalings by alpha (the same
//     function, the f32 sums associated differently); l from the unrounded
//     p in the same loop; each key's values read once for the g heads;
//   - the combine: each block pushes its partial acc [g, Dh] and l [g]
//     into the leader's inbox and arrives on the leader's inbox mbarrier;
//     the leader sums the C partials in rank order (deterministic, no
//     atomics) and stores o once, the others leave. A row's result depends
//     on its own (row, KV head), t[b] and positions alone, so its bits are
//     the same at any B.
// K3 by head, decode_heads_kernel, where g > 1 and a block's shared
// memory holds every key and value of the KV head (ops/decode_attention.py
// ::sp_plan): a cluster of g blocks per (row, KV head), one a query head;
// block rank r copies its share of the keys and of the values with one
// bulk copy each, multicast to all g blocks, so each key and value is
// read once for the group and every block holds them all; then each
// block computes its head's scores, the 128-key blocks' running maxima,
// p.v and the output alone: no exchange between the blocks, no partials.
// Measured on an H100 SXM (chip_smoke.py, chip_sweep.py; PERF.md): K3 at
// the solo decode (B 1, H 8, Hkv 2, M 511, t 300, bf16, cold) by head
// ~9.9 us against ~10.1 us of one SDPA call on keys 0..t (~6.2 / 6.1 us
// warm); over spans it took 11.3-14.8 us with C 1-16: the two exchanges
// (maxima, partials) cost ~2.9 us of its ~6.6 us span. Rows 5 and 6 at
// the batched decode's B 8, H 8, t 300: ~12 us against ~11 us.
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

constexpr int NT_CL = 256;          // threads of a cluster's block
constexpr int NW_CL = NT_CL / 32;
constexpr int CL_MAX = 16;          // blocks in a cluster, at most (sm_90)
// bytes of a staging slot, at most: at the batched decode's M 511 (C 2)
// two 16 KB chunks of keys landed sooner than one of 32 KB (PERF.md)
constexpr size_t SLOT_MAX = 16384;

// the phase boundaries a timed build stamps (common.cuh): entry, barriers
// set (and the cluster's arrival), t read and the span known, copies
// issued, first chunk landed, scores, maxima exchanged, p.v, partials
// pushed, output stored
constexpr int N_STAMP = 10;
#define DEC_STAMP(i) PHASE_STAMP(i, N_STAMP)

// Byte offsets into a block's shared memory; the launcher and the kernel
// compute them from the same arguments. pm and inbox are written by the
// other blocks of the cluster.
struct ClusterSmem {
  int R, NK, NB, LB;
  size_t bar, slot, qs, sc, xm, pm, fm, red, lsum, inbox, total;
  __host__ __device__ ClusterSmem(int M, int DH, int G, int C, int es,
                                  int bk)
      : R((M + C - 1) / C),
        NK(R < (int)(SLOT_MAX / (DH * es)) ? R : (int)(SLOT_MAX / (DH * es))),
        NB(bk > 0 ? (M + bk - 1) / bk : 1),
        LB(bk > 0 ? (R + bk - 1) / bk + 1 : 1) {
    size_t off = 0;
    bar = off;           // four mbarriers: one a slot, the leader's inbox,
    off += 128;          // the maxima
    slot = off;          // [2][NK][DH] of T: the ring of two chunks
    off += 2 * (size_t)NK * DH * es;
    qs = off;            // [G][DH] q, as it lies in device memory
    off += (size_t)G * DH * es;
    sc = off;            // [G][R] scores, then the weights of p.v
    off += sizeof(float) * G * R;
    xm = off;            // [C][G][LB] every block's maxima of the key
    off += sizeof(float) * C * G * LB;   // blocks its keys touch
    pm = off;            // [G][NB] the reference maxima
    off += sizeof(float) * G * NB;
    fm = off;            // [G][NB] exp(reference - final max)
    off += sizeof(float) * G * NB;
    red = off;           // [NW_CL][G][DH] p.v of each warp
    off += sizeof(float) * NW_CL * G * DH;
    lsum = off;          // [NW_CL][G] l of each warp
    off += sizeof(float) * NW_CL * G;
    inbox = off;         // [C][G][DH + 1] every block's partial and sums
    off += sizeof(float) * C * G * (DH + 1);
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
// the same copy landing at dst and completing on bar in every block of
// the cluster that `mask` names (bit i: block rank i), at the same offsets
__device__ __forceinline__ void bulk_copy_multicast(void* dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
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

// lanes on a key's row: the 16-byte vectors of a row, rounded up to a
// power of two (Dh 48: 6 vectors of bf16 on 8 lanes, two idle)
__host__ __device__ constexpr int lanes_for(int nv) {
  return nv <= 1 ? 1 : nv <= 2 ? 2 : nv <= 4 ? 4 : nv <= 8 ? 8
                                            : nv <= 16 ? 16 : 32;
}

// Grid (C, B * Hkv), clusters of (C, 1, 1); block row bh = b * Hkv + hk is
// one (row, KV head) of the cache [B * Hkv, M, Dh], with the G query heads
// bh * G .. bh * G + G - 1 of q [B * H, Dh]. Block rank r takes the keys
// [s0, s0 + n) of the nv = min(t, M - 1) + 1 valid ones, spread evenly
// (ops/decode_attention.py::key_spans): n = nv / C, one more for the first
// nv % C ranks. t is t_rows[b] (t_rows not null) or t_scalar. bks: log2
// of the length of the rounding reference's key blocks (7 or 8), 0 for
// the global max.
template <typename T, int DH, int G>
__global__ void __launch_bounds__(NT_CL)
decode_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      const int* __restrict__ t_rows, int t_scalar, int Hkv,
                      int M, int bks, float scale) {
  namespace cg = cooperative_groups;
  constexpr int VE = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int NV = DH / VE;         // 16-byte vectors of a row
  constexpr int LPR = lanes_for(NV);  // lanes on a key's row
  constexpr int RPW = 32 / LPR;       // key rows a warp scores at once
  constexpr int KG = NT_CL / LPR;     // key groups of p.v
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int bh = blockIdx.y, tid = threadIdx.x, warp = tid / 32;
  const int lane = tid % 32, sub = tid % LPR, grp = tid / LPR;
  const bool on = sub < NV;           // a lane with a vector of the row
  const int bk = bks > 0 ? 1 << bks : 0;   // keys a block, 0: all
  const ClusterSmem L(M, DH, G, C, (int)sizeof(T), bk);
  // barriers: 0 and 1 the slots', 2 the leader's inbox, 3 the maxima's
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  T* slot = reinterpret_cast<T*>(smem + L.slot);
  T* qs = reinterpret_cast<T*>(smem + L.qs);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* xm = reinterpret_cast<float*>(smem + L.xm);
  float* pm = reinterpret_cast<float*>(smem + L.pm);
  float* fm = reinterpret_cast<float*>(smem + L.fm);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* lsum = reinterpret_cast<float*>(smem + L.lsum);
  float* inbox = reinterpret_cast<float*>(smem + L.inbox);

  DEC_STAMP(0);
  // this row's t: by value, or a load from device memory that is in
  // flight while the barriers are set
  const int t = t_rows != nullptr ? t_rows[bh / Hkv] : t_scalar;
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
  const int nv = max(0, min(t, M - 1) + 1);
  const int base = nv / C, rem = nv % C;
  const int n = base + (r < rem), s0 = r * base + min(r, rem);
  const int nch = (n + L.NK - 1) / L.NK, nload = 2 * nch;
  const int nbv = bk > 0 ? (nv + bk - 1) >> bks : (nv > 0);
  DEC_STAMP(2);
  const T* kp = k + ((size_t)bh * M + s0) * DH;
  const T* vp = v + ((size_t)bh * M + s0) * DH;
  // load i: the keys of chunk i (i < nch), else the values of chunk
  // i - nch; one contiguous run of the head-major row, into slot i % 2, on
  // barrier i % 2, by one bulk copy. q rides with the first.
  auto issue = [&](int i) {
    const int c = i < nch ? i : i - nch;
    const uint32_t bytes =
        (uint32_t)(min(L.NK, n - c * L.NK) * DH * (int)sizeof(T));
    const uint32_t qb = i == 0 ? G * DH * sizeof(T) : 0;
    mbar_expect_tx(bar + i % 2, bytes + qb);
    if (qb) bulk_copy(qs, q + (size_t)bh * G * DH, qb, bar);
    bulk_copy(slot + (size_t)(i % 2) * L.NK * DH,
              (i < nch ? kp : vp) + (size_t)c * L.NK * DH, bytes,
              bar + i % 2);
  };
  if (tid == 0)
    for (int i = 0; i < min(2, nload); ++i) issue(i);
  // relaxed: a release here would wait for the copies just issued; no
  // block writes into another's memory before the cluster_wait below
  cluster_arrive_relaxed();
  DEC_STAMP(3);

  // scores, f32, the G heads at once: the LPR lanes of a key's row load 16
  // bytes each and sum in a shuffle tree
  float qv[G][VE];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < VE; ++e) qv[h][e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    mbar_wait(bar + c % 2, (c / 2) & 1);
    if (c == 0) {
      DEC_STAMP(4);
      if (on)
#pragma unroll
        for (int h = 0; h < G; ++h) load16(qs + h * DH + sub * VE, qv[h]);
    }
    const T* ks = slot + (size_t)(c % 2) * L.NK * DH;
    const int keys = min(L.NK, n - c * L.NK);
#pragma unroll 4
    for (int j0 = warp * RPW; j0 < keys; j0 += NW_CL * RPW) {
      const int j = j0 + lane / LPR;
      float a[G];
#pragma unroll
      for (int h = 0; h < G; ++h) a[h] = 0.f;
      if (j < keys && on) {
        float kf[VE];
        load16(ks + (size_t)j * DH + sub * VE, kf);
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int e = 0; e < VE; ++e) a[h] += qv[h][e] * kf[e];
      }
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int w = LPR / 2; w > 0; w >>= 1)
          a[h] += __shfl_xor_sync(0xffffffffu, a[h], w);
      if (j < keys && sub == 0)
#pragma unroll
        for (int h = 0; h < G; ++h) sc[h * L.R + c * L.NK + j] = a[h] * scale;
    }
    __syncthreads();   // slot c % 2 is read
    if (tid == 0 && c + 2 < nload) {
      fence_async();
      issue(c + 2);
    }
  }
  DEC_STAMP(5);

  // the maxima, by remote stores: per head, this block's max over its keys
  // in each key block they touch (all its keys: one block, bk 0), into
  // row r of every block's table at the key block's index among this
  // block's (only ranks with keys write, and a rank reads only what ranks
  // with keys in a key block wrote), then one arrival on every block's
  // maxima barrier
  cluster_wait();
  const int kb_lo = bk > 0 ? s0 >> bks : 0;
  const int nloc = n == 0 ? 0 : bk > 0 ? ((s0 + n - 1) >> bks) - kb_lo + 1 : 1;
  for (int it = warp; it < G * nloc; it += NW_CL) {
    const int h = it / nloc, li = it % nloc, kb = kb_lo + li;
    const int lo = bk > 0 ? max(s0, kb << bks) - s0 : 0;
    const int hi = bk > 0 ? min(s0 + n, (kb + 1) << bks) - s0 : n;
    float mx = -INFINITY;
    for (int j = lo + lane; j < hi; j += 32) mx = fmaxf(mx, sc[h * L.R + j]);
    mx = warp_max(mx);
    if (lane < C)
      *cluster.map_shared_rank(xm + ((size_t)r * G + h) * L.LB + li, lane) =
          mx;
  }
  __syncthreads();   // every push of the block is issued
  if (tid < C) mbar_arrive_remote(bar + 3, tid);
  mbar_wait_cluster(bar + 3, 0);
  // A warp per head, a lane per key block kb: pm[h][kb], its max over the
  // ranks whose keys it holds (the same in every block; max is exact, so
  // no order matters); bk > 0: the running max over key blocks 0..kb (a
  // shuffle scan), the TPU loop's m_cur for block kb; then fm[h][kb] =
  // exp(m_cur - m_fin), the factor that carries the TPU loop's rescalings
  if (warp < G) {
    const int h = warp;
    float carry = -INFINITY;
    for (int b0 = 0; b0 < nbv; b0 += 32) {
      const int kb = b0 + lane;
      float x = -INFINITY;
      if (kb < nbv) {
        const int lo = bk > 0 ? kb << bks : 0;
        const int hi = bk > 0 ? min(nv, (kb + 1) << bks) : nv;
        for (int rr = 0; rr < C; ++rr) {   // rank rr holds [a, a + len)
          const int a = rr * base + min(rr, rem), len = base + (rr < rem);
          if (len > 0 && a < hi && a + len > lo)
            x = fmaxf(x, xm[((size_t)rr * G + h) * L.LB + kb -
                            (bk > 0 ? a >> bks : 0)]);
        }
      }
#pragma unroll
      for (int w = 1; w < 32; w <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, w);
        if (lane >= w && bk > 0) x = fmaxf(x, y);
      }
      x = fmaxf(x, carry);
      carry = __shfl_sync(0xffffffffu, x, 31);
      if (kb < nbv) pm[h * L.NB + kb] = x;
    }
    for (int kb = lane; kb < nbv; kb += 32)   // each lane its own entries
      fm[h * L.NB + kb] = bk > 0 ? expf(pm[h * L.NB + kb] - carry) : 1.f;
  }
  __syncthreads();
  DEC_STAMP(6);

  // p.v: KG groups of keys, VE outputs a thread per head, the values from
  // the ring, each key's values read once for the G heads. The LPR lanes
  // of a group each take a key's weight: p = exp(s - m_ref) rounded to T,
  // times exp(m_ref - m_fin) (fm). The TPU loop rescales acc and l by that
  // factor over its blocks (its chain of alphas); here each key's weight
  // and share of l carry it, the same function with the f32 sums
  // associated differently. l sums the unrounded p.
  float acc[G][VE], lpart[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    lpart[h] = 0.f;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[h][e] = 0.f;
  }
  for (int c = 0; c < nch; ++c) {
    const int i = nch + c;
    mbar_wait(bar + i % 2, (i / 2) & 1);
    const T* vs = slot + (size_t)(i % 2) * L.NK * DH;
    const int keys = min(L.NK, n - c * L.NK);
#pragma unroll 4
    for (int j = grp; j < keys; j += KG) {
      const int jj = c * L.NK + j;
      const int kb = bk > 0 ? (s0 + jj) >> bks : 0;
      float vf[VE];
      if (on) load16(vs + (size_t)j * DH + sub * VE, vf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float p = expf(sc[h * L.R + jj] - pm[h * L.NB + kb]);
        const float f = fm[h * L.NB + kb];
        const float w = round_to<T>(p) * f;
        lpart[h] += p * f;
        if (on)
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[h][e] += w * vf[e];
      }
    }
    __syncthreads();   // slot i % 2 is read
    if (tid == 0 && i + 2 < nload) {
      fence_async();
      issue(i + 2);
    }
  }
  // the key groups of a warp summed in a fixed shuffle tree, then each
  // warp's partial and l (a group's l once: its lane 0's) into shared
  // memory
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int e = 0; e < VE; ++e)
#pragma unroll
      for (int w = LPR; w < 32; w <<= 1)
        acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], w);
    lpart[h] = warp_sum(sub == 0 ? lpart[h] : 0.f);   // a group's once
  }
  if (lane < LPR && on)
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        red[((size_t)warp * G + h) * DH + sub * VE + e] = acc[h][e];
  if (lane == 0)
#pragma unroll
    for (int h = 0; h < G; ++h) lsum[warp * G + h] = lpart[h];
  __syncthreads();
  DEC_STAMP(7);

  // the block's partial, the warps in order, and its sums l pushed into
  // row r of the leader's inbox; then one arrival on the leader's barrier.
  // No block touches another's memory after that, so the others leave at
  // once
  for (int idx = tid; idx < G * DH; idx += NT_CL) {
    const int h = idx / DH, d = idx % DH;
    float a = 0.f;
    for (int w = 0; w < NW_CL; ++w) a += red[(size_t)w * G * DH + idx];
    *cluster.map_shared_rank(inbox + ((size_t)r * G + h) * (DH + 1) + d, 0) =
        a;
  }
  if (tid < G) {
    float ls = 0.f;
    for (int w = 0; w < NW_CL; ++w) ls += lsum[w * G + tid];
    *cluster.map_shared_rank(inbox + ((size_t)r * G + tid) * (DH + 1) + DH,
                             0) = ls;
  }
  __syncthreads();   // every push of the block is issued
  if (tid == 0) mbar_arrive_remote(bar + 2, 0);
  DEC_STAMP(8);
  if (r != 0) return;
  // the leader: the C partials and sums in rank order, one rounding
  mbar_wait_cluster(bar + 2, 0);
  for (int idx = tid; idx < G * DH; idx += NT_CL) {
    const int h = idx / DH, d = idx % DH;
    float a = 0.f, ls = 0.f;
    for (int c = 0; c < C; ++c) {
      a += inbox[((size_t)c * G + h) * (DH + 1) + d];
      ls += inbox[((size_t)c * G + h) * (DH + 1) + DH];
    }
    o[((size_t)bh * G + h) * DH + d] = from_f32<T>(a / fmaxf(ls, 1e-30f));
  }
  DEC_STAMP(9);
}

// K3 by head: a cluster of G blocks per (row, KV head), block rank r the
// query head bh * G + r, each over all the keys 0..t of the KV head.
// Byte offsets into a block's shared memory, from (M, DH, es) alone.
struct HeadsSmem {
  size_t bar, ks, vs, qs, sc, pm, fm, red, lsum, total;
  __host__ __device__ HeadsSmem(int M, int DH, int es) {
    const int NB = (M + 127) / 128;
    size_t off = 0;
    bar = off;           // two mbarriers: the keys (and q), the values
    off += 128;
    ks = off;            // [M][DH] of T: every key of the KV head
    off += (size_t)M * DH * es;
    vs = off;            // [M][DH] of T: every value
    off += (size_t)M * DH * es;
    qs = off;            // [DH] of T: this block's query head
    off += (size_t)DH * es;
    sc = off;            // [M] scores
    off += sizeof(float) * M;
    pm = off;            // [NB] the 128-key blocks' running maxima
    off += sizeof(float) * NB;
    fm = off;            // [NB] exp(running max - final max)
    off += sizeof(float) * NB;
    red = off;           // [NW_CL][DH] p.v of each warp
    off += sizeof(float) * NW_CL * DH;
    lsum = off;          // [NW_CL] l of each warp
    off += sizeof(float) * NW_CL;
    total = off;
  }
};

// the phase boundaries a timed build stamps in the kernel by head: entry,
// barriers set, t read and the barriers armed, the cluster joined, copies
// issued, keys landed, scores, the maxima, p.v, output stored
constexpr int N_STAMP_HEADS = 10;
#define HEADS_STAMP(i) PHASE_STAMP(i, N_STAMP_HEADS)

// Grid (G, B * Hkv), clusters of (G, 1, 1). The keys 0..t of the KV head
// (t = t_rows[b]) are copied once: block rank r issues the run of keys
// and the run of values that key_spans(t, M, G) gives it, multicast to
// all G blocks, so every block holds every key and value; then each
// block computes its query head's scores, maxima, p and p.v alone, with
// the rounding reference of 128-key blocks, and stores its output. No
// block reads another's memory.
template <typename T, int DH, int G>
__global__ void __launch_bounds__(NT_CL)
decode_heads_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    const int* __restrict__ t_rows, int Hkv, int M,
                    float scale) {
  namespace cg = cooperative_groups;
  constexpr int VE = 16 / sizeof(T);
  constexpr int NV = DH / VE;
  constexpr int LPR = lanes_for(NV);
  constexpr int RPW = 32 / LPR;
  constexpr int KG = NT_CL / LPR;
  constexpr int BKS = 7;                 // 128-key blocks
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int bh = blockIdx.y, tid = threadIdx.x, warp = tid / 32;
  const int lane = tid % 32, sub = tid % LPR, grp = tid / LPR;
  const bool on = sub < NV;
  const HeadsSmem L(M, DH, (int)sizeof(T));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  T* ks = reinterpret_cast<T*>(smem + L.ks);
  T* vs = reinterpret_cast<T*>(smem + L.vs);
  T* qs = reinterpret_cast<T*>(smem + L.qs);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* pm = reinterpret_cast<float*>(smem + L.pm);
  float* fm = reinterpret_cast<float*>(smem + L.fm);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* lsum = reinterpret_cast<float*>(smem + L.lsum);

  HEADS_STAMP(0);
  const int t = t_rows[bh / Hkv];        // in flight while barriers are set
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  HEADS_STAMP(1);
  const int nv = max(0, min(t, M - 1) + 1);
  const uint32_t run = (uint32_t)(nv * DH * (int)sizeof(T));
  if (tid == 0) {
    // every byte this block will receive: all keys (and its q), all values
    mbar_expect_tx(bar, run + DH * sizeof(T));
    mbar_expect_tx(bar + 1, run);
  }
  HEADS_STAMP(2);
  __syncthreads();
  // every block's barriers are set and armed before any copy lands
  cluster_arrive_relaxed();
  cluster_wait();
  HEADS_STAMP(3);
  const int base = nv / G, rem = nv % G;
  const int n = base + (r < rem), s0 = r * base + min(r, rem);
  if (tid == 0) {
    bulk_copy(qs, q + ((size_t)bh * G + r) * DH, DH * sizeof(T), bar);
    if (n > 0) {
      const size_t at = (size_t)s0 * DH;
      const uint32_t bytes = (uint32_t)(n * DH * (int)sizeof(T));
      const uint16_t all = (uint16_t)((1u << G) - 1);
      bulk_copy_multicast(ks + at, k + (size_t)bh * M * DH + at, bytes, bar,
                          all);
      bulk_copy_multicast(vs + at, v + (size_t)bh * M * DH + at, bytes,
                          bar + 1, all);
    }
  }
  HEADS_STAMP(4);

  // scores, f32: the LPR lanes of a key's row load 16 bytes each
  mbar_wait(bar, 0);
  HEADS_STAMP(5);
  float qv[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) qv[e] = 0.f;
  if (on) load16(qs + sub * VE, qv);
#pragma unroll 4
  for (int j0 = warp * RPW; j0 < nv; j0 += NW_CL * RPW) {
    const int j = j0 + lane / LPR;
    float a = 0.f;
    if (j < nv && on) {
      float kf[VE];
      load16(ks + (size_t)j * DH + sub * VE, kf);
#pragma unroll
      for (int e = 0; e < VE; ++e) a += qv[e] * kf[e];
    }
#pragma unroll
    for (int w = LPR / 2; w > 0; w >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, w);
    if (j < nv && sub == 0) sc[j] = a * scale;
  }
  __syncthreads();
  HEADS_STAMP(6);

  // the maxima of the 128-key blocks (a warp each), their running max (a
  // shuffle scan: the TPU loop's m_cur), and fm = exp(m_cur - m_fin)
  const int nbv = (nv + 127) >> BKS;
  for (int kb = warp; kb < nbv; kb += NW_CL) {
    float mx = -INFINITY;
    for (int j = (kb << BKS) + lane; j < min(nv, (kb + 1) << BKS); j += 32)
      mx = fmaxf(mx, sc[j]);
    mx = warp_max(mx);
    if (lane == 0) pm[kb] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    float carry = -INFINITY;
    for (int b0 = 0; b0 < nbv; b0 += 32) {
      const int i = b0 + lane;
      float x = i < nbv ? pm[i] : -INFINITY;
#pragma unroll
      for (int w = 1; w < 32; w <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, w);
        if (lane >= w) x = fmaxf(x, y);
      }
      x = fmaxf(x, carry);
      carry = __shfl_sync(0xffffffffu, x, 31);
      if (i < nbv) pm[i] = x;
    }
    for (int i = lane; i < nbv; i += 32) fm[i] = expf(pm[i] - carry);
  }
  __syncthreads();
  HEADS_STAMP(7);

  // p.v as in decode_cluster_kernel: p = exp(s - m_ref) rounded to T,
  // times fm; l from the unrounded p
  mbar_wait(bar + 1, 0);
  // every copy into this block has landed: once every block says so, no
  // copy is in flight into any block, and each may leave (below)
  cluster_arrive_relaxed();
  float acc[VE], lpart = 0.f;
#pragma unroll
  for (int e = 0; e < VE; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int j = grp; j < nv; j += KG) {
    const float p = expf(sc[j] - pm[j >> BKS]);
    const float f = fm[j >> BKS];
    const float w = round_to<T>(p) * f;
    lpart += p * f;
    if (on) {
      float vf[VE];
      load16(vs + (size_t)j * DH + sub * VE, vf);
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[e] += w * vf[e];
    }
  }
#pragma unroll
  for (int e = 0; e < VE; ++e)
#pragma unroll
    for (int w = LPR; w < 32; w <<= 1)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], w);
  lpart = warp_sum(sub == 0 ? lpart : 0.f);   // a group's once
  if (lane < LPR && on)
#pragma unroll
    for (int e = 0; e < VE; ++e) red[warp * DH + sub * VE + e] = acc[e];
  if (lane == 0) lsum[warp] = lpart;
  __syncthreads();
  HEADS_STAMP(8);
  // the warps in order, one rounding
  if (tid < DH) {
    float a = 0.f, ls = 0.f;
    for (int w = 0; w < NW_CL; ++w) {
      a += red[w * DH + tid];
      ls += lsum[w];
    }
    o[((size_t)bh * G + r) * DH + tid] = from_f32<T>(a / fmaxf(ls, 1e-30f));
  }
  HEADS_STAMP(9);
  cluster_wait();
}

// Lets the kernel take `bytes` of shared memory and clusters of 16 blocks
template <typename T, int DH, int G>
cudaError_t prepare_cluster(size_t bytes) {
  static ClusterAllowance allowed;
  return allow_cluster(decode_cluster_kernel<T, DH, G>, bytes, allowed);
}

template <typename T, int DH, int G>
int launch_cluster(const void* q, const void* k, const void* v, void* o,
                   const int* t_rows, int t_scalar, int rows, int Hkv, int M,
                   int bk, float scale, int C, cudaStream_t stream) {
  const ClusterSmem L(M, DH, G, C, (int)sizeof(T), bk);
  if (L.total > EAMG_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare_cluster<T, DH, G>(L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(C, rows, NT_CL, L.total, stream, &attr);
  const int bks = bk == 0 ? 0 : bk == 128 ? 7 : 8;
  e = cudaLaunchKernelEx(&cfg, decode_cluster_kernel<T, DH, G>, (const T*)q,
                         (const T*)k, (const T*)v, (T*)o, t_rows, t_scalar,
                         Hkv, M, bks, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int DH, int G>
int launch_heads(const void* q, const void* k, const void* v, void* o,
                 const int* t_rows, int rows, int Hkv, int M, float scale,
                 cudaStream_t stream) {
  static ClusterAllowance allowed;
  const HeadsSmem L(M, DH, (int)sizeof(T));
  if (L.total > EAMG_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      allow_cluster(decode_heads_kernel<T, DH, G>, L.total, allowed);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(G, rows, NT_CL, L.total, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, decode_heads_kernel<T, DH, G>, (const T*)q,
                         (const T*)k, (const T*)v, (T*)o, t_rows, Hkv, M,
                         scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of C blocks the card keeps resident at once at the
// shape (0 where a block's shared memory would exceed what it allows).
template <typename T, int DH, int G>
int occupancy_k(int M, int bk, int C, int* active) {
  const ClusterSmem L(M, DH, G, C, (int)sizeof(T), bk);
  *active = 0;
  if (L.total > EAMG_MAX_SMEM) return 0;
  cudaError_t e = prepare_cluster<T, DH, G>(L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(C, 1, NT_CL, L.total, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      active, decode_cluster_kernel<T, DH, G>, &cfg);
}

// f(T{}, Int<DH>{}, Int<G>{}) for the runtime dtype, Dh and g
template <typename F>
int by_instance(int dtype, int Dh, int g, F&& f) {
  auto with_t = [&](auto t) {
    auto with_dh = [&](auto dh) {
      switch (g) {
        case 1: return f(t, dh, Int<1>{});
        case 2: return f(t, dh, Int<2>{});
        case 4: return f(t, dh, Int<4>{});
        case 8: return f(t, dh, Int<8>{});
        default: return (int)cudaErrorInvalidValue;
      }
    };
    switch (Dh) {
      case 16: return with_dh(Int<16>{});
      case 32: return with_dh(Int<32>{});
      case 48: return with_dh(Int<48>{});
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

// the key blocks the kernel rounds against: all keys, 128 or 256
bool valid_bk(int bk) { return bk == 0 || bk == 128 || bk == 256; }

bool aligned16(const void* q, const void* k, const void* v) {
  return ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
}

}  // namespace

// K3: q [B, H, 1, Dh], caches [B, Hkv, M, Dh], t [B] int32 on the device
// (read by the kernel, never by the host), g = H / Hkv of 1, 2, 4 or 8,
// the rounding reference of 128-key blocks. One launch: by_head 1, a
// cluster of g blocks per (row, KV head), one a query head, each holding
// every key and value (decode_heads_kernel; g > 1, and 2 M Dh elements
// must fit a block's shared memory); by_head 0, a cluster of C blocks (1,
// 2, 4, 8 or 16) per (row, KV head), each over a span of the keys
// (decode_cluster_kernel). q, k and v start on 16-byte boundaries.
// Returns cudaErrorInvalidValue for what it does not take, and where a
// block's shared memory would exceed what the card allows; a cluster the
// card cannot place comes back as CUDA's own error.
extern "C" int eamg_flash_decode_sp(const void* q, const void* k,
                                    const void* v, const int* t, void* o,
                                    int B, int H, int Hkv, int M, int Dh,
                                    float scale, int by_head, int C,
                                    int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || M <= 0 || t == nullptr ||
      (by_head != 0 && by_head != 1) || (!by_head && !valid_cluster(C)) ||
      !aligned16(q, k, v))
    return (int)cudaErrorInvalidValue;
  return by_instance(dtype, Dh, H / Hkv, [&](auto t_, auto dh, auto g) {
    using T = decltype(t_);
    constexpr int DH = decltype(dh)::value, G = decltype(g)::value;
    const cudaStream_t s = (cudaStream_t)stream;
    if constexpr (G > 1)
      if (by_head)
        return launch_heads<T, DH, G>(q, k, v, o, t, B * Hkv, Hkv, M, scale,
                                      s);
    if (by_head) return (int)cudaErrorInvalidValue;
    return launch_cluster<T, DH, G>(q, k, v, o, t, 0, B * Hkv, Hkv, M, 128,
                                    scale, C, s);
  });
}

// Bytes of shared memory a block of K3's kernel by head takes at (M, Dh,
// dtype), into *bytes (0 for an unknown Dh or dtype).
extern "C" int eamg_decode_heads_smem(int M, int Dh, int dtype,
                                      long long* bytes) {
  *bytes = 0;
  if (M <= 0) return (int)cudaErrorInvalidValue;
  return by_instance(dtype, Dh, 1, [&](auto t_, auto dh, auto) {
    *bytes = (long long)HeadsSmem(M, decltype(dh)::value, (int)sizeof(t_))
                 .total;
    return 0;
  });
}

// flash_decode (blocked 1: the running max of 256-key blocks) and
// flash_decode_vmem (blocked 0: the global max): MHA caches [B * H, M,
// Dh], one scalar t by value, a cluster of C blocks (1, 2, 4, 8 or 16) per
// (row, head); otherwise as K3.
extern "C" int eamg_flash_decode_scalar_t(const void* q, const void* k,
                                          const void* v, void* o, int BH,
                                          int M, int Dh, int t, float scale,
                                          int blocked, int C, int dtype,
                                          void* stream) {
  if (BH <= 0 || M <= 0 || (blocked != 0 && blocked != 1) ||
      !valid_cluster(C) || !aligned16(q, k, v))
    return (int)cudaErrorInvalidValue;
  return by_instance(dtype, Dh, 1, [&](auto t_, auto dh, auto g) {
    return launch_cluster<decltype(t_), decltype(dh)::value,
                          decltype(g)::value>(q, k, v, o, nullptr, t, BH, 1,
                                              M, blocked ? 256 : 0, scale, C,
                                              (cudaStream_t)stream);
  });
}

// How many clusters of C blocks of the kernel (g heads a KV head, key
// blocks of bk, 0 for the global max) the card keeps resident at once at
// (M, Dh, dtype): into *active (0 where a block would need more shared
// memory than the card allows).
extern "C" int eamg_decode_cluster_occupancy(int M, int Dh, int g, int bk,
                                             int C, int dtype, int* active) {
  if (M <= 0 || !valid_bk(bk) || !valid_cluster(C))
    return (int)cudaErrorInvalidValue;
  return by_instance(dtype, Dh, g, [&](auto t_, auto dh, auto g_) {
    return occupancy_k<decltype(t_), decltype(dh)::value,
                       decltype(g_)::value>(M, bk, C, active);
  });
}

#ifdef EAMG_PHASE_TIMING
// The shared memory of a block of the kernel at the shape, into *bytes (as
// the launcher computes it).
extern "C" int eamg_decode_cluster_smem(int M, int Dh, int g, int bk, int C,
                                        int dtype, long long* bytes) {
  if (M <= 0 || !valid_bk(bk) || !valid_cluster(C))
    return (int)cudaErrorInvalidValue;
  return by_instance(dtype, Dh, g, [&](auto t_, auto dh, auto g_) {
    *bytes = (long long)ClusterSmem(M, decltype(dh)::value,
                                    decltype(g_)::value, C, (int)sizeof(t_),
                                    bk)
                 .total;
    return 0;
  });
}
#endif
