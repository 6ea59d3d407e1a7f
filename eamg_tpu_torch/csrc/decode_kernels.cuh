// The decode cluster kernels, shared by two libraries: K3 and rows 5 and 6
// over head-major caches (csrc/decode_attention.cu), rows 8 and 11 over
// the fused position-major cache (csrc/decode_fold.cu). The layout is a
// template parameter (FUSED); the head-major instantiations are the code
// of csrc/decode_attention.cu's note, and each source's note says what
// its kernels replace and why they are built so. One header, two
// translation units, so the two libraries build in parallel.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>

#include <type_traits>

#include "common.cuh"

// Internal linkage (the anonymous namespace), as in a source of its own:
// each library keeps its own function-local statics (what a kernel has been
// let take, ClusterAllowance), which a named namespace would share between
// two libraries that a process loads (the decode_fold and decode_fold_timed
// builds), so the second would launch without its own attributes set.
namespace dk {
namespace {

constexpr int NT_CL = 256;          // threads of a cluster's block
constexpr int NW_CL = NT_CL / 32;
constexpr int CL_MAX = 16;          // blocks in a cluster, at most (sm_90)
// bytes of a staging slot, at most: at the batched decode's M 511 (C 2)
// two 16 KB chunks of keys landed sooner than one of 32 KB (PERF.md)
constexpr size_t SLOT_MAX = 16384;
// Key rows a tensor copy of the fused layout brings (the box of its tensor
// map, ops/decode_fold.py::SP_BOX): a run of keys is staged in boxes of
// KV_BOX rows, so the key rows of a block's shared memory are padded to a
// multiple of it
constexpr int KV_BOX = 32;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

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
  int R, NK, NKP, NB, LB;
  size_t bar, slot, qs, sc, xm, pm, fm, red, lsum, inbox, total;
  // box: the key rows a copy brings (1 head-major, KV_BOX fused); a slot
  // holds NK keys, NKP = NK rounded up to a box
  __host__ __device__ ClusterSmem(int M, int DH, int G, int C, int es,
                                  int bk, int box = 1)
      : R((M + C - 1) / C),
        NK(R < (int)(SLOT_MAX / (DH * es)) ? R : (int)(SLOT_MAX / (DH * es))),
        NKP(round_up(NK, box)),
        NB(bk > 0 ? (M + bk - 1) / bk : 1),
        LB(bk > 0 ? (R + bk - 1) / bk + 1 : 1) {
    size_t off = 0;
    bar = off;           // four mbarriers: one a slot, the leader's inbox,
    off += 128;          // the maxima
    slot = off;          // [2][NKP][DH] of T: the ring of two chunks
    off += 2 * (size_t)NKP * DH * es;
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

// Where block row bh = b * Hkv + hk's keys, values and query heads lie.
// Head-major (FUSED false: K3, rows 5 and 6): caches [B * Hkv, M, DH] and
// q [B * H, DH], key j at k + (bh M + j) DH, so a span's keys are one
// contiguous run, one bulk copy. Fused (rows 8 and 11): one position-major
// cache kv [B, M, 2 KVD], KVD = Hkv DH, K at [..., :KVD]: key j of KV
// head hk is a row of DH contiguous elements at kv + (b M + j) 2 KVD + hk
// DH, 2 KVD from the next key's, and its value KVD further. The kernel
// reads it through a 3-D tensor map over {2 KVD, M, B} with a box of {DH,
// KV_BOX, 1} (ops/decode_fold.py, csrc/decode_fold.cu): one tensor copy
// brings KV_BOX key rows of one head, rows past M filled with zeros. q's
// rows lie q_stride elements apart (q may be the head of the fused QKV
// projection), the G heads of KV head hk contiguous at b q_stride + hk G
// DH. The output is o [B * H, DH] (concat-heads order) in both.
template <bool FUSED>
struct KVMap {
  using type = int;          // head-major: no tensor map
};
template <>
struct KVMap<true> {
  using type = CUtensorMap;
};

template <typename T, int DH, int G, bool FUSED>
__device__ __forceinline__ const T* q_base(const T* q, int bh, int Hkv,
                                           int q_stride) {
  if constexpr (FUSED) {
    const int b = bh / Hkv;
    return q + (size_t)b * q_stride + (bh - b * Hkv) * G * DH;
  } else {
    return q + (size_t)bh * G * DH;
  }
}

// the box at (c0, c1, c2) of the tensor map at `map` (a __grid_constant__
// parameter) into dst (128-byte aligned), completing on bar; the multicast
// form lands it at the same offset, and completes on the same barrier, in
// every block of the cluster that `mask` names
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int c0,
                                            int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d_multicast(void* dst,
                                                      const void* map, int c0,
                                                      int c1, int c2,
                                                      uint64_t* bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::
          "r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}
// the tensor map's descriptor fetched ahead of the first copy
__device__ __forceinline__ void prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
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
// nv % C ranks. t is t_rows[b * t_stride], read on the card: t_stride 1
// for a t a batch row, 0 for one t of the whole batch. bks: log2
// of the length of the rounding reference's key blocks (7 or 8), 0 for
// the global max. FUSED: the fused layout (q_base), k and v unused, the
// keys and values read through kvmap, q_stride its q's.
template <typename T, int DH, int G, bool FUSED>
__global__ void __launch_bounds__(NT_CL)
decode_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      const int* __restrict__ t_rows, int t_stride, int Hkv,
                      int M, int bks, float scale, int q_stride,
                      const __grid_constant__ typename KVMap<FUSED>::type
                          kvmap) {
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
  const ClusterSmem L(M, DH, G, C, (int)sizeof(T), bk, FUSED ? KV_BOX : 1);
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
  // this row's t: a load from device memory that is in flight while the
  // barriers are set
  const int t = t_rows[(bh / Hkv) * t_stride];
  if (tid == 0) {
    if constexpr (FUSED) prefetch_map(&kvmap);
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
  // i - nch, into slot i % 2, on barrier i % 2, issued by thread 0; q
  // rides with the first. Head-major: one contiguous run, one bulk copy.
  // Fused: ceil(rows / KV_BOX) tensor copies of KV_BOX rows each (rows past
  // the chunk land in the slot's padding, past M as zeros).
  auto issue = [&](int i) {
    const int c = i < nch ? i : i - nch;
    const int rows = min(L.NK, n - c * L.NK);
    const uint32_t qb = i == 0 ? G * DH * sizeof(T) : 0;
    T* dst = slot + (size_t)(i % 2) * L.NKP * DH;
    if constexpr (FUSED) {
      const int b = bh / Hkv, hk = bh - b * Hkv;
      const int nbx = (rows + KV_BOX - 1) / KV_BOX;
      mbar_expect_tx(bar + i % 2,
                     (uint32_t)(nbx * KV_BOX * DH * (int)sizeof(T)) + qb);
      if (qb) bulk_copy(qs, q_base<T, DH, G, FUSED>(q, bh, Hkv, q_stride),
                        qb, bar);
      const int col = (i < nch ? 0 : Hkv * DH) + hk * DH;
      for (int x = 0; x < nbx; ++x)
        tma_load_3d(dst + (size_t)x * KV_BOX * DH, &kvmap, col,
                    s0 + c * L.NK + x * KV_BOX, b, bar + i % 2);
    } else {
      const uint32_t bytes = (uint32_t)(rows * DH * (int)sizeof(T));
      mbar_expect_tx(bar + i % 2, bytes + qb);
      if (qb) bulk_copy(qs, q + (size_t)bh * G * DH, qb, bar);
      bulk_copy(dst, (i < nch ? kp : vp) + (size_t)c * L.NK * DH, bytes,
                bar + i % 2);
    }
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
    const T* ks = slot + (size_t)(c % 2) * L.NKP * DH;
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
    const T* vs = slot + (size_t)(i % 2) * L.NKP * DH;
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
// box: the key rows a copy brings (1 head-major, KV_BOX fused), to which
// the rows of ks and vs are padded.
struct HeadsSmem {
  size_t bar, ks, vs, qs, sc, pm, fm, red, lsum, total;
  __host__ __device__ HeadsSmem(int M, int DH, int es, int box = 1) {
    const int NB = (M + 127) / 128;
    const size_t rows = (size_t)round_up(M, box);
    size_t off = 0;
    bar = off;           // two mbarriers: the keys (and q), the values
    off += 128;
    ks = off;            // [rows][DH] of T: every key of the KV head
    off += rows * DH * es;
    vs = off;            // [rows][DH] of T: every value
    off += rows * DH * es;
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
// block reads another's memory. FUSED: the fused layout (q_base, kvmap):
// the keys 0..t in boxes of KV_BOX rows, box x issued by rank x % G (a
// tensor copy of the keys and one of the values, multicast), rows past t
// landing in the padding.
template <typename T, int DH, int G, bool FUSED>
__global__ void __launch_bounds__(NT_CL)
decode_heads_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    const int* __restrict__ t_rows, int Hkv, int M,
                    float scale, int q_stride,
                    const __grid_constant__ typename KVMap<FUSED>::type
                        kvmap) {
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
  const HeadsSmem L(M, DH, (int)sizeof(T), FUSED ? KV_BOX : 1);
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
    if constexpr (FUSED) prefetch_map(&kvmap);
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  HEADS_STAMP(1);
  const int nv = max(0, min(t, M - 1) + 1);
  // fused: every box of KV_BOX rows that the keys 0..t touch, whole
  const int nbx = (nv + KV_BOX - 1) / KV_BOX;
  const uint32_t run = (uint32_t)((FUSED ? nbx * KV_BOX : nv) * DH *
                                  (int)sizeof(T));
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
  const uint16_t all = (uint16_t)((1u << G) - 1);
  if constexpr (FUSED) {
    if (tid == 0) {
      const int b = bh / Hkv, col = (bh - b * Hkv) * DH;
      bulk_copy(qs, q_base<T, DH, G, FUSED>(q, bh, Hkv, q_stride) + r * DH,
                DH * sizeof(T), bar);
      for (int x = r; x < nbx; x += G) {
        tma_load_3d_multicast(ks + (size_t)x * KV_BOX * DH, &kvmap, col,
                              x * KV_BOX, b, bar, all);
        tma_load_3d_multicast(vs + (size_t)x * KV_BOX * DH, &kvmap,
                              Hkv * DH + col, x * KV_BOX, b, bar + 1, all);
      }
    }
  } else {
    if (tid == 0) {
      bulk_copy(qs, q + ((size_t)bh * G + r) * DH, DH * sizeof(T), bar);
      if (n > 0) {
        const size_t at = (size_t)s0 * DH;
        const uint32_t bytes = (uint32_t)(n * DH * (int)sizeof(T));
        bulk_copy_multicast(ks + at, k + (size_t)bh * M * DH + at, bytes,
                            bar, all);
        bulk_copy_multicast(vs + at, v + (size_t)bh * M * DH + at, bytes,
                            bar + 1, all);
      }
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
template <typename T, int DH, int G, bool FUSED>
cudaError_t prepare_cluster(size_t bytes) {
  static ClusterAllowance allowed;
  return allow_cluster(decode_cluster_kernel<T, DH, G, FUSED>, bytes,
                       allowed);
}

// q_stride: the elements between q's rows (fused layout only)
template <typename T, int DH, int G, bool FUSED>
int launch_cluster(const void* q, const void* k, const void* v, void* o,
                   const int* t_rows, int t_stride, int rows, int Hkv, int M,
                   int bk, float scale, int C, int q_stride,
                   const typename KVMap<FUSED>::type& kvmap,
                   cudaStream_t stream) {
  const ClusterSmem L(M, DH, G, C, (int)sizeof(T), bk, FUSED ? KV_BOX : 1);
  if (L.total > EAMG_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare_cluster<T, DH, G, FUSED>(L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(C, rows, NT_CL, L.total, stream, &attr);
  const int bks = bk == 0 ? 0 : bk == 128 ? 7 : 8;
  e = cudaLaunchKernelEx(&cfg, decode_cluster_kernel<T, DH, G, FUSED>,
                         (const T*)q, (const T*)k, (const T*)v, (T*)o,
                         t_rows, t_stride, Hkv, M, bks, scale, q_stride,
                         kvmap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int DH, int G, bool FUSED>
int launch_heads(const void* q, const void* k, const void* v, void* o,
                 const int* t_rows, int rows, int Hkv, int M, float scale,
                 int q_stride, const typename KVMap<FUSED>::type& kvmap,
                 cudaStream_t stream) {
  static ClusterAllowance allowed;
  const HeadsSmem L(M, DH, (int)sizeof(T), FUSED ? KV_BOX : 1);
  if (L.total > EAMG_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      allow_cluster(decode_heads_kernel<T, DH, G, FUSED>, L.total, allowed);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(G, rows, NT_CL, L.total, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, decode_heads_kernel<T, DH, G, FUSED>,
                         (const T*)q, (const T*)k, (const T*)v, (T*)o, t_rows,
                         Hkv, M, scale, q_stride, kvmap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of C blocks the card keeps resident at once at the
// shape (0 where a block's shared memory would exceed what it allows). The
// head-major kernel's; the fused one takes the same shared memory.
template <typename T, int DH, int G>
int occupancy_k(int M, int bk, int C, int* active) {
  const ClusterSmem L(M, DH, G, C, (int)sizeof(T), bk);
  *active = 0;
  if (L.total > EAMG_MAX_SMEM) return 0;
  cudaError_t e = prepare_cluster<T, DH, G, false>(L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(C, 1, NT_CL, L.total, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      active, decode_cluster_kernel<T, DH, G, false>, &cfg);
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
}  // namespace dk
