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
// The kernels live in decode_kernels.cuh, built here for the head-major
// layout and in csrc/decode_fold.cu for the fused one (rows 8 and 11).
//
// Built a second time with -DEAMG_PHASE_TIMING (ops/_build.py, library
// decode_attention_timed) for chip_smoke.py's kernel phase alone: thread 0
// of every block records %globaltimer and clock64 at each phase boundary
// (common.cuh, PHASE_STAMP); an empty cluster launch of the same grid
// (decode_fold_timed's eamg_empty_launch, blocks of 256 threads too) gives
// the floor.
#include "decode_kernels.cuh"

using namespace dk;

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
        return launch_heads<T, DH, G, false>(q, k, v, o, t, B * Hkv, Hkv, M,
                                             scale, 0, 0, s);
    if (by_head) return (int)cudaErrorInvalidValue;
    return launch_cluster<T, DH, G, false>(q, k, v, o, t, 1, B * Hkv, Hkv, M,
                                           128, scale, C, 0, 0, s);
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
// Dh], one t for the whole batch, read on the card from *t (as the TPU
// kernel reads it from its scalar memory), a cluster of C blocks (1, 2, 4,
// 8 or 16) per (row, head); otherwise as K3.
extern "C" int eamg_flash_decode_scalar_t(const void* q, const void* k,
                                          const void* v, void* o, int BH,
                                          int M, int Dh, const int* t,
                                          float scale, int blocked, int C,
                                          int dtype, void* stream) {
  if (BH <= 0 || M <= 0 || t == nullptr || (blocked != 0 && blocked != 1) ||
      !valid_cluster(C) || !aligned16(q, k, v))
    return (int)cudaErrorInvalidValue;
  return by_instance(dtype, Dh, 1, [&](auto t_, auto dh, auto g) {
    return launch_cluster<decltype(t_), decltype(dh)::value,
                          decltype(g)::value, false>(
        q, k, v, o, t, 0, BH, 1, M, blocked ? 256 : 0, scale, C, 0, 0,
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
