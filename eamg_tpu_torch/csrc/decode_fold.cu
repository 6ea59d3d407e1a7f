// Fold decode: one new query per row against the fused, position-major KV
// cache, all heads, per-row lengths, GQA-native.
//
// Computes, for q [B, 1, D] in concat-heads order, kv [B, M, 2 * KVD] with
// K at [..., :KVD] and V at [..., KVD:], and the newest valid position
// t [B] per row,
//   o[b, h*Dh:(h+1)*Dh] = softmax(q[b, h] . K[b, 0..t[b], h / g] / sqrt(Dh))
//                         V[b, 0..t[b], h / g]
// into o [B, 1, D], concat-heads order again: no head split or merge
// outside the kernel. Any M is taken (the flagship's is 511); t is clamped
// to M - 1, and t = 0 over a zero cache row gives zeros. Statistics and
// accumulators are f32. Every call is one launch that allocates nothing.
//
// Rows 8 and 11: eamg_tpu/ops/decode_fold.py::flash_decode_fold_sp
// (_fold_sp_kernel) and ::flash_decode_fold3_sp (_fold3_sp_kernel), the
// decode attention of the ragged decode and the continuous-batching engine
// (ops/decode_fold.py::fold_decode). Both TPU kernels run an online softmax
// over 128-key blocks and round p = exp(s - m_cur) to the cache dtype
// unnormalised before p.v, then divide by the f32 sum; they differ only in
// the axis their softmax reduces along ([keys, H] against [H, keys]). So
// both are one function, and one kernel here: K3's (decode_kernels.cuh,
// decode_heads_kernel and decode_cluster_kernel) built for the fused
// layout, with K3's 128-key rounding (csrc/decode_attention.cu's note) and
// K3's plan (ops/decode_attention.py::sp_plan: from M, Dh, g and the dtype
// alone, never from B or t). t [B] is read on the card.
// What bounds it: the bytes of the prefix 0..t[b] of each row, 2 (t[b] +
// 1) KVD elements, with q and o: 0.68 MB at the engine step of PERF.md's
// table (B 8, H 8, Hkv 2, Dh 64, M 511, bf16, ragged t), 0.2 us at 3.35
// TB/s, against about one flop a byte of MHA: bound by bytes, and at that
// size by the launch (~5 us of a cold call) and by the latency of the first
// bytes. So every byte goes in flight at entry, on several SMs a (row, KV
// head):
//   - by head, where g > 1 and a block holds the KV head's keys and values
//     (the engine's GQA shape): a cluster of g blocks, one a query head;
//     block rank r copies its share of the prefix, multicast to all g
//     blocks, so each key and value is read once for the group, and no
//     block exchanges anything with another;
//   - else (MHA, f32 at M 511, long caches) a cluster of C blocks over
//     spans of the keys, through a ring of two slots, the 128-key blocks'
//     maxima and the partials exchanged through distributed shared memory.
// In the fused layout one KV head's key is a row of Dh contiguous elements
// (128 B in bf16 at Dh 64), 2 KVD elements from the next key's. A first
// design copied each row by a 1D bulk copy, the lanes of a warp issuing
// every 32nd: at the batched decode's MHA shape (~500 rows a block) the
// copies alone took ~12 us (PERF.md, PR 8). So the kernel reads the cache
// through a 3-D TMA tensor map over {2 KVD, M, B} with a box of {Dh, 32,
// 1}: one tensor copy brings 32 key rows of one head (by head: 16 copies of
// keys and 16 of values at t 510, spread over the g ranks), rows past M as
// zeros; a block's key rows are padded to a multiple of 32, where the rows
// past t[b] land unread. The map is encoded on the host once per (pointer,
// shape, dtype) and kept (a layer's cache keeps its pointer from step to
// step), passed by value as a __grid_constant__ argument. Dh (16, 32, 48,
// 64, 128) times 2 or 4 bytes, 2 KVD and q's row stride are multiples of
// 16 bytes, as the copies need (the wrapper checks the pointers). A row's
// result depends on its own (row, KV head), t[b] and the plan alone, so
// its bits are the same alone and inside any batch.
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
// of the port loads: thread 0 of every block of fold_cluster_kernel, and of
// the kernels of rows 8 and 11, then records %globaltimer and clock64 at
// each phase boundary (common.cuh, PHASE_STAMP), and two empty kernels (one
// block; B clusters of C blocks with a given number of cluster barriers)
// give the floor of that way of timing.
#include <cooperative_groups.h>
#include <cuda.h>

#include <algorithm>
#include <mutex>

#include "common.cuh"
#include "decode_kernels.cuh"

namespace {

// -- flash_decode_fold_sp and _fold3_sp: the tensor map of a fused cache

// cuTensorMapEncodeTiled, from the driver through the runtime (so the
// library needs no link to the driver), null where the driver lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// The 3-D tensor map over kv [B, M, W] (W = 2 KVD, elements of es bytes)
// with a box of {DH, KV_BOX, 1}: a key row of one head at a time, rows past
// M read as zeros. Encoded once per (pointer, shape, dtype) and kept: a
// layer's cache keeps its pointer from step to step, so a steady decode
// encodes nothing. The map is a launch argument, copied into the launch
// (a captured graph holds its own copy). Returns cudaErrorNotSupported
// where the driver has no tensor maps, cudaErrorUnknown where it refused
// to encode this one.
struct MapKey {
  const void* kv;
  int B, M, W, DH, dtype;
  bool operator==(const MapKey& o) const {
    return kv == o.kv && B == o.B && M == o.M && W == o.W && DH == o.DH &&
           dtype == o.dtype;
  }
};

cudaError_t kv_map(const MapKey& key, CUtensorMap* out) {
  constexpr int KEPT = 64;   // maps kept, replaced in turn past that
  static std::mutex mu;
  static MapKey keys[KEPT];
  static CUtensorMap maps[KEPT];
  static int n = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < std::min(n, KEPT); ++i)
    if (keys[i] == key) {
      *out = maps[i];
      return cudaSuccess;
    }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = key.dtype == EAMG_F32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)key.W, (cuuint64_t)key.M,
                              (cuuint64_t)key.B};
  const cuuint64_t strides[2] = {key.W * es, (cuuint64_t)key.M * key.W * es};
  const cuuint32_t box[3] = {(cuuint32_t)key.DH, (cuuint32_t)dk::KV_BOX, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUtensorMap m;
  const CUresult r = encode(
      &m,
      key.dtype == EAMG_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(key.kv), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorUnknown;
  keys[n % KEPT] = key;
  maps[n % KEPT] = m;
  ++n;
  *out = m;
  return cudaSuccess;
}

// -- flash_decode_fold, _fold2 and _fold3: a cluster of blocks per row

struct Args {
  const void* q;
  const void* kv;
  const int* t;
  void* o;
  int B, H, Hkv, M, q_stride;
  float scale;
  cudaStream_t stream;
};


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
  constexpr int NVR = DH / VE;        // 16-byte vectors of a (key, KV head)
  // lanes on such a row, a power of two for the shuffle tree (Dh 48: 6
  // vectors of bf16 on 8 lanes, 12 of f32 on 16, the rest idle)
  constexpr int LPR = dk::lanes_for(NVR);
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
    const bool on = sub < NVR;   // a lane with a vector of the row
    for (int base = warp * RPW; base < pairs; base += NW_CL * RPW) {
      const int it = base + lane / LPR;
      const bool ok = it < pairs;
      const int jj = ok ? it / Hkv : 0, hk = ok ? it % Hkv : 0;
      float kf[VE];
      if (on) load16(ks + (size_t)jj * RW + hk * DH + sub * VE, kf);
      for (int gi = 0; gi < g; ++gi) {
        const int h = hk * g + gi;
        const float* qh = qs + h * DH + sub * VE;
        float a = 0.f;
        if (on)
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

}  // namespace

// flash_decode_fold and _fold2 (before 0) and flash_decode_fold3 (before
// 1): a cluster of C blocks per batch row (C 1, 2, 4, 8 or 16), Dh 32, 48,
// 64 or 128; block rank
// r of row b takes the keys [r * Rt, (r + 1) * Rt) of the row's valid
// t[b] + 1, Rt = ceil((t[b] + 1) / C), cut at t[b] + 1, staged by every
// thread's 16-byte copies. q_stride: elements between the rows of q (a
// row's D elements are contiguous), so q may be the head of a fused QKV
// projection; kv 16-byte aligned. Returns cudaErrorInvalidValue when a block's shared memory (the
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
  const Args a = {q, kv, t, o, B, H, Hkv, M, q_stride, scale,
                  (cudaStream_t)stream};
  return by_instance(dtype, Dh, before != 0, [&](auto t_, auto dh, auto bf) {
    return launch_cluster_k<decltype(t_), decltype(dh)::value,
                            decltype(bf)::value>(a, C, (M + C - 1) / C);
  });
}

// flash_decode_fold_sp and flash_decode_fold3_sp: q [B, 1, D] with rows
// q_stride elements apart, kv [B, M, 2 KVD], t [B] int32 on the device
// (read by the kernel, never by the host), o [B, 1, D]; g = H / Hkv of 1,
// 2, 4 or 8, Dh 16, 32, 48, 64 or 128; bk the key blocks of the rounding
// reference (128, the TPU kernels' block_k). One launch: by_head 1, a
// cluster of g blocks per (row, KV head), one a query head (g > 1, and 2 M
// Dh elements must fit a block's shared memory); by_head 0, a cluster of C
// blocks (1, 2, 4, 8 or 16) per (row, KV head) over spans of the keys. q
// and kv start on 16-byte boundaries, and q's rows are a multiple of 16
// bytes apart. Returns cudaErrorInvalidValue for what it does not take,
// and where a block's shared memory would exceed what the card allows; a
// cluster the card cannot place comes back as CUDA's own error.
extern "C" int eamg_fold_decode_sp(const void* q, const void* kv,
                                   const int* t, void* o, int B, int H,
                                   int Hkv, int M, int Dh, int q_stride,
                                   float scale, int bk, int by_head, int C,
                                   int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || M <= 0 || t == nullptr ||
      bk != 128 || (by_head != 0 && by_head != 1) ||
      (!by_head && !dk::valid_cluster(C)) || !dk::aligned16(q, kv, kv))
    return (int)cudaErrorInvalidValue;
  return dk::by_instance(dtype, Dh, H / Hkv, [&](auto t_, auto dh, auto g) {
    using T = decltype(t_);
    constexpr int DH = decltype(dh)::value, G = decltype(g)::value;
    if (q_stride < H * DH || (q_stride * (int)sizeof(T)) % 16)
      return (int)cudaErrorInvalidValue;
    CUtensorMap map;
    const cudaError_t e = kv_map({kv, B, M, 2 * Hkv * DH, DH, dtype}, &map);
    if (e != cudaSuccess) return (int)e;
    const cudaStream_t s = (cudaStream_t)stream;
    if constexpr (G > 1)
      if (by_head)
        return dk::launch_heads<T, DH, G, true>(q, kv, kv, o, t, B * Hkv, Hkv,
                                                M, scale, q_stride, map, s);
    if (by_head) return (int)cudaErrorInvalidValue;
    return dk::launch_cluster<T, DH, G, true>(q, kv, kv, o, t, 1, B * Hkv,
                                              Hkv, M, bk, scale, C, q_stride,
                                              map, s);
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
