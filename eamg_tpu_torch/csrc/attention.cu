// K1 — prefill flash attention, GQA-native.
//
// Replaces eamg_tpu/ops/attention.py::flash_attention (_attn_kernel), which
// the JAX model reaches from models/gpt.py::attention in prefill.
//
// Computes o = softmax(q k^T / sqrt(Dh) + mask) v for q [B, H, T, Dh] and
// k, v [B, Hkv, T, Dh] (H a multiple of Hkv), with a per-row count of valid
// keys valid_len [B] and an optional causal mask; Dh 16, 32, 48, 64 or 128,
// any T. Statistics and the accumulator are f32; the output keeps the
// input dtype (f32 or bf16).
//
// What bounds it: at the served shapes (T = the prompt bucket, 16 to a few
// hundred rows, Dh 64) the work is a few MFLOP and the bytes a few hundred
// KB, so a launch is bound by latency: the launch, the first bytes, the
// few steps after them. Not by bytes or operations.
//
// bf16, attn_bf16_kernel, on tensor cores (mma.sync m16n8k16, f32 sums):
//   - the g = H / Hkv query heads of one KV head and its T positions form
//     the product's M dimension, g * T rows of one (row b, KV head),
//     position-major (row r is position r / g of head r % g), so each K/V
//     tile is read once for the whole group. A warp computes 16 rows; a
//     block of W warps takes 16 W rows (W from the wrapper,
//     ops/attention.py::WARPS, 4), and the grid is (ceil(g T / 16 W),
//     B * Hkv): at the solo prefill (g 4, T 16) 2 blocks of 4 warps;
//   - q, K and V staged by 16-byte cp.async into rows padded by 16 bytes
//     (conflict-free fragment loads), all issued at entry where two key
//     tiles hold the keys (T <= 256), else through a ring of two tiles;
//     keys past the block's causal frontier are never loaded (their rows
//     zero-filled up to the 16-key step), nor tiles past valid_len[b]: the
//     first tile is issued before valid_len[b] is read, so its copies do
//     not wait for that dependent load (its keys past it are masked);
//   - the online softmax runs over key tiles of 128 keys counted from key
//     0, the TPU kernel's block_k = min(128, T): S = Q K^T for the tile
//     (only the 16-key steps a warp's rows can see), masked keys -inf, the
//     running max m, the fully-masked guard m_safe, p = exp(s - m_safe),
//     l = alpha l + sum(p) of the unrounded p, and p rounded to bf16 before
//     P V, as the TPU kernel's p.astype(v.dtype) rounds it; V's B fragments
//     come from ldmatrix.trans. A tile takes two passes over its 16-key
//     steps, the max first, then p, l and P V with S recomputed (the
//     tensor cores' work is tiny; the loops stay short, so a cold call
//     fetches little code);
//   - every order is fixed by T, Dh and g: a warp's rows, its tiles and
//     steps follow from its 16-row index alone, never from B, W or the
//     block, so a row gets the same bits at any B.
// f32, attn_f32_kernel, on CUDA cores (TF32 would lose the f32 checks):
// one block per (32 positions, KV head, row) with g * 32 threads, each
// owning one (head, position) row in registers and folding keys one at a
// time into the online softmax; q, K and V read in 16-byte vectors. In f32
// rounding p is the identity, so the per-key rescaling computes the
// function of the 128-key tiles.
// Measured on an H100 SXM (chip_smoke.py, chip_sweep.py; PERF.md): at the
// solo prefill (B 1, H 8, Hkv 2, T 16, Dh 64, causal, bf16) ~5.6 us warm
// against ~7.2 us of one SDPA call, ~9.8 us cold against ~10.8 (the cold
// call's floor, an empty launch, ~5.2 us); 4 warps a block were the
// fastest or within noise of it at T 16, 64 and 511. At T 511 it is ~2.3x
// SDPA (few blocks, the S recomputation).
//
// Built a second time with -DEAMG_PHASE_TIMING (ops/_build.py, library
// attention_timed) for chip_smoke.py's kernel phase alone: thread 0 of
// every block of the bf16 kernel stamps %globaltimer and clock64 at entry,
// with every copy issued, with q and the first key tile landed, after the
// key loop and after the store (common.cuh, PHASE_STAMP); an empty launch
// of the same grid gives the floor.
#include "common.cuh"

namespace {

// ------------------------------------------------------ bf16: tensor cores

constexpr int BN = 128;   // keys of a tile: the TPU kernel's rounding block
constexpr int PADE = 8;   // row padding, elements (16 bytes)

// the phase boundaries a timed build stamps: entry, copies issued, q and
// the first tile landed, the key loop done, the output stored
constexpr int N_STAMP = 5;
#define ATTN_STAMP(i) PHASE_STAMP(i, N_STAMP)

// Keys a stage holds and stages in the ring, from T alone: one tile of
// min(128, T rounded up to 16) keys, two where T needs more than one.
struct AttnTiles {
  int kt, stages;
  __host__ __device__ AttnTiles(int T)
      : kt(T < BN ? (T + 15) / 16 * 16 : BN), stages(T > BN ? 2 : 1) {}
};

__host__ __device__ inline size_t attn_bf16_smem(int T, int DH, int W) {
  const AttnTiles a(T);
  return sizeof(__nv_bfloat16) * (DH + PADE) *
         (16 * (size_t)W + 2 * (size_t)a.stages * a.kt);
}

template <int DH>
__global__ void __launch_bounds__(256)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 const int* __restrict__ valid_len, int H, int Hkv, int T,
                 int causal, float scale) {
  constexpr int ST = DH + PADE;   // a staged row, elements
  constexpr int CPR = DH / 8;     // 16-byte chunks of a row
  constexpr int KS = DH / 16;     // k-steps of S = Q K^T
  constexpr int NN = DH / 8;      // 8-wide n-tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;    // the mma's group and thread
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv;
  const int g = H / Hkv, rows = g * T;
  const AttnTiles tiles(T);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [16W][ST]
  __nv_bfloat16* ks = qs + (size_t)16 * W * ST;   // [stages][kt][ST]
  __nv_bfloat16* vs = ks + (size_t)tiles.stages * tiles.kt * ST;
  ATTN_STAMP(0);

  // q rows of the block (rows past g T zero-filled), then key tiles; every
  // copy a 16-byte cp.async, one commit group per stage
  const int r_blk = blockIdx.x * 16 * W, r_w = r_blk + 16 * warp;
  const size_t q0 = ((size_t)b * H + (size_t)hk * g) * T;
  for (int e = tid; e < 16 * W * CPR; e += blockDim.x) {
    const int rr = e / CPR, c = e % CPR, r = r_blk + rr;
    const bool ok = r < rows;
    const size_t src = ok ? (q0 + (size_t)(r % g) * T + r / g) * DH : 0;
    cp_async16_zfill(qs + rr * ST + c * 8, q + src + c * 8, ok);
  }
  // the keys any row of the block can see (the causal frontier), then,
  // with valid_len[b], those it does see, and those of this warp's rows
  const int last_blk = min(r_blk + 16 * W, rows) - 1;
  const int front = causal ? min(T, last_blk / g + 1) : T;
  const size_t kv0 = (size_t)bh * T * DH;
  auto issue = [&](int i, int kend) {   // tile i into stage i % stages
    const int k0 = i * BN;
    const int n16 = (min(BN, kend - k0) + 15) / 16 * 16;
    __nv_bfloat16* kd = ks + (size_t)(i % tiles.stages) * tiles.kt * ST;
    __nv_bfloat16* vd = vs + (size_t)(i % tiles.stages) * tiles.kt * ST;
    for (int e = tid; e < n16 * CPR; e += blockDim.x) {
      const int j = e / CPR, c = e % CPR;
      const bool ok = k0 + j < kend;
      const size_t src = ok ? kv0 + (size_t)(k0 + j) * DH + c * 8 : 0;
      cp_async16_zfill(kd + j * ST + c * 8, k + src, ok);
      cp_async16_zfill(vd + j * ST + c * 8, v + src, ok);
    }
  };
  // the first tile up to the frontier before valid_len[b] is read (a
  // dependent load the copies need not wait for; keys past it are masked),
  // later tiles only below valid_len[b]
  issue(0, front);
  cp_async_commit();
  const int lim = max(0, min(valid_len[b], T));
  const int kend = min(lim, front);
  const int kend_w =
      r_w >= rows ? 0 : causal ? min(lim, min(r_w + 15, rows - 1) / g + 1)
                               : lim;
  const int ntile = (kend + BN - 1) / BN;
  if (tiles.stages > 1 && ntile > 1) issue(1, kend);
  cp_async_commit();
  ATTN_STAMP(1);

  // this thread's two rows (gq and gq + 8 of the warp's 16): positions
  const int pos0 = (r_w + gq) / g, pos1 = (r_w + gq + 8) / g;
  float acc[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  uint32_t qa[KS][4];
  const int lr = (lane % 8) + ((lane / 8) % 2) * 8, lc = (lane / 16) * 8;

  for (int i = 0; i < ntile; ++i) {
    cp_async_wait<1>();   // tile i (and q) landed for this thread
    __syncthreads();      // ... and for every thread
    if (i == 0) {
      ATTN_STAMP(2);
      const __nv_bfloat16* qr = qs + (size_t)(16 * warp + gq) * ST + 2 * tq;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qa[kk][0] = ld32(qr + 16 * kk);
        qa[kk][1] = ld32(qr + 8 * ST + 16 * kk);
        qa[kk][2] = ld32(qr + 16 * kk + 8);
        qa[kk][3] = ld32(qr + 8 * ST + 16 * kk + 8);
      }
    }
    const int k0 = i * BN;
    // the 16-key steps of this tile that the warp's rows can see
    const int nstep = (max(0, min(BN, kend_w - k0)) + 15) / 16;
    const __nv_bfloat16* kt = ks + (size_t)(i % tiles.stages) * tiles.kt * ST;
    const __nv_bfloat16* vt = vs + (size_t)(i % tiles.stages) * tiles.kt * ST;
    // S of 16-key step st: two 8-key n-tiles, masked keys -inf
    auto scores = [&](int st, float (&s)[2][4]) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * st + jj;
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
        const __nv_bfloat16* kr = kt + (size_t)(8 * j + gq) * ST + 2 * tq;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          mma_bf16(s[jj], qa[kk], ld32(kr + 16 * kk), ld32(kr + 16 * kk + 8));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          const bool ok = key < lim && (!causal || key <= (e < 2 ? pos0
                                                                 : pos1));
          s[jj][e] = ok ? s[jj][e] * scale : -INFINITY;
        }
      }
    };
    if (nstep > 0) {
      // the tile's max first (its p are rounded against it), then its p,
      // l and P V with S recomputed step by step: a short loop body, so
      // a cold call fetches little code
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll 1
      for (int st = 0; st < nstep; ++st) {
        float s[2][4];
        scores(st, s);
        mx0 = fmaxf(mx0, fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])));
        mx1 = fmaxf(mx1, fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])));
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      const float mc0 = fmaxf(m0, mx0), mc1 = fmaxf(m1, mx1);
      const float ms0 = isfinite(mc0) ? mc0 : 0.f;
      const float ms1 = isfinite(mc1) ? mc1 : 0.f;
      const float al0 = isfinite(m0) ? expf(m0 - ms0) : 0.f;
      const float al1 = isfinite(m1) ? expf(m1 - ms1) : 0.f;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll 1
      for (int st = 0; st < nstep; ++st) {
        float s[2][4];
        scores(st, s);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          s[jj][0] = expf(s[jj][0] - ms0);   // masked: exp(-inf) = 0
          s[jj][1] = expf(s[jj][1] - ms0);
          s[jj][2] = expf(s[jj][2] - ms1);
          s[jj][3] = expf(s[jj][3] - ms1);
          ps0 += s[jj][0] + s[jj][1];
          ps1 += s[jj][2] + s[jj][3];
        }
        // O += round(P) V: S's accumulators of a 16-key step are the A
        // operand's layout; V's B operand by ldmatrix.trans
        const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]),
                               pack_bf16(s[0][2], s[0][3]),
                               pack_bf16(s[1][0], s[1][1]),
                               pack_bf16(s[1][2], s[1][3])};
        const __nv_bfloat16* vr = vt + (size_t)(16 * st + lr) * ST + lc;
#pragma unroll
        for (int n = 0; n < NN; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vr + 8 * n);
          mma_bf16(acc[n], a, bv[0], bv[1]);
          mma_bf16(acc[n + 1], a, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, w);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, w);
      }
      l0 = al0 * l0 + ps0;
      l1 = al1 * l1 + ps1;
      m0 = mc0;
      m1 = mc1;
    }
    __syncthreads();   // stage i % stages is read
    if (tiles.stages > 1 && i + 2 < ntile) issue(i + 2, kend);
    cp_async_commit();
  }
  cp_async_wait<0>();
  ATTN_STAMP(3);

  const float d0 = 1.f / fmaxf(l0, 1e-30f), d1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = r_w + gq, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int d = 8 * n + 2 * tq;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(o + (q0 + (size_t)(r0 % g) * T + pos0) *
                                           DH + d) =
          pack_bf16(acc[n][0] * d0, acc[n][1] * d0);
    if (r1 < rows)
      *reinterpret_cast<uint32_t*>(o + (q0 + (size_t)(r1 % g) * T + pos1) *
                                           DH + d) =
          pack_bf16(acc[n][2] * d1, acc[n][3] * d1);
  }
  ATTN_STAMP(4);
}

// What a block of W warps may take at T, set once per (Dh, W) and larger
// size: the shared memory above 48 KB
template <int DH>
cudaError_t allow_bf16(size_t bytes) {
  static std::mutex mu;
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (allowed[dev] >= bytes) return cudaSuccess;
  e = allow_smem(attn_bf16_kernel<DH>, bytes);
  if (e == cudaSuccess) allowed[dev] = bytes;
  return e;
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const int* valid_len, int B, int H, int Hkv, int T,
                int causal, float scale, int W, cudaStream_t stream) {
  const size_t smem = attn_bf16_smem(T, DH, W);
  cudaError_t e = allow_bf16<DH>(smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = (H / Hkv) * T;
  const dim3 grid((rows + 16 * W - 1) / (16 * W), B * Hkv);
  attn_bf16_kernel<DH><<<grid, 32 * W, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, valid_len, H, Hkv, T,
      causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ f32: CUDA cores

constexpr int BQ = 32;  // query positions per block
constexpr int BK = 32;  // keys per shared-memory tile

template <int DH>
__global__ void attn_f32_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ o,
                                const int* __restrict__ valid_len, int H,
                                int Hkv, int T_len, int causal, float scale) {
  constexpr int V4 = DH / 4;   // float4 of a row
  __shared__ __align__(16) float ks[BK][DH];
  __shared__ __align__(16) float vs[BK][DH];
  const int g = H / Hkv;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int h = hk * g + tid / BQ;
  const int qi = q0 + tid % BQ;
  const bool active = qi < T_len;

  int kend = max(0, min(valid_len[b], T_len));
  if (causal) kend = min(kend, q0 + BQ);

  float qr[DH], acc[DH];
  const float4* qp = reinterpret_cast<const float4*>(
      q + (((size_t)b * H + h) * T_len + (active ? qi : 0)) * DH);
#pragma unroll
  for (int d = 0; d < V4; ++d) {
    const float4 x = active ? qp[d] : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * d] = x.x;
    qr[4 * d + 1] = x.y;
    qr[4 * d + 2] = x.z;
    qr[4 * d + 3] = x.w;
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  const float4* kp = reinterpret_cast<const float4*>(
      k + ((size_t)b * Hkv + hk) * T_len * DH);
  const float4* vp = reinterpret_cast<const float4*>(
      v + ((size_t)b * Hkv + hk) * T_len * DH);

  for (int j0 = 0; j0 < kend; j0 += BK) {
    const int n = min(BK, kend - j0);
    __syncthreads();
    for (int e = tid; e < n * V4; e += blockDim.x) {
      reinterpret_cast<float4*>(&ks[e / V4][0])[e % V4] = kp[j0 * V4 + e];
      reinterpret_cast<float4*>(&vs[e / V4][0])[e % V4] = vp[j0 * V4 + e];
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
    float4* op = reinterpret_cast<float4*>(
        o + (((size_t)b * H + h) * T_len + qi) * DH);
#pragma unroll
    for (int d = 0; d < V4; ++d)
      op[d] = make_float4(acc[4 * d] / den, acc[4 * d + 1] / den,
                          acc[4 * d + 2] / den, acc[4 * d + 3] / den);
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const int* valid_len, int B, int H, int Hkv, int T_len,
               int causal, float scale, cudaStream_t stream) {
  const dim3 grid((T_len + BQ - 1) / BQ, Hkv, B);
  attn_f32_kernel<DH><<<grid, (H / Hkv) * BQ, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      valid_len, H, Hkv, T_len, causal, scale);
  return (int)cudaGetLastError();
}

// f(Int<DH>{}) for the runtime Dh
template <typename F>
int by_dh(int Dh, F&& f) {
  switch (Dh) {
    case 16: return f(Int<16>{});
    case 32: return f(Int<32>{});
    case 48: return f(Int<48>{});
    case 64: return f(Int<64>{});
    case 128: return f(Int<128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o 16-byte aligned, contiguous; W: warps a block of the bf16
// kernel (1 to 8; the f32 kernel takes g * 32 threads, g <= 32). Returns
// cudaErrorInvalidValue for what it does not take.
extern "C" int eamg_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, const int* valid_len, int B, int H,
                                  int Hkv, int T_len, int Dh, int causal,
                                  float scale, int W, int dtype,
                                  void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || T_len < 1 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EAMG_F32) {
    if ((H / Hkv) * BQ > 1024) return (int)cudaErrorInvalidValue;
    return by_dh(Dh, [&](auto dh) {
      return launch_f32<decltype(dh)::value>(q, k, v, o, valid_len, B, H, Hkv,
                                             T_len, causal, scale, s);
    });
  }
  if (dtype == EAMG_BF16) {
    if (W < 1 || W > 8) return (int)cudaErrorInvalidValue;
    return by_dh(Dh, [&](auto dh) {
      return launch_bf16<decltype(dh)::value>(q, k, v, o, valid_len, B, H,
                                              Hkv, T_len, causal, scale, W, s);
    });
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef EAMG_PHASE_TIMING
namespace {
__global__ void empty_grid_kernel() {}
}  // namespace

// The floor of the bf16 kernel's launch: an empty kernel of its grid, its
// block size and its shared memory at (B, H, Hkv, T, Dh, W).
extern "C" int eamg_attention_empty(int B, int H, int Hkv, int T_len, int Dh,
                                    int W, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || W < 1 || W > 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = attn_bf16_smem(T_len, Dh, W);
  cudaError_t e = allow_smem(empty_grid_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = (H / Hkv) * T_len;
  const dim3 grid((rows + 16 * W - 1) / (16 * W), B * Hkv);
  empty_grid_kernel<<<grid, 32 * W, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
#endif
