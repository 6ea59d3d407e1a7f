// K2 — fused FFN: out = act(x W1^T + b1) W2^T + b2, in one launch.
//
// Replaces eamg_tpu/ops/ffn.py::fused_ffn (_ffn_kernel), which the JAX
// model reaches from models/gpt.py::_mlp in every layer, in prefill and in
// every decode step.
//
// Layouts are torch's: x [rows, D], w1 [FF, D], w2 [D, FF], all of the
// input dtype T; b1 [FF] and b2 [D] of T or f32. Products accumulate in
// f32; where the sums are rounded follows a launch flag, the two orders of
// ops/ffn.py::ffn_plain:
//   - the Pallas kernel's (xla 0): + b1 in f32, activation (relu or exact
//     gelu), h rounded to T, second product, + b2 in f32, one rounding;
//   - the JAX model's kernels="xla" (xla 1), which every shipped demo
//     serves (_linear -> act -> _linear): x W1^T rounded to T, + b1 rounded
//     to T (the sum rounded again), the activation, h rounded; then
//     h W2^T rounded, + b2 rounded to T, rounded again.
// In f32 the two are one function. The flag adds two roundings to each
// phase's last step and changes nothing else.
//
// What bounds it: at the decode's rows (1 to 16) the two weight matrices
// are the whole traffic, 2 * D * FF elements (4 MB in bf16 at D 512, FF
// 2048, 1.25 us at 3.35 TB/s) against 4 * rows * D * FF flops: bound by
// bytes, by far. So the design is about bytes in flight on every SM, and
// about the fewest steps after they land:
//   - one block per slice of FS = 16 FF columns, G blocks in all (128 at
//     FF 2048, two an SM; a block takes slices b, b + G, ... where FF / 16
//     exceeds what the card keeps resident). At entry a block issues every
//     byte it needs as 16-byte cp.async copies before it waits for any:
//     the [16, D] slice of W1 with the x tile for phase 1, and its
//     ceil(D / G) rows of W2 for phase 2 (4 rows, 16 KB in bf16). D is
//     staged in panels of P elements (ops/ffn.py::ffn_plan: P = D up to
//     512, so the decode's shapes are one panel).
//   - phase 1, h[16 f, rows] = W1_slice x^T + b1, activation, h rounded to
//     T: bf16 on tensor cores, mma.sync m16n8k16 with the weight slice as
//     the 16-row A operand and the rows of x as the 8-wide B operand, the
//     D / 16 k-steps dealt to the 8 warps by k-step index and summed across
//     warps in warp order; f32 on CUDA cores (TF32 would lose the f32
//     checks), 16 threads per f column, each over a fixed quarter of every
//     64 elements of D, in float4 loads, summed in a fixed shuffle tree.
//     The block writes its h columns to a scratch [rows, FF] of T.
//   - one barrier across the grid, cooperative_groups' grid sync (the
//     launch is cooperative: every block is resident, or the launch is
//     refused, so none waits on a block that cannot run; the barrier's
//     state is the launch's own, so launches on two streams at once cannot
//     mix their arrivals); then phase 2 has no partial sums to combine: a
//     block computes whole outputs, out[r, d] = h[r, :] . W2[d, :] + b2[d],
//     for its rows d of W2, with h staged from the scratch (in L2), a warp
//     per (d, r), its lanes over FF in 16-byte vectors (two sums a lane),
//     summed in a fixed shuffle tree.
// Every order (the k-steps of each warp, the warps, the lanes over FF and
// their tree) is fixed by D and FF alone, never by rows or by the block
// that computes an output, so a row gets the same bits alone and inside a
// batch. wgmma (64-row tiles) would pay off at prefill's 128 rows only.
#include <cooperative_groups.h>

#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FS = 16;          // FF columns of a slice
constexpr int NR = 16;          // rows of a row tile
constexpr int NT = 256;         // threads a block
constexpr int NW = NT / 32;     // warps a block
constexpr int PANEL_MAX = 512;  // elements of D staged at once, at most
// shared memory for h rows in phase 2, and for a block's W2 rows: beyond
// these, h or W2 is read where it lies in device memory
constexpr size_t H_SMEM = 64 * 1024;
constexpr size_t W2_SMEM = 32 * 1024;

// the phase boundaries a timed build stamps (common.cuh): entry, every
// copy issued, W1 and x landed, h stored, past the grid barrier, h staged,
// outputs stored
constexpr int N_STAMP = 7;
#define FFN_STAMP(i) PHASE_STAMP(i, N_STAMP)

template <int ACT>
__device__ __forceinline__ float activation(float h) {
  if (ACT == 1) return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
  return fmaxf(h, 0.f);
}

// h of phase 1 from the f32 sum s and the bias b, in the order the flag
// names (xla: the sum and the biased sum rounded to T first)
template <typename T, int ACT>
__device__ __forceinline__ T finish_h(float s, float b, int xla) {
  const float v = xla ? round_to<T>(round_to<T>(s) + round_to<T>(b)) : s + b;
  return from_f32<T>(activation<ACT>(v));
}

// an output of phase 2 from the f32 sum a and the bias b, likewise
template <typename T>
__device__ __forceinline__ T finish_out(float a, float b, int xla) {
  return from_f32<T>(xla ? round_to<T>(a) + round_to<T>(b) : a + b);
}

// Phase 2 of a block: the rows of W2 it computes (ceil(D / G)), the h rows
// staged at once (0: read in place), and whether its W2 rows are staged.
struct Phase2 {
  int dpb, hr;
  bool w2_resident;
  __host__ __device__ Phase2(int D, int FF, int G, size_t es)
      : dpb((D + G - 1) / G),
        hr((int)(H_SMEM / (FF * es) < NR ? H_SMEM / (FF * es) : NR)),
        w2_resident((size_t)((D + G - 1) / G) * FF * es <= W2_SMEM) {}
};

// Byte offsets into a block's shared memory; the launcher and the kernel
// compute them from the same arguments. W1 and x rows are padded by 16
// bytes, so the mma fragments' 32-bit loads hit 32 distinct banks; the x
// tile of phase 1 and the h rows of phase 2 share their bytes.
template <typename T>
struct Smem {
  static constexpr int PAD = 16 / sizeof(T);
  int ks;   // row stride (elements) of W1 and x
  size_t w1, xh, w2, red, b1, b2, total;
  __host__ __device__ Smem(int P, int FF, const Phase2& q) : ks(P + PAD) {
    const size_t x_bytes = sizeof(T) * NR * ks;
    const size_t h_bytes = sizeof(T) * q.hr * FF;
    size_t off = 0;
    w1 = off;      // [FS][ks] of T: the W1 slice
    off += sizeof(T) * FS * ks;
    xh = off;      // [NR][ks] x tile, then [hr][FF] h rows, of T
    off += x_bytes > h_bytes ? x_bytes : h_bytes;
    w2 = off;      // [dpb][FF] of T: the block's W2 rows, if staged
    off += q.w2_resident ? sizeof(T) * q.dpb * FF : 0;
    red = off;     // [NW][FS][NR] f32: phase 1 of each warp (bf16 only)
    off += std::is_same<T, float>::value ? 0 : sizeof(float) * NW * FS * NR;
    b1 = off;      // b1 of a slice, in its own dtype
    off += sizeof(float) * FS;
    b2 = off;      // b2 of the block's rows, as f32
    off += (sizeof(float) * q.dpb + 15) / 16 * 16;
    total = off;
  }
};

// element i of a bias of T or (f32) float
template <typename T>
__device__ __forceinline__ float bias(const void* b, int i, int f32) {
  return f32 ? static_cast<const float*>(b)[i]
             : to_f32(static_cast<const T*>(b)[i]);
}

// 16 bytes of T as floats from device memory that another block wrote in
// this launch: through L2 (load16 of common.cuh reads anything else)
__device__ __forceinline__ void load16_cg(const float* p, float (&f)[4]) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load16_cg(const __nv_bfloat16* p,
                                          float (&f)[8]) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
  const uint4 u = make_uint4(v.x, v.y, v.z, v.w);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// The lane's share of h_row . w_row over FF (nvec vectors of 16 bytes,
// lane, lane + 32, ...), in two sums, one for each half of a vector, added
// at the end: a fixed order, and half the length of one chain of FMAs.
// cg: h in device memory, read through L2.
template <typename T>
__device__ __forceinline__ float lane_dot(const T* w, const T* h, int nvec,
                                          int lane, bool cg) {
  constexpr int VE = 16 / sizeof(T);
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 2
  for (int v = lane; v < nvec; v += 32) {
    float wf[VE], hf[VE];
    load16(w + v * VE, wf);
    if (cg)
      load16_cg(h + v * VE, hf);
    else
      load16(h + v * VE, hf);
#pragma unroll
    for (int i = 0; i < VE / 2; ++i) {
      a0 = fmaf(hf[i], wf[i], a0);
      a1 = fmaf(hf[VE / 2 + i], wf[VE / 2 + i], a1);
    }
  }
  return a0 + a1;
}

// Grid (G), cooperative; P elements of D a panel; hbuf: scratch [rows, FF]
// of T. Two blocks an SM (at most 128
// registers a thread); the launcher sizes G by what the card keeps
// resident.
template <typename T, int ACT>
__global__ void __launch_bounds__(NT, 2)
ffn_grid_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                const void* __restrict__ b1, const T* __restrict__ w2,
                const void* __restrict__ b2, T* __restrict__ out,
                T* __restrict__ hbuf, int rows, int D, int FF, int P,
                int bias_f32, int xla) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int VE = 16 / sizeof(T);  // elements in 16 bytes
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = gridDim.x, nsl = FF / FS, np = D / P;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;   // mma fragment row, column pair
  const Phase2 q2(D, FF, G, sizeof(T));
  const Smem<T> L(P, FF, q2);
  T* w1s = reinterpret_cast<T*>(smem + L.w1);
  T* xs = reinterpret_cast<T*>(smem + L.xh);
  T* hs = xs;
  T* w2s = reinterpret_cast<T*>(smem + L.w2);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const unsigned char* b1s = smem + L.b1;
  float* b2s = reinterpret_cast<float*>(smem + L.b2);
  const int bsz = bias_f32 ? 4 : (int)sizeof(T);   // bytes of a bias
  const int d0 = blockIdx.x * q2.dpb, nd = max(0, min(q2.dpb, D - d0));

  // panel p of the x tile of rows [r0, r0 + nr) and, with_w1, of the W1
  // slice j (with its b1 at panel 0): one group
  auto stage_w1x = [&](int j, int r0, int nr, int p, bool with_w1) {
    const int cpr = P / VE, skip = with_w1 ? 0 : FS;
    for (int e = tid; e < (FS - skip + nr) * cpr; e += NT) {
      const int row = e / cpr + skip, c = (e % cpr) * VE;
      const T* src = row < FS ? w1 + (size_t)(j * FS + row) * D
                              : x + (size_t)(r0 + row - FS) * D;
      T* dst = row < FS ? w1s + row * L.ks : xs + (row - FS) * L.ks;
      cp_async16(dst + c, src + p * P + c);
    }
    if (with_w1 && p == 0 && tid < FS * bsz / 16)
      cp_async16(smem + L.b1 + 16 * tid, static_cast<const unsigned char*>(
                                             b1) + j * FS * bsz + 16 * tid);
    cp_async_commit();
  };

  FFN_STAMP(0);
  stage_w1x(blockIdx.x, 0, min(NR, rows), 0, true);
  // the block's rows of W2 where they are staged: one group
  if (q2.w2_resident)
    for (int e = tid; e < nd * FF / VE; e += NT)
      cp_async16(w2s + e * VE, w2 + (size_t)d0 * FF + e * VE);
  cp_async_commit();
  // b2 of the block's first NT rows, in flight through phase 1
  const float b2v = tid < nd ? bias<T>(b2, d0 + tid, bias_f32) : 0.f;
  FFN_STAMP(1);

  // ---- phase 1: h = act(x W1^T + b1) of the block's slices, every row
  bool first = true;
  for (int j = blockIdx.x; j < nsl; j += G) {
    for (int r0 = 0; r0 < rows; r0 += NR) {
      const int nr = min(NR, rows - r0);
      float acc[2][4] = {};   // bf16: n-tiles of 8 rows x the mma's outputs
      float accf[NR] = {};    // f32: one output column f, every row
      const int fcol = tid / 16, sub = tid % 16;   // f32: thread's f, part
      for (int p = 0; p < np; ++p) {
        if (first) {
          cp_async_wait<1>();
          first = false;
        } else {
          stage_w1x(j, r0, nr, p, np > 1 || r0 == 0);
          cp_async_wait<0>();
        }
        __syncthreads();
        if (j == (int)blockIdx.x && r0 == 0 && p == 0) FFN_STAMP(2);
        if constexpr (BF16) {
          for (int s = warp; s < P / 16; s += NW) {
            const T* ar = w1s + g * L.ks + 16 * s + 2 * tq;
            const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * L.ks),
                                   ld32(ar + 8), ld32(ar + 8 * L.ks + 8)};
#pragma unroll
            for (int nt = 0; nt < NR / 8; ++nt) {
              if (nt * 8 < nr) {
                const T* br = xs + (nt * 8 + g) * L.ks + 16 * s + 2 * tq;
                mma_bf16(acc[nt], a, ld32(br), ld32(br + 8));
              }
            }
          }
        } else {
          for (int i = 0; i < P / 64; ++i) {
            const float4 w = *reinterpret_cast<const float4*>(
                w1s + fcol * L.ks + 64 * i + 4 * sub);
#pragma unroll
            for (int r = 0; r < NR; ++r) {
              if (r < nr) {
                const float4 v = *reinterpret_cast<const float4*>(
                    xs + r * L.ks + 64 * i + 4 * sub);
                accf[r] = fmaf(w.x, v.x, accf[r]);
                accf[r] = fmaf(w.y, v.y, accf[r]);
                accf[r] = fmaf(w.z, v.z, accf[r]);
                accf[r] = fmaf(w.w, v.w, accf[r]);
              }
            }
          }
        }
        __syncthreads();   // the panel's W1 and x are read
      }
      T* hout = hbuf + (size_t)r0 * FF + j * FS;
      if constexpr (BF16) {
        // red[w][f][r]; then thread (f, r) sums the warps in warp order
#pragma unroll
        for (int nt = 0; nt < NR / 8; ++nt) {
          float* rw = red + warp * FS * NR + nt * 8 + 2 * tq;
          rw[g * NR] = acc[nt][0];
          rw[g * NR + 1] = acc[nt][1];
          rw[(g + 8) * NR] = acc[nt][2];
          rw[(g + 8) * NR + 1] = acc[nt][3];
        }
        __syncthreads();
        const int f = tid % FS, r = tid / FS;   // NT == FS * NR
        if (r < nr) {
          float s = red[f * NR + r];
          for (int w = 1; w < NW; ++w) s += red[w * FS * NR + f * NR + r];
          const float b = bias<T>(b1s, f, bias_f32);
          hout[(size_t)r * FF + f] = finish_h<T, ACT>(s, b, xla);
        }
      } else {
#pragma unroll
        for (int r = 0; r < NR; ++r) {
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            accf[r] += __shfl_xor_sync(0xffffffffu, accf[r], o);
        }
        if (sub == 0) {
          const float b = bias<T>(b1s, fcol, bias_f32);
#pragma unroll
          for (int r = 0; r < NR; ++r)
            if (r < nr)
              hout[(size_t)r * FF + fcol] = finish_h<T, ACT>(accf[r], b, xla);
        }
      }
      __syncthreads();   // red and b1 are read: the next tile may stage
    }
  }
  FFN_STAMP(3);
  // every h is in the scratch: the cooperative launch's own barrier,
  // whose state is the launch's, and which orders the blocks' writes
  cg::this_grid().sync();
  FFN_STAMP(4);

  // ---- phase 2: out[r, d] of the block's rows d of W2, h rows staged
  // q2.hr at a time (read in place where not even one fits)
  for (int i = tid; i < nd; i += NT)
    b2s[i] = i < NT ? b2v : bias<T>(b2, d0 + i, bias_f32);
  cp_async_wait<0>();   // the block's W2 rows
  const int nvec = FF / VE, step = max(q2.hr, 1);
  for (int r0 = 0; r0 < rows; r0 += step) {
    const int nr = min(step, rows - r0);
    if (q2.hr > 0) {
      for (int e = tid; e < nr * nvec; e += NT)
        cp_async16(hs + e * VE, hbuf + (size_t)r0 * FF + e * VE);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    if (r0 == 0) FFN_STAMP(5);
    for (int pr = warp; pr < nd * nr; pr += NW) {
      const int dl = pr % nd, r = pr / nd;
      // both operands staged (the decode's shapes): shared-memory loads
      float a = q2.w2_resident && q2.hr > 0
                    ? lane_dot(w2s + (size_t)dl * FF, hs + (size_t)r * FF,
                               nvec, lane, false)
                    : lane_dot(q2.w2_resident ? w2s + (size_t)dl * FF
                                              : w2 + (size_t)(d0 + dl) * FF,
                               q2.hr > 0 ? hs + (size_t)r * FF
                                         : hbuf + (size_t)(r0 + r) * FF,
                               nvec, lane, q2.hr == 0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0)
        out[(size_t)(r0 + r) * D + d0 + dl] = finish_out<T>(a, b2s[dl], xla);
    }
    __syncthreads();   // the h rows are read
  }
  FFN_STAMP(6);
}

// What the launcher computes once per device and shape: G blocks, and
// their shared memory.
struct Launch {
  int G;
  size_t smem;
};

template <typename T, int ACT>
cudaError_t plan_launch(int D, int FF, int P, Launch* out) {
  constexpr int MAX_DEV = 64;
  static std::mutex mu;
  static int sms[MAX_DEV] = {};
  static size_t allowed[MAX_DEV] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEV) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  auto kern = ffn_grid_kernel<T, ACT>;
  const int nsl = FF / FS;
  // two blocks an SM where their shared memory allows, else one
  for (int per = 2; per >= 1; --per) {
    const int G = nsl < per * sms[dev] ? nsl : per * sms[dev];
    const size_t bytes = Smem<T>(P, FF, Phase2(D, FF, G, sizeof(T))).total;
    if (bytes > EAMG_MAX_SMEM) continue;
    if (allowed[dev] < bytes) {
      e = allow_smem(kern, bytes);
      if (e != cudaSuccess) return e;
      allowed[dev] = bytes;
    }
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kern, NT,
                                                      bytes);
    if (e != cudaSuccess) return e;
    if (resident >= per) {
      *out = {G, bytes};
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T, int ACT>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, void* hbuf, int rows, int D, int FF,
           int P, int bias_f32, int xla, cudaStream_t stream) {
  Launch l;
  cudaError_t e = plan_launch<T, ACT>(D, FF, P, &l);
  if (e != cudaSuccess) return (int)e;
  const T *xt = (const T*)x, *w1t = (const T*)w1, *w2t = (const T*)w2;
  T *ot = (T*)out, *ht = (T*)hbuf;
  void* args[] = {&xt, &w1t, &b1, &w2t, &b2, &ot, &ht,
                  &rows, &D, &FF, &P, &bias_f32, &xla};
  e = cudaLaunchCooperativeKernel((const void*)ffn_grid_kernel<T, ACT>,
                                  dim3(l.G), dim3(NT), args, l.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_act(int act, const void* x, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, void* hbuf,
               int rows, int D, int FF, int P, int bias_f32, int xla,
               cudaStream_t stream) {
  if (act == 1)
    return launch<T, 1>(x, w1, b1, w2, b2, out, hbuf, rows, D, FF, P,
                        bias_f32, xla, stream);
  return launch<T, 0>(x, w1, b1, w2, b2, out, hbuf, rows, D, FF, P,
                      bias_f32, xla, stream);
}

}  // namespace

// x, w1, w2 (and out) of dtype, 16-byte aligned; b1, b2 of dtype, or f32
// with bias_f32, b1 16-byte aligned. P from ops/ffn.py::ffn_plan: a
// multiple of 64 that divides D, at most 512. hbuf: scratch of rows * FF
// elements of dtype, the launch's own. act 0 relu, 1 exact gelu. xla 0:
// the Pallas kernel's rounding, 1: the JAX model's kernels="xla" rounding
// (see above). cudaErrorInvalidValue where no block of the shape fits on an
// SM.
extern "C" int eamg_fused_ffn(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* out,
                              void* hbuf, int rows, int D, int FF, int P,
                              int act, int xla, int bias_f32,
                              int dtype, void* stream) {
  if (D <= 0 || D % 64 || FF <= 0 || FF % 64 || rows <= 0 || P <= 0 ||
      P % 64 || P > PANEL_MAX || D % P || (act != 0 && act != 1) ||
      (xla != 0 && xla != 1) || (bias_f32 != 0 && bias_f32 != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EAMG_F32)
    return launch_act<float>(act, x, w1, b1, w2, b2, out, hbuf, rows, D, FF,
                             P, bias_f32, xla, s);
  if (dtype == EAMG_BF16)
    return launch_act<__nv_bfloat16>(act, x, w1, b1, w2, b2, out, hbuf, rows,
                                     D, FF, P, bias_f32, xla, s);
  return (int)cudaErrorInvalidValue;
}
