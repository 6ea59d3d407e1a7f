// K4 — exact k-th largest value per row (the top-k sampling threshold), and
// the sampler's top-k mask from the same launch.
//
// Replaces eamg_tpu/ops/topk.py::kth_value_pallas (_threshold_kernel); the
// JAX sampler (decode/sampling.py) runs its XLA twin kth_value_bitsearch,
// which gives the same output, on every sampled decode step, and then
// apply_top_k's mask: logits + (logits >= t ? 0 : mask_value).
//
// Keys: each f32 logit maps to an order-preserving uint32 key (sign bit set
// for x >= 0, all bits flipped for x < 0). The TPU kernel finds, most
// significant bit first, the largest key t with count(keys >= t) >= k: 32
// compare-and-count passes. That t is the k-th largest key K itself (ties
// counted with their multiplicity): count(keys >= K) >= k, and every t > K
// has count(keys >= t) <= count(keys > K) <= k - 1. So a select that finds K
// digit by digit gives the same answer, bit for bit, ties, +-inf and NaN
// included: here 4 passes of an 8-bit digit, most significant first. Pass p
// counts, in a 256-bin histogram, the digit p of every key whose higher
// digits equal the prefix chosen so far; the digit of K is the largest d
// with count(bins >= d) >= k', and k' drops by count(bins > d), the keys
// above K that this digit settles. Integer counts keep it exact.
//
// What bounds it: it reads V * 4 bytes per row once (36 KB at V 8892), and
// the mask writes as many, so the bound is bytes; at one row a launch is
// latency-bound: the launch, one read of the row, then passes that each
// end in a barrier. Design, one block per row (512 threads, or 1024 where
// V is no multiple of 4 and the row loads element by element):
// - the row is read once, with 16-byte loads, into keys held in registers
//   (16384 a row); a longer row goes to a kernel of 1024 threads that reads
//   it again from L2 in each pass (the TPU kernel's VMEM held any row);
// - the histograms take a shared-memory atomic a key. A row's logits share
//   a dozen top bytes (the sign and the exponent's top bits), so pass 1
//   puts thousands of keys on a few addresses; on the H100 the shared
//   atomics resolve that faster than both ways that avoid it:
//   __match_any_sync with one atomic per distinct digit of a warp, and
//   per-warp sub-histograms summed after a second barrier (both measured
//   slower at every path shape, PERF.md);
// - one barrier a pass: each pass has its own histogram, all four
//   zeroed at entry, and every warp scans the finished histogram itself
//   (two 16-byte loads a lane and a warp suffix sum), so no second barrier
//   hands the digit around;
// - after pass 2 the keys under the 16-bit prefix are a handful (but for
//   ties): where at most FEW, the block copies them to shared memory and
//   warp 0 alone runs passes 3 and 4 over them, __syncwarp in place of the
//   block barrier, while the other warps wait for the threshold at one
//   barrier (a copy of the few hundred keys under pass 1's digit was tried
//   and made no pass shorter: the appends cost what the walks saved);
// - the mask (eamg_top_k_mask) is written from the keys still in registers
//   once the threshold is known: out = x + (x >= t ? 0 : mask_value), the
//   float compare and f32 add of the sampler's three-op expression, so
//   -0.0 + 0.0 gives +0.0 and NaN stays NaN as they do there.
#include "common.cuh"

namespace {

constexpr uint32_t FULL = 0xffffffffu;
constexpr int REG_KEYS = 16384;  // keys a block holds in registers
constexpr int FEW = 128;  // keys under 16 bits of prefix one warp finishes
// stamps: entry, loaded, passes 1-4 (3 and 4: the keys gathered, warp 0's
// two passes, where it finishes), stored
constexpr int NSTAMP = 7;

__device__ __forceinline__ uint32_t to_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t t) {
  return __uint_as_float((t & 0x80000000u) ? (t & 0x7FFFFFFFu) : ~t);
}

__device__ __forceinline__ float masked(float x, float t, float mask_value) {
  return x + (x >= t ? 0.f : mask_value);
}

// the digit at `shift` of `key` into histogram h, if `take`
__device__ __forceinline__ void count_digit(int* h, uint32_t key, bool take,
                                            int shift) {
  if (take) atomicAdd(h + ((key >> shift) & 0xFFu), 1);
}

// Every warp, on the finished histogram h of the keys under `prefix`: the
// digit of the kk-th largest of them, from the top, into prefix at `shift`,
// kk less the keys in the bins above it, and the keys in its bin (those
// under the longer prefix). Lane l holds bins 8l..8l+7.
__device__ __forceinline__ void scan_digit(const int* h, int lane, int shift,
                                           uint32_t& prefix, int& kk,
                                           int& in_bin) {
  const int4 a = reinterpret_cast<const int4*>(h)[2 * lane];
  const int4 b = reinterpret_cast<const int4*>(h)[2 * lane + 1];
  const int c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j];
  int incl = s;  // keys in the bins of lanes >= this one
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(FULL, incl, o);
    if (lane + o < 32) incl += y;
  }
  const int above = incl - s;
  const bool here = above < kk && kk <= incl;
  int d = 0, rest = 0, n = 0, acc = above;
  bool found = false;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    if (here && !found && acc + c[j] >= kk) {
      found = true;
      d = 8 * lane + j;
      rest = kk - acc;
      n = c[j];
    }
    acc += c[j];
  }
  const int src = __ffs(__ballot_sync(FULL, here)) - 1;
  prefix |= (uint32_t)__shfl_sync(FULL, d, src) << shift;
  kk = __shfl_sync(FULL, rest, src);
  in_bin = __shfl_sync(FULL, n, src);
}

// Keys of the row in registers: J slots of 4 a thread. VEC: slot group j is
// the 16-byte chunk tid + j * NT (V % 4 == 0, 16-byte aligned rows); else
// slot i is the element tid + i * NT.
template <int NT, int J, bool VEC, bool MASK>
__global__ void __launch_bounds__(NT)
topk_reg_kernel(const float* __restrict__ logits, float* __restrict__ thr,
                float* __restrict__ out, int V, int k, float mask_value) {
  __shared__ __align__(16) int hist[4][256];
  __shared__ uint32_t few[FEW];
  __shared__ int n_few;
  __shared__ uint32_t picked;
  constexpr int S = 4 * J;
  PHASE_STAMP(0, NSTAMP);
  const int tid = threadIdx.x, lane = tid % 32;
  for (int i = tid; i < 4 * 256; i += NT) (&hist[0][0])[i] = 0;
  if (tid == 0) n_few = 0;
  const size_t off = (size_t)blockIdx.x * V;
  const float* row = logits + off;
  auto index = [&](int i) {
    return VEC ? 4 * (tid + (i / 4) * NT) + i % 4 : tid + i * NT;
  };
  uint32_t key[S];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if constexpr (VEC) {
      const int c = tid + j * NT;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < V / 4) f = reinterpret_cast<const float4*>(row)[c];
      key[4 * j] = to_key(f.x);
      key[4 * j + 1] = to_key(f.y);
      key[4 * j + 2] = to_key(f.z);
      key[4 * j + 3] = to_key(f.w);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = index(4 * j + e);
        key[4 * j + e] = i < V ? to_key(row[i]) : 0u;
      }
    }
  }
  __syncthreads();
  PHASE_STAMP(1, NSTAMP);
  uint32_t prefix = 0, pmask = 0;
  int kk = k, in_bin = V;
  const auto pass = [&](int p) {
    const int shift = 24 - 8 * p;
#pragma unroll
    for (int i = 0; i < S; ++i)
      count_digit(hist[p], key[i],
                  index(i) < V && ((key[i] ^ prefix) & pmask) == 0, shift);
    __syncthreads();
    scan_digit(hist[p], lane, shift, prefix, kk, in_bin);
    pmask |= 0xFFu << shift;
    PHASE_STAMP(2 + p, NSTAMP);
  };
  pass(0);
  pass(1);
  if (in_bin <= FEW) {
    // the keys under the 16-bit prefix (a handful, but for ties) to shared
    // memory; one warp finishes the select; the others wait for it
#pragma unroll
    for (int i = 0; i < S; ++i)
      if (index(i) < V && ((key[i] ^ prefix) & pmask) == 0)
        few[atomicAdd(&n_few, 1)] = key[i];
    __syncthreads();
    PHASE_STAMP(4, NSTAMP);
    if (tid < 32) {
      // passes 3 and 4 over those keys, in warp 0 alone
      const int n = in_bin;
      uint32_t mine[FEW / 32];
#pragma unroll
      for (int i = 0; i < FEW / 32; ++i)
        mine[i] = lane + 32 * i < n ? few[lane + 32 * i] : 0u;
#pragma unroll
      for (int p = 2; p < 4; ++p) {
        const int shift = 24 - 8 * p;
#pragma unroll
        for (int i = 0; i < FEW / 32; ++i)
          count_digit(hist[p], mine[i],
                      lane + 32 * i < n && ((mine[i] ^ prefix) & pmask) == 0,
                      shift);
        __syncwarp();
        scan_digit(hist[p], lane, shift, prefix, kk, in_bin);
        pmask |= 0xFFu << shift;
      }
      if (lane == 0) picked = prefix;
    }
    __syncthreads();
    prefix = picked;
    PHASE_STAMP(5, NSTAMP);
  } else {
    pass(2);
    pass(3);
  }
  const float t = from_key(prefix);
  if (thr != nullptr && tid == 0) thr[blockIdx.x] = t;
  if constexpr (MASK) {
    float* orow = out + off;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if constexpr (VEC) {
        const int c = tid + j * NT;
        if (c < V / 4)
          reinterpret_cast<float4*>(orow)[c] =
              make_float4(masked(from_key(key[4 * j]), t, mask_value),
                          masked(from_key(key[4 * j + 1]), t, mask_value),
                          masked(from_key(key[4 * j + 2]), t, mask_value),
                          masked(from_key(key[4 * j + 3]), t, mask_value));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = index(4 * j + e);
          if (i < V) orow[i] = masked(from_key(key[4 * j + e]), t, mask_value);
        }
      }
    }
  }
  PHASE_STAMP(6, NSTAMP);
}

// A row longer than the registers hold: every pass reads it again (from L2
// after the first), an element a thread a step.
template <int NT, bool MASK>
__global__ void __launch_bounds__(NT)
topk_stream_kernel(const float* __restrict__ logits, float* __restrict__ thr,
                   float* __restrict__ out, int V, int k, float mask_value) {
  __shared__ __align__(16) int hist[4][256];
  PHASE_STAMP(0, NSTAMP);
  const int tid = threadIdx.x, lane = tid % 32;
  for (int i = tid; i < 4 * 256; i += NT) (&hist[0][0])[i] = 0;
  const size_t off = (size_t)blockIdx.x * V;
  const float* row = logits + off;
  __syncthreads();
  PHASE_STAMP(1, NSTAMP);
  uint32_t prefix = 0, pmask = 0;
  int kk = k, in_bin = V;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int shift = 24 - 8 * p;
    for (int i = tid; i < V; i += NT) {
      const uint32_t key = to_key(row[i]);
      count_digit(hist[p], key, ((key ^ prefix) & pmask) == 0, shift);
    }
    __syncthreads();
    scan_digit(hist[p], lane, shift, prefix, kk, in_bin);
    pmask |= 0xFFu << shift;
    PHASE_STAMP(2 + p, NSTAMP);
  }
  const float t = from_key(prefix);
  if (thr != nullptr && tid == 0) thr[blockIdx.x] = t;
  if constexpr (MASK)
    for (int i = tid; i < V; i += NT)
      out[off + i] = masked(row[i], t, mask_value);
  PHASE_STAMP(6, NSTAMP);
}

// the floor of a launch of the kernels' grid
__global__ void topk_empty_kernel() {}

struct Args {
  const float* logits;
  float* thr;
  float* out;
  int B, V, k;
  float mask_value;
  cudaStream_t stream;
};

constexpr int STREAM_NT = 1024;  // threads of the streaming kernel

// threads a block where the row loads in 16-byte chunks, and where it loads
// element by element (each measured the faster there, PERF.md)
constexpr int VEC_NT = 512, ELEM_NT = 1024;

// J = the slot groups a thread needs (the smallest that holds the row),
// dispatched to the register kernel of that J, or past REG_KEYS to the
// streaming one
template <int NT, bool VEC, bool MASK, int J = 1>
int launch_j(int need, const Args& a) {
  if constexpr (4 * J * NT > REG_KEYS) {
    topk_stream_kernel<STREAM_NT, MASK><<<a.B, STREAM_NT, 0, a.stream>>>(
        a.logits, a.thr, a.out, a.V, a.k, a.mask_value);
  } else {
    if (need > J) return launch_j<NT, VEC, MASK, J + 1>(need, a);
    topk_reg_kernel<NT, J, VEC, MASK><<<a.B, NT, 0, a.stream>>>(
        a.logits, a.thr, a.out, a.V, a.k, a.mask_value);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <bool MASK>
int launch(const Args& a) {
  if (a.B <= 0 || a.V <= 0 || a.V > (1 << 30) || a.k <= 0 || a.k > a.V)
    return (int)cudaErrorInvalidValue;
  const bool vec = a.V % 4 == 0 && aligned16(a.logits) && aligned16(a.out);
  const long long nt = vec ? VEC_NT : ELEM_NT;
  const long long groups = vec ? (a.V / 4 + nt - 1) / nt
                               : (a.V + 4 * nt - 1) / (4 * nt);
  const int need = (int)(groups < 64 ? groups : 64);
  if (vec) return launch_j<VEC_NT, true, MASK>(need, a);
  return launch_j<ELEM_NT, false, MASK>(need, a);
}

}  // namespace

// logits [B, V] f32 -> out [B] f32, the k-th largest of each row
extern "C" int eamg_kth_value(const float* logits, float* out, int B, int V,
                              int k, void* stream) {
  return launch<false>(
      {logits, out, nullptr, B, V, k, 0.f, (cudaStream_t)stream});
}

// logits [B, V] f32 -> out [B, V] f32: logits + (logits >= the row's k-th
// largest ? 0 : mask_value)
extern "C" int eamg_top_k_mask(const float* logits, float* out, int B, int V,
                               int k, float mask_value, void* stream) {
  return launch<true>(
      {logits, nullptr, out, B, V, k, mask_value, (cudaStream_t)stream});
}

// an empty launch of the grid K4 takes for B rows of V (16-byte aligned)
// logits, the floor of the phase timings
extern "C" int eamg_topk_empty(int B, int V, void* stream) {
  if (B <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const int nt = V % 4 == 0 ? VEC_NT : ELEM_NT;
  topk_empty_kernel<<<B, nt, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
