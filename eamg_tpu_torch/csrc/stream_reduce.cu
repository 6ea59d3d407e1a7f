// Stream reduce: a read-rate probe over a position-major cache.
//
// Replaces eamg_tpu/ops/decode_fold.py::stream_reduce (_stream_kernel),
// which the JAX package uses to measure how fast a cache of the fold
// kernels' block shape can be read at all: the fold kernels' speed of
// light.
//
// kv [B, M, W] is read as [B * M, W] in groups of `rows` batch rows
// (rows * M lines each). Every group is read and summed over its lines in
// f32. What comes back, [1, W] in the input dtype, is the sum of the LAST
// group only: in the Pallas kernel every grid step writes the same output
// block, so the last step wins. It is a probe, not a reduction of the
// whole array, and this kernel returns the same thing; but it reads every
// group, which is the point of it.
//
// What bounds it: bytes, B * M * W elements read once. Design, one launch:
// - the array is cut in units of `rs` lines of one group by 32 column
//   vectors; a block of 32 x 8 threads reads a unit, each thread its column
//   with 16-byte loads (8 bf16 or 4 f32 values; neighbouring threads on
//   neighbouring addresses), 8 lines in flight at once, every 8th line.
//   Where W is not a multiple of the vector, a line does not start on 16
//   bytes, and the threads read an element each;
// - the grid is what the card keeps resident at once (or the units, if
//   fewer), and block b takes units b, b + grid, ...: no second wave of
//   blocks starts late (a grid of one block a unit had one at 67 MB).
//   `rs` is the largest power of two from 64 up that still gives every
//   block two units: the path's 2 MB in 64 units of 32 KB, one a block
//   (units of 32 lines, 128 blocks, were slower: twice the partials for
//   the last block to sum); 67 MB in 2048 units of 32 KB;
// - each unit gives one f32 partial per column of its slab (the threads'
//   sums over ty in order), as every grid step of the TPU kernel writes its
//   block;
// - the last block to arrive (a device counter, counted by an
//   acquire-release atomic after the block's barrier, which waits less than
//   a __threadfence() in every block) sums the last group's partials,
//   writes the output and resets the counter, so the next launch, or a
//   CUDA graph's next replay, finds it at 0. Its threads take ranges of
//   slabs of a column, 16 slabs in flight, each range summed in slab
//   order, then the ranges in order: the sum's order depends on the shape
//   alone, so two calls give the same bits. No second launch, no host
//   sync. (A cluster a group that sums through distributed shared memory
//   would hold at most 16 blocks of a group's lines; the counter lets any
//   number read it.)
#include "common.cuh"

namespace {

constexpr int TX = 32, TY = 8, NT = TX * TY;
constexpr int U = 8;            // lines in flight a thread
constexpr int MIN_SLAB = 64;    // mirrored by ops/decode_fold.py
constexpr int MAX_SLAB = 4096;
constexpr int NSTAMP = 4;       // entry, read, arrived, combined

template <typename T, bool VEC>
struct Vec {
  static constexpr int N = VEC ? 16 / (int)sizeof(T) : 1;
  using Raw = std::conditional_t<VEC, uint4, T>;
  static __device__ __forceinline__ Raw load(const T* p) {
    if constexpr (VEC)
      return __ldg(reinterpret_cast<const uint4*>(p));
    else
      return p[0];
  }
  static __device__ __forceinline__ void add(float (&acc)[N], const Raw& r) {
    if constexpr (!VEC) {
      acc[0] += to_f32(r);
    } else if constexpr (std::is_same_v<T, float>) {
      acc[0] += __uint_as_float(r.x);
      acc[1] += __uint_as_float(r.y);
      acc[2] += __uint_as_float(r.z);
      acc[3] += __uint_as_float(r.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(h[i]);
        acc[2 * i] += x.x;
        acc[2 * i + 1] += x.y;
      }
    }
  }
};

// one more block in: an acquire-release add at the device's scope, after
// the block's barrier (as CUTLASS's semaphores arrive); the old count
__device__ __forceinline__ unsigned arrive(unsigned int* counter) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// unit u = (group * n_slab + slab) * ctiles + column tile: `rs` lines of
// one group and 32 column vectors; block b takes units b, b + grid, ...
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
stream_kernel(const T* __restrict__ kv, T* __restrict__ o,
              float* __restrict__ part, unsigned int* __restrict__ arrived,
              int groups, int lines, int W, int rs, int n_slab, int ctiles) {
  using V = Vec<T, VEC>;
  constexpr int N = V::N;
  __shared__ float red[TY][TX * N];
  __shared__ float sums[4 * NT];  // the last block's sums of slab ranges
  __shared__ bool last;
  PHASE_STAMP(0, NSTAMP);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int units = groups * n_slab * ctiles;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int ct = u % ctiles, gs = u / ctiles;
    const int slab = gs % n_slab, grp = gs / n_slab;
    const int cv = ct * TX + tx;
    const int r0 = slab * rs, r1 = min(lines, r0 + rs);
    float acc[N] = {};
    if (cv < W / N) {
      const T* p = kv + (size_t)grp * lines * W + (size_t)cv * N;
      for (int r = r0 + ty; r < r1; r += U * TY) {
        typename V::Raw v[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int rr = r + i * TY;
          v[i] = rr < r1 ? V::load(p + (size_t)rr * W) : typename V::Raw{};
        }
#pragma unroll
        for (int i = 0; i < U; ++i) V::add(acc, v[i]);
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) red[ty][tx * N + e] = acc[e];
    __syncthreads();
    const int c0 = ct * TX * N, width = min(TX * N, W - c0);
    float* out = part + ((size_t)grp * n_slab + slab) * W + c0;
    for (int c = threadIdx.x; c < width; c += NT) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < TY; ++y) s += red[y][c];
      out[c] = s;
    }
    __syncthreads();
  }
  PHASE_STAMP(1, NSTAMP);
  // the block's partials are written (the barrier above): thread 0 counts
  // the block in, releasing them, and acquires the others' if it is last
  if (threadIdx.x == 0) last = arrive(arrived) == gridDim.x - 1;
  __syncthreads();
  PHASE_STAMP(2, NSTAMP);
  if (!last) return;
  // the last group's partials: slab ranges [ph * per, (ph + 1) * per) of a
  // column (4 columns a thread where W allows) summed in order by thread
  // (j, ph), then the P ranges of a column in order
  const float* lp = part + (size_t)(groups - 1) * n_slab * W;
  const int Q = W % 4 == 0 ? 4 : 1;
  const int cols = W / Q;
  const int P = cols >= NT ? 1 : min(NT / cols, n_slab);
  const int L = NT / P, per = (n_slab + P - 1) / P;
  const int j = threadIdx.x % L, ph = threadIdx.x / L;
  for (int c0 = 0; c0 < cols; c0 += L) {
    const int c = c0 + j;
    if (c < cols && ph < P) {
      float s[4] = {};
      const int s1 = min(n_slab, (ph + 1) * per);
      for (int sl = ph * per; sl < s1; sl += 16) {
        float4 v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (sl + i < s1) {
            const float* at = lp + (size_t)(sl + i) * W;
            if (Q == 4)
              v[i] = __ldcg(reinterpret_cast<const float4*>(at) + c);
            else
              v[i].x = __ldcg(at + c);
          }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          s[0] += v[i].x;
          s[1] += v[i].y;
          s[2] += v[i].z;
          s[3] += v[i].w;
        }
      }
      for (int e = 0; e < Q; ++e) sums[(ph * L + j) * Q + e] = s[e];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < L * Q; e += NT) {
      const int col = c0 * Q + e;
      if (col < W) {
        float s = 0.f;
        for (int q = 0; q < P; ++q) s += sums[q * L * Q + e];
        o[col] = from_f32<T>(s);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *arrived = 0u;
  PHASE_STAMP(3, NSTAMP);
}

// the blocks of stream_kernel<T, VEC> the card keeps resident at once
template <typename T, bool VEC>
int resident_blocks() {
  constexpr int MAX_DEV = 64;
  static std::mutex mu;
  static int blocks[MAX_DEV] = {};
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEV)
    return 0;
  std::lock_guard<std::mutex> lock(mu);
  if (blocks[dev] == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stream_kernel<T, VEC>, NT, 0) == cudaSuccess)
    blocks[dev] = sms * per_sm;
  return blocks[dev];
}

struct Plan {
  int rs, n_slab, ctiles, grid;
};

template <typename T, bool VEC>
cudaError_t plan(int groups, int lines, int W, Plan* p) {
  const int resident = resident_blocks<T, VEC>();
  if (resident == 0) return cudaErrorInvalidDevice;
  const long long ctiles = (W / Vec<T, VEC>::N + TX - 1) / TX;
  const auto units = [&](long long r) {
    return groups * ((lines + r - 1) / r) * ctiles;
  };
  int rs = MIN_SLAB;
  while (rs < MAX_SLAB && units(2 * rs) >= 2LL * resident) rs *= 2;
  if (units(rs) >= (1LL << 31)) return cudaErrorInvalidValue;
  *p = {rs, (lines + rs - 1) / rs, (int)ctiles,
        (int)(units(rs) < resident ? units(rs) : resident)};
  return cudaSuccess;
}

template <typename T, bool VEC>
int launch(const void* kv, void* o, float* part, unsigned int* arrived,
           int groups, int lines, int W, cudaStream_t stream) {
  Plan p;
  const cudaError_t e = plan<T, VEC>(groups, lines, W, &p);
  if (e != cudaSuccess) return (int)e;
  stream_kernel<T, VEC><<<p.grid, NT, 0, stream>>>(
      (const T*)kv, (T*)o, part, arrived, groups, lines, W, p.rs, p.n_slab,
      p.ctiles);
  return (int)cudaGetLastError();
}

bool vec_ok(const void* kv, int W, int size) {
  return W % (16 / size) == 0 && (uintptr_t)kv % 16 == 0;
}

template <typename T>
int launch_t(const void* kv, void* o, float* part, unsigned int* arrived,
             int groups, int lines, int W, cudaStream_t stream) {
  if (vec_ok(kv, W, sizeof(T)))
    return launch<T, true>(kv, o, part, arrived, groups, lines, W, stream);
  return launch<T, false>(kv, o, part, arrived, groups, lines, W, stream);
}

}  // namespace

// kv: `groups` groups of `lines` lines of W elements; o: W elements; part:
// f32 scratch of groups * ceil(lines / 64) * W elements and arrived: one
// counter at 0, both from the caller and kept between launches (the kernel
// leaves the counter at 0). Launches that share them must not overlap.
extern "C" int eamg_stream_reduce(const void* kv, void* o, float* part,
                                  unsigned int* arrived, int groups,
                                  int lines, int W, int dtype, void* stream) {
  if (groups <= 0 || lines <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EAMG_F32)
    return launch_t<float>(kv, o, part, arrived, groups, lines, W, s);
  if (dtype == EAMG_BF16)
    return launch_t<__nv_bfloat16>(kv, o, part, arrived, groups, lines, W, s);
  return (int)cudaErrorInvalidValue;
}

// the launch eamg_stream_reduce makes for this kv: its grid and the lines
// of a unit (chip_smoke.py reads the stamps of that many blocks)
extern "C" int eamg_stream_reduce_plan(const void* kv, int groups, int lines,
                                       int W, int dtype, int* grid, int* rs) {
  if (groups <= 0 || lines <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == EAMG_F32)
    e = vec_ok(kv, W, 4) ? plan<float, true>(groups, lines, W, &p)
                         : plan<float, false>(groups, lines, W, &p);
  if (dtype == EAMG_BF16)
    e = vec_ok(kv, W, 2) ? plan<__nv_bfloat16, true>(groups, lines, W, &p)
                         : plan<__nv_bfloat16, false>(groups, lines, W, &p);
  if (e != cudaSuccess) return (int)e;
  *grid = p.grid;
  *rs = p.rs;
  return 0;
}
