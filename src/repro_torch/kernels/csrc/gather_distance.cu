// Fused gather + distance (Hopper, sm_90a), in two schedules.
//
// out[b, j] = dist(Q[b], vectors[ids[b, j]])      Q f32[B, d], vectors f32[n, d],
//                                                 ids i32[B, K], out f32[B, K]
//   l2: sum (x - q)^2     cos: 1 - sum x*q     dot: -sum x*q
//   ids < 0 give +inf; ids are clamped into [0, n-1] before any read.
//
// Replaces the TPU kernels repro/kernels/gather_distance.py::
// gather_distance_batch_pallas, which runs a (B, K) grid of one (1, d) row
// per step, fed by scalar prefetch of the ids, and gather_distance_pallas,
// its single-query form (here a B = 1 launch).
//
// Bound on an H100 SXM: it moves bytes, it does almost no arithmetic
// (2 flops per loaded float). Bytes = B*K*(4d + 4) + 4*B*d + 4*B*K (each
// valid candidate row and its id, each query row, each output), at
// 3.35 TB/s. At the batched engine's shapes (B = 1024, K = 64, d = 960)
// that is 256 MB, 76 us; a single query's 64 rows are 246 KB, 0.07 us, far
// below the time of one launch, so there the bound is latency: how many
// dependent memory round trips a launch waits on.
//
// Design: the rows are scattered, so what matters is keeping independent
// 16-byte loads in flight. The wrapper's plan picks one of two schedules by
// the grid the tiled one would have:
// - tiled (0), for grids that fill the card (B * ceil(K/64) >= the SM
//   count: the batched search, the build's full morsels): one block of 8
//   warps per (lane b, tile of 64 candidates); each warp takes one candidate
//   at a time.
// - spread (1), for smaller grids (the single-query search's one lane, the
//   build's first morsels): one warp per candidate, 4 warps a block, a grid
//   of (B, ceil(K/4)). One lane's 64 candidates then run on 16 SMs at once,
//   and a launch waits on the id's and one row's round trip, where a tiled
//   block waited on its 8 warps' rows one after the other. A padding id
//   loads nothing.
// Both stage Q[b] in shared memory once per block (3.84 KB at d = 960).
// The spread kernel issues its id's load and then its row's first group of
// loads before the barrier, so they overlap the staging and only the adds
// wait on it. A lane sums its part of a row with add_group() and
// add_groups(), which both schedules call: lane l issues the loads of its
// chunks l, l + 32, ... in groups of 8 (a d = 960 row is one group: 8
// float4, 32 registers) before the group's first add, adds .x .y .z .w of
// each chunk in ascending order with explicit FMAs (so nvcc's contraction
// cannot differ between the call sites), and warp_distance() reduces the
// warp with a fixed xor-shuffle tree. The order depends only on d, never on
// the schedule, B or K: a lane computed in a tiled batch of 1024 equals the
// same lane computed alone on the spread schedule, bit for bit. Rows that
// are not 16-byte aligned (d % 4 != 0 or an unaligned base pointer; the
// wrapper decides and the entry checks) are read with coalesced 4-byte
// loads in the same grouped order. wgmma, TMA and cp.async pipelining are
// left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTiledWarps = 8;
constexpr int kTileK = 64;        // candidates per tiled block
constexpr int kSpreadWarps = 4;   // candidates per spread block
constexpr int kGroup = 8;         // loads a lane issues before its first add
constexpr unsigned kFull = 0xffffffffu;

enum Metric { kL2 = 0, kCos = 1, kDot = 2 };
enum Schedule { kTiled = 0, kSpread = 1 };

template <int METRIC>
__device__ __forceinline__ float add_term(float acc, float x, float q) {
  if (METRIC == kL2) {
    const float t = __fsub_rn(x, q);
    return __fmaf_rn(t, t, acc);
  }
  return __fmaf_rn(x, q, acc);
}

// What a lane loads at a time: a 16-byte chunk of 4 floats, or one float
// where rows are not 16-byte aligned.
template <bool VEC4>
using Elem = typename std::conditional<VEC4, float4, float>::type;

template <int METRIC>
__device__ __forceinline__ float add_elem(float acc, float x, float q) {
  return add_term<METRIC>(acc, x, q);
}

template <int METRIC>
__device__ __forceinline__ float add_elem(float acc, const float4& x,
                                          const float4& q) {
  acc = add_term<METRIC>(acc, x.x, q.x);
  acc = add_term<METRIC>(acc, x.y, q.y);
  acc = add_term<METRIC>(acc, x.z, q.z);
  return add_term<METRIC>(acc, x.w, q.w);
}

// The row's elements base, base + 32, ... (kGroup of them, those below
// len) into registers: all loads issued before any is used.
template <bool VEC4>
__device__ __forceinline__ void load_group(const Elem<VEC4>* __restrict__ x,
                                           int base, int len,
                                           Elem<VEC4> (&xv)[kGroup]) {
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int i = base + 32 * g;
    if (i < len) xv[g] = __ldg(x + i);
  }
}

// acc plus the loaded group against q (in shared memory), in ascending
// element order.
template <int METRIC, bool VEC4>
__device__ __forceinline__ float add_group(float acc,
                                           const Elem<VEC4> (&xv)[kGroup],
                                           const Elem<VEC4>* q, int base,
                                           int len) {
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int i = base + 32 * g;
    if (i < len) acc = add_elem<METRIC>(acc, xv[g], q[i]);
  }
  return acc;
}

// acc plus the lane's groups from `base` on (base = lane for a whole row),
// one group after the other.
template <int METRIC, bool VEC4>
__device__ __forceinline__ float add_groups(float acc,
                                            const Elem<VEC4>* __restrict__ x,
                                            const Elem<VEC4>* q, int base,
                                            int len) {
  for (; base < len; base += 32 * kGroup) {
    Elem<VEC4> xv[kGroup];
    load_group<VEC4>(x, base, len, xv);
    acc = add_group<METRIC, VEC4>(acc, xv, q, base, len);
  }
  return acc;
}

// The warp's per-lane sums reduced by the fixed xor-shuffle tree (every
// lane returns it), then turned into the metric's distance.
template <int METRIC>
__device__ __forceinline__ float warp_distance(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  return METRIC == kL2 ? acc : (METRIC == kCos ? __fsub_rn(1.f, acc) : -acc);
}

// Elements of a row: d / 4 chunks or d floats.
template <bool VEC4>
__device__ __forceinline__ int row_len(int d) {
  return VEC4 ? d >> 2 : d;
}

// Q[b] into shared memory, by all `threads` threads of the block.
template <bool VEC4>
__device__ __forceinline__ void stage_query(const Elem<VEC4>* __restrict__ q,
                                            Elem<VEC4>* q_smem, int len,
                                            int threads) {
  for (int i = threadIdx.x; i < len; i += threads) q_smem[i] = __ldg(q + i);
}

template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(kTiledWarps * 32)
gather_distance_tiled_kernel(const float* __restrict__ Q,
                             const float* __restrict__ vectors,
                             const int* __restrict__ ids,
                             float* __restrict__ out, int K, int n, int d) {
  extern __shared__ float4 q_smem4[];
  using T = Elem<VEC4>;
  T* q_smem = reinterpret_cast<T*>(q_smem4);
  const int len = row_len<VEC4>(d);
  const long long b = blockIdx.x;
  stage_query<VEC4>(reinterpret_cast<const T*>(Q + b * d), q_smem, len,
                    kTiledWarps * 32);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k_end = min((int)blockIdx.y * kTileK + kTileK, K);
  for (int j = blockIdx.y * kTileK + warp; j < k_end; j += kTiledWarps) {
    const long long o = b * K + j;
    const int id = ids[o];  // the same for the whole warp
    if (id < 0) {
      if (lane == 0) out[o] = INFINITY;
      continue;
    }
    const T* x = reinterpret_cast<const T*>(
        vectors + (long long)min(id, n - 1) * d);
    const float r = warp_distance<METRIC>(
        add_groups<METRIC, VEC4>(0.f, x, q_smem, lane, len));
    if (lane == 0) out[o] = r;
  }
}

// One warp per candidate. The warp's id, then its row's first group of
// loads, are in flight while the block stages Q[b]; only the adds wait on
// the barrier.
template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(kSpreadWarps * 32)
gather_distance_spread_kernel(const float* __restrict__ Q,
                              const float* __restrict__ vectors,
                              const int* __restrict__ ids,
                              float* __restrict__ out, int K, int n, int d) {
  extern __shared__ float4 q_smem4[];
  using T = Elem<VEC4>;
  T* q_smem = reinterpret_cast<T*>(q_smem4);
  const int len = row_len<VEC4>(d);
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.y * kSpreadWarps + (threadIdx.x >> 5);
  const long long o = b * K + j;
  const int id = j < K ? ids[o] : -1;  // the same for the whole warp
  const T* x = reinterpret_cast<const T*>(
      vectors + (long long)min(max(id, 0), n - 1) * d);
  T xv[kGroup];
  if (id >= 0) load_group<VEC4>(x, lane, len, xv);
  stage_query<VEC4>(reinterpret_cast<const T*>(Q + b * d), q_smem, len,
                    kSpreadWarps * 32);
  __syncthreads();
  if (j >= K) return;
  if (id < 0) {  // padding: loads nothing
    if (lane == 0) out[o] = INFINITY;
    return;
  }
  // the same adds, in the same order, as add_groups(0.f, x, q, lane, len)
  float acc = add_group<METRIC, VEC4>(0.f, xv, q_smem, lane, len);
  acc = add_groups<METRIC, VEC4>(acc, x, q_smem, lane + 32 * kGroup, len);
  const float r = warp_distance<METRIC>(acc);
  if (lane == 0) out[o] = r;
}

template <int METRIC, bool VEC4>
cudaError_t launch(const float* Q, const float* vectors, const int* ids,
                   float* out, int B, int K, int n, int d, int schedule,
                   cudaStream_t stream) {
  const size_t smem = ((size_t)d * sizeof(float) + 15) / 16 * 16;
  const bool spread = schedule == kSpread;
  auto kernel = spread ? gather_distance_spread_kernel<METRIC, VEC4>
                       : gather_distance_tiled_kernel<METRIC, VEC4>;
  const int per_block = spread ? kSpreadWarps : kTileK;
  const int threads = spread ? kSpreadWarps * 32 : kTiledWarps * 32;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)B,
                  (unsigned)(((long long)K + per_block - 1) / per_block));
  kernel<<<grid, threads, smem, stream>>>(Q, vectors, ids, out, K, n, d);
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t launch_metric(const float* Q, const float* vectors,
                          const int* ids, float* out, int B, int K, int n,
                          int d, int schedule, int vec, cudaStream_t stream) {
  if (vec)
    return launch<METRIC, true>(Q, vectors, ids, out, B, K, n, d, schedule,
                                stream);
  return launch<METRIC, false>(Q, vectors, ids, out, B, K, n, d, schedule,
                               stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller owns every buffer; the kernel allocates nothing and does not
// synchronise. metric: 0 = l2, 1 = cos, 2 = dot. schedule: 0 = tiled,
// 1 = spread. vec: 1 for 16-byte loads, which needs d % 4 == 0 and Q and
// vectors 16-byte aligned (refused otherwise).
extern "C" int navix_gather_distance_batch_f32(const float* Q,
                                               const float* vectors,
                                               const int* ids, float* out,
                                               int B, int K, int n, int d,
                                               int metric, int schedule,
                                               int vec, void* stream) {
  if (B <= 0 || K <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (schedule != kTiled && schedule != kSpread)
    return (int)cudaErrorInvalidValue;
  if (vec && ((d & 3) || (((uintptr_t)Q | (uintptr_t)vectors) & 15)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2:
      return (int)launch_metric<kL2>(Q, vectors, ids, out, B, K, n, d,
                                     schedule, vec, s);
    case kCos:
      return (int)launch_metric<kCos>(Q, vectors, ids, out, B, K, n, d,
                                      schedule, vec, s);
    case kDot:
      return (int)launch_metric<kDot>(Q, vectors, ids, out, B, K, n, d,
                                      schedule, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
