// Fused gather + dequantize + distance over int8 codes (Hopper, sm_90a),
// in two schedules.
//
// out[b, j] = dist(Q[b], x)   x = fl(scale[id] * codes[id]),  id = ids[b, j]
//   Q f32[B, d], codes int8[n, d], scale f32[n], ids i32[B, K], out f32[B, K]
//   l2: sum (x - q)^2     cos: 1 - sum x*q     dot: -sum x*q
//   ids < 0 give +inf; ids are clamped into [0, n-1] before any read.
//
// Replaces the TPU kernel repro/kernels/gather_distance.py::
// quantized_gather_distance_batch_pallas (body _quantized_batch_kernel),
// which runs a (B, K) grid of one (1, d) int8 row and its (1, 1) scale per
// step, fed by scalar prefetch of the ids, and its single-query form,
// quantized_gather_distance_pallas (here a B = 1 launch).
//
// Bound on an H100 SXM: bytes (4 flops per code byte: dequantize, subtract,
// multiply-add). Each valid candidate row costs its d bytes of codes and one
// 32-byte sector for its 4-byte scale (a random address); add each id, each
// query row and each output once:
//   bytes = rows * (d + 32) + 4*B*K + 4*B*d + 4*B*K,   at 3.35 TB/s.
// At B = 1024, K = 64, d = 960 with 20% of the ids padding that is about
// 56 MB, 17 us, against 256 MB for the f32 kernel; the query rows (3.9 MB)
// are now 7% of it. A single query's 64 rows are 63 KB, far below one
// launch: there the bound is the dependent round trips a launch waits on.
//
// Design: the wrapper's plan picks one of two schedules by the grid the
// tiled one would have (as in gather_distance.cu, at another threshold):
// - tiled (0), for grids of B * ceil(K/64) >= 3/4 of the SM count (where
//   it was faster on an H100; the batched search): one block per (lane b, tile of 64 candidates); each of the 8
//   warps owns 8 consecutive candidates. Lanes 0..7 load the warp's ids and
//   scales once (one sector each) and broadcast them with shuffles. A row is
//   cut into 16-byte chunks of 16 codes; lane l takes chunks l, l + 32, ...
//   of all 8 of its warp's rows, so the 16 floats of Q[b] that a chunk needs
//   stay in registers for the 8 rows, and the 8 rows' 16-byte loads are
//   issued together before they are used (4 KB in flight per warp). At
//   d = 960 a row is 60 chunks: the second pass leaves 4 of 32 lanes idle.
// - spread (1), for smaller grids (the single-query search's one lane,
//   the parity phase's batch of 32): one
//   warp per candidate, 4 warps a block, a grid of (B, ceil(K/4)), so one
//   lane's 64 candidates run on 16 SMs at once. Each warp reads its id (one
//   broadcast load), then its scale and lane l's chunks l, l + 32, ... in
//   groups of 4 (all of a row up to d = 2048), all before the barrier on
//   the block's staging of Q[b] in shared memory (3.84 KB at d = 960), so
//   the row's round trip overlaps the staging; the 16 floats of Q[b] a
//   chunk needs are read from there. A padding id loads nothing.
// Both add a chunk with add_chunk() and reduce with warp_distance(). Each
// code is dequantized with __fmul_rn before it meets q, so nvcc cannot
// contract c*s - q into one FMA and the row is exactly the reference's
// codes * scale; the sums use explicit FMAs. A lane sums its chunks in
// ascending order, then the warp reduces with a fixed xor-shuffle tree, so
// the summation order depends on d only, never on the schedule, B, K, or
// which of the two load paths ran: a lane computed in a tiled batch of 1024
// equals the same lane computed alone on the spread schedule, bit for bit.
// Rows that are not 16-byte aligned (d % 16 != 0, or an unaligned base
// pointer; the wrapper decides and the entry checks) are read byte by byte
// in the same order. wgmma, TMA and cp.async pipelining are left for later
// work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps per tiled block
constexpr int kCand = 8;                  // candidates per tiled warp
constexpr int kTileK = kWarps * kCand;    // candidates per tiled block
constexpr int kSpreadWarps = 4;           // candidates per spread block
constexpr int kGroup = 4;                 // chunks a spread lane loads at once
constexpr int kChunk = 16;                // codes per 16-byte load
constexpr unsigned kFull = 0xffffffffu;

enum Metric { kL2 = 0, kCos = 1, kDot = 2 };
enum Schedule { kTiled = 0, kSpread = 1 };

// Codes c*16 .. c*16+15 of a row, packed little-endian into an int4 (bytes
// past d are zero and never used).
template <bool VEC16>
__device__ __forceinline__ int4 load_codes(const signed char* row, int c,
                                           int d) {
  if (VEC16) return __ldg(reinterpret_cast<const int4*>(row) + c);
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int i = c * kChunk + k;
    if (i < d) w[k >> 2] |= (int)(unsigned char)row[i] << ((k & 3) * 8);
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// Q[b] elements c*16 .. c*16+15 (zero past d).
template <bool VEC16>
__device__ __forceinline__ void load_query(const float* q, int c, int d,
                                           float (&qv)[kChunk]) {
  if (VEC16) {
    const float4* q4 = reinterpret_cast<const float4*>(q) + c * (kChunk / 4);
#pragma unroll
    for (int m = 0; m < kChunk / 4; ++m) {
      const float4 v = q4[m];
      qv[4 * m] = v.x;
      qv[4 * m + 1] = v.y;
      qv[4 * m + 2] = v.z;
      qv[4 * m + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = c * kChunk + k;
      qv[k] = i < d ? q[i] : 0.f;
    }
  }
}

__device__ __forceinline__ float code_at(const int4& raw, int k) {
  const int w = (k >> 2) == 0 ? raw.x
              : (k >> 2) == 1 ? raw.y
              : (k >> 2) == 2 ? raw.z : raw.w;
  return (float)(signed char)(w >> ((k & 3) * 8));
}

// acc plus the first kn codes of one chunk, dequantized by s, against qv,
// in ascending order: the one per-chunk order of both schedules.
template <int METRIC>
__device__ __forceinline__ float add_chunk(float acc, const int4& raw,
                                           float s, const float (&qv)[kChunk],
                                           int kn) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (k >= kn) break;
    const float x = __fmul_rn(code_at(raw, k), s);
    if (METRIC == kL2) {
      const float t = __fsub_rn(x, qv[k]);
      acc = __fmaf_rn(t, t, acc);
    } else {
      acc = __fmaf_rn(x, qv[k], acc);
    }
  }
  return acc;
}

// The warp's per-lane sums reduced by the fixed xor-shuffle tree (every
// lane returns it), then turned into the metric's distance.
template <int METRIC>
__device__ __forceinline__ float warp_distance(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return METRIC == kL2 ? v : (METRIC == kCos ? 1.f - v : -v);
}

template <int METRIC, bool VEC16>
__global__ void __launch_bounds__(kWarps * 32)
quantized_gather_distance_tiled_kernel(const float* __restrict__ Q,
                                       const signed char* __restrict__ codes,
                                       const float* __restrict__ scale,
                                       const int* __restrict__ ids,
                                       float* __restrict__ out, int K, int n,
                                       int d) {
  const long long b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = blockIdx.y * kTileK + warp * kCand;
  if (j0 >= K) return;  // the whole warp is past the last candidate

  // lane m < kCand reads candidate m's id and scale, once
  int my_id = -1;
  float my_s = 0.f;
  if (lane < kCand && j0 + lane < K) {
    my_id = ids[b * K + j0 + lane];
    if (my_id >= 0) my_s = scale[min(my_id, n - 1)];
  }
  const signed char* row[kCand];
  float s[kCand], acc[kCand];
  bool live[kCand];
#pragma unroll
  for (int m = 0; m < kCand; ++m) {
    const int id = __shfl_sync(kFull, my_id, m);
    s[m] = __shfl_sync(kFull, my_s, m);
    live[m] = id >= 0;  // the same on every lane of the warp
    row[m] = codes + (long long)min(max(id, 0), n - 1) * d;
    acc[m] = 0.f;
  }

  const float* q = Q + b * d;
  const int n_chunks = (d + kChunk - 1) / kChunk;
  for (int c = lane; c < n_chunks; c += 32) {
    float qv[kChunk];
    load_query<VEC16>(q, c, d, qv);
    int4 raw[kCand];
#pragma unroll
    for (int m = 0; m < kCand; ++m)
      raw[m] = live[m] ? load_codes<VEC16>(row[m], c, d) : make_int4(0, 0, 0, 0);
    const int kn = VEC16 ? kChunk : min(kChunk, d - c * kChunk);
#pragma unroll
    for (int m = 0; m < kCand; ++m)
      if (live[m]) acc[m] = add_chunk<METRIC>(acc[m], raw[m], s[m], qv, kn);
  }

  float mine = 0.f;
#pragma unroll
  for (int m = 0; m < kCand; ++m) {
    const float v = warp_distance<METRIC>(acc[m]);
    if (lane == m) mine = v;
  }
  if (lane < kCand && j0 + lane < K)
    out[b * K + j0 + lane] = my_id < 0 ? INFINITY : mine;
}

// Q[b] into shared memory, by all `threads` threads of the block.
template <bool VEC16>
__device__ __forceinline__ void stage_query(const float* __restrict__ q,
                                            float4* q_smem4, int d,
                                            int threads) {
  if (VEC16) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int i = threadIdx.x; i < (d >> 2); i += threads)
      q_smem4[i] = __ldg(q4 + i);
  } else {
    float* q_smem = reinterpret_cast<float*>(q_smem4);
    for (int i = threadIdx.x; i < d; i += threads) q_smem[i] = __ldg(q + i);
  }
}

// Chunks base, base + 32, ... (kGroup of them, those below n_chunks) of a
// row into registers: all loads issued before any is used.
template <bool VEC16>
__device__ __forceinline__ void load_chunks(const signed char* row, int base,
                                            int n_chunks, int d,
                                            int4 (&raw)[kGroup]) {
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int c = base + 32 * g;
    if (c < n_chunks) raw[g] = load_codes<VEC16>(row, c, d);
  }
}

// acc plus the loaded chunks against q (in shared memory), in ascending
// chunk order.
template <int METRIC, bool VEC16>
__device__ __forceinline__ float add_chunks(float acc,
                                            const int4 (&raw)[kGroup],
                                            float s, const float* q, int base,
                                            int n_chunks, int d) {
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int c = base + 32 * g;
    if (c < n_chunks) {
      float qv[kChunk];
      load_query<VEC16>(q, c, d, qv);
      const int kn = VEC16 ? kChunk : min(kChunk, d - c * kChunk);
      acc = add_chunk<METRIC>(acc, raw[g], s, qv, kn);
    }
  }
  return acc;
}

// One warp per candidate. The warp's id, then its scale and its row's
// first group of chunks, are in flight while the block stages Q[b]; only
// the adds wait on the barrier.
template <int METRIC, bool VEC16>
__global__ void __launch_bounds__(kSpreadWarps * 32)
quantized_gather_distance_spread_kernel(const float* __restrict__ Q,
                                        const signed char* __restrict__ codes,
                                        const float* __restrict__ scale,
                                        const int* __restrict__ ids,
                                        float* __restrict__ out, int K, int n,
                                        int d) {
  extern __shared__ float4 q_smem4[];
  const float* q_smem = reinterpret_cast<const float*>(q_smem4);
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.y * kSpreadWarps + (threadIdx.x >> 5);
  const long long o = b * K + j;
  const int id = j < K ? ids[o] : -1;  // the same for the whole warp
  const int r = min(max(id, 0), n - 1);
  const signed char* row = codes + (long long)r * d;
  const int n_chunks = (d + kChunk - 1) / kChunk;
  float s = 0.f;
  int4 raw[kGroup];
  if (id >= 0) {
    s = scale[r];
    load_chunks<VEC16>(row, lane, n_chunks, d, raw);
  }
  stage_query<VEC16>(Q + b * d, q_smem4, d, kSpreadWarps * 32);
  __syncthreads();
  if (j >= K) return;
  if (id < 0) {  // padding: loads nothing
    if (lane == 0) out[o] = INFINITY;
    return;
  }
  float acc = add_chunks<METRIC, VEC16>(0.f, raw, s, q_smem, lane, n_chunks,
                                        d);
  for (int base = lane + 32 * kGroup; base < n_chunks; base += 32 * kGroup) {
    load_chunks<VEC16>(row, base, n_chunks, d, raw);
    acc = add_chunks<METRIC, VEC16>(acc, raw, s, q_smem, base, n_chunks, d);
  }
  const float v = warp_distance<METRIC>(acc);
  if (lane == 0) out[o] = v;
}

template <int METRIC, bool VEC16>
cudaError_t launch(const float* Q, const signed char* codes,
                   const float* scale, const int* ids, float* out, int B,
                   int K, int n, int d, int schedule, cudaStream_t stream) {
  if (schedule == kSpread) {
    const size_t smem = ((size_t)d * sizeof(float) + 15) / 16 * 16;
    auto kernel = quantized_gather_distance_spread_kernel<METRIC, VEC16>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    const dim3 grid((unsigned)B, (unsigned)(((long long)K + kSpreadWarps - 1)
                                            / kSpreadWarps));
    kernel<<<grid, kSpreadWarps * 32, smem, stream>>>(Q, codes, scale, ids,
                                                      out, K, n, d);
  } else {
    const dim3 grid((unsigned)B,
                    (unsigned)(((long long)K + kTileK - 1) / kTileK));
    quantized_gather_distance_tiled_kernel<METRIC, VEC16>
        <<<grid, kWarps * 32, 0, stream>>>(Q, codes, scale, ids, out, K, n,
                                           d);
  }
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t launch_metric(const float* Q, const signed char* codes,
                          const float* scale, const int* ids, float* out,
                          int B, int K, int n, int d, int schedule, int vec,
                          cudaStream_t stream) {
  if (vec)
    return launch<METRIC, true>(Q, codes, scale, ids, out, B, K, n, d,
                                schedule, stream);
  return launch<METRIC, false>(Q, codes, scale, ids, out, B, K, n, d,
                               schedule, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller owns every buffer; the kernel allocates nothing and does not
// synchronise. metric: 0 = l2, 1 = cos, 2 = dot. schedule: 0 = tiled,
// 1 = spread. vec: 1 for 16-byte loads, which needs d % 16 == 0 and Q and
// codes 16-byte aligned (refused otherwise).
extern "C" int navix_quantized_gather_distance_batch(
    const float* Q, const signed char* codes, const float* scale,
    const int* ids, float* out, int B, int K, int n, int d, int metric,
    int schedule, int vec, void* stream) {
  if (B <= 0 || K <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (schedule != kTiled && schedule != kSpread)
    return (int)cudaErrorInvalidValue;
  if (vec && ((d % kChunk) || (((uintptr_t)Q | (uintptr_t)codes) & 15)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2:
      return (int)launch_metric<kL2>(Q, codes, scale, ids, out, B, K, n, d,
                                     schedule, vec, s);
    case kCos:
      return (int)launch_metric<kCos>(Q, codes, scale, ids, out, B, K, n, d,
                                      schedule, vec, s);
    case kDot:
      return (int)launch_metric<kDot>(Q, codes, scale, ids, out, B, K, n, d,
                                      schedule, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
