// Fused gather + dequantize + distance over int8 codes (Hopper, sm_90a).
//
// out[b, j] = dist(Q[b], x)   x = fl(scale[id] * codes[id]),  id = ids[b, j]
//   Q f32[B, d], codes int8[n, d], scale f32[n], ids i32[B, K], out f32[B, K]
//   l2: sum (x - q)^2     cos: 1 - sum x*q     dot: -sum x*q
//   ids < 0 give +inf; ids are clamped into [0, n-1] before any read.
//
// Replaces the TPU kernel repro/kernels/gather_distance.py::
// quantized_gather_distance_batch_pallas (body _quantized_batch_kernel),
// which runs a (B, K) grid of one (1, d) int8 row and its (1, 1) scale per
// step, fed by scalar prefetch of the ids. Its single-query form,
// quantized_gather_distance_pallas, is the one-lane (B = 1) launch of this
// kernel.
//
// Bound on an H100 SXM: bytes (4 flops per code byte: dequantize, subtract,
// multiply-add). Each valid candidate row costs its d bytes of codes and one
// 32-byte sector for its 4-byte scale (a random address); add each id, each
// query row and each output once:
//   bytes = rows * (d + 32) + 4*B*K + 4*B*d + 4*B*K,   at 3.35 TB/s.
// At B = 1024, K = 64, d = 960 with 20% of the ids padding that is about
// 56 MB, 17 us, against 256 MB for the f32 kernel; the query rows (3.9 MB)
// are now 7% of it.
//
// Design: one block per (lane b, tile of 64 candidates); each of the 8 warps
// owns 8 consecutive candidates. Lanes 0..7 load the warp's ids and scales
// once (one sector each) and broadcast them with shuffles. A row is cut into
// 16-byte chunks of 16 codes; lane l takes chunks l, l + 32, ... of all 8 of
// its warp's rows, so the 16 floats of Q[b] that a chunk needs stay in
// registers for the 8 rows, and the 8 rows' 16-byte loads are issued together
// before they are used (4 KB in flight per warp). At d = 960 a row is 60
// chunks: the second pass leaves 4 of 32 lanes idle. Each code is dequantized
// with __fmul_rn before it meets q, so nvcc cannot contract c*s - q into one
// FMA and the row is exactly the reference's codes * scale; the sums use
// explicit FMAs. A lane sums its chunks in ascending order, then the warp
// reduces with a fixed xor-shuffle tree, so the summation order depends on d
// only, never on B, K, or which of the two load paths ran: a lane computed in
// a batch of 1024 equals the same lane computed alone, bit for bit. Rows that
// are not 16-byte aligned (d % 16 != 0, or an unaligned base pointer) are
// read byte by byte in the same order. wgmma, TMA and cp.async pipelining are
// left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCand = 8;                  // candidates per warp
constexpr int kTileK = kWarps * kCand;    // candidates per block
constexpr int kChunk = 16;                // codes per 16-byte load
constexpr unsigned kFull = 0xffffffffu;

enum Metric { kL2 = 0, kCos = 1, kDot = 2 };

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

template <int METRIC, bool VEC16>
__global__ void __launch_bounds__(kThreads)
quantized_gather_distance_batch_kernel(const float* __restrict__ Q,
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
    for (int m = 0; m < kCand; ++m) {
      if (!live[m]) continue;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (k >= kn) break;
        const float x = __fmul_rn(code_at(raw[m], k), s[m]);
        if (METRIC == kL2) {
          const float t = __fsub_rn(x, qv[k]);
          acc[m] = __fmaf_rn(t, t, acc[m]);
        } else {
          acc[m] = __fmaf_rn(x, qv[k], acc[m]);
        }
      }
    }
  }

  float mine = 0.f;
#pragma unroll
  for (int m = 0; m < kCand; ++m) {
    float v = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
    if (lane == m) mine = v;
  }
  if (lane < kCand && j0 + lane < K) {
    float r = METRIC == kL2 ? mine : (METRIC == kCos ? 1.f - mine : -mine);
    out[b * K + j0 + lane] = my_id < 0 ? INFINITY : r;
  }
}

template <int METRIC, bool VEC16>
cudaError_t launch(const float* Q, const signed char* codes,
                   const float* scale, const int* ids, float* out, int B,
                   int K, int n, int d, cudaStream_t stream) {
  const dim3 grid((unsigned)B, (unsigned)((K + kTileK - 1) / kTileK));
  quantized_gather_distance_batch_kernel<METRIC, VEC16>
      <<<grid, kThreads, 0, stream>>>(Q, codes, scale, ids, out, K, n, d);
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t dispatch_vec(const float* Q, const signed char* codes,
                         const float* scale, const int* ids, float* out,
                         int B, int K, int n, int d, cudaStream_t stream) {
  const bool vec16 = d % kChunk == 0 && (uintptr_t)Q % 16 == 0 &&
                     (uintptr_t)codes % 16 == 0;
  if (vec16)
    return launch<METRIC, true>(Q, codes, scale, ids, out, B, K, n, d, stream);
  return launch<METRIC, false>(Q, codes, scale, ids, out, B, K, n, d, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller owns every buffer; the kernel allocates nothing and does not
// synchronise. metric: 0 = l2, 1 = cos, 2 = dot.
extern "C" int navix_quantized_gather_distance_batch(
    const float* Q, const signed char* codes, const float* scale,
    const int* ids, float* out, int B, int K, int n, int d, int metric,
    void* stream) {
  if (B <= 0 || K <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2:
      return (int)dispatch_vec<kL2>(Q, codes, scale, ids, out, B, K, n, d, s);
    case kCos:
      return (int)dispatch_vec<kCos>(Q, codes, scale, ids, out, B, K, n, d, s);
    case kDot:
      return (int)dispatch_vec<kDot>(Q, codes, scale, ids, out, B, K, n, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
