// Fused gather + distance for the batched search engine (Hopper, sm_90a).
//
// out[b, j] = dist(Q[b], vectors[ids[b, j]])      Q f32[B, d], vectors f32[n, d],
//                                                 ids i32[B, K], out f32[B, K]
//   l2: sum (x - q)^2     cos: 1 - sum x*q     dot: -sum x*q
//   ids < 0 give +inf; ids are clamped into [0, n-1] before any read.
//
// Replaces the TPU kernel repro/kernels/gather_distance.py::
// gather_distance_batch_pallas, which runs a (B, K) grid of one (1, d) row
// per step, fed by scalar prefetch of the ids.
//
// Bound on an H100 SXM: it moves bytes, it does almost no arithmetic
// (2 flops per loaded float). Bytes = B*K*(4d + 4) + 4*B*d + 4*B*K (each
// valid candidate row and its id, each query row, each output), at
// 3.35 TB/s. At the main path's shapes (B = 1024, K = 64, d = 960) that is
// 256 MB, 76 us.
//
// Design: the rows are scattered, so the only thing that matters is keeping
// enough independent 16-byte loads in flight. One block per (lane b, tile of
// 64 candidates): Q[b] is staged once in shared memory (3.84 KB at
// d = 960); each of the 8 warps takes one candidate at a time and reads its
// row with coalesced 16-byte loads (a warp covers 512 contiguous bytes per
// instruction; the loop is unrolled so several loads are outstanding),
// accumulates in f32 per thread and reduces with warp shuffles. The
// summation order depends only on d, never on B or K, so a lane computed in
// a batch of 1024 equals the same lane computed alone, bit for bit. When d
// is not a multiple of 4 (or a base pointer is not 16-byte aligned) rows are
// not 16-byte aligned and the kernel reads them with coalesced 4-byte loads
// instead. wgmma, TMA and cp.async pipelining are left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 64;  // candidates per block

enum Metric { kL2 = 0, kCos = 1, kDot = 2 };

template <int METRIC>
__device__ __forceinline__ float term(float x, float q) {
  if (METRIC == kL2) {
    const float t = x - q;
    return t * t;
  }
  return x * q;
}

template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(kThreads)
gather_distance_batch_kernel(const float* __restrict__ Q,
                             const float* __restrict__ vectors,
                             const int* __restrict__ ids,
                             float* __restrict__ out, int K, int n, int d) {
  extern __shared__ float4 q_smem4[];
  float* q_smem = reinterpret_cast<float*>(q_smem4);

  const long long b = blockIdx.x;
  const float* q = Q + b * d;
  if (VEC4) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int i = threadIdx.x; i < (d >> 2); i += kThreads) q_smem4[i] = q4[i];
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) q_smem[i] = q[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k_end = min((int)blockIdx.y * kTileK + kTileK, K);
  for (int j = blockIdx.y * kTileK + warp; j < k_end; j += kWarps) {
    const long long o = b * K + j;
    const int id = ids[o];  // the same for the whole warp
    if (id < 0) {
      if (lane == 0) out[o] = INFINITY;
      continue;
    }
    const float* x = vectors + (long long)min(id, n - 1) * d;
    float acc = 0.f;
    if (VEC4) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      const int d4 = d >> 2;
#pragma unroll 4
      for (int i = lane; i < d4; i += 32) {
        const float4 xv = x4[i];
        const float4 qv = q_smem4[i];
        acc += term<METRIC>(xv.x, qv.x);
        acc += term<METRIC>(xv.y, qv.y);
        acc += term<METRIC>(xv.z, qv.z);
        acc += term<METRIC>(xv.w, qv.w);
      }
    } else {
#pragma unroll 4
      for (int i = lane; i < d; i += 32) acc += term<METRIC>(x[i], q_smem[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      out[o] = METRIC == kL2 ? acc : (METRIC == kCos ? 1.f - acc : -acc);
    }
  }
}

template <int METRIC, bool VEC4>
cudaError_t launch(const float* Q, const float* vectors, const int* ids,
                   float* out, int B, int K, int n, int d,
                   cudaStream_t stream) {
  const size_t smem = ((size_t)d * sizeof(float) + 15) / 16 * 16;
  auto kernel = gather_distance_batch_kernel<METRIC, VEC4>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)B, (unsigned)((K + kTileK - 1) / kTileK));
  kernel<<<grid, kThreads, smem, stream>>>(Q, vectors, ids, out, K, n, d);
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t dispatch_vec(const float* Q, const float* vectors, const int* ids,
                         float* out, int B, int K, int n, int d,
                         cudaStream_t stream) {
  const bool vec4 = d % 4 == 0 && (uintptr_t)Q % 16 == 0 &&
                    (uintptr_t)vectors % 16 == 0;
  if (vec4)
    return launch<METRIC, true>(Q, vectors, ids, out, B, K, n, d, stream);
  return launch<METRIC, false>(Q, vectors, ids, out, B, K, n, d, stream);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller owns every buffer; the kernel allocates nothing and does not
// synchronise. metric: 0 = l2, 1 = cos, 2 = dot.
extern "C" int navix_gather_distance_batch_f32(const float* Q,
                                               const float* vectors,
                                               const int* ids, float* out,
                                               int B, int K, int n, int d,
                                               int metric, void* stream) {
  if (B <= 0 || K <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2:
      return (int)dispatch_vec<kL2>(Q, vectors, ids, out, B, K, n, d, s);
    case kCos:
      return (int)dispatch_vec<kCos>(Q, vectors, ids, out, B, K, n, d, s);
    case kDot:
      return (int)dispatch_vec<kDot>(Q, vectors, ids, out, B, K, n, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
