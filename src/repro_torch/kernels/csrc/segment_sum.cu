// CSR segment sum out[v] = sum of messages[e] over the edges e whose sorted
// destination is v (Hopper, sm_90a).
//
//   messages f32[E, d] (sorted by destination), row_ptr i64[n + 1] -> out
//   f32[n, d]; edges row_ptr[v] .. row_ptr[v + 1] - 1 belong to node v.
//
// Replaces the TPU kernel repro/kernels/segment_sum.py::
// csr_segment_sum_pallas, which sums one-hot (bn x be) matmuls on the MXU
// over each node block's contiguous range of edge tiles (planned on the host
// by plan_tiles). The wrapper's row_ptr = searchsorted(dst_sorted, 0..n)
// takes plan_tiles' place; padding (the sentinel 0x3FFFFFFF, sorting last)
// lies at or past row_ptr[n] and is never read.
//
// Bound on an H100 SXM: pure bytes (one add per float read). Bytes = 4Ed
// read + 4nd written (+ 4E of destinations read by the wrapper), at
// 3.35 TB/s. ogb_products at d = 128 (n = 2,449,029, E = 61,859,140): about
// 33.2 GB, 9.9 ms.
//
// Design: a segmented reduce with no one-hot matrix and no atomics. One warp
// per node, its lanes across d with 16-byte loads (d = 128 is one float4 per
// lane, a warp reads each 512-byte message row in one instruction); the
// node's rows are contiguous, so the warp streams them in edge order, the
// loop unrolled so several rows are in flight. Each node is summed in edge
// order, deterministically; nodes with no edges get zeros. Edge offsets are
// 64-bit (E * d = 7.9e9 at ogb_products).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
csr_segment_sum_kernel(const float* __restrict__ msg,
                       const long long* __restrict__ row_ptr,
                       float* __restrict__ out, int n, int d) {
  const long long v = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= n) return;
  const int lane = threadIdx.x & 31;
  const long long e0 = row_ptr[v], e1 = row_ptr[v + 1];
  if (VEC4) {
    const long long d4 = d >> 2;
    const float4* m4 = reinterpret_cast<const float4*>(msg);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long c = lane; c < d4; c += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (long long e = e0; e < e1; ++e) {
        const float4 m = m4[e * d4 + c];
        acc.x += m.x;
        acc.y += m.y;
        acc.z += m.z;
        acc.w += m.w;
      }
      o4[v * d4 + c] = acc;
    }
  } else {
    for (long long c = lane; c < d; c += 32) {
      float acc = 0.f;
#pragma unroll 4
      for (long long e = e0; e < e1; ++e) acc += msg[e * d + c];
      out[v * d + c] = acc;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int navix_csr_segment_sum(const float* messages,
                                     const long long* row_ptr, float* out,
                                     int n, int d, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((n + kWarps - 1) / kWarps));
  const bool vec4 = d % 4 == 0 && (uintptr_t)messages % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  if (vec4)
    csr_segment_sum_kernel<true><<<grid, kThreads, 0, s>>>(messages, row_ptr,
                                                           out, n, d);
  else
    csr_segment_sum_kernel<false><<<grid, kThreads, 0, s>>>(messages, row_ptr,
                                                            out, n, d);
  return (int)cudaGetLastError();
}
