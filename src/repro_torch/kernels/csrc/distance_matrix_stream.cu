// All-pairs distances for small batches, b <= 16 (Hopper, sm_90a): the
// streaming path of the all-pairs distance kernel.
//
//   Q f32[b, d], X f32[n, d] -> D f32[b, n], f32 accumulation
//   l2: ||q||^2 + ||x||^2 - 2 q.x     cos: 1 - q.x     dot: -q.x
//
// Replaces, for b <= 16, the TPU kernel repro/kernels/distance_matrix.py::
// distance_matrix_pallas (an MXU schedule of (bq, bd) x (bn, bd) blocks with
// d innermost and an f32 accumulator in VMEM); distance_matrix_wgmma.cu
// takes b > 16.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. X is read once, D written once,
// Q is a few KB: 4nd + 4bn bytes against 2bnd flops, at most 8 flops a byte
// of X at b = 16, far below the card's 67 TFLOP/s of f32 FMAs.
//   (1, 1,000,000, 32)    the recsys retrieval step: 132 MB, 0.0394 ms
//   (16, 1,000,000, 32)   192 MB, 0.0573 ms
//
// Design: one thread per row of X, 256 rows a block. A block streams its
// rows through shared memory in chunks of 32 columns with cp.async (16-byte
// copies where rows are 16-byte aligned, d % 4 == 0; 4-byte copies
// otherwise), up to three chunks in flight; at d = 32 a block has one chunk
// and several blocks share an SM, so their copies overlap. Staged rows are
// padded to 144 bytes: the 16-byte reads of eight neighbouring rows fall on
// distinct banks. All b query rows' chunk sits beside it and is read by
// broadcast. Each thread keeps its row's b sums in registers and adds
// x[k] q[k] with fmaf for k = 0, 1, ..., d-1, one order whatever b is, so a
// lone query row gives the same bits as its row in any batch of b <= 16;
// ||x||^2 and ||q||^2 are summed the same way from the same staged values.
// Rows past n and columns past d are staged as zeros and never summed or
// stored. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // one row of X per thread
constexpr int kRows = kThreads;
constexpr int kBK = 32;         // columns per staged chunk
constexpr int kPad = 36;        // floats per staged row (144 bytes)
constexpr int kMaxB = 16;
constexpr int kStages = 3;      // chunks in flight

enum Metric { kL2 = 0, kCos = 1, kDot = 2 };

struct Stage {
  float x[kRows * kPad];
  float q[kMaxB * kBK];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros where !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <bool VEC>
__device__ __forceinline__ void load_chunk(Stage& s, const float* __restrict__ Q,
                                           const float* __restrict__ X,
                                           long long row0, int b, int n,
                                           int d, int k0) {
  const int tid = threadIdx.x;
  if (VEC) {
    // 8 threads copy one row's 128 bytes: coalesced
#pragma unroll
    for (int j = 0; j < kRows * 8 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i >> 3, c = i & 7;
      const long long row = row0 + r;
      const int k = k0 + 4 * c;
      const bool ok = row < n && k < d;
      cp_async16(&s.x[r * kPad + 4 * c], ok ? X + row * d + k : X, ok);
    }
    if (tid < b * 8) {
      const int r = tid >> 3, c = tid & 7;
      const int k = k0 + 4 * c;
      const bool ok = k < d;
      cp_async16(&s.q[r * kBK + 4 * c], ok ? Q + (long long)r * d + k : Q,
                 ok);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < kRows * kBK / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kBK, c = i % kBK;
      const long long row = row0 + r;
      const int k = k0 + c;
      const bool ok = row < n && k < d;
      cp_async4(&s.x[r * kPad + c], ok ? X + row * d + k : X, ok);
    }
    for (int i = tid; i < b * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int k = k0 + c;
      const bool ok = k < d;
      cp_async4(&s.q[r * kBK + c], ok ? Q + (long long)r * d + k : Q, ok);
    }
  }
}

template <int METRIC, bool VEC>
__global__ void __launch_bounds__(kThreads)
distance_stream_kernel(const float* __restrict__ Q,
                       const float* __restrict__ X, float* __restrict__ out,
                       int b, int n, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float qn[kMaxB];
  Stage* st = reinterpret_cast<Stage*>(smem_raw);
  constexpr bool kNorms = METRIC == kL2;

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int nk = (d + kBK - 1) / kBK;

  float acc[kMaxB];
#pragma unroll
  for (int q = 0; q < kMaxB; ++q) acc[q] = 0.f;
  float xx = 0.f, qq = 0.f;

  // chunks 0 and 1 in flight; one group committed per chunk, empty or not
#pragma unroll
  for (int kc = 0; kc < kStages - 1; ++kc) {
    if (kc < nk) load_chunk<VEC>(st[kc], Q, X, row0, b, n, d, kc * kBK);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    const int next = kc + kStages - 1;
    if (next < nk)
      load_chunk<VEC>(st[next % kStages], Q, X, row0, b, n, d, next * kBK);
    cp_async_commit();
    cp_async_wait<kStages - 1>();            // chunk kc has landed
    __syncthreads();

    const Stage& s = st[kc % kStages];
    const int kn = min(kBK, d - kc * kBK);
    const float* xr = &s.x[tid * kPad];
    if (kn == kBK) {
#pragma unroll
      for (int c = 0; c < kBK / 4; ++c) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * c);
        if (kNorms) {
          xx = fmaf(xv.x, xv.x, xx);
          xx = fmaf(xv.y, xv.y, xx);
          xx = fmaf(xv.z, xv.z, xx);
          xx = fmaf(xv.w, xv.w, xx);
        }
#pragma unroll
        for (int q = 0; q < kMaxB; ++q) {
          if (q < b) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&s.q[q * kBK + 4 * c]);
            acc[q] = fmaf(xv.x, qv.x, acc[q]);
            acc[q] = fmaf(xv.y, qv.y, acc[q]);
            acc[q] = fmaf(xv.z, qv.z, acc[q]);
            acc[q] = fmaf(xv.w, qv.w, acc[q]);
          }
        }
      }
    } else {
      for (int k = 0; k < kn; ++k) {
        const float xv = xr[k];
        if (kNorms) xx = fmaf(xv, xv, xx);
#pragma unroll
        for (int q = 0; q < kMaxB; ++q)
          if (q < b) acc[q] = fmaf(xv, s.q[q * kBK + k], acc[q]);
      }
    }
    // ||q||^2 by thread q, in the same k order
    if (kNorms && tid < b)
      for (int k = 0; k < kn; ++k) {
        const float qv = s.q[tid * kBK + k];
        qq = fmaf(qv, qv, qq);
      }
    __syncthreads();                          // the slot may be refilled
  }

  if (kNorms) {
    if (tid < b) qn[tid] = qq;
    __syncthreads();
  }
  const long long row = row0 + tid;
  if (row >= n) return;
#pragma unroll
  for (int q = 0; q < kMaxB; ++q) {
    if (q < b) {
      float v;
      if (METRIC == kL2) v = (qn[q] + xx) - 2.f * acc[q];
      else if (METRIC == kCos) v = 1.f - acc[q];
      else v = -acc[q];
      out[(long long)q * n + row] = v;
    }
  }
}

template <int METRIC, bool VEC>
cudaError_t launch_stream(const float* Q, const float* X, float* out, int b,
                          int n, int d, cudaStream_t stream) {
  const int nk = (d + kBK - 1) / kBK;
  const int slots = nk < kStages ? nk : kStages;
  const int smem = slots * (int)sizeof(Stage);
  auto kernel = distance_stream_kernel<METRIC, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStages * (int)sizeof(Stage));
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(((long long)n + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(Q, X, out, b, n, d);
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t launch_metric(const float* Q, const float* X, float* out, int b,
                          int n, int d, int vec, cudaStream_t stream) {
  if (vec) return launch_stream<METRIC, true>(Q, X, out, b, n, d, stream);
  return launch_stream<METRIC, false>(Q, X, out, b, n, d, stream);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// metric: 0 = l2, 1 = cos, 2 = dot. vec: 1 for 16-byte copies, which needs
// d % 4 == 0 and 16-byte aligned Q and X; 0 for 4-byte copies.
extern "C" int navix_distance_matrix_stream(const float* Q, const float* X,
                                            float* out, int b, int n, int d,
                                            int metric, int vec,
                                            void* stream) {
  if (b <= 0 || b > kMaxB || n <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  if (vec && ((d & 3) || (((uintptr_t)Q | (uintptr_t)X) & 15)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2: return (int)launch_metric<kL2>(Q, X, out, b, n, d, vec, s);
    case kCos: return (int)launch_metric<kCos>(Q, X, out, b, n, d, vec, s);
    case kDot: return (int)launch_metric<kDot>(Q, X, out, b, n, d, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
