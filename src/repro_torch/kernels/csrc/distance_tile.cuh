// The tiled all-pairs distance schedule of quantized_distance.cu (int8 codes
// with a per-row scale). It served the f32 all-pairs distance too until that
// kernel got its own two paths (distance_matrix_stream.cu for b <= 16,
// distance_matrix_wgmma.cu on the tensor cores); its XT = float form is no
// longer instantiated.
//
// One block per (BQ x 64) tile of the output D[b, n]; 16 x 16 threads, each
// holding a TM x 4 register micro-tile of outputs at rows ty + 16 i and
// columns tx + 16 j (so neighbouring threads read neighbouring shared-memory
// words and write neighbouring outputs). d is walked in 32-wide chunks: the
// block stages Q's and X's chunk, transposed, in shared memory (stride + 1,
// so the transposing stores hit distinct banks), then every thread runs full
// f32 FMAs over the chunk. Rows of Q past b and of X past n, and columns
// past d, are staged as zeros and never stored: nothing is padded in memory.
// TM = 1 (16 query rows per tile) serves small batches, TM = 4 (64) larger
// ones; both sum each output over d in the same order, so the choice of
// tile changes no bit. All offsets are 64-bit (b * n and n * d pass 2^31).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace navix_tile {

constexpr int kTX = 16;              // threads along n
constexpr int kTY = 16;              // threads along b
constexpr int kThreads = kTX * kTY;
constexpr int kTN = 4;               // outputs per thread along n
constexpr int kBN = kTX * kTN;       // 64 rows of X per tile
constexpr int kBD = 32;              // d chunk staged in shared memory

enum Metric { kL2 = 0, kCos = 1, kDot = 2 };

// XT = float: f32 rows, D = metric(q.x) with ||q||^2 + ||x||^2 - 2 q.x for
// l2. XT = int8_t: codes c with scale s, D = ||q||^2 + s^2 (c.c) - 2 s (q.c)
// for l2, 1 - s (q.c) for cos, -s (q.c) for dot (the scale is applied here,
// in the epilogue, never to the codes).
template <typename XT, int METRIC, int TM>
__global__ void __launch_bounds__(kThreads)
distance_tile_kernel(const float* __restrict__ Q, const XT* __restrict__ X,
                     const float* __restrict__ scale, float* __restrict__ out,
                     int b, int n, int d) {
  constexpr int kBQ = kTY * TM;
  constexpr bool kQuant = sizeof(XT) == 1;
  constexpr bool kNorms = METRIC == kL2;
  __shared__ float qs[kBD][kBQ + 1];
  __shared__ float xs[kBD][kBN + 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const long long row0 = (long long)blockIdx.y * kBQ;
  const long long col0 = (long long)blockIdx.x * kBN;

  float acc[TM][kTN];
  float qq[TM], xx[kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    qq[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kTN; ++j) xx[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBD) {
    // consecutive threads read consecutive k of one row: coalesced
    for (int i = tid; i < kBQ * kBD; i += kThreads) {
      const int r = i / kBD, c = i % kBD;
      const long long row = row0 + r;
      const int k = k0 + c;
      qs[c][r] = (row < b && k < d) ? Q[row * d + k] : 0.f;
    }
    for (int i = tid; i < kBN * kBD; i += kThreads) {
      const int r = i / kBD, c = i % kBD;
      const long long row = col0 + r;
      const int k = k0 + c;
      xs[c][r] = (row < n && k < d) ? (float)X[row * d + k] : 0.f;
    }
    __syncthreads();
    const int kn = min(kBD, d - k0);
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      float qv[TM], xv[kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = qs[k][ty + kTY * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) xv[j] = xs[k][tx + kTX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(qv[i], xv[j], acc[i][j]);
      if (kNorms) {
#pragma unroll
        for (int i = 0; i < TM; ++i) qq[i] = fmaf(qv[i], qv[i], qq[i]);
#pragma unroll
        for (int j = 0; j < kTN; ++j) xx[j] = fmaf(xv[j], xv[j], xx[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = row0 + ty + kTY * i;
    if (row >= b) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const long long col = col0 + tx + kTX * j;
      if (col >= n) continue;
      float v;
      if (kQuant) {
        const float s = scale[col];
        const float sdot = acc[i][j] * s;
        if (METRIC == kL2) v = qq[i] + (s * s) * xx[j] - 2.f * sdot;
        else if (METRIC == kCos) v = 1.f - sdot;
        else v = -sdot;
      } else {
        if (METRIC == kL2) v = (qq[i] + xx[j]) - 2.f * acc[i][j];
        else if (METRIC == kCos) v = 1.f - acc[i][j];
        else v = -acc[i][j];
      }
      out[row * n + col] = v;
    }
  }
}

template <typename XT, int METRIC, int TM>
cudaError_t launch_tm(const float* Q, const XT* X, const float* scale,
                      float* out, int b, int n, int d, cudaStream_t stream) {
  constexpr int kBQ = kTY * TM;
  const dim3 grid((unsigned)((n + kBN - 1) / kBN),
                  (unsigned)((b + kBQ - 1) / kBQ));
  distance_tile_kernel<XT, METRIC, TM>
      <<<grid, dim3(kTX, kTY), 0, stream>>>(Q, X, scale, out, b, n, d);
  return cudaGetLastError();
}

template <typename XT, int METRIC>
cudaError_t launch_metric(const float* Q, const XT* X, const float* scale,
                          float* out, int b, int n, int d,
                          cudaStream_t stream) {
  if (b <= kTY)
    return launch_tm<XT, METRIC, 1>(Q, X, scale, out, b, n, d, stream);
  return launch_tm<XT, METRIC, 4>(Q, X, scale, out, b, n, d, stream);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// metric: 0 = l2, 1 = cos, 2 = dot.
template <typename XT>
int launch(const float* Q, const XT* X, const float* scale, float* out,
           int b, int n, int d, int metric, void* stream) {
  if (b <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if ((b + kTY - 1) / kTY > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2: return (int)launch_metric<XT, kL2>(Q, X, scale, out, b, n, d, s);
    case kCos: return (int)launch_metric<XT, kCos>(Q, X, scale, out, b, n, d, s);
    case kDot: return (int)launch_metric<XT, kDot>(Q, X, scale, out, b, n, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace navix_tile
