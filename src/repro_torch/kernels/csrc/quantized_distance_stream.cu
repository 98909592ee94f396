// All-pairs distances against int8 codes for small batches (Hopper,
// sm_90a): the streaming path of the int8 all-pairs distance kernel.
//
//   Q f32[b, d], codes i8[n, d], scale f32[n] -> D f32[b, n], x ~ s * c
//   l2: ||q||^2 + s^2 (c.c) - 2 s (q.c)   cos: 1 - s (q.c)   dot: -s (q.c)
//
// Replaces, for small b, the TPU kernel repro/kernels/quantized.py::
// quantized_distance_pallas (an MXU schedule of (bq, bd) x (bn, bd) blocks
// over int8 codes, q.c, c.c and q.q accumulated over d blocks in VMEM, the
// scale applied on the last d step); quantized_distance_wgmma.cu takes the
// larger batches (the threshold is the wrapper's, kernels/quantized.py).
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The codes are read once, D
// written once: nd + 4n + 4bn + 4bd bytes against 2bnd flops, 2b flops a
// byte of codes, so below the card's 67 TFLOP/s of f32 FMAs (20 flops a
// byte) up to b ~ 10.
//   (8, 1,000,000, 960)    an int8 brute-force scan: 0.996 GB, 0.297 ms
//
// Design: two rows of codes a thread, 256 rows a block, and one group of
// up to 16 query rows a block (a grid of row blocks x query groups, the
// groups of one row block adjacent, so a second group finds its codes in
// L2). A block streams its rows through shared memory in chunks of 64
// columns with cp.async (16-byte copies where d % 16 == 0 and the rows are
// 16-byte aligned, 4-byte copies where d % 4 == 0, else byte loads), up to
// three chunks in flight. Staged rows are padded to 80 bytes, so the
// 16-byte reads of eight neighbouring rows fall on distinct banks. The
// group's chunk of Q sits beside them and is read by broadcast, each read
// serving both of a thread's rows (one row a thread took 1.13-1.22x longer
// at b = 8 .. 16 on an H100).
// - Four codes at a time are converted to f32 from one 32-bit word without
//   I2F (16 a clock per SM on sm_90, against 128 FMAs): each byte, biased
//   by 128, goes into the mantissa of 2^23 with __byte_perm, and one
//   subtraction of 2^23 + 128 leaves the code, exactly.
// - Each thread keeps its rows' sums q.c for the group's queries in
//   registers: it adds c[k] q[k] with fmaf for k = 0, 1, ... into a fresh
//   partial for each chunk, which joins the row's total with a rounded add
//   (one f32 sum over all of d left 4-5x the plain version's error against
//   float64 at d = 960; blocks of 64 bring it level). One order whatever b
//   is, so a lone query row gives the same bits as its row in any batch;
//   ||q||^2 is summed the same way from the staged values and c.c exactly
//   in integers (__dp4a; at most 127^2 d, below 2^31).
// - The scale is applied in the epilogue in the TPU kernel's form; no row
//   is dequantized.
// Rows past n and b and columns past d are staged as zeros (their products
// add nothing) and never stored. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 2 * kThreads;   // two rows of codes per thread
constexpr int kBK = 64;         // columns per staged chunk
constexpr int kPad = 80;        // bytes per staged row of codes
constexpr int kGroup = 16;      // query rows per block
constexpr int kStages = 3;      // chunks in flight

enum Metric { kL2 = 0, kCos = 1, kDot = 2 };

struct Stage {
  unsigned char c[kRows * kPad];
  float q[kGroup * kBK];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes, or zeros where !valid (src-size 0 reads nothing)
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

// The metric in the TPU kernel's form from q.c, the row's scale s, its c.c
// and ||q||^2, every rounding explicit so that no build contracts it into
// another order: l2 ||q||^2 + s^2 (c.c) - 2 s (q.c), cos 1 - s (q.c), dot
// -s (q.c)
template <int METRIC>
__device__ __forceinline__ float epilogue(float dot, float s, float cc,
                                          float qq) {
  const float sdot = __fmul_rn(dot, s);
  if (METRIC == kL2)
    return __fsub_rn(__fadd_rn(qq, __fmul_rn(__fmul_rn(s, s), cc)),
                     __fmul_rn(2.f, sdot));
  if (METRIC == kCos) return __fsub_rn(1.f, sdot);
  return -sdot;
}

// the four signed bytes of w as exact floats, byte 0 first
__device__ __forceinline__ float4 codes_to_f32(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;          // c + 128 in each byte
  const float bias = 8388736.f;                // 2^23 + 128
  return make_float4(
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440)), bias),
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7441)), bias),
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7442)), bias),
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7443)), bias));
}

// Stages chunk k0 of the block's rows of codes and of its query group.
// LOAD: 16 (16-byte copies), 4 (4-byte copies) or 1 (byte loads).
template <int LOAD>
__device__ __forceinline__ void load_chunk(
    Stage& s, const float* __restrict__ Q, const int8_t* __restrict__ C,
    long long row0, long long q0, int b, int n, int d, int k0) {
  const int tid = threadIdx.x;
  if (LOAD == 16) {
    // 4 threads copy one row's 64 bytes: coalesced
#pragma unroll
    for (int j = 0; j < kRows * 4 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i >> 2, c = i & 3;
      const long long row = row0 + r;
      const int k = k0 + 16 * c;
      const bool ok = row < n && k < d;
      cp_async16(&s.c[r * kPad + 16 * c], ok ? C + row * d + k : C, ok);
    }
#pragma unroll
    for (int i = tid; i < kGroup * kBK / 4; i += kThreads) {
      const int r = i >> 4, c = i & 15;        // 16 rows x 64 floats
      const int k = k0 + 4 * c;
      const bool ok = q0 + r < b && k < d;
      cp_async16(&s.q[r * kBK + 4 * c], ok ? Q + (q0 + r) * d + k : Q, ok);
    }
  } else {
    if (LOAD == 4) {
#pragma unroll 4
      for (int j = 0; j < kRows * kBK / 4 / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i >> 4, c = i & 15;
        const long long row = row0 + r;
        const int k = k0 + 4 * c;
        const bool ok = row < n && k < d;
        cp_async4(&s.c[r * kPad + 4 * c], ok ? C + row * d + k : C, ok);
      }
    } else {
      // rows of any width: 64 threads load one row's 64 bytes
#pragma unroll 4
      for (int j = 0; j < kRows * kBK / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i >> 6, c = i & 63;
        const long long row = row0 + r;
        const int k = k0 + c;
        s.c[r * kPad + c] =
            row < n && k < d ? (unsigned char)C[row * d + k] : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup * kBK / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kBK, c = i % kBK;
      const int k = k0 + c;
      const bool ok = q0 + r < b && k < d;
      cp_async4(&s.q[r * kBK + c], ok ? Q + (q0 + r) * d + k : Q, ok);
    }
  }
}

// G: query rows summed per thread, 4, 8 or 16 (16 for any b > 8; rows of a
// group past b are staged as zeros, summed and never stored)
template <int METRIC, int LOAD, int G>
__global__ void __launch_bounds__(kThreads)
quantized_stream_kernel(const float* __restrict__ Q,
                        const int8_t* __restrict__ C,
                        const float* __restrict__ scale,
                        float* __restrict__ out, int b, int n, int d,
                        int groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float qn[kGroup];
  Stage* st = reinterpret_cast<Stage*>(smem_raw);
  constexpr bool kNorms = METRIC == kL2;

  const int tid = threadIdx.x;
  const long long q0 = (long long)(blockIdx.x % (unsigned)groups) * kGroup;
  const long long row0 = (long long)(blockIdx.x / (unsigned)groups) * kRows;
  const int bg = (int)min((long long)kGroup, b - q0);   // queries here
  const int nk = (d + kBK - 1) / kBK;

  float acc[2][G];                           // rows tid and tid + kThreads
#pragma unroll
  for (int q = 0; q < G; ++q) acc[0][q] = acc[1][q] = 0.f;
  float qq = 0.f;
  int cc[2] = {0, 0};

  // chunks 0 and 1 in flight; one group committed per chunk, empty or not
#pragma unroll
  for (int kc = 0; kc < kStages - 1; ++kc) {
    if (kc < nk) load_chunk<LOAD>(st[kc], Q, C, row0, q0, b, n, d, kc * kBK);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    const int next = kc + kStages - 1;
    if (next < nk)
      load_chunk<LOAD>(st[next % kStages], Q, C, row0, q0, b, n, d,
                       next * kBK);
    cp_async_commit();
    cp_async_wait<kStages - 1>();            // chunk kc has landed
    __syncthreads();

    // a whole chunk every time: columns past d are zeros in both operands
    const Stage& s = st[kc % kStages];
    float part[2][G];
#pragma unroll
    for (int q = 0; q < G; ++q) part[0][q] = part[1][q] = 0.f;
#pragma unroll
    for (int p = 0; p < kBK / 16; ++p) {
      uint32_t ws[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(
            &s.c[(tid + kThreads * h) * kPad + 16 * p]);
        ws[h][0] = w4.x; ws[h][1] = w4.y; ws[h][2] = w4.z; ws[h][3] = w4.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 x[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x[h] = codes_to_f32(ws[h][e]);
          if (kNorms) cc[h] = __dp4a((int)ws[h][e], (int)ws[h][e], cc[h]);
        }
        const int k = 16 * p + 4 * e;
#pragma unroll
        for (int q = 0; q < G; ++q) {
          // one broadcast read of Q serves both rows
          const float4 qv =
              *reinterpret_cast<const float4*>(&s.q[q * kBK + k]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            part[h][q] = fmaf(x[h].x, qv.x, part[h][q]);
            part[h][q] = fmaf(x[h].y, qv.y, part[h][q]);
            part[h][q] = fmaf(x[h].z, qv.z, part[h][q]);
            part[h][q] = fmaf(x[h].w, qv.w, part[h][q]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      acc[0][q] = __fadd_rn(acc[0][q], part[0][q]);
      acc[1][q] = __fadd_rn(acc[1][q], part[1][q]);
    }
    // ||q||^2 by thread q, in the same k order
    if (kNorms && tid < bg) {
      float qpart = 0.f;
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float qv = s.q[tid * kBK + k];
        qpart = fmaf(qv, qv, qpart);
      }
      qq = __fadd_rn(qq, qpart);
    }
    __syncthreads();                          // the slot may be refilled
  }

  if (kNorms) {
    if (tid < bg) qn[tid] = qq;
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + tid + kThreads * h;
    if (row >= n) return;
    const float sc = scale[row];
    const float ccf = (float)cc[h];          // exact: below 2^24
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (q < bg) {
        out[(q0 + q) * n + row] =
            epilogue<METRIC>(acc[h][q], sc, ccf, kNorms ? qn[q] : 0.f);
      }
    }
  }
}

template <int METRIC, int LOAD, int G>
cudaError_t launch_stream(const float* Q, const int8_t* C, const float* scale,
                          float* out, int b, int n, int d,
                          cudaStream_t stream) {
  const int nk = (d + kBK - 1) / kBK;
  const int slots = nk < kStages ? nk : kStages;
  const int smem = slots * (int)sizeof(Stage);
  const long long groups = ((long long)b + kGroup - 1) / kGroup;
  const long long blocks = ((long long)n + kRows - 1) / kRows * groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = quantized_stream_kernel<METRIC, LOAD, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStages * (int)sizeof(Stage));
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(Q, C, scale, out, b, n,
                                                       d, (int)groups);
  return cudaGetLastError();
}

template <int METRIC, int LOAD>
cudaError_t launch_load(const float* Q, const int8_t* C, const float* scale,
                        float* out, int b, int n, int d, cudaStream_t stream) {
  if (b <= 4)
    return launch_stream<METRIC, LOAD, 4>(Q, C, scale, out, b, n, d, stream);
  if (b <= 8)
    return launch_stream<METRIC, LOAD, 8>(Q, C, scale, out, b, n, d, stream);
  return launch_stream<METRIC, LOAD, 16>(Q, C, scale, out, b, n, d, stream);
}

template <int METRIC>
cudaError_t launch_metric(const float* Q, const int8_t* C, const float* scale,
                          float* out, int b, int n, int d, int load,
                          cudaStream_t stream) {
  switch (load) {
    case 16: return launch_load<METRIC, 16>(Q, C, scale, out, b, n, d, stream);
    case 4: return launch_load<METRIC, 4>(Q, C, scale, out, b, n, d, stream);
    default: return launch_load<METRIC, 1>(Q, C, scale, out, b, n, d, stream);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// metric: 0 = l2, 1 = cos, 2 = dot. load: 16 for 16-byte copies (d % 16 ==
// 0, Q and codes 16-byte aligned), 4 for 4-byte copies (d % 4 == 0, codes
// 4-byte aligned), 1 for byte loads (any d).
extern "C" int navix_quantized_distance_stream(const float* Q,
                                               const signed char* codes,
                                               const float* scale, float* out,
                                               int b, int n, int d,
                                               int metric, int load,
                                               void* stream) {
  if (b <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (load == 16 && ((d & 15) || (((uintptr_t)Q | (uintptr_t)codes) & 15)))
    return (int)cudaErrorInvalidValue;
  if (load == 4 && ((d & 3) || ((uintptr_t)codes & 3)))
    return (int)cudaErrorInvalidValue;
  if (load != 16 && load != 4 && load != 1) return (int)cudaErrorInvalidValue;
  const int8_t* C = reinterpret_cast<const int8_t*>(codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2: return (int)launch_metric<kL2>(Q, C, scale, out, b, n, d, load, s);
    case kCos: return (int)launch_metric<kCos>(Q, C, scale, out, b, n, d, load, s);
    case kDot: return (int)launch_metric<kDot>(Q, C, scale, out, b, n, d, load, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
