// All-pairs distances against int8 codes for larger batches on the tensor
// cores (Hopper, sm_90a): the wgmma path of the int8 all-pairs distance
// kernel, at full f32 accuracy through a 3xBF16 split of Q.
//
//   Q f32[b, d], codes i8[n, d], scale f32[n] -> D f32[b, n], x ~ s * c
//   l2: ||q||^2 + s^2 (c.c) - 2 s (q.c)   cos: 1 - s (q.c)   dot: -s (q.c)
//
// Replaces, for the batches above the streaming path's threshold (the
// wrapper's, kernels/quantized.py), the TPU kernel repro/kernels/
// quantized.py::quantized_distance_pallas (an MXU schedule of (bq, bd) x
// (bn, bd) blocks over int8 codes with d innermost, q.c, c.c and q.q in
// VMEM, the scale applied on the last d step); quantized_distance_stream.cu
// takes the small batches.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s dense BF16): the larger of
// bytes (4bd + nd + 4n + 4bn) and 3 x 2bnd BF16 operations, the cheapest
// f32-accurate route for int8 codes (a 2xTF32 split at 495 TFLOP/s would
// need 2 x 2bnd TF32 operations, 1.33x the time).
//   (1024, 65,536, 960)    GIST width: 387 BF16 GFLOP, 0.39 ms
//                          (2xTF32: 0.52 ms)
//
// Precision. A code c is an integer in -128 .. 127, exact in BF16 (8
// significant bits), so only Q is split, in three BF16 pieces rounded to
// nearest: hi = bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid) (each
// difference exact in f32); q = hi + mid + lo to 2^-24 relative, and every
// product with c is exact. Each product q.c is accumulated as lo_q c +
// mid_q c + hi_q c. The tensor cores' f32 accumulation truncates as it
// adds, so, as in distance_matrix_wgmma.cu, each stage of 64 columns sums
// into a fresh accumulator, the small products first, and joins an f32
// register total with a rounded add. ||q||^2 is an f32 sum of the unsplit
// values (a warp's lanes each over their columns, then a butterfly); c.c is
// summed exactly in integers (__dp4a); the scale is applied in the
// epilogue in the TPU kernel's form, and no row is dequantized.
//
// Design: the transposed product D^T = codes Q^T, so the codes are the
// wgmma's A operand, taken from registers, and Q its B operand (N = 128
// queries), in two launches.
// - A first kernel splits Q once into its three pieces and writes them as
//   the shared-memory image of the B operand: per tile of 128 queries and
//   stage of 64 columns, hi, mid and lo, 16 KB each in the 128-byte
//   swizzle, zeros past b and d; and ||q||^2 per query.
// - The main kernel runs persistent blocks of three warpgroups, one block
//   per SM (177 KB of shared memory: two stages of 56 KB and a 64 KB output
//   tile), each walking output tiles of 128 queries x 128 rows of codes,
//   query tiles fastest, so the blocks that share a tile of codes run
//   together and read it from L2.
// - Warpgroup 0, the producer (40 registers a thread after setmaxnreg),
//   only copies, a stage ahead: one bulk asynchronous copy of the stage's
//   48 KB of Q's pieces (complete_tx on the stage's mbarrier), and 64 bytes
//   of each of the tile's 128 rows of codes with cp.async (16-byte copies
//   where d % 16 == 0 and the rows are 16-byte aligned, 4-byte copies where
//   d % 4 == 0, else byte loads), whose completion arrives on the same
//   mbarrier (cp.async.mbarrier.arrive.noinc).
// - Warpgroups 1 and 2, the consumers (232 registers), each own 64 rows of
//   codes of the tile with 64 f32 accumulators a thread for the stage and 64
//   for the total. Per stage a thread runs 12 wgmma.m64n128k16 (lo, mid,
//   hi), then, while they run, reads the next stage's 16 codes of each of
//   its two rows as four 32-bit words and converts them without I2F (each
//   byte, biased by 128, into the mantissa of 2^23 with __byte_perm, less
//   2^23 + 128; the f32 value's upper half is its BF16, exactly) into the
//   other set of A fragments; then it releases the stage and adds the
//   partial to the total. The columns of each stage are permuted so that a
//   thread's 16 codes lie side by side in memory: physical column
//   16t + 4k + j is logical column 16k + 2t + (j % 2) + 8 (j / 2) of k16
//   step k, and the first kernel writes Q's columns in the same order, so
//   q.c is unchanged.
// - At a tile's last stage the consumers apply the metric and the scale,
//   stage the tile transposed (query-major, XOR-swizzled so that neither
//   the writes nor the reads conflict) and write each query's 128 outputs
//   as one coalesced 512-byte store of a warp.
// Rows past n and columns past d are copied as zeros and never stored.
// Each output's sum runs over d in one order whatever its query's place in
// the tile, so queries computed alone equal the same queries inside a
// larger batch. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;          // queries per tile (the wgmma's N)
constexpr int kBM = 128;          // rows of codes per tile (two warpgroups)
constexpr int kBK = 64;           // columns per stage
constexpr int kProducers = 128;   // warpgroup 0: copies
constexpr int kConsumers = 256;   // warpgroups 1-2: wgmma and epilogue
constexpr int kThreads = kProducers + kConsumers;
constexpr int kStages = 2;        // stages in flight
constexpr int kPieces = 3;        // Q's BF16 pieces
constexpr int kQTileBytes = kBQ * kBK * 2;       // one piece: 16 KB
constexpr int kCodeBytes = kBM * kBK;            // 8 KB
// a stage: Q's hi, mid and lo (the B operands), then 64 bytes of each row
// of codes
constexpr int kQHi = 0, kQMid = kQTileBytes, kQLo = 2 * kQTileBytes;
constexpr int kCodes = kPieces * kQTileBytes;
constexpr int kStageBytes = kPieces * kQTileBytes + kCodeBytes;
constexpr int kOutBytes = kBQ * kBM * 4;          // the output tile: 64 KB
constexpr int kAlign = 1024;      // the 128-byte swizzle repeats every 1 KB
constexpr int kSmemBytes = kStages * kStageBytes + kOutBytes + kAlign;

enum Metric { kL2 = 0, kCos = 1, kDot = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor for a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused for this layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// v rounded to the nearest BF16 (ties to even), finite v, as an f32 whose
// lower 16 bits are zero
__device__ __forceinline__ float bf16_rn(float v) {
  const uint32_t u = __float_as_uint(v);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
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

// ---- the first kernel: Q's split, in the B operand's shared-memory image

// physical column (0 .. 63 within a stage) of logical column L of the
// wgmma's k16 steps: L = 16k + 2t + i + 8h (i, h in 0, 1) holds physical
// column 16t + 4k + i + 2h
__device__ __forceinline__ int physical_column(int L) {
  const int w = L & 15;
  return 16 * ((w & 7) >> 1) + 4 * (L >> 4) + (w & 1) + 2 * (w >> 3);
}

// One warp per query row of the padded batch: lane L writes logical columns
// L and L + 32 of every stage (hi at tile offset 0, mid at 16 KB, lo at 32
// KB), and sums the squares of its physical columns, then the warp's lanes
// in a butterfly.
__global__ void __launch_bounds__(256)
split_q_kernel(const float* __restrict__ Q, unsigned char* __restrict__ qs,
               float* __restrict__ qn, int b, int d, int nk, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long qt = row / kBQ;
  const int r = (int)(row % kBQ);
  float qq = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    unsigned char* t = qs + (qt * nk + kc) * kPieces * kQTileBytes;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int L = lane + 32 * half;
      const int k = kc * kBK + physical_column(L);
      const float v = row < b && k < d ? Q[row * d + k] : 0.f;
      qq = fmaf(v, v, qq);
      const float hi = bf16_rn(v);
      const float r1 = __fsub_rn(v, hi);
      const float mid = bf16_rn(r1);
      const float lo = bf16_rn(__fsub_rn(r1, mid));
      // byte offset of (r, L) in the 128-byte swizzle of 2-byte values
      const int off = r * 128 + (((L >> 3) ^ (r & 7)) << 4) + (L & 7) * 2;
      *reinterpret_cast<uint16_t*>(t + kQHi + off) =
          (uint16_t)(__float_as_uint(hi) >> 16);
      *reinterpret_cast<uint16_t*>(t + kQMid + off) =
          (uint16_t)(__float_as_uint(mid) >> 16);
      *reinterpret_cast<uint16_t*>(t + kQLo + off) =
          (uint16_t)(__float_as_uint(lo) >> 16);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    qq += __shfl_xor_sync(0xffffffffu, qq, o);
  if (lane == 0) qn[row] = qq;
}

// ---- the main kernel

// 16 or 4 bytes, or zeros where !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// copies codes k .. k+15 of row `row` of C[rows, d] to shared memory at dst
// (sm, its generic address, for the byte loads' stores); zeros past rows
// and d
template <int LOAD>
__device__ __forceinline__ void copy_codes(uint32_t dst, unsigned char* sm,
                                           const int8_t* __restrict__ C,
                                           long long row, long long rows,
                                           int d, int k) {
  const bool in = row < rows;
  const int8_t* p = C + (in ? row * d : 0);
  if (LOAD == 16) {
    cp_async16(dst, in && k < d ? p + k : C, in && k < d);
  } else if (LOAD == 4) {
#pragma unroll
    for (int e = 0; e < 16; e += 4)
      cp_async4(dst + e, in && k + e < d ? p + k + e : C, in && k + e < d);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w[e] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k + 4 * e + j;
        const uint32_t v = in && kk < d ? (uint8_t)p[kk] : 0u;
        w[e] |= v << (8 * j);
      }
    }
    *reinterpret_cast<uint4*>(sm) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// an arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// an arrival once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// `bytes` from global src to shared dst in one asynchronous bulk copy that
// completes its bytes on the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Waits for the phase of `parity` to complete. A lost arrival would hang
// the card, so after about ten seconds the kernel traps instead, and the
// next synchronisation with the device raises.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// Walks a block's tiles (blockIdx.x, + gridDim.x, ...; query tiles
// fastest) and each tile's stages, with no 64-bit division.
struct Cursor {
  int kc;            // stage of the tile
  int qi;            // query tile
  long long xi;      // tile of codes
  __device__ void start(int q_tiles) {
    kc = 0;
    qi = (int)(blockIdx.x % (unsigned)q_tiles);
    xi = blockIdx.x / (unsigned)q_tiles;
  }
  __device__ void advance(int nk, int q_tiles) {
    if (++kc < nk) return;
    kc = 0;
    qi += gridDim.x;
    xi += qi / q_tiles;
    qi %= q_tiles;
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across a wgmma
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64x128] = A[64x16] B[128x16]^T (+ d unless scale_d is 0): A BF16 from
// registers, two a 32-bit word (a0 row g cols 2t, 2t+1; a1 row g+8, the
// same columns; a2 row g cols 2t+8, 2t+9; a3 row g+8, those columns; of the
// warp's 16 rows, g = lane / 4, t = lane % 4), B BF16 from shared memory,
// K-major
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// two f32 values' BF16 halves (exact for the codes) in one word, x low
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}

// The A fragments of a stage's four k16 steps from a thread's 16 codes of
// each of its two rows (physical columns 16 t4 .. 16 t4 + 15: word k holds
// step k's columns 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9), and c.c of them
// in cc
template <bool NORMS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4],
                                       const unsigned char* codes, int row0,
                                       int t4, int (&cc)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cc[h] = 0;
    const uint4 w4 = *reinterpret_cast<const uint4*>(
        codes + (row0 + 8 * h) * kBK + 16 * t4);
    const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (NORMS) cc[h] = __dp4a((int)w[k], (int)w[k], cc[h]);
      const float4 x = codes_to_f32(w[k]);
      a[k][h] = pack_bf16(x.x, x.y);
      a[k][2 + h] = pack_bf16(x.z, x.w);
    }
  }
}

// A stage's 12 wgmma into a fresh acc: the small lo products first, then
// mid, then hi
__device__ __forceinline__ void mma_stage(float (&acc)[64],
                                          const uint32_t (&a)[4][4],
                                          uint32_t stage) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_m64n128k16_rs(acc, a[k], make_desc(stage + kQLo + 32 * k), k > 0);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_m64n128k16_rs(acc, a[k], make_desc(stage + kQMid + 32 * k), 1);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_m64n128k16_rs(acc, a[k], make_desc(stage + kQHi + 32 * k), 1);
  wgmma_commit();
}

template <int METRIC, int LOAD>
__global__ void __launch_bounds__(kThreads, 1)
quantized_wgmma_kernel(const int8_t* __restrict__ C,
                       const float* __restrict__ scale,
                       const unsigned char* __restrict__ qs,
                       const float* __restrict__ qn, float* __restrict__ out,
                       int b, int n, int d, int q_tiles, long long x_tiles) {
  extern __shared__ __align__(kAlign) unsigned char smem_raw[];
  // full[kStages], empty[kStages]
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  constexpr bool kNorms = METRIC == kL2;

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  unsigned char* const sm = smem_raw + (base - raw);
  float* const tile_out =
      reinterpret_cast<float*>(sm + kStages * kStageBytes);
  const uint32_t full = smem_u32(&bars[0]);
  const uint32_t empty = smem_u32(&bars[kStages]);
  const int nk = (d + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // one arrival per producer thread (its codes) and one with the
      // expected bytes of Q's bulk copy
      mbar_init(full + 8 * s, kProducers + 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kProducers) {
    // ---- producer: copies only
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    Cursor cur;
    cur.start(q_tiles);
    for (uint32_t it = 0; cur.xi < x_tiles; ++it) {
      const uint32_t s = it % kStages;
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      const uint32_t stage = base + s * kStageBytes;
      if (tid == 0) {
        mbar_arrive_expect_tx(full + 8 * s, kPieces * kQTileBytes);
        bulk_copy(stage + kQHi,
                  qs + ((long long)cur.qi * nk + cur.kc) * kPieces *
                           kQTileBytes,
                  kPieces * kQTileBytes, full + 8 * s);
      }
      // 64 bytes of each of 128 rows: four 16-byte quarters a thread
      const long long x0 = cur.xi * kBM;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int unit = tid + kProducers * u;
        const int r = unit >> 2, h = unit & 3;
        const int off = kCodes + r * kBK + 16 * h;
        copy_codes<LOAD>(stage + off, sm + s * kStageBytes + off, C, x0 + r,
                         n, d, cur.kc * kBK + 16 * h);
      }
      if (LOAD == 1) mbar_arrive(full + 8 * s);   // stores are in order
      else mbar_arrive_cp_async(full + 8 * s);
      cur.advance(nk, q_tiles);
    }
    return;
  }

  // ---- consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63 of the
  // tile's codes; 64 accumulators for the stage and 64 for the f32 total.
  // A stage runs on the tensor cores while the thread converts the next
  // stage's codes into the other set of fragments.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = tid - kProducers;
  const int wg = ct >> 7;
  const int lane = ct & 31, warp = (ct >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = wg * 64 + warp * 16 + g;      // and row0 + 8
  float total[64], acc[64];
  // even and odd stages' fragments and c.c of their codes, and the tile's
  uint32_t a0[4][4], a1[4][4];
  int cc0[2] = {0, 0}, cc1[2] = {0, 0}, cc[2] = {0, 0};
  Cursor cur;
  cur.start(q_tiles);
  if (cur.xi < x_tiles) {
    mbar_wait(full, 0);
    load_a<kNorms>(a0, sm + kCodes, row0, t4, cc0);
  }
  for (uint32_t it = 0; cur.xi < x_tiles; ++it) {
    const uint32_t s = it % kStages, sn = (it + 1) % kStages;
    Cursor next = cur;
    next.advance(nk, q_tiles);
    const bool more = next.xi < x_tiles;
    const unsigned char* codes_next = sm + sn * kStageBytes + kCodes;
    fence_operands(acc);
    if ((it & 1) == 0) {
      mma_stage(acc, a0, base + s * kStageBytes);
      if (more) {
        mbar_wait(full + 8 * sn, ((it + 1) / kStages) & 1);
        load_a<kNorms>(a1, codes_next, row0, t4, cc1);
      }
      cc[0] += cc0[0];
      cc[1] += cc0[1];
    } else {
      mma_stage(acc, a1, base + s * kStageBytes);
      if (more) {
        mbar_wait(full + 8 * sn, ((it + 1) / kStages) & 1);
        load_a<kNorms>(a0, codes_next, row0, t4, cc0);
      }
      cc[0] += cc1[0];
      cc[1] += cc1[1];
    }
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(empty + 8 * s);              // the stage is read
    // the stage's partial joins the f32 total with a rounded add: the
    // tensor cores' own accumulation truncates
#pragma unroll
    for (int e = 0; e < 64; ++e)
      total[e] = cur.kc == 0 ? acc[e] : __fadd_rn(total[e], acc[e]);
    if (cur.kc == nk - 1) {
      // epilogue. Accumulator e of a thread: row row0 + 8 ((e / 2) % 2) of
      // codes, query 8 (e / 4) + 2 t4 + e % 2. The tile is staged
      // query-major: output (query q, row m) at tile_out[q * 128 + (m ^ 8
      // ((q / 2) % 4))], so a warp's 32 writes of one accumulator fall on
      // 32 banks and each query's 128 floats stay in groups of four.
      const long long q0 = (long long)cur.qi * kBQ, x0 = cur.xi * kBM;
      float sc[2], ccf[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int c = cc[h];
        if (kNorms) {
          c += __shfl_xor_sync(0xffffffffu, c, 1);
          c += __shfl_xor_sync(0xffffffffu, c, 2);
        }
        ccf[h] = (float)c;                   // exact: below 2^24
        cc[h] = 0;
        const long long m = x0 + row0 + 8 * h;
        sc[h] = m < n ? scale[m] : 0.f;
      }
      // the previous tile's output is written out
      asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 8 * j + 2 * t4 + e;
          const float qq = kNorms ? qn[q0 + q] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v =
                epilogue<METRIC>(total[4 * j + 2 * h + e], sc[h], ccf[h], qq);
            tile_out[q * kBM + ((row0 + 8 * h) ^ (8 * ((q >> 1) & 3)))] = v;
          }
        }
      }
      asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
      const bool quads = (n & 3) == 0;       // 16-byte aligned rows of D
      const int w8 = wg * 4 + warp;          // queries 16 w8 .. 16 w8 + 15
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const int q = 16 * w8 + r;
        if (q0 + q >= b) break;
        const float4 v = *reinterpret_cast<const float4*>(
            &tile_out[q * kBM + 4 * lane]);
        const long long col = x0 + ((4 * lane) ^ (8 * ((q >> 1) & 3)));
        float* o = out + (q0 + q) * n + col;
        if (quads && col + 3 < n) {
          __stcs(reinterpret_cast<float4*>(o), v);
        } else {
          if (col < n) __stcs(o, v.x);
          if (col + 1 < n) __stcs(o + 1, v.y);
          if (col + 2 < n) __stcs(o + 2, v.z);
          if (col + 3 < n) __stcs(o + 3, v.w);
        }
      }
    }
    cur.advance(nk, q_tiles);
  }
}

// bytes of the split's output: per query tile and stage, hi, mid and lo
// (16 KB each), then ||q||^2 for the padded batch
long long scratch_bytes(int b, int d, int* q_tiles, int* nk) {
  *q_tiles = (int)(((long long)b + kBQ - 1) / kBQ);
  *nk = (d + kBK - 1) / kBK;
  return (long long)*q_tiles * *nk * kPieces * kQTileBytes +
         (long long)*q_tiles * kBQ * 4;
}

template <int METRIC, int LOAD>
cudaError_t launch_wgmma(const float* Q, const int8_t* C, const float* scale,
                         float* out, void* scratch, int b, int n, int d,
                         cudaStream_t stream) {
  int q_tiles = 0, nk = 0;
  const long long qs_bytes = scratch_bytes(b, d, &q_tiles, &nk) -
                             (long long)q_tiles * kBQ * 4;
  unsigned char* qs = static_cast<unsigned char*>(scratch);
  float* qn = reinterpret_cast<float*>(static_cast<unsigned char*>(scratch) +
                                       qs_bytes);
  const long long rows = (long long)q_tiles * kBQ;
  split_q_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      Q, qs, qn, b, d, nk, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long x_tiles = ((long long)n + kBM - 1) / kBM;
  const long long tiles = (long long)q_tiles * x_tiles;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  auto kernel = quantized_wgmma_kernel<METRIC, LOAD>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  // persistent: one block per SM (the block holds 177 KB of shared memory)
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(C, scale, qs, qn, out, b, n,
                                                 d, q_tiles, x_tiles);
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t launch_metric(const float* Q, const int8_t* C, const float* scale,
                          float* out, void* scratch, int b, int n, int d,
                          int load, cudaStream_t stream) {
  switch (load) {
    case 16:
      return launch_wgmma<METRIC, 16>(Q, C, scale, out, scratch, b, n, d,
                                      stream);
    case 4:
      return launch_wgmma<METRIC, 4>(Q, C, scale, out, scratch, b, n, d,
                                     stream);
    default:
      return launch_wgmma<METRIC, 1>(Q, C, scale, out, scratch, b, n, d,
                                     stream);
  }
}

}  // namespace

// Bytes of the scratch tensor the wgmma path needs for Q[b, d] (the split
// of Q and its norms), which the caller allocates, 16-byte aligned.
extern "C" long long navix_quantized_distance_wgmma_scratch(int b, int d) {
  int q_tiles = 0, nk = 0;
  return scratch_bytes(b, d, &q_tiles, &nk);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// metric: 0 = l2, 1 = cos, 2 = dot. load: 16 for 16-byte copies (d % 16 ==
// 0, codes 16-byte aligned), 4 for 4-byte copies (d % 4 == 0, codes 4-byte
// aligned), 1 for byte loads of the codes (any d). scratch: the bytes
// navix_quantized_distance_wgmma_scratch(b, d) gives, 16-byte aligned.
extern "C" int navix_quantized_distance_wgmma(const float* Q,
                                              const signed char* codes,
                                              const float* scale, float* out,
                                              void* scratch, int b, int n,
                                              int d, int metric, int load,
                                              void* stream) {
  if (b <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (load == 16 && ((d & 15) || ((uintptr_t)codes & 15)))
    return (int)cudaErrorInvalidValue;
  if (load == 4 && ((d & 3) || ((uintptr_t)codes & 3)))
    return (int)cudaErrorInvalidValue;
  if (load != 16 && load != 4 && load != 1) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)scratch & 15) return (int)cudaErrorInvalidValue;
  const int8_t* C = reinterpret_cast<const int8_t*>(codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2:
      return (int)launch_metric<kL2>(Q, C, scale, out, scratch, b, n, d, load,
                                     s);
    case kCos:
      return (int)launch_metric<kCos>(Q, C, scale, out, scratch, b, n, d,
                                      load, s);
    case kDot:
      return (int)launch_metric<kDot>(Q, C, scale, out, scratch, b, n, d,
                                      load, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
