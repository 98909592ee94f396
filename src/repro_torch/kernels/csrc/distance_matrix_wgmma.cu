// All-pairs distances for batches b > 16 on the tensor cores (Hopper,
// sm_90a): the wgmma path of the all-pairs distance kernel, at full f32
// accuracy through a 3xTF32 split.
//
//   Q f32[b, d], X f32[n, d] -> D f32[b, n]
//   l2: ||q||^2 + ||x||^2 - 2 q.x     cos: 1 - q.x     dot: -q.x
//
// Replaces, for b > 16, the TPU kernel repro/kernels/distance_matrix.py::
// distance_matrix_pallas (an MXU schedule of (bq, bd) x (bn, bd) blocks with
// d innermost and an f32 accumulator in VMEM); distance_matrix_stream.cu
// takes b <= 16.
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s dense TF32, so 165 TFLOP/s
// of f32-accurate products at 3 TF32 products each): the larger of bytes
// (4bd + 4nd + 4bn) and 3 x 2bnd TF32 operations.
//   (512, 1,000,000, 32)    a serve_p99 batch: the 2.05 GB output, 0.65 ms
//   (1024, 65,536, 960)     GIST width: 386 TF32 GFLOP, 0.78 ms
//
// Precision. TF32 keeps 11 significant bits, so each value v is split into
// hi = rna(v) and lo = rna(v - hi), rna being cvt.rna.tf32.f32's rounding
// (v - hi is exact in f32), and each product q.x is accumulated as lo_q hi_x
// + hi_q lo_x + hi_q hi_x; the lo_q lo_x term is below f32's rounding. The
// split rounds to nearest: a truncating split (the tensor core reads only a
// word's upper 19 bits) would leave the result at TF32 accuracy with no
// fault reported. The tensor cores' f32 accumulation truncates as it adds,
// up to a unit in the last place of the running sum per instruction: over
// all of d in one accumulator that is d / 8 x 3 truncations, and at d = 960
// the sum left the 1e-4 tolerance. So each stage of 32 columns sums into a
// fresh accumulator, small products first (their sum is ~2^-11 of the
// stage's, so only the four hi.hi instructions truncate at the partial
// sum's scale), and joins an f32 register total with a rounded add.
// ||q||^2 and ||x||^2 are plain f32 FMAs on the unsplit values.
//
// Design: persistent blocks of three warpgroups, one block per SM (196 KB
// of shared memory), each walking output tiles of 128 x 128, query tiles
// fastest, so the blocks that share a tile of X run together and read it
// from L2. d is walked in stages of 32 columns, one 128-byte row of the
// 128-byte swizzle.
// - Warpgroup 0, the producer, copies each stage's f32 tiles of Q and X
//   with cp.async (16-byte copies where d % 4 == 0 and the rows are 16-byte
//   aligned, 4-byte copies otherwise) into one of two f32 slots, one stage
//   ahead, then splits them into hi and lo, swizzled, in one of two 64 KB
//   buffers, sums the norms from the same f32 values, and signals the
//   buffer full on an mbarrier.
// - Warpgroups 1 and 2, the consumers, each own a 64 x 128 half of the tile
//   with 64 f32 accumulators a thread for the stage and 64 for the total:
//   they wait for a full buffer, run the stage's 12 wgmma.m64n128k8 (both
//   operands from shared memory, K-major as Q and X lie in memory), add
//   the partial to the total and release the buffer. So the split of one
//   stage runs beside the tensor cores' work on the previous one.
// - At a tile's last stage the consumers apply the metric, stage each
//   warp's 16 rows x 128 columns in the buffer they have just read, and
//   write each row as one coalesced 512-byte store of the warp (16 bytes a
//   lane); the stores drain while the next tile's stages run.
// Rows past b and n and columns past d are copied as zeros and never
// stored. Each output's sum runs over d in one order whatever its row's
// place in the tile, so rows computed alone equal the same rows inside a
// larger batch. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // query rows per tile (two warpgroups)
constexpr int kBN = 128;          // rows of X per tile (the wgmma's N)
constexpr int kBK = 32;           // columns per stage: 128 bytes of f32
constexpr int kProducers = 128;   // warpgroup 0: copies and splits
constexpr int kConsumers = 256;   // warpgroups 1-2: wgmma and epilogue
constexpr int kThreads = kProducers + kConsumers;
constexpr int kTileBytes = 128 * kBK * 4;   // one 128-row operand: 16 KB
// a buffer holds, in order, Q's hi and lo, then X's hi and lo
constexpr int kAHi = 0, kALo = kTileBytes, kBHi = 2 * kTileBytes,
              kBLo = 3 * kTileBytes;
constexpr int kBufBytes = 4 * kTileBytes;
// the f32 stages in flight: Q's tile then X's, in the same swizzled layout
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kAlign = 1024;      // the 128-byte swizzle repeats every 1 KB
// two split buffers and two f32 stages
constexpr int kSmemBytes = 2 * kBufBytes + 2 * kStageBytes + kAlign;

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

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled operand
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero) of a finite
// v, in two integer operations: half a TF32 unit added to the magnitude's
// bits carries into the kept ones exactly when the 13 dropped bits are at
// least half, then the dropped bits are cleared. It runs at the integer
// rate; the conversion instruction is slower, and the split does 8 per
// 16-byte chunk.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32 words, stored at hi and lo in shared memory
__device__ __forceinline__ void split_store(unsigned char* hi,
                                            unsigned char* lo, float4 v) {
  const uint4 h = make_uint4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                             tf32_rna(v.w));
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) =
      make_uint4(tf32_rna(__fsub_rn(v.x, __uint_as_float(h.x))),
                 tf32_rna(__fsub_rn(v.y, __uint_as_float(h.y))),
                 tf32_rna(__fsub_rn(v.z, __uint_as_float(h.z))),
                 tf32_rna(__fsub_rn(v.w, __uint_as_float(h.w))));
}

__device__ __forceinline__ float sum_squares(float4 v, float s) {
  s = fmaf(v.x, v.x, s);
  s = fmaf(v.y, v.y, s);
  s = fmaf(v.z, v.z, s);
  return fmaf(v.w, v.w, s);
}

// 16 bytes, or zeros where !valid (src-size 0 reads nothing)
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// copies columns k .. k+3 of row `row` of P[rows, d] to shared memory at
// dst; zeros past rows and d
template <bool VEC>
__device__ __forceinline__ void copy4(uint32_t dst, const float* __restrict__ P,
                                      long long row, long long rows, int d,
                                      int k) {
  const bool in = row < rows;
  const float* p = P + (in ? row * d : 0);
  if (VEC) {
    cp_async16(dst, in && k < d ? p + k : P, in && k < d);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cp_async4(dst + 4 * e, in && k + e < d ? p + k + e : P, in && k + e < d);
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
  long long xi;      // tile of X
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

// d[64x128] = A[64x8] B[128x8]^T (+ d unless scale_d is 0), both TF32
// from shared memory, K-major
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// One stage's products q.x over its 32 columns into a fresh accumulator:
// the small products first (their sum is ~2^-11 of the stage's), then the
// exact hi.hi products, so only four instructions add to a value as large
// as the stage's partial sum.
__device__ __forceinline__ void mma_stage(float (&acc)[64], uint32_t buf,
                                          int wg) {
  const uint32_t a = buf + wg * 64 * 128;   // this warpgroup's 64 rows of Q
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kBK / 8; ++s) {       // k8 steps: 32 bytes apart
    wgmma_m64n128k8(acc, make_desc(a + kALo + 32 * s),
                    make_desc(buf + kBHi + 32 * s), s > 0);
    wgmma_m64n128k8(acc, make_desc(a + kAHi + 32 * s),
                    make_desc(buf + kBLo + 32 * s), 1);
  }
#pragma unroll
  for (int s = 0; s < kBK / 8; ++s)
    wgmma_m64n128k8(acc, make_desc(a + kAHi + 32 * s),
                    make_desc(buf + kBHi + 32 * s), 1);
  wgmma_commit();
}

template <int METRIC, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
distance_wgmma_kernel(const float* __restrict__ Q,
                      const float* __restrict__ X, float* __restrict__ out,
                      int b, int n, int d, int q_tiles, long long x_tiles) {
  extern __shared__ __align__(kAlign) unsigned char smem_raw[];
  // per split buffer: the norms of the tile whose last stage it holds
  __shared__ float qn_s[2][kBM], xn_s[2][kBN];
  __shared__ __align__(8) uint64_t bars[4];        // full[2], empty[2]
  constexpr bool kNorms = METRIC == kL2;

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t ring = base + 2 * kBufBytes;      // two f32 stages
  const uint32_t full = smem_u32(&bars[0]), empty = smem_u32(&bars[2]);
  const int nk = (d + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(full, kProducers);
    mbar_init(full + 8, kProducers);
    mbar_init(empty, kConsumers);
    mbar_init(empty + 8, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kProducers) {
    // ---- producer: copies each stage's f32 chunks into a ring slot, then
    // splits them into hi and lo in a free buffer. Each thread splits only
    // the chunks it copied (16-byte chunk c of rows rr + 16 j of both
    // tiles), so its own cp.async wait is all the ordering it needs.
    const int c = tid & 7, rr = tid >> 3;
    float qp[8], xp[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) qp[j] = xp[j] = 0.f;
    auto issue = [&](const Cursor& cur, uint32_t dst) {
      const long long q0 = (long long)cur.qi * kBM, x0 = cur.xi * kBN;
      const int k = cur.kc * kBK + 4 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t off = swizzle(rr + 16 * j, c);
        copy4<VEC>(dst + off, Q, q0 + rr + 16 * j, b, d, k);
        copy4<VEC>(dst + kTileBytes + off, X, x0 + rr + 16 * j, n, d, k);
      }
    };
    Cursor ahead, cur;
    ahead.start(q_tiles);
    cur.start(q_tiles);
    issue(ahead, ring);
    cp_async_commit();
    ahead.advance(nk, q_tiles);
    for (uint32_t it = 0; cur.xi < x_tiles; ++it) {
      const uint32_t s = it & 1;
      // the other slot last held item it - 1, split by this thread
      if (ahead.xi < x_tiles) {
        issue(ahead, ring + (s ^ 1) * kStageBytes);
        ahead.advance(nk, q_tiles);
      }
      cp_async_commit();
      cp_async_wait<1>();                    // item it has landed
      mbar_wait(empty + 8 * s, ((it >> 1) & 1) ^ 1);
      const unsigned char* src = sm + 2 * kBufBytes + s * kStageBytes;
      unsigned char* buf = sm + s * kBufBytes;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t off = swizzle(rr + 16 * j, c);
        const float4 qv = *reinterpret_cast<const float4*>(src + off);
        const float4 xv =
            *reinterpret_cast<const float4*>(src + kTileBytes + off);
        split_store(buf + kAHi + off, buf + kALo + off, qv);
        split_store(buf + kBHi + off, buf + kBLo + off, xv);
        if (kNorms) {
          qp[j] = sum_squares(qv, qp[j]);
          xp[j] = sum_squares(xv, xp[j]);
        }
      }
      if (kNorms && cur.kc == nk - 1) {
        // the 8 threads of a row hold its 8 chunks' partial sums
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) {
            qp[j] += __shfl_xor_sync(0xffffffffu, qp[j], o);
            xp[j] += __shfl_xor_sync(0xffffffffu, xp[j], o);
          }
          if (c == 0) {
            qn_s[s][rr + 16 * j] = qp[j];
            xn_s[s][rr + 16 * j] = xp[j];
          }
          qp[j] = xp[j] = 0.f;
        }
      }
      // make the generic-proxy stores visible to the tensor cores' reads,
      // then hand the buffer over
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + 8 * s);
      cur.advance(nk, q_tiles);
    }
    return;
  }

  // ---- consumers: warpgroup wg holds query rows 64 wg .. 64 wg + 63 of
  // the tile; 64 accumulators for the stage and 64 for the f32 total
  const int ct = tid - kProducers;
  const int wg = ct >> 7;
  const int lane = ct & 31, warp = (ct >> 5) & 3;
  float total[64], acc[64];
  Cursor cur;
  cur.start(q_tiles);
  for (uint32_t it = 0; cur.xi < x_tiles; ++it) {
    const uint32_t s = it & 1;
    mbar_wait(full + 8 * s, (it >> 1) & 1);
    mma_stage(acc, base + s * kBufBytes, wg);
    wgmma_wait<0>();
    fence_operands(acc);
    // the stage's partial joins the f32 total with a rounded add: the
    // tensor cores' own accumulation truncates, and over d / 8 x 3
    // instructions into one accumulator that loses f32 accuracy
#pragma unroll
    for (int e = 0; e < 64; ++e)
      total[e] = cur.kc == 0 ? acc[e] : __fadd_rn(total[e], acc[e]);
    if (cur.kc == nk - 1) {
      // epilogue: each warp stages its 16 rows x 128 columns (8 KB) in the
      // buffer both warpgroups have just finished reading, then writes
      // each row as one 512-byte store of the warp. 16-byte chunk g of
      // staged row r sits at chunk g ^ 2 (r % 8): the 8-byte writes of
      // eight rows then take the minimum two wavefronts.
      asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
      unsigned char* stage = sm + s * kBufBytes + (wg * 4 + warp) * 8192;
      const int rw = wg * 64 + warp * 16;       // the warp's first row
      // accumulator e of a thread: row lane / 4 + 8 ((e / 2) % 2) of the
      // warp's 16, column 8 (e / 4) + 2 (lane % 4) + e % 2
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (lane >> 2) + 8 * h;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int lc = 8 * j + 2 * (lane & 3);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dot = total[4 * j + 2 * h + e];
            if (METRIC == kL2)
              v[e] = (qn_s[s][rw + r] + xn_s[s][lc + e]) - 2.f * dot;
            else if (METRIC == kCos) v[e] = 1.f - dot;
            else v[e] = -dot;
          }
          const int g = lc >> 2;
          *reinterpret_cast<float2*>(stage + r * 512 +
                                     ((g ^ (2 * (r & 7))) << 4) +
                                     (lc & 3) * 4) = make_float2(v[0], v[1]);
        }
      }
      __syncwarp();
      const long long q0 = (long long)cur.qi * kBM + rw;
      const long long x0 = cur.xi * kBN;
      const bool quads = (n & 3) == 0;          // 16-byte aligned rows
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const long long row = q0 + r;
        if (row >= b) break;
        const float4 v =
            *reinterpret_cast<const float4*>(stage + r * 512 + lane * 16);
        const long long col = x0 + 4 * (lane ^ (2 * (r & 7)));
        float* o = out + row * n + col;
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
    // the buffer (and, at a tile's last stage, its norms) is read
    mbar_arrive(empty + 8 * s);
    cur.advance(nk, q_tiles);
  }
}

template <int METRIC, bool VEC>
cudaError_t launch_wgmma(const float* Q, const float* X, float* out, int b,
                         int n, int d, cudaStream_t stream) {
  const long long q_tiles = ((long long)b + kBM - 1) / kBM;
  const long long x_tiles = ((long long)n + kBN - 1) / kBN;
  const long long tiles = q_tiles * x_tiles;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  auto kernel = distance_wgmma_kernel<METRIC, VEC>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  // persistent: one block per SM (the block holds 196 KB of shared memory)
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(Q, X, out, b, n, d,
                                                 (int)q_tiles, x_tiles);
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t launch_metric(const float* Q, const float* X, float* out, int b,
                          int n, int d, int vec, cudaStream_t stream) {
  if (vec) return launch_wgmma<METRIC, true>(Q, X, out, b, n, d, stream);
  return launch_wgmma<METRIC, false>(Q, X, out, b, n, d, stream);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// metric: 0 = l2, 1 = cos, 2 = dot. vec: 1 for 16-byte loads, which needs
// d % 4 == 0 and 16-byte aligned Q and X; 0 for 4-byte loads.
extern "C" int navix_distance_matrix_wgmma(const float* Q, const float* X,
                                           float* out, int b, int n, int d,
                                           int metric, int vec,
                                           void* stream) {
  if (b <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
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
