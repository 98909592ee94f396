// CSR segment sum out[v] = sum of messages[e] over the edges e whose sorted
// destination is v (Hopper, sm_90a).
//
//   messages f32[E, d], dst i32[E] ascending -> out f32[n, d]; rows whose
//   destination lies outside [0, n) (the padding sentinel 0x3FFFFFFF, sorting
//   last) are dropped and never read; nodes with no edges get zeros.
//
// Replaces the TPU kernel repro/kernels/segment_sum.py::
// csr_segment_sum_pallas, which sums one-hot (bn x be) matmuls on the MXU
// over each node block's contiguous range of edge tiles (planned on the host
// by plan_tiles). Here nothing is planned outside the kernel: segment
// boundaries are read from dst itself.
//
// Bound on an H100 SXM: pure bytes (one add per float read). Bytes = 4Ed
// read + 4nd written (+ 4E of destinations read), at 3.35 TB/s. ogb_products
// at d = 128 (n = 2,449,029, E = 61,859,140): about 33.2 GB, 9.9 ms.
//
// Design: an edge-balanced segmented reduce, no one-hot matrix, no atomics.
// The E rows are cut into spans of S rows (S from the wrapper: a fixed
// number of bytes, at most kMaxSpanRows rows); a block of one warp streams
// one span, its lanes across d (float4 lanes where d % 4 == 0 and the
// pointers are 16-byte aligned, scalar lanes otherwise; columns past 32
// lanes in further passes). Rows stream through a shared-memory ring of
// kAhead + 1 groups of kBatch rows, each with an mbarrier: each lane copies
// its piece of a group's rows with cp.async (16 or 4 bytes) and arrives on
// the group's mbarrier once they land (TMA bulk copies of whole rows were
// tried and were no faster on the card). kAhead groups are in flight while
// the warp adds the oldest, so a warp keeps kAhead * kBatch rows (16 KB at
// d = 128) in flight without holding them in registers.
//
// The span's plan costs one round trip: the destinations of rows s0 ..
// s1 + L - 1 (L = min(kLook, S)) into shared memory, and of the row before
// s0, one span before it, and L rows past s0 and past s1, all read at once.
// A segment that ends at most L rows past the span it starts in is short:
// that span sums it whole, reading on past s1, and the next span skips it. A
// longer one (a hub) is cut at span edges: each span it touches sums its
// piece into a carry slot (slot 0: the piece its first segment continues,
// slot 1: a long segment starting inside it) and the span where it ends is
// flagged; the fix-up kernel adds that segment's pieces in span order and
// writes its row. So no warp sums more than S + L rows of one segment, and
// a hub of k rows costs about k / S pieces. Empty nodes: the span holding a
// boundary between destinations u < w writes zeros to u + 1 .. w - 1 (span 0
// also from 0, the last span also up to n - 1), so every row of out is
// written once and out needs no memset.
//
// Summation order (fixed, so two calls agree bit for bit): a short segment
// in edge order from 0; a long one per span in edge order from 0, then those
// pieces in span order from 0. Edge offsets are 64-bit (E * d = 7.9e9 at
// ogb_products). Launches: the span kernel, then the fix-up when there is
// more than one span.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 16;            // rows a copy group
constexpr int kAhead = 2;             // groups in flight ahead of the sum
constexpr int kRing = (kAhead + 1) * kBatch;   // rows the ring holds
constexpr int kMaxSpanRows = 512;
constexpr int kLook = 32;             // rows a short segment may run past
                                      // its span (at most S)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFixThreads = 128;      // fix-up: spans a block, columns a pass
constexpr int kFixBatch = 64;         // fix-up: pieces in flight a thread

__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ bool bar_done(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// one lane's copy of its piece of a row (16 bytes past L1, or 4 bytes), and
// its arrival on the mbarrier once its copies have landed
__device__ __forceinline__ void copy_lane(unsigned to, const float4* from) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
               "l"(from)
               : "memory");
}
__device__ __forceinline__ void copy_lane(unsigned to, const float* from) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(from)
               : "memory");
}
__device__ __forceinline__ void copies_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// destination of row r with every id outside [0, n) made -1 or n
__device__ __forceinline__ int dest(const int* __restrict__ dst, long long r,
                                    int n) {
  const int x = __ldg(dst + r);
  return x < 0 ? -1 : (x >= n ? n : x);
}

__device__ __forceinline__ bool valid(int v, int n) { return v >= 0 && v < n; }

// zeros to out rows a + 1 .. b - 1 (the nodes between two destinations)
template <class T>
__device__ void fill_gap(T* __restrict__ out, int a, int b, int cols, int col,
                         bool on) {
  if (!on) return;
  for (long long v = (long long)a + 1; v < b; ++v)
    out[v * cols + col] = zero_of(T());
}

template <class T>
__global__ void __launch_bounds__(32)
segment_span_kernel(const T* __restrict__ msg, const int* __restrict__ dst,
                    T* __restrict__ out, T* __restrict__ carry,
                    int* __restrict__ flags, long long E, int n, int cols,
                    int S, int n_spans) {
  __shared__ __align__(128) T ring[kRing][32];
  __shared__ __align__(8) unsigned long long bars[kAhead + 1];
  __shared__ int ids[kMaxSpanRows + kLook];   // destinations of rows s0 ..
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  if (lane == 0)
    for (int b = 0; b <= kAhead; ++b) bar_init(smem(&bars[b]), 32);
  const long long s0 = (long long)t * S;
  const long long s1 = s0 + S < E ? s0 + S : E;
  const int L = S < kLook ? S : kLook;
  // the plan (see the note above): a short segment ends at most L rows past
  // the span it starts in
  const long long wend = s1 + L < E ? s1 + L : E;
#pragma unroll
  for (int i = 0; i < (kMaxSpanRows + kLook) / 32; ++i) {
    const long long r = s0 + 32 * i + lane;
    if (r < wend) ids[r - s0] = dest(dst, r, n);
  }
  const int v0 = s0 < E ? dest(dst, s0, n) : n;
  const int before = s0 > 0 ? dest(dst, s0 - 1, n) : -1;
  const bool head_old = s0 > S && dest(dst, s0 - S - 1, n) == v0;
  const bool head_far = s0 + L < E && dest(dst, s0 + L, n) == v0;
  const int vt = s1 > 0 ? dest(dst, s1 - 1, n) : -1;
  const bool after = s1 < E && dest(dst, s1, n) == vt;
  const bool tail_far = s1 + L < E && dest(dst, s1 + L, n) == vt;
  // head: the segment of row s0 continues from the span before; skipped
  // when short (the span before sums it), else summed into slot 0; flag: it
  // is long and ends here
  const bool head_cont = s0 < s1 && s0 > 0 && valid(v0, n) && before == v0;
  const bool head_through = head_cont && vt == v0 && after;
  const bool head_long = head_cont && (head_old || head_far);
  const int skip = head_cont && !head_long ? v0 : -2;
  // tail: a segment starting here and crossing s1; read on to its end when
  // short, else summed up to s1 into slot 1
  const bool tail_cross = valid(vt, n) && after && !head_through;
  const bool tail_long = tail_cross && tail_far;
  if (lane == 0) {
    flags[t] = head_long && !head_through;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // end: the stream's last row + 1 (past s1 for a short tail)
  long long end = s1;
  if (tail_cross && !tail_long) {
    const long long r = s1 + lane;
    const unsigned m = __ballot_sync(kFull, r < wend && ids[r - s0] != vt);
    end = m ? s1 + __ffs(m) - 1 : wend;
  }
  const int rows = (int)(end - s0);
  // the rows the sum reads (valid, not skipped): one range need_lo ..
  // need_hi - 1, since dropped rows sort first or last
  int need_lo = rows, need_hi = 0;
  for (int base = 0; base < rows; base += 32) {
    const int i = base + lane;
    const unsigned m = __ballot_sync(
        kFull, i < rows && valid(ids[i], n) && ids[i] != skip);
    if (m && need_lo == rows) need_lo = base + __ffs(m) - 1;
    if (m) need_hi = base + 32 - __clz(m);
  }
  const int groups = (rows + kBatch - 1) / kBatch;

  T* slot0 = carry + (2LL * t) * cols;
  T* slot1 = carry + (2LL * t + 1) * cols;
  // copy groups issued and waited for, over all passes; group number q
  // fills ring part q % (kAhead + 1) and completes its mbarrier's phase
  // q / (kAhead + 1)
  unsigned issued = 0, waited = 0;
  auto wait = [&]() {
    const unsigned bar = smem(&bars[waited % (kAhead + 1)]);
    const unsigned parity = (waited / (kAhead + 1)) & 1;
    while (!bar_done(bar, parity)) {
    }
    return (int)(waited++ % (kAhead + 1)) * kBatch;
  };
  for (int c0 = 0; c0 < cols; c0 += 32) {
    const int col = c0 + lane;
    const bool on = col < cols;
    // group g: the needed rows of g * kBatch .. g * kBatch + kBatch - 1,
    // this pass's columns
    auto issue = [&](int g) {
      __syncwarp();                          // the part's last use is read
      const int part = (int)(issued % (kAhead + 1)) * kBatch - g * kBatch;
      const unsigned bar = smem(&bars[issued++ % (kAhead + 1)]);
      const int a = g * kBatch > need_lo ? g * kBatch : need_lo;
      const int b = g * kBatch + kBatch < need_hi ? g * kBatch + kBatch
                                                  : need_hi;
      if (on)
        for (int i = a; i < b; ++i)
          copy_lane(smem(&ring[part + i][lane]), msg + (s0 + i) * cols + col);
      copies_arrive(bar);
    };
    if (s0 < s1) {
      if (before != v0) fill_gap(out, before, v0, cols, col, on);
      for (int g = 0; g < kAhead; ++g) issue(g);
      int cur = v0;
      bool first = true;
      T acc = zero_of(T());
      for (int g = 0; g < groups; ++g) {
        issue(g + kAhead);
        const int part = wait();
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = g * kBatch + u;
          if (i < rows) {
            const int v = ids[i];
            if (v != cur) {                  // a boundary inside the span
              T* to = first && head_long     ? slot0
                      : first && skip == cur ? nullptr
                      : valid(cur, n)        ? out + (long long)cur * cols
                                             : nullptr;
              if (to != nullptr && on) to[col] = acc;
              fill_gap(out, cur, v, cols, col, on);
              first = false;
              cur = v;
              acc = zero_of(T());
            }
            if (on && valid(v, n) && v != skip)
              add_to(acc, ring[part + u][lane]);
          }
        }
      }
      while (waited < issued) wait();        // the empty groups past the end
      T* to = first && head_long     ? slot0
              : first && skip == cur ? nullptr
              : tail_long            ? slot1
              : valid(cur, n)        ? out + (long long)cur * cols
                                     : nullptr;
      if (to != nullptr && on) to[col] = acc;
    }
    if (t == n_spans - 1)                    // the nodes after the last edge
      fill_gap(out, E > 0 ? dest(dst, E - 1, n) : -1, n, cols, col, on);
  }
}

// One block per kFixThreads spans, one thread per column; for each flagged
// span t (a long segment ends in it), out[v] = slot 1 of the span s_a it
// starts in + slot 0 of s_a + 1 .. t, added in that order, kFixBatch pieces
// in flight.
__global__ void __launch_bounds__(kFixThreads)
segment_fixup_kernel(const int* __restrict__ dst,
                     const float* __restrict__ carry,
                     const int* __restrict__ flags, float* __restrict__ out,
                     int n, int d, int S, int n_spans) {
  __shared__ int list[kFixThreads];
  __shared__ int count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  const int me = blockIdx.x * kFixThreads + threadIdx.x;
  if (me < n_spans && flags[me] != 0) list[atomicAdd(&count, 1)] = me;
  __syncthreads();
  for (int i = 0; i < count; ++i) {
    const int t = list[i];
    const int v = dest(dst, (long long)t * S, n);
    // s_a = the last span whose row before does not hold v (span 0 has
    // none); spans s_a + 1 .. t all do. Gallop down from t, then bisect.
    int good = t, bad = 0;
    for (int step = 1;; step *= 2) {
      const int u = good - step;
      if (u <= 0) break;
      if (dest(dst, (long long)u * S - 1, n) != v) {
        bad = u;
        break;
      }
      good = u;
    }
    while (good - bad > 1) {
      const int mid = bad + (good - bad) / 2;
      if (dest(dst, (long long)mid * S - 1, n) == v)
        good = mid;
      else
        bad = mid;
    }
    const int sa = bad;
    for (int c = threadIdx.x; c < d; c += kFixThreads) {
      float acc = 0.f;
      acc += carry[(2LL * sa + 1) * d + c];
      for (int u = sa + 1; u <= t; u += kFixBatch) {
        float buf[kFixBatch];
#pragma unroll
        for (int k = 0; k < kFixBatch; ++k)
          buf[k] = u + k <= t ? carry[(2LL * (u + k)) * d + c] : 0.f;
#pragma unroll
        for (int k = 0; k < kFixBatch; ++k)
          if (u + k <= t) acc += buf[k];
      }
      out[(long long)v * d + c] = acc;
    }
  }
}

template <class T>
int launch(const float* messages, const int* dst, float* out, float* carry,
           int* flags, long long E, int n, int d, int S, int n_spans,
           cudaStream_t s) {
  const int cols = sizeof(T) == 16 ? d / 4 : d;
  segment_span_kernel<T><<<n_spans, 32, 0, s>>>(
      reinterpret_cast<const T*>(messages), dst, reinterpret_cast<T*>(out),
      reinterpret_cast<T*>(carry), flags, E, n, cols, S, n_spans);
  if (n_spans > 1) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const dim3 fix((unsigned)((n_spans + kFixThreads - 1) / kFixThreads));
    segment_fixup_kernel<<<fix, kFixThreads, 0, s>>>(dst, carry, flags, out,
                                                     n, d, S, n_spans);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (the span kernel, then the fix-up when n_spans > 1)
// and returns cudaGetLastError() (0 on success). carry: f32[n_spans, 2, d]
// and flags: i32[n_spans], scratch the caller allocates uninitialised;
// n_spans = max(1, ceil(E / span_rows)), span_rows <= kMaxSpanRows.
extern "C" int navix_csr_segment_sum(const float* messages, const int* dst,
                                     float* out, float* carry, int* flags,
                                     long long E, int n, int d, int span_rows,
                                     int n_spans, void* stream) {
  if (n <= 0 || d <= 0 || E < 0 || span_rows <= 0 ||
      span_rows > kMaxSpanRows || n_spans <= 0 ||
      (long long)(n_spans - 1) * span_rows >= (E > 0 ? E : 1) ||
      (long long)n_spans * span_rows < E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 && (uintptr_t)messages % 16 == 0 &&
                    (uintptr_t)out % 16 == 0 && (uintptr_t)carry % 16 == 0;
  if (vec4)
    return launch<float4>(messages, dst, out, carry, flags, E, n, d, span_rows,
                          n_spans, s);
  return launch<float>(messages, dst, out, carry, flags, E, n, d, span_rows,
                       n_spans, s);
}
