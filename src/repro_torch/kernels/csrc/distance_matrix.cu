// All-pairs distances D[b, n] = dist(Q[b], X[n]) (Hopper, sm_90a).
//
//   Q f32[b, d], X f32[n, d] -> D f32[b, n], f32 accumulation
//   l2: ||q||^2 + ||x||^2 - 2 q.x     cos: 1 - q.x     dot: -q.x
//
// Replaces the TPU kernel repro/kernels/distance_matrix.py::
// distance_matrix_pallas, an MXU schedule of (bq, bd) x (bn, bd) blocks with
// d innermost and an f32 accumulator in VMEM.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the tensor cores),
// the larger of bytes (4bd + 4nd + 4bn) and 2bnd flops:
//   (1, 1,000,000, 32)      the recsys retrieval step: 132 MB, 0.039 ms (bytes)
//   (512, 1,000,000, 32)    a serve_p99 batch: the 2.05 GB output, 0.65 ms
//   (1024, 65,536, 960)     GIST width: 128.8 GFLOP, 1.92 ms (f32 flops)
//
// Design (distance_tile.cuh): one block per (16 or 64) x 64 output tile,
// d staged through shared memory in chunks of 32, a 1 x 4 or 4 x 4 register
// micro-tile of full f32 FMAs per thread (no TF32), ||q||^2 and ||x||^2
// summed alongside for l2 and the metric applied in the epilogue. At b = 1
// a 16-row tile computes 16x the needed products: the retrieval shape pays
// for that in arithmetic, not bytes. wgmma, TMA and a split of d across
// warps for tiny b are later work.

#include "distance_tile.cuh"

extern "C" int navix_distance_matrix_f32(const float* Q, const float* X,
                                         float* out, int b, int n, int d,
                                         int metric, void* stream) {
  return navix_tile::launch<float>(Q, X, nullptr, out, b, n, d, metric,
                                   stream);
}
