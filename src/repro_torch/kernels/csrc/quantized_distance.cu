// All-pairs distances against int8 codes with a per-row scale (sm_90a).
//
//   Q f32[b, d], codes i8[n, d], scale f32[n] -> D f32[b, n], x ~ s * c
//   l2: ||q||^2 - 2 s (q.c) + s^2 (c.c)   cos: 1 - s (q.c)   dot: -s (q.c)
//
// Replaces the TPU kernel repro/kernels/quantized.py::
// quantized_distance_pallas (distance_matrix's schedule over int8 codes,
// q.c, c.c and q.q accumulated over d blocks, the scale applied on the last
// d step).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the tensor cores),
// the larger of bytes (4bd + nd + 4n + 4bn) and 2bnd flops:
//   (8, 1,000,000, 960)     an int8 brute-force scan: 1.0 GB, 0.30 ms (bytes)
//   (1024, 65,536, 960)     128.8 GFLOP, 1.92 ms (f32 flops)
//
// Design: distance_matrix.cu's schedule (distance_tile.cuh) with the codes
// loaded as bytes (4x fewer than f32 rows) and converted to f32 in shared
// memory; q.c, c.c and q.q are accumulated in f32 (c.c is exact: 960 * 127^2
// < 2^24) and the scale is applied in the epilogue in the TPU kernel's form,
// never by dequantizing rows first. Products are f32 FMAs; the int8 tensor
// cores would need Q quantized too, which changes the result.

#include "distance_tile.cuh"

extern "C" int navix_quantized_distance(const float* Q,
                                        const signed char* codes,
                                        const float* scale, float* out,
                                        int b, int n, int d, int metric,
                                        void* stream) {
  return navix_tile::launch<int8_t>(Q, reinterpret_cast<const int8_t*>(codes),
                                    scale, out, b, n, d, metric, stream);
}
