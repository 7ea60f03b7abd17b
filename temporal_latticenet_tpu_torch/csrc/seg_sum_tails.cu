// K3: per-run float32 totals evaluated at given tail rows.
//
// Replaces the Pallas TPU kernel temporal_latticenet_tpu/ops/pallas_scan.py
// :_seg_scan_kernel_laneonly as composed by seg_sum_tails (a lane-only chunk
// scan, a summary chain over chunk ends and four gathers).  On the main path
// it produces the union's per-(vertex, frame) position sums and point counts:
// x is (Q, 4) float32 (x w, y w, z w, w) with Q = 2,097,152 rows, read at
// 196,608 tail rows (frames x level-0 capacity).
//
// Bound on the H100: bytes.  The function reads x, the run ids and the tails
// once and writes (B, C): about 46 MB at the flagship, 14 us at 3.35 TB/s.
// Design: the chunk-scan intermediate was a TPU layout device; here one
// thread per (tail, channel) walks its run backwards from the tail row while
// the run id matches and sums the rows.  Runs are short (~10 rows at the
// flagship), neighbouring threads read neighbouring channels of one row,
// and only rows inside runs that end at a requested tail are touched.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
seg_sum_tails_kernel(const int* __restrict__ ids, const float* __restrict__ x,
                     const int64_t* __restrict__ tails, int64_t q, int c,
                     int64_t b, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= b * c) return;
  const int64_t bi = i / c;
  const int ch = static_cast<int>(i - bi * c);
  const int64_t t = tails[bi];
  float s = 0.0f;
  if (t >= 0 && t < q) {
    const int id = ids[t];
    for (int64_t r = t; r >= 0 && ids[r] == id; --r) s += x[r * c + ch];
  }
  out[i] = s;
}

}  // namespace

TLN_API int tln_seg_sum_tails(const void* ids, const void* x,
                              const void* tails, int64_t q, int c, int64_t b,
                              void* out, void* stream) {
  const int64_t n = b * c;
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  seg_sum_tails_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(x),
      static_cast<const int64_t*>(tails), q, c, b, static_cast<float*>(out));
  return tln_last_error();
}
