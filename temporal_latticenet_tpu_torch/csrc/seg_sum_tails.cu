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
// Design: K2's single-pass float32 sum (seg_scan_lookback.cuh; one float4
// and one id per row at C = 4), writing only the rows that end a run into a
// (Q, C) scratch that is never cleared, then a gather of the tails.  A tail
// that ends its run reads the scratch; one that sits mid-run (the contract
// allows it; the main path has none) sums its run back to the head itself.
// The tails may come in any order and repeat; those outside [0, Q) give 0.
#include "seg_scan_lookback.cuh"

template <int N>
__global__ void __launch_bounds__(tln::lb::kThreads, 2)
seg_sum_tails_scan(const int* ids, const float* x, float* ends,
                   tln::lb::u64* state, float* desc, int64_t q, int c, int w,
                   int ntiles) {
  tln::lb::scan_tile<tln::kSumF32, N, true, false>(ids, x, ends, state, desc,
                                                   q, c, w, ntiles);
}

template <int N>
__global__ void __launch_bounds__(256)
seg_sum_tails_gather(const int* __restrict__ ids, const float* __restrict__ x,
                     const float* __restrict__ ends,
                     const int64_t* __restrict__ tails, int64_t q, int c,
                     int64_t b, float* __restrict__ out) {
  // one thread per N channels of one tail
  using V = tln::lb::Vec<float, N>;
  const int lanes = c / N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= b * lanes) return;
  const int64_t bi = i / lanes;
  const int ch = static_cast<int>(i - bi * lanes) * N;
  const int64_t t = tails[bi];
  V v;
#pragma unroll
  for (int k = 0; k < N; ++k) v.v[k] = 0.0f;
  if (t >= 0 && t < q) {
    const int id = __ldg(ids + t);
    if (t + 1 == q || __ldg(ids + t + 1) != id) {
      v = tln::lb::ld<float, N>(ends + t * c + ch);
    } else {
      for (int64_t r = t; r >= 0 && __ldg(ids + r) == id; --r)
        v = tln::lb::comb<tln::kSumF32, N>(
            v, tln::lb::ld<float, N>(x + r * c + ch));
    }
  }
  tln::lb::st<float, N>(out + bi * c + ch, v);
}

template <int N>
static int launch(const void* ids, const void* x, const void* tails,
                  int64_t q, int c, int64_t b, void* ends, void* state,
                  void* desc, int w, int ntiles, int ncb, void* out,
                  void* stream) {
  const int* i = static_cast<const int*>(ids);
  const float* xf = static_cast<const float*>(x);
  float* e = static_cast<float*>(ends);
  int err = tln::lb::launch(
      seg_sum_tails_scan<N>, state,
      tln::lb::state_bytes(false, ntiles, ncb), ntiles, ncb,
      w == 1 ? tln::lb::stage_bytes<N>() : 0, stream,
      i, xf, e, static_cast<tln::lb::u64*>(state), static_cast<float*>(desc),
      q, c, w, ntiles);
  if (err != 0) return err;
  const int64_t n = b * (c / N);
  if (n <= 0) return 0;
  const int64_t blocks = (n + 255) / 256;
  seg_sum_tails_gather<N><<<static_cast<unsigned>(blocks), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      i, xf, e, static_cast<const int64_t*>(tails), q, c, b,
      static_cast<float*>(out));
  return tln_last_error();
}

// ends: (Q, C) float32 scratch (only run-end rows are written); state and
// desc as for tln_seg_scan.  vw = 4 needs C % 4 == 0 and 16-byte aligned x,
// ends and out.
TLN_API int tln_seg_sum_tails(const void* ids, const void* x,
                              const void* tails, int64_t q, int c, int64_t b,
                              void* ends, void* state, void* desc, int vw,
                              int w, int ntiles, int ncb, void* out,
                              void* stream) {
  if (vw == 4)
    return launch<4>(ids, x, tails, q, c, b, ends, state, desc, w, ntiles,
                     ncb, out, stream);
  return launch<1>(ids, x, tails, q, c, b, ends, state, desc, w, ntiles, ncb,
                   out, stream);
}
