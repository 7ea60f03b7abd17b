// K2: inclusive segmented scan (sum float32 / sum int32 / max int32 / first)
// over contiguous runs given by nondecreasing int32 run ids, or over one run
// when no ids are given.
//
// Replaces the Pallas TPU kernel temporal_latticenet_tpu/ops/pallas_scan.py
// :_seg_scan_kernel_lanes (wrapper sorted_segment_scan).  On the main path it
// runs the single-run int32 cumsums of the union builds (Q = 2,097,152 rows
// at the flagship, no ids), the birth propagation ("first"), the coarsen
// splats' float32 segmented sums at C = 64 and 128 and, in the training
// step, the finefy slices' backward at C = 128.
//
// Bound on the H100: bytes.  The function reads each row and its run id
// once and writes each row once: (8 C + 4) bytes per row, 8 C without ids,
// e.g. 16.8 MB for the 2.1M-row one-run cumsum (5.0 us at 3.35 TB/s); one
// add or compare per element leaves the ALUs idle.  Design
// (seg_scan_lookback.cuh): one pass with decoupled look-back, one kernel per
// call after a memset of the tile state; at C = 1 warp-contiguous 16-byte
// loads staged through shared memory and, for the integer modes and
// "first", status and value in one 64-bit word per tile (no fences); at
// C % 4 == 0 16-byte loads along the channels; float32 sums bit-equal from
// call to call.  The TPU kernel's lane packing of small C is a TPU layout
// device and has no counterpart here.
#include "seg_scan_lookback.cuh"

template <int M, int N, bool kPacked>
__global__ void __launch_bounds__(tln::lb::kThreads, 2)
seg_scan_lookback(const int* ids, const typename tln::Op<M>::T* x,
                  typename tln::Op<M>::T* out, tln::lb::u64* state,
                  typename tln::Op<M>::T* desc, int64_t q, int c, int w,
                  int ntiles) {
  tln::lb::scan_tile<M, N, false, kPacked>(ids, x, out, state, desc, q, c, w,
                                           ntiles);
}

template <int M>
static int launch(const void* ids, const void* x, void* out, void* state,
                  void* desc, int64_t q, int c, int vw, int w, int ntiles,
                  int ncb, void* stream) {
  using T = typename tln::Op<M>::T;
  tln::lb::u64* st = static_cast<tln::lb::u64*>(state);
  const int* i = static_cast<const int*>(ids);
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  T* d = static_cast<T*>(desc);
  if constexpr (M != tln::kSumF32) {
    if (c == 1)
      return tln::lb::launch(seg_scan_lookback<M, 1, true>, state,
                             tln::lb::state_bytes(true, ntiles, ncb), ntiles,
                             ncb, tln::lb::stage_bytes<1>(), stream, i, xt, o,
                             st, d, q, c, w, ntiles);
  }
  const size_t bytes = tln::lb::state_bytes(false, ntiles, ncb);
  if (vw == 4)
    return tln::lb::launch(seg_scan_lookback<M, 4, false>, state, bytes,
                           ntiles, ncb, w == 1 ? tln::lb::stage_bytes<4>() : 0,
                           stream, i, xt, o, st, d, q, c, w, ntiles);
  return tln::lb::launch(seg_scan_lookback<M, 1, false>, state, bytes, ntiles,
                         ncb, w == 1 ? tln::lb::stage_bytes<1>() : 0, stream,
                         i, xt, o, st, d, q, c, w, ntiles);
}

// state: the tile state (cleared here; tln::lb::state_bytes); desc:
// (2, ntiles, c) elements of x's type.  vw = 4 needs C % 4 == 0 and 16-byte
// aligned x.
TLN_API int tln_seg_scan(const void* ids, const void* x, void* out,
                         void* state, void* desc, int64_t q, int c, int mode,
                         int vw, int w, int ntiles, int ncb, void* stream) {
  switch (mode) {
    case tln::kSumF32:
      return launch<tln::kSumF32>(ids, x, out, state, desc, q, c, vw, w, ntiles,
                                  ncb, stream);
    case tln::kSumI32:
      return launch<tln::kSumI32>(ids, x, out, state, desc, q, c, vw, w, ntiles,
                                  ncb, stream);
    case tln::kMaxI32:
      return launch<tln::kMaxI32>(ids, x, out, state, desc, q, c, vw, w, ntiles,
                                  ncb, stream);
    case tln::kFirst:
      return launch<tln::kFirst>(ids, x, out, state, desc, q, c, vw, w, ntiles,
                                 ncb, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
