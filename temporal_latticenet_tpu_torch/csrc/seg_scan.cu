// K2: inclusive segmented scan (sum float32 / sum int32 / max int32 / first)
// over contiguous runs given by nondecreasing int32 run ids.
//
// Replaces the Pallas TPU kernel temporal_latticenet_tpu/ops/pallas_scan.py
// :_seg_scan_kernel_lanes (wrapper sorted_segment_scan).  On the main path it
// runs the single-run int32 cumsums of the union builds (Q = 2,097,152 rows
// at the flagship), the birth propagation ("first"), and the coarsen splat's
// float32 segmented sums at C = 64 and 128.
//
// Bound on the H100: bytes.  The function reads each row and its run id
// once and writes each row once: (8 C + 4) bytes per row, e.g. 25 MB for the
// 2.1M-row int32 cumsum (7.5 us at 3.35 TB/s); one add or compare per
// element leaves the ALUs idle.  Design (seg_scan.cuh): a block-local scan
// in registers and shared memory, a recursive scan of the per-block carries
// (1/R of the rows), and a fix-up pass that rewrites only the rows that
// continue a run across a block boundary.  The TPU kernel's lane packing of
// small C is a TPU layout device and has no counterpart here.
#include "seg_scan.cuh"

TLN_API int tln_seg_scan_local(const void* ids, const void* x, void* out,
                               void* blk_val, void* blk_id, int64_t q, int c,
                               int cb, int mode, void* stream) {
  switch (mode) {
    case tln::kSumF32:
      return tln::launch_local<tln::kSumF32>(ids, x, out, blk_val, blk_id, q,
                                             c, cb, stream);
    case tln::kSumI32:
      return tln::launch_local<tln::kSumI32>(ids, x, out, blk_val, blk_id, q,
                                             c, cb, stream);
    case tln::kMaxI32:
      return tln::launch_local<tln::kMaxI32>(ids, x, out, blk_val, blk_id, q,
                                             c, cb, stream);
    case tln::kFirst:
      return tln::launch_local<tln::kFirst>(ids, x, out, blk_val, blk_id, q,
                                            c, cb, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

TLN_API int tln_seg_scan_fixup(const void* ids, void* out, const void* blk_scan,
                               const void* blk_id, int64_t q, int c,
                               int64_t rows_per_block, int mode, void* stream) {
  switch (mode) {
    case tln::kSumF32:
      return tln::launch_fixup<tln::kSumF32>(ids, out, blk_scan, blk_id, q, c,
                                             rows_per_block, stream);
    case tln::kSumI32:
      return tln::launch_fixup<tln::kSumI32>(ids, out, blk_scan, blk_id, q, c,
                                             rows_per_block, stream);
    case tln::kMaxI32:
      return tln::launch_fixup<tln::kMaxI32>(ids, out, blk_scan, blk_id, q, c,
                                             rows_per_block, stream);
    case tln::kFirst:
      return tln::launch_fixup<tln::kFirst>(ids, out, blk_scan, blk_id, q, c,
                                            rows_per_block, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
