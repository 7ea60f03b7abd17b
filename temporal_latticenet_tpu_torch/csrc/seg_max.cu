// K4: inclusive segmented running max of uint32 bit patterns (held in int32
// tensors) over contiguous runs given by nondecreasing int32 run ids.
//
// Replaces the Pallas TPU kernel temporal_latticenet_tpu/ops/pallas_scan.py
// :_seg_max_kernel (wrappers sorted_segment_max_i32 / sorted_segment_max_u32).
// On the main path it reduces the batched pointnet's packed (bf16 value |
// u16 barycentric weight) rows: Q = 2,097,152 rows x C = 64 at the flagship;
// the caller reads each (vertex, frame) bucket's maximum at its tail row.
// The values compare as unsigned here, so the TPU kernel's sign-flip to
// int32 is not needed; its max_window option (a VMEM workaround) is not
// reproduced: every row gets the full-run maximum, so the tails are equal.
//
// Bound on the H100: bytes.  Reads (4 C + 4) and writes 4 C bytes per row:
// 1.08 GB at the flagship shape, about 0.32 ms at 3.35 TB/s.  Design
// (seg_scan.cuh): with C = 64 a block covers 16 rows x 64 channels, each
// thread scans 4 rows of one channel in registers (a warp's loads of one
// row are 128 contiguous bytes), shared memory joins the 4 segments, and the
// per-block carries are scanned recursively and folded in by a fix-up pass.
#include "seg_scan.cuh"

TLN_API int tln_seg_max_local(const void* ids, const void* x, void* out,
                              void* blk_val, void* blk_id, int64_t q, int c,
                              int cb, int mode, void* stream) {
  if (mode != tln::kMaxU32) return static_cast<int>(cudaErrorInvalidValue);
  return tln::launch_local<tln::kMaxU32>(ids, x, out, blk_val, blk_id, q, c,
                                         cb, stream);
}

TLN_API int tln_seg_max_fixup(const void* ids, void* out, const void* blk_scan,
                              const void* blk_id, int64_t q, int c,
                              int64_t rows_per_block, int mode, void* stream) {
  if (mode != tln::kMaxU32) return static_cast<int>(cudaErrorInvalidValue);
  return tln::launch_fixup<tln::kMaxU32>(ids, out, blk_scan, blk_id, q, c,
                                         rows_per_block, stream);
}
