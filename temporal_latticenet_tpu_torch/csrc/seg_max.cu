// K4: inclusive segmented running max of uint32 bit patterns (held in int32
// tensors) over contiguous runs given by nondecreasing int32 run ids.
//
// Replaces the Pallas TPU kernel temporal_latticenet_tpu/ops/pallas_scan.py
// :_seg_max_kernel (wrappers sorted_segment_max_i32 / sorted_segment_max_u32).
// On the main path it reduces the batched pointnet's packed (bf16 value |
// u16 barycentric weight) rows: Q = 2,097,152 rows x C = 64 in the forward,
// and in the training step's two-level route the summary scan over Q / 16 =
// 131,072 rows x 64.  The values compare as unsigned here, so the TPU
// kernel's sign-flip to int32 is not needed; its max_window option (a VMEM
// workaround) is not reproduced: every row gets the full-run maximum, so the
// tails are equal.
//
// Bound on the H100: bytes.  Reads (4 C + 4) and writes 4 C bytes per row:
// 1.08 GB at the flagship shape, 0.323 ms at 3.35 TB/s; one compare per
// element leaves the ALUs idle.  Design: the single-pass scan with decoupled
// look-back of seg_scan_lookback.cuh, a memset of the tile state and one
// kernel per call.  At C % 4 == 0 a thread holds one 16-byte vector of
// channels for each of its strip's 16 rows, all loads in flight at once (C
// = 64: 16 threads per row, 256-row tiles, two blocks per SM); the threads
// of a row read its run id at one address, which the load unit serves once.
// Where no tile continues a run this runs close to the rate of a copy of the
// values; what a continuing run adds is the look-back, so K4 publishes each
// tile's descriptor as one 64-bit (status, value) word per channel, in the
// state the memset clears.  A tile reads its predecessor's words whole: when
// they hold P (the predecessor held the run's head, as it nearly always
// does when runs are much shorter than a tile) that is the prefix, after one
// round trip and no fence; otherwise it looks back as K2 does.  Other C (or
// an unaligned x) take the same kernel with 4-byte vectors.
#include "seg_scan_lookback.cuh"

template <int N>
__global__ void __launch_bounds__(tln::lb::kThreads, 2)
seg_max_lookback(const int* ids, const unsigned* x, unsigned* out,
                 tln::lb::u64* state, int64_t q, int c, int w, int ntiles) {
  tln::lb::scan_tile<tln::kMaxU32, N, false, false>(ids, x, out, state,
                                                    nullptr, q, c, w, ntiles);
}

// The plan of ops/seg_scan.py:_lookback_plan; state holds
// channel_word_state_bytes() (cleared here).  vw = 4 needs C % 4 == 0 and
// 16-byte aligned x.
TLN_API int tln_seg_max(const void* ids, const void* x, void* out, void* state,
                        int64_t q, int c, int vw, int w, int ntiles, int ncb,
                        void* stream) {
  const size_t bytes = tln::lb::channel_word_state_bytes(ntiles, ncb, c);
  const int* i = static_cast<const int*>(ids);
  const unsigned* xt = static_cast<const unsigned*>(x);
  unsigned* o = static_cast<unsigned*>(out);
  tln::lb::u64* st = static_cast<tln::lb::u64*>(state);
  if (vw == 4)
    return tln::lb::launch(seg_max_lookback<4>, state, bytes, ntiles, ncb,
                           w == 1 ? tln::lb::stage_bytes<4>() : 0, stream, i,
                           xt, o, st, q, c, w, ntiles);
  return tln::lb::launch(seg_max_lookback<1>, state, bytes, ntiles, ncb,
                         w == 1 ? tln::lb::stage_bytes<1>() : 0, stream, i, xt,
                         o, st, q, c, w, ntiles);
}
