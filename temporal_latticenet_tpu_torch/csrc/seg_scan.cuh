// The modes and combine operators (Op<M>) of the port's segmented scans:
// K2 (seg_scan.cu), K3 (seg_sum_tails.cu) and K4 (seg_max.cu), all on the
// single-pass look-back scan of seg_scan_lookback.cuh.
//
// Rows are (Q, C) row-major; runs are given by nondecreasing int32 run ids,
// equal id == same run.  comb(earlier, later) is associative, so runs can be
// joined at any row, strip or tile boundary: a run that continues across a
// boundary is, on the far side, a contiguous prefix of rows with the
// previous segment's last id.
#pragma once

#include <limits.h>

#include "common.cuh"

namespace tln {

enum Mode { kSumF32 = 0, kSumI32 = 1, kMaxI32 = 2, kFirst = 3, kMaxU32 = 4 };

// comb(earlier, later)
template <int M> struct Op;
template <> struct Op<kSumF32> {
  using T = float;
  __device__ static T ident() { return 0.0f; }
  __device__ static T comb(T a, T b) { return a + b; }
};
template <> struct Op<kSumI32> {
  using T = int;
  __device__ static T ident() { return 0; }
  __device__ static T comb(T a, T b) { return a + b; }
};
template <> struct Op<kMaxI32> {
  using T = int;
  __device__ static T ident() { return INT_MIN; }
  __device__ static T comb(T a, T b) { return a > b ? a : b; }
};
// the run head's 32-bit pattern propagates forward (float or int alike)
template <> struct Op<kFirst> {
  using T = int;
  __device__ static T ident() { return 0; }
  __device__ static T comb(T a, T) { return a; }
};
template <> struct Op<kMaxU32> {
  using T = unsigned int;
  __device__ static T ident() { return 0u; }
  __device__ static T comb(T a, T b) { return a > b ? a : b; }
};

}  // namespace tln
