// The combine operators of every segmented scan (Op<M>), and the
// hierarchical scan templates below, which only K4 (seg_max.cu: uint32 max)
// runs; K2 and K3 take the single-pass scan of seg_scan_lookback.cuh.
//
// Rows are (Q, C) row-major; runs are given by nondecreasing int32 run ids,
// equal id == same run.  The TPU kernels carried the running value across
// an in-order grid in scratch memory; CUDA blocks run in no order, so the
// scan is hierarchical:
//   1. seg_scan_local: each block scans R = (256 / CB) * 4 rows of CB
//      channels.  A thread scans its 4 rows of one channel in registers,
//      a Hillis-Steele pass over the block's thread segments in shared
//      memory (keyed by each segment's last run id) joins the segments, and
//      the block writes its last row's value and run id as its carry.
//   2. the wrapper scans the block carries with the same two kernels,
//      recursively, until one block holds them all;
//   3. seg_scan_fixup: rows of block b whose run id equals block b-1's last
//      run id fold in block b-1's scanned carry.
// Joining at segment and block granularity is exact for any associative
// combine: a run that continues across a boundary is, on the far side, a
// contiguous prefix of rows with the previous segment's last id.
#pragma once

#include <limits.h>

#include "common.cuh"

namespace tln {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

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

template <int M>
__global__ void __launch_bounds__(kThreads)
seg_scan_local(const int* __restrict__ ids,
               const typename Op<M>::T* __restrict__ x,
               typename Op<M>::T* __restrict__ out,
               typename Op<M>::T* __restrict__ blk_val,
               int* __restrict__ blk_id, int64_t q, int c, int cb) {
  using T = typename Op<M>::T;
  __shared__ T sval[kThreads];
  __shared__ int sid[kThreads];
  __shared__ int sok[kThreads];

  const int tid = threadIdx.x;
  const int cl = tid % cb;             // channel within this channel block
  const int s = tid / cb;              // thread segment within the block
  const int nseg = kThreads / cb;
  const int ch = blockIdx.y * cb + cl;
  const bool ch_ok = ch < c;
  const int64_t rows_per_block = static_cast<int64_t>(nseg) * kRowsPerThread;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block +
                       static_cast<int64_t>(s) * kRowsPerThread;

  // 1. serial scan of this thread's rows
  T v[kRowsPerThread];
  int id[kRowsPerThread];
  bool ok[kRowsPerThread];
  T run = Op<M>::ident();
  int last_id = 0;
  bool any = false;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = row0 + k;
    ok[k] = r < q;
    if (ok[k]) {
      id[k] = ids[r];
      const T xv = ch_ok ? x[r * c + ch] : Op<M>::ident();
      run = (any && id[k] == last_id) ? Op<M>::comb(run, xv) : xv;
      last_id = id[k];
      any = true;
    } else {
      id[k] = 0;
    }
    v[k] = run;
  }
  sval[tid] = run;
  if (cl == 0) {
    sid[s] = last_id;
    sok[s] = any ? 1 : 0;
  }
  __syncthreads();

  // 2. Hillis-Steele over the thread segments, keyed by last run id
  for (int d = 1; d < nseg; d <<= 1) {
    T other = Op<M>::ident();
    bool take = false;
    if (s >= d && sok[s] && sok[s - d] && sid[s - d] == sid[s]) {
      other = sval[(s - d) * cb + cl];
      take = true;
    }
    __syncthreads();
    if (take) sval[tid] = Op<M>::comb(other, sval[tid]);
    __syncthreads();
  }

  // 3. fold the previous segment's scanned carry into the continuing rows
  if (s > 0 && sok[s - 1]) {
    const T carry = sval[(s - 1) * cb + cl];
    const int cid = sid[s - 1];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k)
      if (ok[k] && id[k] == cid) v[k] = Op<M>::comb(carry, v[k]);
  }
  if (ch_ok) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k)
      if (ok[k]) out[(row0 + k) * c + ch] = v[k];
  }
  if (s == nseg - 1) {
    // the block's carry: its last segment's scanned value and run id (only
    // a full block is ever read as a carry, so its last segment is valid)
    if (ch_ok) blk_val[static_cast<int64_t>(blockIdx.x) * c + ch] = sval[tid];
    if (cl == 0 && blockIdx.y == 0) blk_id[blockIdx.x] = sid[s];
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
seg_scan_fixup(const int* __restrict__ ids, typename Op<M>::T* __restrict__ out,
               const typename Op<M>::T* __restrict__ blk_scan,
               const int* __restrict__ blk_id, int64_t q, int c,
               int64_t rows_per_block) {
  // one thread per element of blocks 1.. (block 0 has no carry-in)
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x + rows_per_block * c;
  if (i >= q * c) return;
  const int64_t r = i / c;
  const int ch = static_cast<int>(i - r * c);
  const int64_t b = r / rows_per_block;
  if (ids[r] != blk_id[b - 1]) return;
  out[i] = Op<M>::comb(blk_scan[(b - 1) * c + ch], out[i]);
}

template <int M>
int launch_local(const void* ids, const void* x, void* out, void* blk_val,
                 void* blk_id, int64_t q, int c, int cb, void* stream) {
  using T = typename Op<M>::T;
  const int64_t rows_per_block = static_cast<int64_t>(kThreads / cb) *
                                 kRowsPerThread;
  const int64_t nb = (q + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>(nb),
                  static_cast<unsigned>((c + cb - 1) / cb));
  seg_scan_local<M><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const T*>(x),
      static_cast<T*>(out), static_cast<T*>(blk_val),
      static_cast<int*>(blk_id), q, c, cb);
  return tln_last_error();
}

template <int M>
int launch_fixup(const void* ids, void* out, const void* blk_scan,
                 const void* blk_id, int64_t q, int c, int64_t rows_per_block,
                 void* stream) {
  using T = typename Op<M>::T;
  const int64_t n = q * c - rows_per_block * c;
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  seg_scan_fixup<M><<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<T*>(out),
      static_cast<const T*>(blk_scan), static_cast<const int*>(blk_id), q, c,
      rows_per_block);
  return tln_last_error();
}

}  // namespace tln
