// K5: windowed inclusive segmented running max of uint32 bit patterns (held
// in int32 tensors) over contiguous runs given by nondecreasing int32 run ids.
//
// Replaces the Pallas TPU kernel temporal_latticenet_tpu/ops/pallas_scan.py
// :_seg_max_kernel_packed (the lane-packed path of sorted_segment_max_i32
// with max_window, taken under TLN_MAXSCAN_PACKED=1).  Contract: row r's
// output is the max over rows [max(head(r), r - 2 W + 1), r], W = window,
// so every row covers its last 2 W same-run rows (at least the 2 W - 1 the
// two-level tail max of ops/segment.py relies on) and never crosses a run
// head.  On the main path (the batched pointnet under the packed route) it
// reads Q = 2,097,152 packed (bf16 value | u16 barycentric weight) rows of
// C = 64 at W = 8.
//
// The TPU kernel packed row pairs into 2C lanes and carried the running max
// from one grid step to the next; both were layout devices of an in-order
// TPU grid and are gone.  Here the window bounds how far back a row looks,
// so one launch needs no carry: a block loads its tile of kTileRows rows
// plus the 2 W - 1 rows before it (the halo) into shared memory as one
// contiguous span with 16-byte loads, and each thread takes the max over
// its own (row, 4 channels) window, stopping at the run head.
//
// Bound on the H100: bytes.  Reads (4 C + 4) and writes 4 C bytes per row:
// 1.08 GB at the flagship shape, about 0.32 ms at 3.35 TB/s.  The halo adds
// (2 W - 1) / kTileRows = 12 % re-reads at W = 8, mostly from L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 128;

__device__ __forceinline__ int umax32(int a, int b) {
  return static_cast<unsigned>(a) > static_cast<unsigned>(b) ? a : b;
}

__device__ __forceinline__ int4 umax32(int4 a, int4 b) {
  return make_int4(umax32(a.x, b.x), umax32(a.y, b.y), umax32(a.z, b.z),
                   umax32(a.w, b.w));
}

// V is int4 (C % 4 == 0, 16-byte aligned rows) or int; cv = C in V units.
template <typename V>
__global__ void seg_max_window_kernel(const int* __restrict__ ids,
                                      const V* __restrict__ x,
                                      V* __restrict__ out, int64_t q, int cv,
                                      int halo) {
  extern __shared__ int4 smem[];
  V* sx = reinterpret_cast<V*>(smem);
  int* sid = reinterpret_cast<int*>(sx + static_cast<size_t>(kTileRows + halo) * cv);

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int64_t lo = row0 > halo ? row0 - halo : 0;
  const int64_t hi = row0 + kTileRows < q ? row0 + kTileRows : q;
  const int nrows = static_cast<int>(hi - lo);

  // rows [lo, hi) are one contiguous span of memory: coalesced loads
  const V* src = x + lo * cv;
  for (int i = threadIdx.x; i < nrows * cv; i += kThreads) sx[i] = src[i];
  for (int i = threadIdx.x; i < nrows; i += kThreads) sid[i] = ids[lo + i];
  __syncthreads();

  const int first = static_cast<int>(row0 - lo);   // shared row of row0
  const int nout = static_cast<int>(hi - row0) * cv;
  V* dst = out + row0 * cv;
  for (int i = threadIdx.x; i < nout; i += kThreads) {
    const int r = first + i / cv;
    const int c = i - (i / cv) * cv;
    const int id = sid[r];
    const int stop = r > halo ? r - halo : 0;
    V acc = sx[r * cv + c];
    for (int s = r - 1; s >= stop && sid[s] == id; --s) {
      acc = umax32(acc, sx[s * cv + c]);
    }
    dst[i] = acc;
  }
}

template <typename V>
int launch(const void* ids, const void* x, void* out, int64_t q, int cv,
           int halo, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTileRows + halo) *
                      (cv * sizeof(V) + sizeof(int));
  const int64_t blocks = (q + kTileRows - 1) / kTileRows;
  seg_max_window_kernel<V><<<static_cast<unsigned>(blocks), kThreads, smem,
                             stream>>>(
      static_cast<const int*>(ids), static_cast<const V*>(x),
      static_cast<V*>(out), q, cv, halo);
  return tln_last_error();
}

}  // namespace

// window in [1, 16] (the wrapper checks): the halo of 2 W - 1 rows keeps the
// block's shared memory at (128 + 31) x (4 C + 4) bytes, under 48 KB at
// C = 64.
TLN_API int tln_seg_max_window(const void* ids, const void* x, void* out,
                               int64_t q, int c, int window, void* stream) {
  if (q <= 0 || c <= 0) return 0;
  const int halo = 2 * window - 1;
  const bool vec4 = c % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  return vec4 ? launch<int4>(ids, x, out, q, c / 4, halo, st)
              : launch<int>(ids, x, out, q, c, halo, st);
}
