// Single-pass segmented inclusive scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016), written by hand for K2 (seg_scan.cu), K3 (seg_sum_tails.cu)
// and K4 (seg_max.cu).  One kernel per call, after one memset of the tile
// state.
//
// Rows are (Q, C) row-major; runs are given by nondecreasing int32 run ids
// (equal id == same run), or by no ids at all: one run over every row.
//
// Layout.  A block of kThreads threads scans one tile.  N (1 or 4) channels
// are one 4- or 16-byte vector; w = the threads that cover one row's vectors
// (a power of two, at most kThreads); the block holds kThreads / w strips of
// kStrip consecutive rows, so a tile is (kThreads / w) * kStrip rows: 4096
// rows at C = 1 and C = 4, 256 at C = 64, 128 at C = 128.  Channels past
// kThreads * N go to further blocks along grid y, each a scan of its own.
//   1. loads: at C = 1 and C = 4 (a thread covers a row) a warp reads its 512
//      rows (ids and values) with 16-byte loads contiguous across the warp
//      and hands each lane its 16 rows through shared memory; at wider
//      C % 4 == 0 a thread reads one float4 of channels per row;
//   2. a thread scans its strip in registers;
//   3. strips join by warp shuffles, then across warps in shared memory, as
//      pairs (has a run head, value since the last head) under the segmented
//      combine: on the far side of a boundary a continuing run is a prefix of
//      rows with the previous segment's last id;
//   4. the block publishes its tile's descriptor: the value of the tile's
//      trailing run, as an inclusive prefix (status P) when the tile holds
//      that run's head, else as an aggregate (status A).  At C = 1 for the
//      integer modes and "first" (packed) the status and the 32-bit value
//      share one 64-bit word, written and read whole, so no fence is needed;
//      otherwise the values are written, fenced, and then the status.  For
//      the uint32 max (K4) the values are channel words: one 64-bit (status,
//      value) word per channel, in the state the memset clears;
//   5. a tile whose first row continues the previous tile's run looks back
//      to the nearest P with only A's between (one warp, a tile per lane,
//      128 tiles per round trip, so a run over every row takes a few round
//      trips), folds the values forward and publishes its own P.  Packed,
//      the warp folds the values it read (in any grouping: the results are
//      exact); otherwise the channels' owners fold left to right.  K4 first
//      reads the predecessor's channel words: when all hold P that is the
//      prefix (one round trip, no fence); else it looks back as the others
//      do and folds the channel words;
//   6. rows before a strip's first head take the carry; with kEnds only the
//      rows that end a run are written (K3 reads nothing else).
// Tiles are numbered by an atomic counter in launch order, so every tile a
// tile waits on has started: the look-back cannot deadlock.
//
// Determinism.  A float32 tile prefix is the left fold, in tile order, of
// the head tile's value and the aggregates after it:
// P_i = (((P_h + A_h+1) + ...) + A_i).  A published P_j is that same fold up
// to j, so continuing a fold from any P_j gives the same bits as folding from
// the head tile: float32 sums do not depend on which descriptor was ready.
// The integer modes are exact in any grouping.
#pragma once

#include <stdint.h>
#include <string.h>

#include "seg_scan.cuh"

namespace tln {
namespace lb {

constexpr int kThreads = 256;
constexpr int kStrip = 16;              // rows per thread
constexpr int kAggregate = 1;           // tile word statuses (0: not yet)
constexpr int kPrefix = 2;
constexpr int kWindows = 4;             // look-back: 32-tile windows per
                                        // round trip
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

template <typename T, int N>
struct Vec {
  T v[N];
};

template <int M, int N>
__device__ __forceinline__ Vec<typename Op<M>::T, N> comb(
    const Vec<typename Op<M>::T, N>& a, const Vec<typename Op<M>::T, N>& b) {
  Vec<typename Op<M>::T, N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = Op<M>::comb(a.v[i], b.v[i]);
  return r;
}

template <int M, int N>
__device__ __forceinline__ Vec<typename Op<M>::T, N> ident() {
  Vec<typename Op<M>::T, N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = Op<M>::ident();
  return r;
}

// read-only input
template <typename T, int N>
__device__ __forceinline__ Vec<T, N> ld(const T* p) {
  Vec<T, N> r;
  if constexpr (N == 4) {
    const int4 b = __ldg(reinterpret_cast<const int4*>(p));
    memcpy(&r, &b, sizeof(r));
  } else {
    const int b = __ldg(reinterpret_cast<const int*>(p));
    memcpy(&r, &b, sizeof(r));
  }
  return r;
}

template <typename T, int N>
__device__ __forceinline__ void st(T* p, const Vec<T, N>& v) {
  if constexpr (N == 4) {
    int4 b;
    memcpy(&b, &v, sizeof(b));
    *reinterpret_cast<int4*>(p) = b;
  } else {
    int b;
    memcpy(&b, &v, sizeof(b));
    *reinterpret_cast<int*>(p) = b;
  }
}

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> shfl_up(const Vec<T, N>& v, int d) {
  Vec<T, N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = __shfl_up_sync(kFull, v.v[i], d);
  return r;
}

// packed tile words: written and read whole by other blocks while the
// kernel runs
__device__ __forceinline__ u64 ld_word(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_word(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// a status word of another block's tile
__device__ __forceinline__ int ld_status(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// descriptor values other blocks wrote in this launch: from L2, never L1
template <typename T, int N>
__device__ __forceinline__ Vec<T, N> ld_cg(const T* p) {
  Vec<T, N> r;
  if constexpr (N == 4) {
    const int4 b = __ldcg(reinterpret_cast<const int4*>(p));
    memcpy(&r, &b, sizeof(r));
  } else {
    const int b = __ldcg(reinterpret_cast<const int*>(p));
    memcpy(&r, &b, sizeof(r));
  }
  return r;
}

template <typename T>
__device__ __forceinline__ u64 pack(int status, T v) {
  unsigned b;
  memcpy(&b, &v, sizeof(b));
  return (static_cast<u64>(status) << 32) | b;
}

__device__ __forceinline__ int word_status(u64 wd) {
  return static_cast<int>(wd >> 32);
}

template <typename T>
__device__ __forceinline__ T word_value(u64 wd) {
  const unsigned b = static_cast<unsigned>(wd);
  T v;
  memcpy(&v, &b, sizeof(v));
  return v;
}

// K4's descriptors: one packed word (status, value) per channel, N in a row
template <int N, typename T>
__device__ __forceinline__ void st_words(u64* p, int status,
                                         const Vec<T, N>& v) {
#pragma unroll
  for (int i = 0; i < N; ++i) st_word(p + i, pack(status, v.v[i]));
}

template <int M, int N>
__device__ __forceinline__ Vec<typename Op<M>::T, N> ld_words(const u64* p) {
  Vec<typename Op<M>::T, N> r;
#pragma unroll
  for (int i = 0; i < N; ++i)
    r.v[i] = word_value<typename Op<M>::T>(ld_word(p + i));
  return r;
}

// Staging of a warp's 512 rows when a thread covers a whole row (w = 1):
// the warp loads them with 16-byte loads contiguous across the warp, and
// each lane takes its 16 consecutive rows from shared memory.  One pad int4
// after every 8 (ids, C = 1: a lane reads 4 consecutive int4) or 16 (C = 4:
// 16 consecutive int4) keeps both the contiguous writes and the lanes'
// reads free of bank conflicts.
template <int N>
__host__ __device__ constexpr int lane_int4() {     // int4 of x per lane
  return N == 1 ? kStrip / 4 : kStrip;
}
template <int N>
__host__ __device__ constexpr int stage_int4() {    // padded, per warp
  return 32 * lane_int4<N>() + 32 * lane_int4<N>() / (N == 1 ? 8 : 16);
}
template <int N>
__device__ __forceinline__ int stage_at(int i) {
  return i + (N == 1 ? i >> 3 : i >> 4);
}
// dynamic shared memory of a block with w = 1: the staged ids and values
template <int N>
constexpr size_t stage_bytes() {
  return static_cast<size_t>(kThreads / 32) *
         (stage_int4<1>() + stage_int4<N>()) * sizeof(int4);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the rows of a tile, as the wrapper plans them (ops/seg_scan.py
// :_lookback_plan)
__host__ __device__ inline int64_t tile_rows(int w) {
  return static_cast<int64_t>(kThreads / w) * kStrip;
}

// Warp 0: the nearest tile k before `tile` whose status is P with only A's
// between, 32 * kWindows tiles a round trip.  kPacked (C = 1, integer modes
// and "first"): the tile words carry the values, and their fold, exact in
// any grouping, goes to *acc.
template <int M, bool kPacked>
__device__ __forceinline__ int look_back_warp(const u64* words,
                                              const int* status, int tile,
                                              int lane,
                                              typename Op<M>::T* acc) {
  using T = typename Op<M>::T;
  T total = Op<M>::ident();
  int base = tile, k = -1;
  while (k < 0) {
    u64 wd[kWindows];
#pragma unroll
    for (int u = 0; u < kWindows; ++u) {
      const int j = base - 1 - 32 * u - lane;
      if constexpr (kPacked)
        wd[u] = j >= 0 ? ld_word(words + j) : pack(kPrefix, Op<M>::ident());
      else
        wd[u] = static_cast<u64>(j >= 0 ? ld_status(status + j) : kPrefix)
                << 32;
    }
    T got = Op<M>::ident();
    bool wait = false;
#pragma unroll
    for (int u = 0; u < kWindows; ++u) {
      if (k >= 0 || wait) continue;
      const int sj = word_status(wd[u]);
      const unsigned pm = __ballot_sync(kFull, sj == kPrefix);
      const unsigned zm = __ballot_sync(kFull, sj == 0);
      const int lp = pm ? __ffs(pm) - 1 : 31;
      if (zm & (pm ? (1u << lp) - 1u : kFull)) {
        wait = true;                  // a tile in the window has not published
        continue;
      }
      if constexpr (kPacked) {
        // this window's tiles up to the P, farther than the ones before
        T part;
        if constexpr (M == kFirst) {
          part = __shfl_sync(kFull, word_value<T>(wd[u]), lp);
        } else {
          part = lane <= lp ? word_value<T>(wd[u]) : Op<M>::ident();
#pragma unroll
          for (int d = 16; d > 0; d >>= 1)
            part = Op<M>::comb(part, __shfl_xor_sync(kFull, part, d));
        }
        got = Op<M>::comb(part, got);
      }
      if (pm) k = base - 1 - 32 * u - lp;
    }
    if (wait) {
      k = -1;
      __nanosleep(32);
      continue;
    }
    total = Op<M>::comb(got, total);
    base -= 32 * kWindows;
  }
  if constexpr (kPacked) *acc = total;
  return k;
}

// The tile state's bytes: a header of ncb int32 tile counters (one per
// channel block, rounded up to 8 bytes), then a 64-bit word per tile when
// packed (C = 1, integer modes and "first"), else an int32 status per
// (channel block, tile) beside the descriptor values.
__host__ __device__ inline int64_t state_header_words(int ncb) {
  return (ncb + 1) / 2;
}

inline size_t state_bytes(bool packed, int ntiles, int ncb) {
  return static_cast<size_t>(state_header_words(ncb)) * sizeof(u64) +
         static_cast<size_t>(ntiles) *
             (packed ? sizeof(u64) : static_cast<size_t>(ncb) * sizeof(int));
}

// K4 (the uint32 max) keeps its descriptors in the state too, so that the
// launch's memset clears them: after the int32 statuses (rounded up to 8
// bytes), a packed word (status, value) per (tile, channel), ntiles x C.
__host__ __device__ inline int64_t channel_words_at(int ntiles, int ncb) {
  return state_header_words(ncb) +
         (static_cast<int64_t>(ntiles) * ncb + 1) / 2;
}

inline size_t channel_word_state_bytes(int ntiles, int ncb, int c) {
  return static_cast<size_t>(channel_words_at(ntiles, ncb) +
                             static_cast<int64_t>(ntiles) * c) *
         sizeof(u64);
}

// One block: scans one tile.  state: as state_bytes() (K4:
// channel_word_state_bytes()) lays it out, zero at launch; desc: (2, ntiles,
// C) descriptor values (aggregates, inclusive prefixes) when neither kPacked
// nor K4.  kPacked: C = 1, integer modes and "first".  ids == nullptr: one
// run.
template <int M, int N, bool kEnds, bool kPacked>
__device__ __forceinline__ void scan_tile(
    const int* __restrict__ ids, const typename Op<M>::T* __restrict__ x,
    typename Op<M>::T* __restrict__ out, u64* state,
    typename Op<M>::T* desc, int64_t q, int c, int w, int ntiles) {
  using T = typename Op<M>::T;
  using V = Vec<T, N>;
  __shared__ int s_tile, s_cont, s_k;
  __shared__ int s_gflag[kThreads];
  __shared__ V s_val[kThreads];
  extern __shared__ int4 s_dyn[];          // stage_bytes<N>() when w = 1

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cl = tid % w;                 // vector lane within the row
  const int s = tid / w;                  // strip
  const int nstrips = kThreads / w;
  const int64_t ch = (static_cast<int64_t>(blockIdx.y) * w + cl) * N;
  const bool ch_ok = ch < c;
  static_assert(!kPacked || (N == 1 && M != kSumF32), "packed: C = 1 exact");
  int* counter = reinterpret_cast<int*>(state) + blockIdx.y;
  u64* words = state + state_header_words(gridDim.y);
  int* status = reinterpret_cast<int*>(words) +
                static_cast<int64_t>(blockIdx.y) * ntiles;
  T* agg = desc;
  T* incl = desc + static_cast<int64_t>(ntiles) * c;
  // K4: a word per (tile, channel), each written and read whole
  constexpr bool kWords = M == kMaxU32;
  static_assert(!(kWords && kPacked), "K4's descriptors are channel words");
  u64* cwords = state + channel_words_at(ntiles, gridDim.y);

  if (tid == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const int64_t tile0 = static_cast<int64_t>(tile) * tile_rows(w);
  const int64_t r0 = tile0 + static_cast<int64_t>(s) * kStrip;
  const bool full = r0 + kStrip <= q;

  // 1. the strip's run ids (and the rows around it) and values
  int id[kStrip];
  V xv[kStrip];
  int prev = 0, next = 0;
  if (ids != nullptr && r0 > 0 && r0 <= q) prev = __ldg(ids + r0 - 1);
  if (kEnds && ids != nullptr && r0 + kStrip < q)
    next = __ldg(ids + r0 + kStrip);
  const int64_t wrow0 = tile0 + static_cast<int64_t>(tid / 32) * 32 * kStrip;
  const bool warp_rows = w == 1 && c == N && wrow0 + 32 * kStrip <= q &&
                         aligned16(x) && aligned16(out) &&
                         (ids == nullptr || aligned16(ids));
  int4* ids_stage = s_dyn + (tid / 32) * (stage_int4<1>() + stage_int4<N>());
  int4* x_stage = ids_stage + stage_int4<1>();
  if (warp_rows) {
    static_assert(kStrip == 16, "a lane takes 4 int4 of the warp's ids");
    const int4* gx = reinterpret_cast<const int4*>(x + wrow0 * N);
#pragma unroll
    for (int m = 0; m < lane_int4<N>(); ++m)
      x_stage[stage_at<N>(32 * m + lane)] = __ldg(gx + 32 * m + lane);
    if (ids != nullptr) {
      const int4* gi = reinterpret_cast<const int4*>(ids + wrow0);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        ids_stage[stage_at<1>(32 * m + lane)] = __ldg(gi + 32 * m + lane);
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < lane_int4<N>(); ++u) {
      const int4 b = x_stage[stage_at<N>(lane_int4<N>() * lane + u)];
      memcpy(reinterpret_cast<char*>(xv) + sizeof(int4) * u, &b, sizeof(b));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int4 d = ids != nullptr ? ids_stage[stage_at<1>(4 * lane + u)]
                                    : make_int4(0, 0, 0, 0);
      id[4 * u] = d.x;
      id[4 * u + 1] = d.y;
      id[4 * u + 2] = d.z;
      id[4 * u + 3] = d.w;
    }
    __syncwarp();
  } else {
    if (ids != nullptr && full && aligned16(ids)) {
#pragma unroll
      for (int j = 0; j < kStrip / 4; ++j) {
        const int4 b = __ldg(reinterpret_cast<const int4*>(ids + r0) + j);
        id[4 * j] = b.x;
        id[4 * j + 1] = b.y;
        id[4 * j + 2] = b.z;
        id[4 * j + 3] = b.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kStrip; ++k)
        id[k] = (ids != nullptr && r0 + k < q) ? __ldg(ids + r0 + k) : 0;
    }
#pragma unroll
    for (int k = 0; k < kStrip; ++k)
      xv[k] = (r0 + k < q && ch_ok) ? ld<T, N>(x + (r0 + k) * c + ch)
                                    : ident<M, N>();
  }

  // 2. the strip in registers: heads, running values, (has head, trailing
  // value) of the strip
  unsigned heads = 0;
  V run = ident<M, N>();
#pragma unroll
  for (int k = 0; k < kStrip; ++k) {
    const int64_t r = r0 + k;
    if (r < q) {
      const bool head =
          r == 0 || (ids != nullptr && id[k] != (k == 0 ? prev : id[k - 1]));
      if (head) heads |= 1u << k;
      run = (head || k == 0) ? xv[k] : comb<M, N>(run, xv[k]);
      xv[k] = run;
    }
  }
  const bool f_own = heads != 0;
  // kEnds: the rows that end a run (the next row is a head, or the last row)
  unsigned ends = 0;
  if (kEnds) {
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      const int64_t r = r0 + k;
      const bool end =
          r + 1 >= q || (k + 1 < kStrip ? ((heads >> (k + 1)) & 1u) != 0
                                        : next != id[kStrip - 1]);
      if (r < q && end) ends |= 1u << k;
    }
  }

  // 3. join the strips: within a warp by shuffles (strips of one vector
  // lane are w lanes apart), then across warps (or strips, when w > 32) in
  // shared memory.  Each thread ends with the pair of the strips before its
  // own in the tile (ex) and the pair up to and including its own.
  bool f = f_own;
  V a = run;
  bool has_we = false, fe = false;
  V ae = a;
  if (w < 32) {
    for (int d = w; d < 32; d <<= 1) {
      const bool fo = __shfl_up_sync(kFull, f ? 1 : 0, d) != 0;
      const V ao = shfl_up(a, d);
      if (lane >= d) {
        a = f ? a : comb<M, N>(ao, a);
        f = f || fo;
      }
    }
    fe = __shfl_up_sync(kFull, f ? 1 : 0, w) != 0;
    ae = shfl_up(a, w);
    has_we = lane >= w;
  }
  const int g = w <= 32 ? tid / 32 : s;
  const bool glast = w <= 32 ? lane >= 32 - w : true;
  if (glast) {
    s_val[g * w + cl] = a;
    if (cl == 0) s_gflag[g] = f ? 1 : 0;
  }
  if (tid == 0)
    s_cont = tile0 > 0 && (ids == nullptr || id[0] == prev) ? 1 : 0;
  __syncthreads();
  bool has_ex = false, ex_f = false;
  V ex_a = ident<M, N>();
  for (int j = 0; j < g; ++j) {
    const bool fj = s_gflag[j] != 0;
    const V aj = s_val[j * w + cl];
    ex_a = (!has_ex || fj) ? aj : comb<M, N>(ex_a, aj);
    ex_f = ex_f || fj;
    has_ex = true;
  }
  if (has_we) {
    ex_a = (has_ex && !fe) ? comb<M, N>(ex_a, ae) : ae;
    ex_f = ex_f || fe;
    has_ex = true;
  }
  const V tile_val = (has_ex && !f_own) ? comb<M, N>(ex_a, run) : run;
  const bool cont = s_cont != 0;
  // the tile holds its trailing run's head iff any row of it is a head
  const bool tile_head = __syncthreads_or(f_own ? 1 : 0) != 0;

  // 4. publish this tile's descriptor
  const bool last_strip = s == nstrips - 1;
  const int64_t dsc = static_cast<int64_t>(tile) * c + ch;
  if constexpr (kPacked) {
    if (last_strip)
      st_word(words + tile,
              pack(tile_head ? kPrefix : kAggregate, tile_val.v[0]));
  } else {
    if (last_strip && ch_ok) {
      if constexpr (kWords)
        st_words<N>(cwords + dsc, tile_head ? kPrefix : kAggregate, tile_val);
      else
        st<T, N>((tile_head ? incl : agg) + dsc, tile_val);
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) st_release(status + tile, tile_head ? kPrefix : kAggregate);
  }

  // 5. look back for the tile's prefix, then publish the tile's own
  V tp = ident<M, N>();
  if (cont) {
    if constexpr (kPacked) {
      if (tid < 32) {
        T acc;
        look_back_warp<M, true>(words, status, tile, lane, &acc);
        if (lane == 0) s_val[0].v[0] = acc;
      }
      __syncthreads();
    } else {
      // K4: the predecessor's channel words, each read whole; when they all
      // hold P (it held the run's head) that is the prefix, after one round
      // trip and no fence
      bool at_p = false;
      if constexpr (kWords) {
        bool mine = true;
        if (tid < w && ch_ok) {
          const u64* pw = cwords + static_cast<int64_t>(tile - 1) * c + ch;
          u64 wd[N];
          bool ready;
          do {
            ready = true;
#pragma unroll
            for (int i = 0; i < N; ++i) {
              wd[i] = ld_word(pw + i);
              ready = ready && word_status(wd[i]) != 0;
            }
            if (!ready) __nanosleep(32);
          } while (!ready);
          V v;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            mine = mine && word_status(wd[i]) == kPrefix;
            v.v[i] = word_value<T>(wd[i]);
          }
          s_val[cl] = v;
        }
        at_p = __syncthreads_or(mine ? 0 : 1) == 0;
      }
      if (!at_p) {
        if (tid < 32) {
          const int k = look_back_warp<M, false>(words, status, tile, lane,
                                                 nullptr);
          if (lane == 0) s_k = k;
        }
        __syncthreads();
        // the left fold in tile order from the P: the same bits whichever P
        // was found (K4: of the channel words, exact in any order)
        if (tid < w && ch_ok) {
          const int k = s_k;
          __threadfence();
          auto published = [&](const T* d, int j) {
            if constexpr (kWords)
              return ld_words<M, N>(cwords + static_cast<int64_t>(j) * c + ch);
            else
              return ld_cg<T, N>(d + static_cast<int64_t>(j) * c + ch);
          };
          V acc = published(incl, k);
          int j = k + 1;
          for (; j + 8 <= tile; j += 8) {
            V b[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) b[u] = published(agg, j + u);
#pragma unroll
            for (int u = 0; u < 8; ++u) acc = comb<M, N>(acc, b[u]);
          }
          for (; j < tile; ++j) acc = comb<M, N>(acc, published(agg, j));
          s_val[cl] = acc;
        }
        __syncthreads();
      }
    }
    tp = s_val[cl];
    if (!tile_head) {
      const V p = comb<M, N>(tp, tile_val);
      if constexpr (kPacked) {
        if (last_strip) st_word(words + tile, pack(kPrefix, p.v[0]));
      } else {
        if (last_strip && ch_ok) {
          if constexpr (kWords)
            st_words<N>(cwords + dsc, kPrefix, p);
          else
            st<T, N>(incl + dsc, p);
          __threadfence();
        }
        __syncthreads();
        if (tid == 0) st_release(status + tile, kPrefix);
      }
    }
  }

  // 6. rows before the strip's first head take the carry: the strips before
  // it in the tile and, while no head came yet, the tile's prefix
  bool has_c = cont;
  V cv = tp;
  if (has_ex) {
    cv = (ex_f || !cont) ? ex_a : comb<M, N>(tp, ex_a);
    has_c = true;
  }
  const int first_head = heads ? __ffs(heads) - 1 : kStrip;
  if (has_c) {
#pragma unroll
    for (int k = 0; k < kStrip; ++k)
      if (k < first_head) xv[k] = comb<M, N>(cv, xv[k]);
  }
  if (!kEnds && warp_rows) {
#pragma unroll
    for (int u = 0; u < lane_int4<N>(); ++u) {
      int4 b;
      memcpy(&b, reinterpret_cast<const char*>(xv) + sizeof(int4) * u,
             sizeof(b));
      x_stage[stage_at<N>(lane_int4<N>() * lane + u)] = b;
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < lane_int4<N>(); ++m)
      reinterpret_cast<int4*>(out + wrow0 * N)[32 * m + lane] =
          x_stage[stage_at<N>(32 * m + lane)];
  } else if (ch_ok) {
#pragma unroll
    for (int k = 0; k < kStrip; ++k)
      if (r0 + k < q && (!kEnds || ((ends >> k) & 1u)))
        st<T, N>(out + (r0 + k) * c + ch, xv[k]);
  }
}

// Clears the tile state (one memset of `bytes`), then launches
// kernel<<<(ntiles, ncb), kThreads, smem>>>.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, void* state, size_t bytes, int ntiles, int ncb,
           size_t smem, void* stream, Args... args) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(state, 0, bytes, st);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(static_cast<unsigned>(ntiles), static_cast<unsigned>(ncb)),
           kThreads, smem, st>>>(args...);
  return tln_last_error();
}

}  // namespace lb
}  // namespace tln
