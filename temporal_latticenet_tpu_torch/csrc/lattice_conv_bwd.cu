// K8: the backward of K6 (the bf16 lattice convolution) as two gather-GEMMs
// on the tensor cores, the float32 cotangent split exactly into three bf16
// parts.
//
// With dY = mask_rows(dy) (C, Cout) float32, R the (C, 9 Cin) rows K6
// multiplies (the bf16 values gathered through the table, the center last)
// and W the (9 Cin, Cout) bf16 weight, the plain backward
// (lattice_ops.lattice_conv_backward_plain) computes, in float32 products,
//
//   dW = bf16(R^T dY)
//   dR = bf16(dY W^T), each tap's (C, Cin) block rounded on its own
//   dX[v] = bf16(bf16(sum over k < 8 of dR[u_k(v), k]) + dR[v, 8])
//
// where u_k(v) = idx[v, (k + 4) % 8] is the row that reads v at tap k (the
// one-hop offsets come in +/- pairs), used only where 0 < u < count.
//
// The split: x = hi + mid + lo, with hi the top 16 bits of the float32 x
// (sign, exponent and 7 fraction bits: a bf16), mid the top 16 bits of
// x - hi, and lo = x - hi - mid.  Each difference is exact in float32 and
// lo keeps at most 8 significant bits, so it is a bf16 too (for |x| >=
// 2^-110, and any multiple of 2^-133, bf16's subnormal step).  Truncating
// rather than rounding cannot overflow at float32's largest magnitudes.  A
// bf16 x bf16 product is exact in float32, so three MMAs of the exact bf16
// operand with hi, mid and lo give the plain path's float32 products,
// summed in float32 in another order.  No operand is rounded.
//
// It replaces no Pallas kernel: the JAX package leaves this backward to
// XLA's transposed dots.  It was added because the port's plain backward
// wrote (C, 9 Cin) float32 rows to device memory (gathered again and
// upcast, then dR, then the taps' gather and its float32 copy) and
// multiplied on float32 FFMA, since TF32 is off: about 480 C Cin bytes and
// 30 launches a call.
//
// Bound on the H100: each product is 3 x 2 count 9 Cin Cout operations at
// 989 TFLOP/s against reading dy, the table and the values once and
// writing dX (or dW's partials): operations bound every main-path width
// but the 64-channel ones.  Like K6, a block waits on the latency of
// dependent, scattered row reads, which the 50 MB L2 mostly serves.
//
// Design: both are K6's pipeline: 256 threads, 8 warps of mma.sync
// m16n8k16 over a 128-row tile, cp.async in 3 stages of 32 deep.
//  - dX (lattice_conv_dx_kernel): a 128-row x BN-column tile of dX (BN 32
//    or 64 of Cin); the depth runs over the 9 taps x Cout; each step
//    gathers its tap's 128 cotangent rows (u_k(v), or the row itself at the
//    center; zero where unused) and W_k's 32 x BN slice, which is W's own
//    layout (row tap Cin + ci, Cout contiguous), through ldmatrix.  The A
//    fragments are split as they are read from shared memory.  Each tap
//    sums into its own accumulators, which are rounded to bf16 and added to
//    the taps' float32 sum when the tap ends, so every rounding of the
//    plain path is kept.  A tile whose rows read no cotangent row writes
//    zeros and stops.
//  - dW (lattice_conv_dw_kernel): a split-K GEMM.  A block computes a
//    128 x BN tile of the (9 Cin, Cout) product (its 128 rows may cross
//    taps) over one chunk of the rows, 32 rows a step: A is the gathered
//    values (the chunk's table entries staged in shared memory a step
//    ahead), B is dY, split as its fragments are read.  Chunks that start
//    at or past `count` stop at once; each other block writes its partials
//    to scratch, and lattice_conv_dw_sum_kernel adds the live chunks' in
//    chunk order and rounds to bf16: the same bits on every call, no float
//    atomics.
// `count` is read on the device and the kernels allocate nothing, so a
// CUDA graph replays them as captured.  No (C, 9 Cin) buffer exists.
#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int kBM = 128;          // rows of a tile
constexpr int kBK = 32;           // depth per step
constexpr int kStages = 3;        // steps in flight
constexpr int kThreads = 256;     // 8 warps: 4 along the rows x 2 along N
constexpr int kTaps = 9;
constexpr int kPairShift = 4;     // lattice_ops._PAIR_SHIFT_3D
constexpr int kMT = 2;            // m16 tiles a warp (32 rows)

// The top 16 bits of x0 and x1 (two bf16 values), packed as an MMA
// fragment register holds them: x0 in the low half.
__device__ __forceinline__ uint32_t top16(float x0, float x1) {
  return __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}

// x less its top 16 bits: exact in float32 (the two share a sign and
// exponent, or the top bits are zero)
__device__ __forceinline__ float drop16(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// the exact split of x0 and x1 into hi + mid + lo, each a bf16 pair
__device__ __forceinline__ void split3(uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo, float x0, float x1) {
  hi = top16(x0, x1);
  x0 = drop16(x0);
  x1 = drop16(x1);
  mid = top16(x0, x1);
  lo = top16(drop16(x0), drop16(x1));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// dX
// ---------------------------------------------------------------------------

template <int BN>
struct DxSmem {
  // float32 rows of 160 bytes (K6's A stage: each half-warp's 8-byte
  // fragment reads hit 32 distinct banks); bf16 rows of 80 (ldmatrix
  // conflict-free); both 16-byte multiples for cp.async
  static constexpr int kAStride = kBK + 8;
  static constexpr int kBStride = kBK + 8;
  float a[kStages][kBM * kAStride];           // rows v, depth Cout
  __nv_bfloat16 b[kStages][BN * kBStride];    // rows ci, depth Cout
  int src[kBM][kTaps];                        // cotangent row, -1 none
};

// A fragments (16 rows x 16 depth) of a float32 stage, split in three
__device__ __forceinline__ void a_split(uint32_t (&hi)[4], uint32_t (&mid)[4],
                                        uint32_t (&lo)[4], const float* s,
                                        int stride, int row, int k,
                                        int lane) {
  const float* p = s + (row + (lane >> 2)) * stride + k + (lane & 3) * 2;
  const float2 x[4] = {*reinterpret_cast<const float2*>(p),
                       *reinterpret_cast<const float2*>(p + 8 * stride),
                       *reinterpret_cast<const float2*>(p + 8),
                       *reinterpret_cast<const float2*>(p + 8 * stride + 8)};
#pragma unroll
  for (int i = 0; i < 4; ++i) split3(hi[i], mid[i], lo[i], x[i].x, x[i].y);
}

template <typename TOut, int BN>
__global__ void __launch_bounds__(kThreads, 2)
lattice_conv_dx_kernel(const float* __restrict__ dy,
                       const int64_t* __restrict__ idx, int64_t idx_stride,
                       const __nv_bfloat16* __restrict__ w,
                       const int64_t* __restrict__ count_ptr,
                       int64_t count_imm, TOut* __restrict__ dx, int rows,
                       int cin, int cout, int vec_a, int vec_b) {
  using S = DxSmem<BN>;
  constexpr int kWN = BN / 2;                 // columns per warp
  constexpr int kNT = kWN / 8;                // n8 tiles per warp
  constexpr int kAChunksRow = kBK / 4;        // float32 16-byte chunks
  constexpr int kAChunks = kBM * kAChunksRow / kThreads;
  constexpr int kBChunksRow = kBK / 8;        // bf16 16-byte chunks
  static_assert(kWN % 16 == 0, "a warp's columns come in ldmatrix pairs");
  static_assert(kAChunks * kThreads == kBM * kAChunksRow, "whole A chunks");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int n0 = blockIdx.x * BN;
  int64_t cnt = count_ptr != nullptr ? *count_ptr : count_imm;
  if (cnt > rows) cnt = rows;

  // the cotangent row each of the tile's rows reads at each tap
  bool any = false;
  for (int e = tid; e < kBM * kTaps; e += kThreads) {
    const int lr = e / kTaps;
    const int tap = e % kTaps;
    const int64_t v = r0 + lr;
    int g = -1;
    if (v < rows) {
      const int64_t u =
          tap == kTaps - 1 ? v : idx[v * idx_stride + (tap + kPairShift) % 8];
      if (u > 0 && u < cnt) g = static_cast<int>(u);
    }
    any |= g >= 0;
    sm.src[lr][tap] = g;
  }
  if (!__syncthreads_or(any)) {  // no row of the tile reads anything
    for (int e = tid; e < kBM * BN; e += kThreads) {
      const int64_t r = r0 + e / BN;
      const int c = n0 + e % BN;
      if (r < rows && c < cin) store(dx + r * cin + c, 0.f);
    }
    return;
  }

  const int k_steps = (cout + kBK - 1) / kBK;
  const int steps = kTaps * k_steps;
  const bool va = vec_a != 0;
  const bool vb = vec_b != 0;

  // step s into stage st: the tap's gathered cotangent slice, then W_tap's
  // (BN ci) x (32 co) slice
  auto fetch = [&](int st, int s) {
    const int tap = s / k_steps;
    const int k0 = (s - tap * k_steps) * kBK;
    float* a = sm.a[st];
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int q = tid + i * kThreads;
      const int lr = q / kAChunksRow;
      const int kc = (q % kAChunksRow) * 4;
      const int g = sm.src[lr][tap];
      const int k = k0 + kc;
      const int n = g >= 0 ? cout - k : 0;
      copy_chunk(a + lr * S::kAStride + kc,
                 dy + (n > 0 ? static_cast<int64_t>(g) * cout + k : 0), n,
                 va);
    }
    __nv_bfloat16* b = sm.b[st];
    for (int q = tid; q < BN * kBChunksRow; q += kThreads) {
      const int nl = q / kBChunksRow;
      const int kc = (q % kBChunksRow) * 8;
      const int ci = n0 + nl;
      const int k = k0 + kc;
      const int n = ci < cin ? cout - k : 0;
      copy_chunk(b + nl * S::kBStride + kc,
                 w + (n > 0 ? (static_cast<int64_t>(tap) * cin + ci) * cout +
                                  k
                            : 0),
                 n, vb);
    }
  };

  float acc[kMT][kNT][4];   // the current tap
  float sum[kMT][kNT][4];   // the neighbor taps done, each rounded to bf16
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = sum[mt][nt][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) fetch(st, st);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed for every thread; s - 1 is consumed
    const int next = s + kStages - 1;
    if (next < steps) fetch(next % kStages, next);
    cp_async_commit();
    const float* a = sm.a[s % kStages];
    const __nv_bfloat16* b = sm.b[s % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t ah[kMT][4], am[kMT][4], al[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        a_split(ah[mt], am[mt], al[mt], a, S::kAStride,
                warp_m * 32 + mt * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b + (warp_n * kWN + np * 16 + (lane & 7) +
                             ((lane >> 4) << 3)) * S::kBStride +
                            kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float(&c)[4] = acc[mt][2 * np + h];
            mma_bf16(c, ah[mt], bf[2 * h], bf[2 * h + 1]);
            mma_bf16(c, am[mt], bf[2 * h], bf[2 * h + 1]);
            mma_bf16(c, al[mt], bf[2 * h], bf[2 * h + 1]);
          }
      }
    }
    if ((s + 1) % k_steps == 0 && s + 1 < steps) {  // a neighbor tap ends
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[mt][nt][e] += round_bf16(acc[mt][nt][e]);
            acc[mt][nt][e] = 0.f;
          }
    }
  }
  cp_async_wait<0>();

  // epilogue: bf16(bf16(taps) + bf16(center)), in the values' type
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t r =
          r0 + warp_m * 32 + mt * 16 + half * 8 + (lane >> 2);
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = n0 + warp_n * kWN + nt * 8 + (lane & 3) * 2;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (c + j >= cin) continue;
          const float t = round_bf16(sum[mt][nt][half * 2 + j]);
          store(dx + r * cin + c + j,
                round_bf16(t + round_bf16(acc[mt][nt][half * 2 + j])));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dW
// ---------------------------------------------------------------------------

template <typename TIn, int BN>
struct DwSmem {
  // rows of 528 (float32) or 272 (bf16) bytes: the float32 fragment reads
  // below, 8 banks apart from one depth pair to the next, and ldmatrix's
  // 8 rows each hit distinct banks; 16-byte multiples for cp.async
  static constexpr int kAStride = kBM + 16 / static_cast<int>(sizeof(TIn));
  static constexpr int kBStride = BN + 4;
  TIn a[kStages][kBK * kAStride];    // rows: depth (the chunk's rows); m
  float b[kStages][kBK * kBStride];  // rows: depth; Cout
  int src[kStages][kBK][kTaps];      // each row's gathered row, -1 none
};

// A fragment (16 m x 16 depth) of an A stage stored depth-major, rounded to
// bf16 (float32) or through ldmatrix.trans (bf16)
__device__ __forceinline__ void a_fragment_t(uint32_t (&a)[4], const float* s,
                                             int stride, int m, int k,
                                             int lane) {
  const float* p = s + (k + (lane & 3) * 2) * stride + m + (lane >> 2);
  a[0] = pack_bf16(p[0], p[stride]);
  a[1] = pack_bf16(p[8], p[stride + 8]);
  a[2] = pack_bf16(p[8 * stride], p[9 * stride]);
  a[3] = pack_bf16(p[8 * stride + 8], p[9 * stride + 8]);
}

__device__ __forceinline__ void a_fragment_t(uint32_t (&a)[4],
                                             const __nv_bfloat16* s,
                                             int stride, int m, int k,
                                             int lane) {
  ldmatrix_x4_trans(a, s + (k + (lane & 7) + ((lane >> 4) << 3)) * stride +
                           m + ((lane >> 3) & 1) * 8);
}

// B fragments (16 depth x 8 n) of a float32 stage stored depth-major,
// split in three
__device__ __forceinline__ void b_split(uint32_t (&hi)[2], uint32_t (&mid)[2],
                                        uint32_t (&lo)[2], const float* s,
                                        int stride, int n, int k, int lane) {
  const float* p = s + (k + (lane & 3) * 2) * stride + n + (lane >> 2);
  split3(hi[0], mid[0], lo[0], p[0], p[stride]);
  split3(hi[1], mid[1], lo[1], p[8 * stride], p[9 * stride]);
}

template <typename TIn, int BN>
__global__ void __launch_bounds__(kThreads, 2)
lattice_conv_dw_kernel(const TIn* __restrict__ values,
                       const int64_t* __restrict__ idx, int64_t idx_stride,
                       const float* __restrict__ dy,
                       const int64_t* __restrict__ count_ptr,
                       int64_t count_imm, float* __restrict__ partial,
                       int rows, int cin, int cout, int chunk_rows, int vec_a,
                       int vec_b) {
  using S = DwSmem<TIn, BN>;
  constexpr int kWN = BN / 2;
  constexpr int kNT = kWN / 8;
  constexpr int kAElems = 16 / sizeof(TIn);
  constexpr int kAChunksRow = kBM / kAElems;
  constexpr int kAChunks = kBK * kAChunksRow / kThreads;
  constexpr int kBChunksRow = BN / 4;
  constexpr int kSlab = kBK * kTaps;
  constexpr int kSlabPer = (kSlab + kThreads - 1) / kThreads;
  static_assert(kAChunks * kThreads == kBK * kAChunksRow, "whole A chunks");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;
  const int m_total = kTaps * cin;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * BN;
  int64_t cnt = count_ptr != nullptr ? *count_ptr : count_imm;
  if (cnt > rows) cnt = rows;
  const int64_t rb = static_cast<int64_t>(blockIdx.z) * chunk_rows;
  if (rb >= cnt) return;  // past the occupied rows: the sum skips the chunk
  const int64_t re = rb + chunk_rows < cnt ? rb + chunk_rows : cnt;
  const int steps = static_cast<int>((re - rb + kBK - 1) / kBK);
  const bool va = vec_a != 0;
  const bool vb = vec_b != 0;

  // the table entries of step s's rows (-1 for rows 0 and from count on,
  // whose dY is zero), loaded a step before the fetch that uses them
  auto slab_load = [&](int s, int64_t (&u)[kSlabPer]) {
#pragma unroll
    for (int i = 0; i < kSlabPer; ++i) {
      const int e = tid + i * kThreads;
      u[i] = -1;
      if (e < kSlab && s < steps) {
        const int64_t r = rb + static_cast<int64_t>(s) * kBK + e / kTaps;
        const int tap = e % kTaps;
        if (r > 0 && r < re)
          u[i] = tap == kTaps - 1 ? r : idx[r * idx_stride + tap];
      }
    }
  };
  auto slab_store = [&](int st, const int64_t (&u)[kSlabPer]) {
#pragma unroll
    for (int i = 0; i < kSlabPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < kSlab)
        sm.src[st][e / kTaps][e % kTaps] =
            u[i] >= 0 && u[i] < rows ? static_cast<int>(u[i]) : -1;
    }
  };

  // step s into stage st (whose slab holds step s's entries): the
  // gathered values (32 rows x 128 m, m = tap Cin + ci), then dY's slice
  auto fetch = [&](int st, int s) {
    const int64_t rs = rb + static_cast<int64_t>(s) * kBK;
    TIn* a = sm.a[st];
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int q = tid + i * kThreads;
      const int kr = q / kAChunksRow;
      const int mc = (q % kAChunksRow) * kAElems;
      const int m = m0 + mc;
      TIn* dst = a + kr * S::kAStride + mc;
      if (va) {  // Cin a multiple of a chunk: one tap, contiguous
        int g = -1, ci = 0;
        if (m < m_total) {
          const int tap = m / cin;
          ci = m - tap * cin;
          g = sm.src[st][kr][tap];
        }
        cp_async16(dst, values + (g >= 0 ? static_cast<int64_t>(g) * cin + ci
                                         : 0),
                   g >= 0 ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < kAElems; ++e) {
          const int me = m + e;
          TIn x = TIn(0.f);
          if (me < m_total) {
            const int tap = me / cin;
            const int g = sm.src[st][kr][tap];
            if (g >= 0) x = values[static_cast<int64_t>(g) * cin + me -
                                   tap * cin];
          }
          dst[e] = x;
        }
      }
    }
    float* b = sm.b[st];
    for (int q = tid; q < kBK * kBChunksRow; q += kThreads) {
      const int kr = q / kBChunksRow;
      const int nc = (q % kBChunksRow) * 4;
      const int64_t r = rs + kr;
      const int col = n0 + nc;
      const int n = r > 0 && r < re ? cout - col : 0;
      copy_chunk(b + kr * S::kBStride + nc, dy + (n > 0 ? r * cout + col : 0),
                 n, vb);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  int64_t u[kSlabPer];
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    slab_load(st, u);
    slab_store(st, u);
  }
  __syncthreads();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) fetch(st, st);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; s - 1 is consumed; slab s + 2 stored
    slab_load(s + kStages, u);
    const int next = s + kStages - 1;
    if (next < steps) fetch(next % kStages, next);
    cp_async_commit();
    const TIn* a = sm.a[s % kStages];
    const float* b = sm.b[s % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        a_fragment_t(af[mt], a, S::kAStride, warp_m * 32 + mt * 16, kk, lane);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t bh[2], bm[2], bl[2];
        b_split(bh, bm, bl, b, S::kBStride, warp_n * kWN + nt * 8, kk, lane);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][nt], af[mt], bh[0], bh[1]);
          mma_bf16(acc[mt][nt], af[mt], bm[0], bm[1]);
          mma_bf16(acc[mt][nt], af[mt], bl[0], bl[1]);
        }
      }
    }
    // slab s + 3 replaces slab s, whose fetch ended two steps ago
    slab_store(s % kStages, u);
  }
  cp_async_wait<0>();

  float* out = partial + static_cast<int64_t>(blockIdx.z) * m_total * cout;
  const bool even = (cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * 32 + mt * 16 + half * 8 + (lane >> 2);
      if (m >= m_total) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = n0 + warp_n * kWN + nt * 8 + (lane & 3) * 2;
        if (c >= cout) continue;
        float* o = out + static_cast<int64_t>(m) * cout + c;
        if (even) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[mt][nt][half * 2], acc[mt][nt][half * 2 + 1]);
        } else {
          o[0] = acc[mt][nt][half * 2];
          if (c + 1 < cout) o[1] = acc[mt][nt][half * 2 + 1];
        }
      }
    }
  }
}

// dW = bf16(the live chunks' partials added in chunk order), in the
// weight's type
template <typename TOut>
__global__ void lattice_conv_dw_sum_kernel(
    const float* __restrict__ partial, const int64_t* __restrict__ count_ptr,
    int64_t count_imm, TOut* __restrict__ dw, int64_t n, int rows,
    int chunk_rows, int chunks) {
  int64_t cnt = count_ptr != nullptr ? *count_ptr : count_imm;
  if (cnt > rows) cnt = rows;
  int live = 0;
  if (cnt > 0) {
    const int64_t c = (cnt + chunk_rows - 1) / chunk_rows;
    live = c < chunks ? static_cast<int>(c) : chunks;
  }
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
#pragma unroll 4
    for (int c = 0; c < live; ++c) s += partial[c * n + i];
    store(dw + i, round_bf16(s));
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename TOut, int BN>
int launch_dx(const void* dy, const void* idx, int64_t idx_stride,
              const void* w, const void* count, int64_t count_imm, void* dx,
              int rows, int cin, int cout, int vec_a, int vec_b,
              cudaStream_t stream) {
  constexpr int kBytes = static_cast<int>(sizeof(DxSmem<BN>));
  static std::atomic<uint64_t> set_on{0};
  const int e = allow_smem(lattice_conv_dx_kernel<TOut, BN>, kBytes, set_on);
  if (e != 0) return e;
  const dim3 grid((cin + BN - 1) / BN, (rows + kBM - 1) / kBM);
  lattice_conv_dx_kernel<TOut, BN><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(dy), static_cast<const int64_t*>(idx),
      idx_stride, static_cast<const __nv_bfloat16*>(w),
      static_cast<const int64_t*>(count), count_imm, static_cast<TOut*>(dx),
      rows, cin, cout, vec_a, vec_b);
  return tln_last_error();
}

template <typename TOut>
int launch_dx_bn(int bn, const void* dy, const void* idx, int64_t idx_stride,
                 const void* w, const void* count, int64_t count_imm,
                 void* dx, int rows, int cin, int cout, int vec_a, int vec_b,
                 cudaStream_t stream) {
  switch (bn) {
    case 32:
      return launch_dx<TOut, 32>(dy, idx, idx_stride, w, count, count_imm, dx,
                                 rows, cin, cout, vec_a, vec_b, stream);
    case 64:
      return launch_dx<TOut, 64>(dy, idx, idx_stride, w, count, count_imm, dx,
                                 rows, cin, cout, vec_a, vec_b, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TIn, int BN>
int launch_dw(const void* values, const void* idx, int64_t idx_stride,
              const void* dy, const void* count, int64_t count_imm,
              void* partial, int rows, int cin, int cout, int chunk_rows,
              int chunks, int vec_a, int vec_b, cudaStream_t stream) {
  constexpr int kBytes = static_cast<int>(sizeof(DwSmem<TIn, BN>));
  static std::atomic<uint64_t> set_on{0};
  const int e = allow_smem(lattice_conv_dw_kernel<TIn, BN>, kBytes, set_on);
  if (e != 0) return e;
  const dim3 grid((cout + BN - 1) / BN, (kTaps * cin + kBM - 1) / kBM,
                  chunks);
  lattice_conv_dw_kernel<TIn, BN><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const TIn*>(values), static_cast<const int64_t*>(idx),
      idx_stride, static_cast<const float*>(dy),
      static_cast<const int64_t*>(count), count_imm,
      static_cast<float*>(partial), rows, cin, cout, chunk_rows, vec_a,
      vec_b);
  return tln_last_error();
}

template <typename TIn>
int launch_dw_bn(int bn, const void* values, const void* idx,
                 int64_t idx_stride, const void* dy, const void* count,
                 int64_t count_imm, void* partial, int rows, int cin,
                 int cout, int chunk_rows, int chunks, int vec_a, int vec_b,
                 cudaStream_t stream) {
  switch (bn) {
    case 32:
      return launch_dw<TIn, 32>(values, idx, idx_stride, dy, count, count_imm,
                                partial, rows, cin, cout, chunk_rows, chunks,
                                vec_a, vec_b, stream);
    case 64:
      return launch_dw<TIn, 64>(values, idx, idx_stride, dy, count, count_imm,
                                partial, rows, cin, cout, chunk_rows, chunks,
                                vec_a, vec_b, stream);
    case 96:
      return launch_dw<TIn, 96>(values, idx, idx_stride, dy, count, count_imm,
                                partial, rows, cin, cout, chunk_rows, chunks,
                                vec_a, vec_b, stream);
    case 128:
      return launch_dw<TIn, 128>(values, idx, idx_stride, dy, count,
                                 count_imm, partial, rows, cin, cout,
                                 chunk_rows, chunks, vec_a, vec_b, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TOut>
int launch_dw_sum(const void* partial, const void* count, int64_t count_imm,
                  void* dw, int64_t n, int rows, int chunk_rows, int chunks,
                  cudaStream_t stream) {
  constexpr int kSumThreads = 256;
  const int64_t want = (n + kSumThreads - 1) / kSumThreads;
  const unsigned blocks = static_cast<unsigned>(want < 65535 ? want : 65535);
  lattice_conv_dw_sum_kernel<TOut><<<blocks, kSumThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const int64_t*>(count),
      count_imm, static_cast<TOut*>(dw), n, rows, chunk_rows, chunks);
  return tln_last_error();
}

}  // namespace

// dy: (rows, cout) float32 contiguous, the cotangent; idx: (rows, >= 8)
// int64 with row stride idx_stride; w: (9 cin, cout) bf16 contiguous;
// count: a () int64 on the device, or null to use count_imm; dx: (rows,
// cin) float32 (dx_bf16 = 0) or bf16.  bn: the tile width (32 or 64);
// vec_a: cout a multiple of 4 and dy 16-byte aligned; vec_b: cout a
// multiple of 8 and w 16-byte aligned.
TLN_API int tln_lattice_conv_dx(const void* dy, const void* idx,
                                int64_t idx_stride, const void* w,
                                const void* count, int64_t count_imm,
                                void* dx, int dx_bf16, int rows, int cin,
                                int cout, int bn, int vec_a, int vec_b,
                                void* stream) {
  if (rows <= 0 || cin <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dx_bf16)
    return launch_dx_bn<__nv_bfloat16>(bn, dy, idx, idx_stride, w, count,
                                       count_imm, dx, rows, cin, cout, vec_a,
                                       vec_b, s);
  return launch_dx_bn<float>(bn, dy, idx, idx_stride, w, count, count_imm,
                             dx, rows, cin, cout, vec_a, vec_b, s);
}

// values: (rows, cin) float32 (values_bf16 = 0) or bf16, contiguous; idx,
// count as above; dy: (rows, cout) float32 contiguous; partial: (chunks,
// 9 cin, cout) float32 scratch; dw: (9 cin, cout) float32 (dw_bf16 = 0) or
// bf16.  Chunk c holds rows [c chunk_rows, (c + 1) chunk_rows); bn: the
// tile width (32, 64, 96 or 128); vec_a: cin a multiple of a 16-byte
// chunk's elements and values 16-byte aligned; vec_b: cout a multiple of 4
// and dy 16-byte aligned.
TLN_API int tln_lattice_conv_dw(const void* values, int values_bf16,
                                const void* idx, int64_t idx_stride,
                                const void* dy, const void* count,
                                int64_t count_imm, void* partial, void* dw,
                                int dw_bf16, int rows, int cin, int cout,
                                int bn, int chunk_rows, int chunks, int vec_a,
                                int vec_b, void* stream) {
  const int64_t n = static_cast<int64_t>(kTaps) * cin * cout;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0 && chunks > 0) {
    const int e =
        values_bf16
            ? launch_dw_bn<__nv_bfloat16>(bn, values, idx, idx_stride, dy,
                                          count, count_imm, partial, rows,
                                          cin, cout, chunk_rows, chunks,
                                          vec_a, vec_b, s)
            : launch_dw_bn<float>(bn, values, idx, idx_stride, dy, count,
                                  count_imm, partial, rows, cin, cout,
                                  chunk_rows, chunks, vec_a, vec_b, s);
    if (e != 0) return e;
  }
  if (dw_bf16)
    return launch_dw_sum<__nv_bfloat16>(partial, count, count_imm, dw, n,
                                        rows, chunk_rows, chunks, s);
  return launch_dw_sum<float>(partial, count, count_imm, dw, n, rows,
                              chunk_rows, chunks, s);
}
