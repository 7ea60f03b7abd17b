// K6: the one-hop lattice convolution in bf16 as one gather-GEMM on the
// tensor cores.
//
//   out[r] = sum over tap of bf16(values[idx(r, tap)]) @ W[tap] + bias
//
// accumulated in float32, for taps in gather_rowified's order: the 8
// neighbors of idx[r, :8], then the row r itself; W is the (9 Cin, Cout)
// weight rounded to bf16 by the wrapper.  Rows 0 and from `count` up are
// written as zero (mask_rows); `count` is read from device memory, so no
// host sync is needed and a CUDA graph replays it as captured.
//
// It replaces no Pallas kernel: the JAX package leaves this product to
// XLA's dot over the gathered (C, 9 Cin) rows.  It was added because the
// port's PyTorch version of that chain wrote the rows to device memory
// (an 8-tap gather, a concatenation with the center, two float32 upcasts)
// and then multiplied them on float32 FFMA, since TF32 is off: a bf16 value
// upcast is exact, so that product is bf16 x bf16 summed in float32, which
// is what a tensor core computes.
//
// Bound on the H100: at the main path's shapes (C = 12,288-49,152 rows,
// Cin and Cout 64-256) 2 C 9 Cin Cout operations against reading the
// values table once (4 Cin bytes a row as float32), the weight once and
// writing the float32 output (4 Cout bytes a row): 130-370 operations a
// byte, so operations bound the wider convolutions (at 989 TFLOP/s) and
// bytes the 64-channel ones (at 3.35 TB/s).  The gather itself reads each
// row nine times, which the 50 MB L2 mostly serves; what a block waits on
// is the latency of those dependent, scattered row reads.
//
// Design: a block computes a 128-row x BN-column tile (BN 32, 64, 96 or
// 128 by Cout) with 8 warps of mma.sync m16n8k16 (bf16 in, float32
// accumulators in registers).  The depth runs over the 9 taps x Cin in
// steps of 32: each step copies its 128 rows' slice of one tap (the rows
// named by the block's gather indices, which sit in shared memory) and the
// weight's 32 x BN slice into shared memory with cp.async, three steps in
// flight, so the gather's latency overlaps two steps of products.  Float32
// values stay float32 in shared memory and are rounded to bf16 (round to
// nearest even, as Tensor.to(torch.bfloat16)) as the A fragments are
// read; bf16 values and the weight go through ldmatrix.  No (C, 9 Cin)
// buffer exists, and the rows of a tile past `count` are neither gathered
// nor multiplied.  Cin and Cout need not be multiples of anything: the
// depth is padded with zeros in shared memory and the edges are masked;
// where a width or a pointer does not allow 16-byte copies, that operand's
// elements are loaded one by one into the same stages.
#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int kBM = 128;          // rows per block
constexpr int kBK = 32;           // depth per step
constexpr int kStages = 3;        // steps in flight
constexpr int kThreads = 256;     // 8 warps: 4 along the rows x 2 along Cout
constexpr int kTaps = 9;

// Elements a row of an A stage, which holds the values' type: float32 rows
// of 160 bytes (each half-warp's 8-byte fragment reads below hit 32
// distinct banks), bf16 rows of 80 (ldmatrix conflict-free); both 16-byte
// multiples for cp.async.
constexpr int kAStride = kBK + 8;

// A fragment (16 rows x 16 depth) of a float32 stage, rounded to bf16
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const float* s,
                                           int row, int k, int lane) {
  const float* p = s + (row + (lane >> 2)) * kAStride + k + (lane & 3) * 2;
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * kAStride);
  const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 x3 = *reinterpret_cast<const float2*>(p + 8 * kAStride + 8);
  a[0] = pack_bf16(x0.x, x0.y);
  a[1] = pack_bf16(x1.x, x1.y);
  a[2] = pack_bf16(x2.x, x2.y);
  a[3] = pack_bf16(x3.x, x3.y);
}

__device__ __forceinline__ void a_fragment(uint32_t (&a)[4],
                                           const __nv_bfloat16* s, int row,
                                           int k, int lane) {
  ldmatrix_x4(a, s + (row + (lane & 15)) * kAStride + k + (lane >> 4) * 8);
}

template <typename TIn, int BN>
struct Smem {
  static constexpr int kBStride = BN + 8;  // bf16; 16-byte multiple rows
  TIn a[kStages][kBM * kAStride];
  __nv_bfloat16 b[kStages][kBK * kBStride];
  int idx[kBM][kTaps];
};

template <typename TIn, int BN>
__global__ void __launch_bounds__(kThreads, 2)
lattice_conv_kernel(const TIn* __restrict__ values,
                    const int64_t* __restrict__ idx, int64_t idx_stride,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    const int64_t* __restrict__ count_ptr, int64_t count_imm,
                    float* __restrict__ out, int rows, int cin, int cout,
                    int vec_a, int vec_b) {
  using S = Smem<TIn, BN>;
  constexpr int kWN = BN / 2;                 // columns per warp
  constexpr int kNT = kWN / 8;                // n8 tiles per warp
  constexpr int kMT = 2;                      // m16 tiles per warp (32 rows)
  constexpr int kAElems = 16 / sizeof(TIn);   // elements of an A chunk
  constexpr int kAChunksRow = kBK / kAElems;
  constexpr int kAChunks = kBM * kAChunksRow / kThreads;
  constexpr int kBChunksRow = BN / 8;
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

  if (r0 >= cnt) {  // the whole tile lies past the occupied rows
    for (int e = tid; e < kBM * BN; e += kThreads) {
      const int64_t r = r0 + e / BN;
      const int c = n0 + e % BN;
      if (r < rows && c < cout) out[r * cout + c] = 0.f;
    }
    return;
  }

  // gather indices of the tile's rows, -1 where nothing is read (rows 0
  // and past count, whose outputs are zero; out-of-range neighbors)
  for (int e = tid; e < kBM * kTaps; e += kThreads) {
    const int lr = e / kTaps;
    const int tap = e % kTaps;
    const int64_t r = r0 + lr;
    int g = -1;
    if (r > 0 && r < cnt) {
      if (tap == kTaps - 1) {
        g = static_cast<int>(r);
      } else {
        const int64_t v = idx[r * idx_stride + tap];
        if (v >= 0 && v < rows) g = static_cast<int>(v);
      }
    }
    sm.idx[lr][tap] = g;
  }
  __syncthreads();

  const int k_steps = (cin + kBK - 1) / kBK;
  const int steps = kTaps * k_steps;
  const bool va = vec_a != 0;
  const bool vb = vec_b != 0;

  // step s into stage st: the gathered A slice, then the weight slice
  auto fetch = [&](int st, int s) {
    const int tap = s / k_steps;
    const int k0 = (s - tap * k_steps) * kBK;
    TIn* a = sm.a[st];
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int q = tid + i * kThreads;
      const int lr = q / kAChunksRow;
      const int kc = (q % kAChunksRow) * kAElems;
      const int g = sm.idx[lr][tap];
      const int k = k0 + kc;
      const int n = g >= 0 ? cin - k : 0;
      copy_chunk(a + lr * kAStride + kc,
                 values + (n > 0 ? static_cast<int64_t>(g) * cin + k : 0), n,
                 va);
    }
    __nv_bfloat16* b = sm.b[st];
    for (int q = tid; q < kBK * kBChunksRow; q += kThreads) {
      const int kr = q / kBChunksRow;
      const int nc = (q % kBChunksRow) * 8;
      const int kk = k0 + kr;
      const int col = n0 + nc;
      const int n = kk < cin ? cout - col : 0;
      copy_chunk(b + kr * S::kBStride + nc,
                 w + (n > 0 ? (static_cast<int64_t>(tap) * cin + kk) * cout +
                                  col
                            : 0),
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
    const TIn* a = sm.a[s % kStages];
    const __nv_bfloat16* b = sm.b[s % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        a_fragment(af[mt], a, warp_m * 32 + mt * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, b + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * S::kBStride +
                    warp_n * kWN + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: bias, the row mask, float32 stores
  const bool even = (cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t r =
          r0 + warp_m * 32 + mt * 16 + half * 8 + (lane >> 2);
      if (r >= rows) continue;
      const bool keep = r > 0 && r < cnt;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = n0 + warp_n * kWN + nt * 8 + (lane & 3) * 2;
        if (c >= cout) continue;
        float v0 = 0.f, v1 = 0.f;
        if (keep) {
          v0 = acc[mt][nt][half * 2];
          v1 = acc[mt][nt][half * 2 + 1];
          if (bias != nullptr) {
            v0 += bias[c];
            if (c + 1 < cout) v1 += bias[c + 1];
          }
        }
        float* o = out + r * cout + c;
        if (even) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (c + 1 < cout) o[1] = v1;
        }
      }
    }
  }
}

template <typename TIn, int BN>
int launch(const void* values, const void* idx, int64_t idx_stride,
           const void* w, const void* bias, const void* count,
           int64_t count_imm, void* out, int rows, int cin, int cout,
           int vec_a, int vec_b, cudaStream_t stream) {
  constexpr int kBytes = static_cast<int>(sizeof(Smem<TIn, BN>));
  static std::atomic<uint64_t> set_on{0};
  const int e = allow_smem(lattice_conv_kernel<TIn, BN>, kBytes, set_on);
  if (e != 0) return e;
  const dim3 grid((cout + BN - 1) / BN, (rows + kBM - 1) / kBM);
  lattice_conv_kernel<TIn, BN><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const TIn*>(values), static_cast<const int64_t*>(idx),
      idx_stride, static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const int64_t*>(count),
      count_imm, static_cast<float*>(out), rows, cin, cout, vec_a, vec_b);
  return tln_last_error();
}

template <typename TIn>
int launch_bn(int bn, const void* values, const void* idx, int64_t idx_stride,
              const void* w, const void* bias, const void* count,
              int64_t count_imm, void* out, int rows, int cin, int cout,
              int vec_a, int vec_b, cudaStream_t stream) {
  switch (bn) {
    case 32:
      return launch<TIn, 32>(values, idx, idx_stride, w, bias, count,
                             count_imm, out, rows, cin, cout, vec_a, vec_b,
                             stream);
    case 64:
      return launch<TIn, 64>(values, idx, idx_stride, w, bias, count,
                             count_imm, out, rows, cin, cout, vec_a, vec_b,
                             stream);
    case 96:
      return launch<TIn, 96>(values, idx, idx_stride, w, bias, count,
                             count_imm, out, rows, cin, cout, vec_a, vec_b,
                             stream);
    case 128:
      return launch<TIn, 128>(values, idx, idx_stride, w, bias, count,
                              count_imm, out, rows, cin, cout, vec_a, vec_b,
                              stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// values: (rows, cin) float32 (values_bf16 = 0) or bf16, contiguous; idx:
// (rows, >= 8) int64 with row stride idx_stride; w: (9 cin, cout) bf16
// contiguous; bias: (cout,) float32 or null; count: a () int64 on the device,
// or null to use count_imm; out: (rows, cout) float32.  bn: the tile width
// (32, 64, 96 or 128); vec_a: cin a multiple of a 16-byte chunk's elements
// and values 16-byte aligned; vec_b: cout a multiple of 8 and w 16-byte
// aligned.
TLN_API int tln_lattice_conv(const void* values, int values_bf16,
                             const void* idx, int64_t idx_stride,
                             const void* w, const void* bias,
                             const void* count, int64_t count_imm, void* out,
                             int rows, int cin, int cout, int bn, int vec_a,
                             int vec_b, void* stream) {
  if (rows <= 0 || cout <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (values_bf16)
    return launch_bn<__nv_bfloat16>(bn, values, idx, idx_stride, w, bias,
                                    count, count_imm, out, rows, cin, cout,
                                    vec_a, vec_b, s);
  return launch_bn<float>(bn, values, idx, idx_stride, w, bias, count,
                          count_imm, out, rows, cin, cout, vec_a, vec_b, s);
}
