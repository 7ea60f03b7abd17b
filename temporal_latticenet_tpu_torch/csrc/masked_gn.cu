// K7: the masked GroupNorm and its ReLU, forward and backward.
//
//   out[r, c] = relu((x[r, c] - mean[g]) * inv[g] * w[c] + b[c])  on rows
//               [1, count), zero on row 0 and from `count` up,
//
// where g is c's group (cpg consecutive channels), mean[g] the float32 sum
// of x over the valid rows and the group's channels divided by n cpg (n the
// valid rows, at least 1), var[g] the sum of the centred squares
// (x - mean)^2 over the same elements divided by n cpg (a second pass: not
// the sum of squares, not Welford), and inv[g] = 1 / sqrt(var + eps).  The
// elementwise arithmetic is the plain path's, rounded at the same places
// (ops/group_norm.masked_group_norm), so the float32 results differ from it
// only by the order of the sums.  The backward, with xh = (x - mean) inv,
// y = xh w + b and g = dy [y > 0] w on the valid rows:
//
//   db[c] = sum over rows of dy [y > 0],  dw[c] = sum of dy [y > 0] xh,
//   dx    = inv (g - S1[g] / (n cpg) - xh S2[g] / (n cpg)),
//
// S1 and S2 the group sums of g and g xh; dx is zero off the valid rows.
// `count` is read from device memory (or given as a number), so nothing
// syncs with the host and a CUDA graph replays a call as captured.
//
// It replaces no Pallas kernel: the JAX package leaves GroupNorm to XLA,
// which fuses it.  The port's plain version launches about 22 operations a
// call (an index range, compares, casts, masked products, two strided
// sums, rsqrt, the affine, a select against zero), each a full pass over
// the (rows, C) float32 array, and its autograd backward about 25 more.
//
// Bound on the H100: bytes.  A forward reads x three times (sum, centred
// squares, normalise) and writes the output once; a backward reads x and
// dy twice and writes dx once.  At the main path's shapes (12.6 MB arrays:
// 49,152 x 64, 24,576 x 128, 12,288 x 256) every pass after the first
// mostly hits the 50 MB L2.
//
// Design: a call is three launches forward and two backward, each over a
// fixed grid of `blocks` blocks of 512 threads, two per SM (against 256
// or 1,024 threads and one or four blocks per SM, the fastest or within 2 %
// of it at each main-path shape on the H100).  A block takes a
// contiguous share of the valid rows; a thread keeps one slot of V = 4 (or
// 1) channels, so a row is read as 16-byte vectors by C / V neighbouring
// threads and a block steps through `rpi` rows at a time.  Each thread sums
// its channels over its rows in registers; the block adds its threads'
// sums in shared memory in a fixed order and writes one partial per group
// (per channel for dw and db) to a workspace.  The next launch adds the
// partials of all blocks in a fixed order (each block again, so no extra
// launch and no grid-wide sync) before its own pass.  No float atomics:
// every call gives the same bits.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// One thread's place in a block: `slot` of `slots` channel slots of V
// channels, row `r` of the `rpi` rows a step covers (r >= rpi: idle).
struct Layout {
  int rows;
  int c;
  int groups;
  int cpg;
  int slots;
  int rpi;
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// The valid rows are [1, end).
__device__ __forceinline__ int valid_end(const int64_t* count_ptr,
                                         int64_t count_imm, int rows) {
  int64_t cnt = count_ptr != nullptr ? *count_ptr : count_imm;
  return static_cast<int>(max(int64_t(1), min(cnt, int64_t(rows))));
}

// n cpg, with n the valid rows clamped to at least 1, as the plain path's
// float32 product.
__device__ __forceinline__ float denominator(int end, int cpg) {
  return static_cast<float>(max(end - 1, 1)) * static_cast<float>(cpg);
}

// This block's contiguous share [lo, hi) of the rows [first, end).
__device__ __forceinline__ void share(int first, int end, int& lo, int& hi) {
  int64_t n = end - first;
  lo = first + static_cast<int>(n * blockIdx.x / gridDim.x);
  hi = first + static_cast<int>(n * (blockIdx.x + 1) / gridDim.x);
}

// xh = (x - mean) inv and y = xh w + b, each product and sum rounded as the
// plain path rounds them (no contraction into FMAs): the forward and both
// backward passes see the same y, so the same ReLU mask.
__device__ __forceinline__ float normalise(float x, float mean, float inv,
                                           float w, float b, float& xh) {
  xh = __fmul_rn(__fsub_rn(x, mean), inv);
  return __fadd_rn(__fmul_rn(xh, w), b);
}

// Writes each thread's V sums into buf[r][c] (the block's rpi x C table).
template <int V>
__device__ __forceinline__ void stage(float* buf, const float (&acc)[V],
                                      const Layout& L, int slot, int r) {
  if (r < L.rpi) {
#pragma unroll
    for (int k = 0; k < V; ++k) buf[r * L.c + slot * V + k] = acc[k];
  }
}

// Channel ch's sum over the block's rows: buf[0][ch] + buf[1][ch] + ...
__device__ __forceinline__ float channel_sum(const float* buf, const Layout& L,
                                             int ch) {
  float s = 0.f;
  for (int r = 0; r < L.rpi; ++r) s += buf[r * L.c + ch];
  return s;
}

// Group g's sum: its channels' sums, in channel order.
__device__ __forceinline__ float group_sum(const float* buf, const Layout& L,
                                           int g) {
  float s = 0.f;
  for (int k = 0; k < L.cpg; ++k) s += channel_sum(buf, L, g * L.cpg + k);
  return s;
}

// out[j] = sum over p of part[p * width + col0 + j] for the 32 columns from
// col0 (those below width), in a fixed order: warp w adds the partials
// w, w + warps, ...; then the warps' sums are added in warp order.  Every
// thread of the block calls it; out may be shared or device memory.
__device__ void reduce_columns(const float* part, int nparts, int width,
                               int col0, float* out) {
  __shared__ float scratch[kWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = col0 + lane;
  float s = 0.f;
  if (col < width) {
    // many loads in flight: the partials sit in L2, and each add waits on
    // one
#pragma unroll 16
    for (int p = warp; p < nparts; p += kWarps) s += part[p * width + col];
  }
  scratch[warp][lane] = s;
  __syncthreads();
  if (threadIdx.x < 32 && col < width) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += scratch[w][threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

// Pass 1: each block's per-group sums of x over its share of the valid
// rows, into part[block][group].
template <int V>
__global__ void __launch_bounds__(kThreads)
masked_gn_sum_kernel(const float* __restrict__ x,
                     const int64_t* __restrict__ count_ptr, int64_t count_imm,
                     Layout L, float* __restrict__ part) {
  extern __shared__ float buf[];
  const int slot = threadIdx.x % L.slots, r = threadIdx.x / L.slots;
  int lo, hi;
  share(1, valid_end(count_ptr, count_imm, L.rows), lo, hi);
  float acc[V] = {};
  if (r < L.rpi) {
    const float* p = x + slot * V;
#pragma unroll 4
    for (int row = lo + r; row < hi; row += L.rpi) {
      float v[V];
      load<V>(p + static_cast<int64_t>(row) * L.c, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += v[k];
    }
  }
  stage<V>(buf, acc, L, slot, r);
  __syncthreads();
  if (threadIdx.x < L.groups)
    part[blockIdx.x * L.groups + threadIdx.x] = group_sum(buf, L, threadIdx.x);
}

// Pass 2: the means from pass 1's partials (block 0 stores them in
// stats[0:G]), then each block's per-group sums of (x - mean)^2 into
// part2[block][group].
template <int V>
__global__ void __launch_bounds__(kThreads)
masked_gn_sq_kernel(const float* __restrict__ x,
                    const int64_t* __restrict__ count_ptr, int64_t count_imm,
                    Layout L, const float* __restrict__ part,
                    float* __restrict__ part2, float* __restrict__ stats) {
  extern __shared__ float buf[];
  __shared__ float mean_s[32];
  const int end = valid_end(count_ptr, count_imm, L.rows);
  reduce_columns(part, gridDim.x, L.groups, 0, mean_s);
  if (threadIdx.x < L.groups) {
    mean_s[threadIdx.x] = mean_s[threadIdx.x] / denominator(end, L.cpg);
    if (blockIdx.x == 0) stats[threadIdx.x] = mean_s[threadIdx.x];
  }
  __syncthreads();
  const int slot = threadIdx.x % L.slots, r = threadIdx.x / L.slots;
  int lo, hi;
  share(1, end, lo, hi);
  float acc[V] = {};
  if (r < L.rpi) {
    float m[V];
#pragma unroll
    for (int k = 0; k < V; ++k) m[k] = mean_s[(slot * V + k) / L.cpg];
    const float* p = x + slot * V;
#pragma unroll 4
    for (int row = lo + r; row < hi; row += L.rpi) {
      float v[V];
      load<V>(p + static_cast<int64_t>(row) * L.c, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = __fsub_rn(v[k], m[k]);
        acc[k] = __fadd_rn(acc[k], __fmul_rn(d, d));
      }
    }
  }
  stage<V>(buf, acc, L, slot, r);
  __syncthreads();
  if (threadIdx.x < L.groups)
    part2[blockIdx.x * L.groups + threadIdx.x] =
        group_sum(buf, L, threadIdx.x);
}

// Pass 3: inv from pass 2's partials (block 0 stores it in stats[G:2G]),
// then every row of the block's share of [0, rows): the ReLU of the affine
// normalisation on the valid rows, zero elsewhere.
template <int V>
__global__ void __launch_bounds__(kThreads)
masked_gn_relu_out_kernel(const float* __restrict__ x,
                          const int64_t* __restrict__ count_ptr,
                          int64_t count_imm, Layout L,
                          const float* __restrict__ weight,
                          const float* __restrict__ bias, float eps,
                          const float* __restrict__ part2,
                          float* __restrict__ stats, float* __restrict__ out) {
  __shared__ float inv_s[32];
  const int end = valid_end(count_ptr, count_imm, L.rows);
  reduce_columns(part2, gridDim.x, L.groups, 0, inv_s);
  if (threadIdx.x < L.groups) {
    const float var = inv_s[threadIdx.x] / denominator(end, L.cpg);
    inv_s[threadIdx.x] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    if (blockIdx.x == 0) stats[L.groups + threadIdx.x] = inv_s[threadIdx.x];
  }
  __syncthreads();
  const int slot = threadIdx.x % L.slots, r = threadIdx.x / L.slots;
  if (r >= L.rpi) return;
  float m[V], iv[V], w[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = slot * V + k, g = ch / L.cpg;
    m[k] = stats[g];
    iv[k] = inv_s[g];
    w[k] = weight[ch];
    b[k] = bias[ch];
  }
  int lo, hi;
  share(0, L.rows, lo, hi);
#pragma unroll 4
  for (int row = lo + r; row < hi; row += L.rpi) {
    float v[V] = {};
    const int64_t at = static_cast<int64_t>(row) * L.c + slot * V;
    if (row >= 1 && row < end) {
      load<V>(x + at, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float xh;
        const float y = normalise(v[k], m[k], iv[k], w[k], b[k], xh);
        v[k] = y > 0.f ? y : 0.f;
      }
    }
    store<V>(out + at, v);
  }
}

// Backward pass 1: each block's per-channel sums of dy [y > 0] and
// dy [y > 0] xh into part_c[block][0:C] and [C:2C], and its per-group sums
// of g and g xh into part_g[block][0:G] and [G:2G].
template <int V>
__global__ void __launch_bounds__(kThreads)
masked_gn_bwd_sums_kernel(const float* __restrict__ x,
                          const float* __restrict__ dy,
                          const int64_t* __restrict__ count_ptr,
                          int64_t count_imm, Layout L,
                          const float* __restrict__ weight,
                          const float* __restrict__ bias,
                          const float* __restrict__ stats,
                          float* __restrict__ part_c,
                          float* __restrict__ part_g) {
  extern __shared__ float buf[];   // two rpi x C tables
  float* buf2 = buf + L.rpi * L.c;
  const int slot = threadIdx.x % L.slots, r = threadIdx.x / L.slots;
  int lo, hi;
  share(1, valid_end(count_ptr, count_imm, L.rows), lo, hi);
  float db[V] = {}, dw[V] = {}, sg[V] = {}, sgx[V] = {};
  if (r < L.rpi) {
    float m[V], iv[V], w[V], b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int ch = slot * V + k, g = ch / L.cpg;
      m[k] = stats[g];
      iv[k] = stats[L.groups + g];
      w[k] = weight[ch];
      b[k] = bias[ch];
    }
#pragma unroll 2
    for (int row = lo + r; row < hi; row += L.rpi) {
      const int64_t at = static_cast<int64_t>(row) * L.c + slot * V;
      float v[V], d[V];
      load<V>(x + at, v);
      load<V>(dy + at, d);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float xh;
        const float y = normalise(v[k], m[k], iv[k], w[k], b[k], xh);
        const float gy = y > 0.f ? d[k] : 0.f;
        const float gg = gy * w[k];
        db[k] += gy;
        dw[k] += gy * xh;
        sg[k] += gg;
        sgx[k] += gg * xh;
      }
    }
  }
  const int nb = blockIdx.x;
  stage<V>(buf, db, L, slot, r);
  stage<V>(buf2, dw, L, slot, r);
  __syncthreads();
  for (int ch = threadIdx.x; ch < L.c; ch += kThreads) {
    part_c[(nb * 2) * L.c + ch] = channel_sum(buf, L, ch);
    part_c[(nb * 2 + 1) * L.c + ch] = channel_sum(buf2, L, ch);
  }
  __syncthreads();
  stage<V>(buf, sg, L, slot, r);
  stage<V>(buf2, sgx, L, slot, r);
  __syncthreads();
  if (threadIdx.x < L.groups) {
    part_g[(nb * 2) * L.groups + threadIdx.x] = group_sum(buf, L, threadIdx.x);
    part_g[(nb * 2 + 1) * L.groups + threadIdx.x] =
        group_sum(buf2, L, threadIdx.x);
  }
}

// Backward pass 2: S1 and S2 from pass 1's group partials; the first blocks
// also add up the channel partials into db and dw (32 columns of the
// (blocks, 2C) partials each); then every row of the block's share of
// [0, rows): dx on the valid rows, zero elsewhere.
template <int V>
__global__ void __launch_bounds__(kThreads)
masked_gn_bwd_dx_kernel(const float* __restrict__ x,
                        const float* __restrict__ dy,
                        const int64_t* __restrict__ count_ptr,
                        int64_t count_imm, Layout L,
                        const float* __restrict__ weight,
                        const float* __restrict__ bias,
                        const float* __restrict__ stats,
                        const float* __restrict__ part_c,
                        const float* __restrict__ part_g,
                        float* __restrict__ dx, float* __restrict__ dw_out,
                        float* __restrict__ db_out) {
  __shared__ float s_s[64];
  __shared__ float col_s[32];
  const int end = valid_end(count_ptr, count_imm, L.rows);
  const float denom = denominator(end, L.cpg);
  for (int col0 = 0; col0 < 2 * L.groups; col0 += 32)
    reduce_columns(part_g, gridDim.x, 2 * L.groups, col0, s_s + col0);
  const int chunks = (2 * L.c + 31) / 32;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    reduce_columns(part_c, gridDim.x, 2 * L.c, chunk * 32, col_s);
    const int col = chunk * 32 + threadIdx.x;
    if (threadIdx.x < 32 && col < 2 * L.c) {
      if (col < L.c) db_out[col] = col_s[threadIdx.x];
      else dw_out[col - L.c] = col_s[threadIdx.x];
    }
  }
  const int slot = threadIdx.x % L.slots, r = threadIdx.x / L.slots;
  if (r >= L.rpi) return;
  float m[V], iv[V], w[V], b[V], m1[V], m2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int ch = slot * V + k, g = ch / L.cpg;
    m[k] = stats[g];
    iv[k] = stats[L.groups + g];
    w[k] = weight[ch];
    b[k] = bias[ch];
    m1[k] = s_s[g] / denom;
    m2[k] = s_s[L.groups + g] / denom;
  }
  int lo, hi;
  share(0, L.rows, lo, hi);
#pragma unroll 2
  for (int row = lo + r; row < hi; row += L.rpi) {
    const int64_t at = static_cast<int64_t>(row) * L.c + slot * V;
    float out[V] = {};
    if (row >= 1 && row < end) {
      float v[V], d[V];
      load<V>(x + at, v);
      load<V>(dy + at, d);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float xh;
        const float y = normalise(v[k], m[k], iv[k], w[k], b[k], xh);
        const float gg = (y > 0.f ? d[k] : 0.f) * w[k];
        out[k] = iv[k] * ((gg - m1[k]) - xh * m2[k]);
      }
    }
    store<V>(dx + at, out);
  }
}

Layout make_layout(int rows, int c, int groups, int vec) {
  Layout L;
  L.rows = rows;
  L.c = c;
  L.groups = groups;
  L.cpg = c / groups;
  L.slots = c / vec;
  L.rpi = kThreads / L.slots;
  return L;
}

template <int V>
int forward(const float* x, const int64_t* count_ptr, int64_t count_imm,
            const float* weight, const float* bias, float eps, float* out,
            float* stats, float* work, const Layout& L, int blocks,
            cudaStream_t stream) {
  float* part = work;
  float* part2 = work + blocks * L.groups;
  const size_t smem = sizeof(float) * L.rpi * L.c;
  masked_gn_sum_kernel<V><<<blocks, kThreads, smem, stream>>>(
      x, count_ptr, count_imm, L, part);
  masked_gn_sq_kernel<V><<<blocks, kThreads, smem, stream>>>(
      x, count_ptr, count_imm, L, part, part2, stats);
  masked_gn_relu_out_kernel<V><<<blocks, kThreads, 0, stream>>>(
      x, count_ptr, count_imm, L, weight, bias, eps, part2, stats, out);
  return tln_last_error();
}

template <int V>
int backward(const float* x, const float* dy, const int64_t* count_ptr,
             int64_t count_imm, const float* weight, const float* bias,
             const float* stats, float* dx, float* dw, float* db, float* work,
             const Layout& L, int blocks, cudaStream_t stream) {
  float* part_c = work;
  float* part_g = work + blocks * 2 * L.c;
  const size_t smem = 2 * sizeof(float) * L.rpi * L.c;
  masked_gn_bwd_sums_kernel<V><<<blocks, kThreads, smem, stream>>>(
      x, dy, count_ptr, count_imm, L, weight, bias, stats, part_c, part_g);
  masked_gn_bwd_dx_kernel<V><<<blocks, kThreads, 0, stream>>>(
      x, dy, count_ptr, count_imm, L, weight, bias, stats, part_c, part_g,
      dx, dw, db);
  return tln_last_error();
}

}  // namespace

// Forward.  x, out: (rows, c) float32, 16-byte aligned rows when vec is 4;
// weight, bias: (c,); stats: (2, groups), written with mean and inv; work:
// 2 * blocks * groups floats.  count_ptr: one int64 on the device, or null
// and count_imm.  c / vec at most 512 (a block's threads), groups at most
// 32, vec 4 or 1.
TLN_API int tln_masked_gn_forward(const float* x, const int64_t* count_ptr,
                                  int64_t count_imm, const float* weight,
                                  const float* bias, float eps, float* out,
                                  float* stats, float* work, int rows, int c,
                                  int groups, int vec, int blocks,
                                  void* stream) {
  const Layout L = make_layout(rows, c, groups, vec);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return forward<4>(x, count_ptr, count_imm, weight, bias, eps, out, stats,
                      work, L, blocks, s);
  return forward<1>(x, count_ptr, count_imm, weight, bias, eps, out, stats,
                    work, L, blocks, s);
}

// Backward.  dy, dx: (rows, c) float32 like x; stats: the forward's; dw,
// db: (c,); work: blocks * 2 * (c + groups) floats.
TLN_API int tln_masked_gn_backward(const float* x, const float* dy,
                                   const int64_t* count_ptr,
                                   int64_t count_imm, const float* weight,
                                   const float* bias, const float* stats,
                                   float* dx, float* dw, float* db,
                                   float* work, int rows, int c, int groups,
                                   int vec, int blocks, void* stream) {
  const Layout L = make_layout(rows, c, groups, vec);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return backward<4>(x, dy, count_ptr, count_imm, weight, bias, stats, dx,
                       dw, db, work, L, blocks, s);
  return backward<1>(x, dy, count_ptr, count_imm, weight, bias, stats, dx,
                     dw, db, work, L, blocks, s);
}
