// K1: fused elevate + enclosing simplex + key pack, one thread per point.
//
// Replaces the Pallas TPU kernel temporal_latticenet_tpu/ops/pallas_simplex.py
// :_simplex_kernel (wrapper fused_simplex_pack).  The TPU kernel worked on
// (rows, 128) coordinate planes; here each thread reads one point's three
// pre-scaled coordinates and its mask byte and writes the (N, 4) int64 packed
// keys and (N, 4) float32 barycentric weights in the port's row layout.
//
// Bound on the H100: bytes.  Per point it reads 13 bytes and writes 48
// (61 B/point; at 524,288 points 32 MB, about 10 us at 3.35 TB/s); the
// arithmetic (~150 float/int operations per point) is far below the
// compute roofline.  Design for that bound: no shared memory and no
// cross-thread state, 16-byte vector stores for the outputs, one pass.
//
// Bit-exactness: keys and weights must equal the float32 reference
// (permutohedral.elevate_scaled + find_enclosing_simplex + pack_keys) bit for
// bit.  The file is compiled with --fmad=false so no multiply-add contracts,
// and the order of every add follows the reference: the reversed-cumsum
// elevate and the pairwise-tree sum in bary_ext.
#include "common.cuh"

namespace {

constexpr int kBias = 512;
constexpr int kMmax = 1021;
constexpr long long kSentinel = 0xFFFFFFFFLL;

__global__ void simplex_kernel(const float* __restrict__ y,
                               const uint8_t* __restrict__ mask, int64_t n,
                               int64_t* __restrict__ packed,
                               float* __restrict__ bary) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float y0 = y[3 * p];
  const float y1 = y[3 * p + 1];
  const float y2 = y[3 * p + 2];

  // elevate: suffix sums in the reversed-cumsum order
  const float t2 = y2;
  const float t1 = y2 + y1;
  const float t0 = t1 + y0;
  const float e[4] = {t0, t1 - 1.0f * y0, t2 - 2.0f * y1, 0.0f - 3.0f * y2};

  // round each coordinate to the nearest multiple of 4
  float remf[4];
  int remi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = e[i] / 4.0f;
    const float up = ceilf(v) * 4.0f;
    const float down = floorf(v) * 4.0f;
    const float rf = (up - e[i] < e[i] - down) ? up : down;
    remf[i] = rf;
    remi[i] = static_cast<int>(rf);
  }
  const int sum_g = ((remi[0] + remi[1]) + (remi[2] + remi[3])) >> 2;

  // rank of each rounding residual (ties by index), then hyperplane walk
  float diff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) diff[i] = e[i] - remf[i];
  int rank[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j == i) continue;
      r += (j > i) ? (diff[j] > diff[i]) : (diff[j] >= diff[i]);
    }
    rank[i] = r + sum_g;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int adj = (rank[i] < 0 ? 4 : 0) - (rank[i] > 3 ? 4 : 0);
    remi[i] += adj;
    rank[i] += adj;
  }

  // barycentric weights from the ranked residuals
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    delta[i] = (e[i] - static_cast<float>(remi[i])) / 4.0f;
  float b[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    float t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = (rank[i] == 3 - k) ? 1.0f : 0.0f;
      const float hi = (rank[i] == 4 - k) ? 1.0f : 0.0f;
      t[i] = delta[i] * (lo - hi);
    }
    b[k] = (t[0] + t[1]) + (t[2] + t[3]);
  }
  b[0] = b[0] + (1.0f + b[4]);
  reinterpret_cast<float4*>(bary)[p] = make_float4(b[0], b[1], b[2], b[3]);

  // packed key per remainder r; rem0 coordinates are exact multiples of 4
  const bool ok_mask = mask[p] != 0;
  int mb[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) mb[j] = (remi[j] >> 2) + kBias;
  long long out[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    bool ok = ok_mask;
    long long a[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[j] = mb[j] - (rank[j] > 3 - r ? 1 : 0);
      ok = ok && a[j] >= 0 && a[j] <= kMmax;
    }
    out[r] = ok ? ((a[0] << 22) | (a[1] << 12) | (a[2] << 2) | r) : kSentinel;
  }
  longlong2* dst = reinterpret_cast<longlong2*>(packed + 4 * p);
  dst[0] = make_longlong2(out[0], out[1]);
  dst[1] = make_longlong2(out[2], out[3]);
}

}  // namespace

TLN_API int tln_fused_simplex(const void* y, const void* mask, int64_t n,
                              void* packed, void* bary, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  simplex_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const uint8_t*>(mask), n,
      static_cast<int64_t*>(packed), static_cast<float*>(bary));
  return tln_last_error();
}
