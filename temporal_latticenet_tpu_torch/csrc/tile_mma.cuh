// Shared by the tensor-core gather-GEMMs (K6 in lattice_conv.cu, its
// backward in lattice_conv_bwd.cu): cp.async copies into shared memory,
// ldmatrix loads and the mma.sync m16n8k16 product of bf16 fragments into
// float32 accumulators (sm_80 instructions, which sm_90a runs), and the
// host-side opt-in to more than 48 KB of dynamic shared memory a block.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled past `bytes` (0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-byte chunk of elements of type T from src, of which the first n
// exist, into dst: by cp.async (vec: 16-byte aligned, n >= the chunk's
// elements or <= 0; src is then still a valid address) or element by
// element.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int n,
                                           bool vec) {
  constexpr int kElems = 16 / sizeof(T);
  if (vec) {
    cp_async16(dst, src, n > 0 ? 16 : 0);
    return;
  }
#pragma unroll
  for (int e = 0; e < kElems; ++e) dst[e] = e < n ? src[e] : T(0.f);
}

template <typename K>
int allow_smem(K kernel, int bytes, std::atomic<uint64_t>& set_on) {
  // above 48 KB a block's dynamic shared memory needs the attribute (a
  // host-side setting of the current device, not a stream operation): set
  // once for each device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!bit || !(set_on.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    set_on.fetch_or(bit, std::memory_order_release);
  }
  return 0;
}

}  // namespace
