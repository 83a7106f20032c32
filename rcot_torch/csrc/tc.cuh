// Helpers shared by the port's tensor-core kernels (gram.cu, block_bwd.cu)
// and its cp.async rings (dwconv.cu): asynchronous copies into shared
// memory, 3xTF32 products on mma.sync m16n8k8, and the once-per-device
// raise of a kernel's dynamic shared-memory limit.
//
// 3xTF32: a float x is split into two tf32 values, x = hi + lo + O(2^-22
// |x|), and a product a b is taken as al bh + ah bl + ah bh (al bl, about
// 2^-22 of the product, dropped), each on the tensor cores with fp32
// accumulation: about fp32's accuracy at a third of the TF32 rate.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dst <- src (16, 8 or 4 bytes), or zeros where !in (the source is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
// V floats (V = 4, 2 or 1)
template <int V>
__device__ __forceinline__ void cp_async_v(float* dst, const float* src, bool in) {
  if constexpr (V == 4)
    cp_async16(dst, src, in);
  else if constexpr (V == 2)
    cp_async8(dst, src, in);
  else
    cp_async4(dst, src, in);
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo + O(2^-22 |x|), hi and lo tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d += a b on the tensor cores. Not volatile, so that the compiler may
// interleave independent products and hide each one's latency.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 over a warp's M x N tiles of one 8-deep step: acc[i][j] += a_i b_j
// as al bh + ah bl + ah bh, each term over every tile before the next, so
// that no product waits on the one before it. Tiles outside the matrix
// (use_m, use_n false) are skipped.
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[M][N][4], uint32_t (&ah)[M][4],
                                           uint32_t (&al)[M][4], uint32_t (&bh)[N][2],
                                           uint32_t (&bl)[N][2], const bool (&use_m)[M],
                                           const bool (&use_n)[N]) {
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (use_m[i] && use_n[j])
          mma_tf32(acc[i][j], term == 0 ? al[i] : ah[i], term == 1 ? bl[j] : bh[j]);
}

// Raise the dynamic shared-memory limit of a kernel's two variants to
// `floats`, once per device (the attribute is the device's): `done` is the
// caller's function-local flags. A failure is returned and tried again on
// the next call.
constexpr int kMaxDevices = 64;
constexpr int kMaxSmemBytes = 232448;  // a block's most on sm_90 (227 KB)

template <typename Kernel>
cudaError_t allow_smem(bool (&done)[kMaxDevices], Kernel k1, Kernel k2, int floats) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  const Kernel ks[2] = {k1, k2};
  for (int i = 0; i < 2; ++i) {
    e = cudaFuncSetAttribute(ks[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(float) * floats);
    if (e != cudaSuccess) return e;
  }
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

}  // namespace
