// Helpers shared by the port's tensor-core kernels (gram.cu, mdta.cu and,
// through mm.cuh, the block and fused kernels) and its cp.async rings
// (dwconv.cu): asynchronous copies into shared memory, 3xTF32 products on
// mma.sync m16n8k8, the channel blocks of a wide head and the fixed-order
// sum of a tensor's slots, and the once-per-device raise of a kernel's
// dynamic shared-memory limit; for the bf16 kernels (block_fwd_bf16.cu,
// gram_bf16.cu) the conversions, copies of any byte width, ldmatrix and
// bf16 products on mma.sync m16n8k16 with fp32 accumulation; for the
// backward products' bf16-operand policy the rounding of an operand into a
// tf32 fragment and a one-term product (bf16_tf32, mma_1xtf32); and the
// GDFN's gate (gate_fwd).
//
// 3xTF32: a float x is split into two tf32 values, x = hi + lo + O(2^-22
// |x|), and a product a b is taken as al bh + ah bl + ah bh (al bl, about
// 2^-22 of the product, dropped), each on the tensor cores with fp32
// accumulation: about fp32's accuracy at a third of the TF32 rate.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

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
// dst <- BYTES (16, 8 or 4) bytes at src, or zeros where !in
template <int BYTES>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, bool in) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(in ? BYTES : 0));
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

// x = hi + lo exactly, hi = x rounded to tf32 (to nearest, ties away from
// zero) by integer ops on its bits; lo goes to the tensor cores as it is,
// and they read its top 19 bits (|error| <= 2^-21 |x|, of either sign).
// Two integer ops and a subtraction, where two cvt.rna.tf32 and a
// subtraction (split_tf32) made the conversions the products' limit
// (mm.cuh, mdta.cu).
__device__ __forceinline__ void split_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
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
// (use_m, use_n false) are skipped. A_EXACT: every a is exact in tf32 (a
// bf16 value widened), so al is zero and its term, which adds exact zeros,
// is left out: two mma.sync a step, the same sums (al is not read); B_EXACT
// the same for b (bl is not read); both, one mma.sync a step.
template <int M, int N, bool A_EXACT = false, bool B_EXACT = false>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[M][N][4], uint32_t (&ah)[M][4],
                                           uint32_t (&al)[M][4], uint32_t (&bh)[N][2],
                                           uint32_t (&bl)[N][2], const bool (&use_m)[M],
                                           const bool (&use_n)[N]) {
#pragma unroll
  for (int term = A_EXACT ? 1 : 0; term < 3; ++term) {
    if (B_EXACT && term == 1) continue;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (use_m[i] && use_n[j])
          mma_tf32(acc[i][j], term == 0 ? al[i] : ah[i], term == 1 ? bl[j] : bh[j]);
  }
}

// The bf16-operand policy of the backward products (RCOT_BWD_BF16 in the
// JAX package, rcot_tpu/ops/pallas_fused.py _bwd_dot): x rounded to bf16
// (to nearest, ties to even) and handed to the tensor cores as a tf32
// value. A bf16 value is exact in tf32, so one tf32 mma.sync m16n8k8 on two
// such operands takes exactly the bf16 x bf16 products, with fp32 sums.
__device__ __forceinline__ uint32_t bf16_tf32(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x)) << 16;
}

// A bf16 value as a tf32 operand: its bits widened, exact.
__device__ __forceinline__ uint32_t widen_tf32(bf16 x) {
  return (uint32_t)__bfloat16_as_ushort(x) << 16;
}

// One tf32 term where both operands are exact in tf32 (bf16 values: the
// bf16-operand policy's, bf16_tf32's, and mdta.cu's bf16 Gram), over a
// warp's M x N tiles of one 8-deep step: acc[i][j] += a_i b_j. Tiles
// outside the matrix (use_m, use_n false) are skipped.
template <int M, int N>
__device__ __forceinline__ void mma_1xtf32(float (&acc)[M][N][4], uint32_t (&a)[M][4],
                                           uint32_t (&b)[N][2], const bool (&use_m)[M],
                                           const bool (&use_n)[N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (use_m[i] && use_n[j]) mma_tf32(acc[i][j], a[i], b[j]);
}

// Conversions between a storage type (float or bf16) and fp32 arithmetic;
// round_to<T>(v) is v rounded to T's precision, kept as a float (the
// identity for float).
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (sizeof(T) == 2)
    return __float2bfloat16_rn(v);
  else
    return v;
}
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// The GDFN's gate gelu(x1) x2, the exact-erf gelu (mm.cuh's gate pass and
// gate_bwd, dwconv.cu's gated depthwise)
__device__ __forceinline__ float gate_fwd(float x1, float x2) {
  return x1 * (0.5f * (1.0f + erff(x1 * 0.70710678118654752f))) * x2;
}

// Fragments of four (x4) or two (x2) 8 x 8 bf16 matrices from shared
// memory, lane l giving the address of row l % 8 of matrix l / 8; with
// TRANS each matrix is read transposed.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
}

// d += a b on the tensor cores, bf16 operands, fp32 accumulator; a bf16
// product is exact in fp32.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Width of channel block k of a head of ch channels cut into blocks of cb
// (ops/gram.py channel_blocks), the last one the narrowest.
__device__ __forceinline__ int block_width(int k, int ch, int cb) {
  const int w = ch - k * cb;
  return w < cb ? w : cb;
}

// out[e] = ws[e] + ws[size + e] + ... + ws[(nb - 1) * size + e], in that
// order: the fixed-order sum of a tensor's nb slots of `size` floats, one
// slot per channel block of a sum over channel blocks (gram.cu, mdta.cu),
// stored as TO (a bf16 out rounded once: gram_bf16.cu, mdta.cu in bf16).
constexpr int kSlotThreads = 256;

template <typename TO>
__global__ void __launch_bounds__(kSlotThreads)
sum_slots_kernel(const float* __restrict__ ws, TO* __restrict__ out, long long size, int nb) {
  const long long e = (long long)blockIdx.x * kSlotThreads + threadIdx.x;
  if (e >= size) return;
  float v = ws[e];
  for (int k = 1; k < nb; ++k) v += ws[k * size + e];
  out[e] = from_f<TO>(v);
}

// After the launch that filled ws (its error is returned first).
template <typename TO>
inline cudaError_t sum_slots(const float* ws, TO* out, long long size, int nb,
                             cudaStream_t st) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_slots_kernel<TO><<<(unsigned)((size + kSlotThreads - 1) / kSlotThreads), kSlotThreads, 0,
                         st>>>(ws, out, size, nb);
  return cudaGetLastError();
}

// Raise the dynamic shared-memory limit of a kernel's two variants to
// `floats`, once per device (the attribute is the device's): `done` is the
// caller's function-local flags. A failure is returned and tried again on
// the next call.
constexpr int kMaxDevices = 64;
constexpr int kMaxSmemBytes = 232448;  // a block's most on sm_90 (227 KB)
constexpr int kSmemPerSm = 233472;     // an SM's for its blocks (228 KB)
constexpr int kSmemPerBlockReserved = 1024;  // what the runtime keeps of it a block

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
