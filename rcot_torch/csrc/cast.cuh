// Conversions between bf16 and fp32 for the bf16 backward forms of bf16
// training (fused_dwconv_bf16.cu, block_bwd_bf16.cu, gram_bwd_bf16.cu).
//
// The JAX package's backward kernels, on bf16 activations and weights,
// widen every operand to fp32 and do all their backward products, stencils
// and sums in fp32 (RCOT_BWD_BF16 unset: rcot_tpu/ops/pallas_fused.py
// _bwd_dot, pallas_block.py:301), then round their bf16 outputs once. A
// bf16 value converts to fp32, and to tf32, exactly. So the port's bf16
// backward forms widen their bf16 operands into fp32 workspaces in one
// launch (`Casts`, up to kCastSegs matrices of any pitch), run the fp32
// kernels' design on them (the 3xTF32 products, the stencils and the
// fixed-order sums), and round their bf16 outputs in one more launch.
// Each conversion is exact or a single round-to-nearest-even, so the
// results are those of the fp32 design on the widened values.
//
// cast_kernel: one warp a row of the segments' rows taken in order, its
// lanes over the row's columns, so that a warp reads and writes
// consecutive elements. Bound by its bytes (6 a converted element).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc.cuh"

namespace {

constexpr int kCastSegs = 10;
constexpr int kCastThreads = 256;
constexpr int kCastMaxBlocks = 4096;

// rows x cols elements of src (rows src_ld elements apart) into dst (rows
// dst_ld apart)
struct CastSeg {
  const void* src;
  void* dst;
  long long rows, src_ld, dst_ld;
  int cols;
};

struct CastList {
  CastSeg seg[kCastSegs];
  long long first_row[kCastSegs + 1];  // first_row[s]: rows of the segments before s
  int n;
};

template <typename TI, typename TO>
__global__ void __launch_bounds__(kCastThreads) cast_kernel(const CastList l) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kCastThreads / 32);
  const long long total = l.first_row[l.n];
  int s = 0;
  // a warp's rows increase, so its segment only moves forward
  for (long long r = (long long)blockIdx.x * (kCastThreads / 32) + threadIdx.x / 32; r < total;
       r += warps) {
    while (r >= l.first_row[s + 1]) ++s;
    const CastSeg& g = l.seg[s];
    const long long row = r - l.first_row[s];
    const TI* src = static_cast<const TI*>(g.src) + row * g.src_ld;
    TO* dst = static_cast<TO*>(g.dst) + row * g.dst_ld;
    for (int c = lane; c < g.cols; c += 32) dst[c] = from_f<TO>(to_f(src[c]));
  }
}

// The segments of one launch, each converted from TI to TO (bf16 -> fp32
// widens exactly, fp32 -> bf16 rounds to nearest even).
template <typename TI, typename TO>
struct Casts {
  CastList l{};
  bool overflow = false;

  void add(const TI* src, long long src_ld, TO* dst, long long dst_ld, long long rows,
           int cols) {
    if (l.n == kCastSegs) {
      overflow = true;
      return;
    }
    l.seg[l.n] = CastSeg{src, dst, rows, src_ld, dst_ld, cols};
    l.first_row[l.n + 1] = l.first_row[l.n] + rows;
    ++l.n;
  }

  cudaError_t run(cudaStream_t st) const {
    if (overflow) return cudaErrorInvalidValue;
    const long long total = l.first_row[l.n];
    if (total == 0) return cudaSuccess;
    const long long want = (total + kCastThreads / 32 - 1) / (kCastThreads / 32);
    const unsigned blocks = (unsigned)(want < kCastMaxBlocks ? want : kCastMaxBlocks);
    cast_kernel<TI, TO><<<blocks, kCastThreads, 0, st>>>(l);
    return cudaGetLastError();
  }
};

using Widen = Casts<bf16, float>;
using Narrow = Casts<float, bf16>;

}  // namespace
