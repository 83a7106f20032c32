// The product-depthwise of the bf16 forwards (pw_dw.cu), for other kernels'
// launchers: block_fwd_bf16.cu's head (after its LayerNorm) and
// fused_dwconv_bf16.cu's qkv run their 1x1 product and their depthwise 3x3
// through it, in one launch.
// The plan (PW_PLAN_INTS ints) is ops/dwconv.py's pw_dw_plan, made in
// Python and passed in; the launch is on `st` and returns its error.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rcot_pwdw {

// The plan's ints, ops/dwconv.py pw_dw_plan: bf16 a copy of x's and W's
// rows, bf16 a store of the output (2 or 4: 4 and 8 bytes), the output
// channels a block (cw), the rows of its band, the ring's stages, the input
// rows a step (pw_dw_group, which C decides), and the product's K ranges
// and depth a range (ops/block.py split_plan), whose sums keep mm.cuh's
// order.
enum Plan { kVecC, kVecOut, kChunk, kRows, kStages, kGroup, kParts, kKPer, kPlanInts };

// qkv = bf16(dw3x3(h)) on bf16 taps (M, 3, 3), the stencil in fp32 in
// dwconv.cu's order; h = bf16(x @ W^T) with W (M, C) bf16, as mm.cuh's bf16
// product sums and rounds it, zeros outside the image. x (B, H, W, C), qkv
// (B, H, W, M), bf16; M even. h never leaves the SM.
cudaError_t pw_dw_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                       const __nv_bfloat16* taps, __nv_bfloat16* out, int B, int H, int W, int C,
                       int M, const int* plan, cudaStream_t st);

}  // namespace rcot_pwdw
