// Fused 1x1 -> depthwise 3x3 in bf16 for Hopper (sm_90a), forward and
// backward: the MDTA qkv path of bf16 training in "tail"
// (cli.train --dtype bfloat16).
//
// Replaces the TPU kernels of rcot_tpu/ops/pallas_fused.py in the qkv
// configuration (conv1x1_dw_fused, :568) as the JAX package runs them on
// bf16 activations and bf16 weights:
//
//   conv1x1_dw_bf16 (fused_dwconv_fwd, pallas_call at :274, body :153-183):
//       h = bf16(x @ W_in^T); qkv = bf16(dw3x3(h)), the stencil in fp32;
//   conv1x1_dw_bwd_bf16 (fused_dwconv_bwd, pallas_call at :456, body
//   :297-410), which recomputes h = bf16(x @ W_in^T) and then works in
//   fp32: dconv = g, dh = the rotated dw3x3 of g, dx = bf16(dh @ W_in),
//   dW_in = bf16(dh^T x), ddw = bf16(sum of dconv times the h taps).
//
// Weights in the port's layouts, read in place: W_in (M, C), taps (M, 3, 3).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores,
// 67 TFLOP/s fp32 outside them). The forward reads 2C and writes 2M bytes
// a pixel against 2 M C flops of product (bf16) and 18 M of stencil (fp32):
// bound by its bytes up to about C = 96 and by the stencil's operations
// above it. The backward reads 2C + 2M bytes a pixel and writes 2C against
// 4 M C flops of fp32 products (the recompute's 2 M C in bf16) and 36 M of
// stencils: bound by its operations (chip_smoke.py states the bound).
//
// Design. The forward is block_fwd_bf16.cu's head without its LayerNorm:
// mm.cuh's bf16 product (mma.sync m16n8k16, fp32 sums, the epilogue
// rounding h to bf16) into a bf16 workspace, then row 11's depthwise
// kernel on bf16 into bf16 (dwconv.cuh conv_bf16). The backward recomputes
// h with the same bf16 product, so that h is rounded where the forward
// rounds it; widens x, g, h and the weights into fp32 workspaces in one
// launch (cast.cuh); runs fused_dwconv.cu's fp32 backward on them (the
// rotated depthwise, dtaps, the 3xTF32 dx product and the dW_in pixel sum,
// every sum in a fixed order); and rounds dx, dW_in and ddw to bf16 in one
// last launch. No atomics and no memsets: two calls on the same inputs
// give the same bits. The plans are ops/fused.py's (fused_fwd_plan with
// copy widths in bf16 elements, fused_bwd_plan on the fp32 workspaces).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cast.cuh"
#include "dwconv.cuh"
#include "mm.cuh"

namespace {

// The forward's plan, ops/fused.py fused_fwd_plan (as fused_dwconv.cu's).
enum FwdPlan {
  kGateBlocks,
  kFVecC,  // bf16 a copy of the C-wide operands (x, W_in)
  kFVecH,
  kFVecG,
  kFSplit,  // (K ranges, depth a range) of the products h and out
  kFDw = kFSplit + 4,  // (vec, cv, tc, rows) of the depthwise forward, bf16 into bf16
  kGatePass = kFDw + 4,
  kFwdInts
};
// The backward's plan, ops/fused.py fused_bwd_plan (as fused_dwconv.cu's),
// its copy widths those of the fp32 workspaces.
enum BwdPlan {
  kSumOut,
  kSumIn,   // pixels a range of the pixel sum dW_in
  kBVecC,   // floats a copy of the C-wide operands (x32, W_in32, dx32),
  kBVecH,
  kBVecM,   //   of the M-wide ones (h32, dh, g32)
  kBSplit,  // (K ranges, depth a range) of the products h and dx
  kDwFwd = kBSplit + 4,
  kDwRot = kDwFwd + 4,   // (vec, cv, tc, rows) of the rotated forward (dh),
  kDwTaps = kDwRot + 4,  //   of the dtaps
  kBwdInts = kDwTaps + 4
};
enum Prod { kProdH, kProdDx };

}  // namespace

#define SPLIT(at, k) plan[(at) + 2 * (k)], plan[(at) + 2 * (k) + 1]

extern "C" {

// qkv = bf16(dw3x3(bf16(x @ W_in^T))). Inputs x (B,H,W,C), w_in (M,C), dwk
// (M,3,3), bf16; output out (B,H,W,M) bf16. Workspace: h (N,M) bf16,
// N = B*H*W, and sums (fp32, the plan's). plan: kFwdInts ints (kGateBlocks,
// kFVecH, kFVecG, out's split and kGatePass unused).
int rcot_conv1x1_dw_bf16(const bf16* x, const bf16* w_in, const bf16* dwk, bf16* out, bf16* h,
                         float* sums, const int* plan, int B, int H, int W, int C, int M,
                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int vc = plan[kFVecC];
  RCOT_TRY((product<false, kEpiStore>(x, C, vc, w_in, vc, h, M, n, SPLIT(kFSplit, kProdH), sums,
                                      st)));
  return rcot_dwconv::conv_bf16(h, dwk, out, true, B, H, W, M, plan[kFDw], plan[kFDw + 1],
                                plan[kFDw + 2], plan[kFDw + 3], st);
}

// Backward of rcot_conv1x1_dw_bf16 for the cotangent g (B,H,W,M) bf16.
// Outputs dx (B,H,W,C), dw_in (M,C), ddw (M,3,3), bf16. Workspace: hb (N,M)
// bf16; x32 (N,C), g32 (N,M), h32 (N,M), dh (N,M), dx32 (N,C), w32 (M,C),
// dwk32 (M,9), dw_in32 (M,C), ddw32 (M,9) fp32; sums (fp32, the plan's);
// N = B*H*W. plan: kBwdInts ints (kSumOut, kBVecH and kDwFwd unused); vcb:
// bf16 a copy of x and W_in in the recompute of h.
int rcot_conv1x1_dw_bwd_bf16(const bf16* x, const bf16* w_in, const bf16* dwk, const bf16* g,
                             bf16* dx, bf16* dw_in, bf16* ddw, bf16* hb, float* x32, float* g32,
                             float* h32, float* dh, float* dx32, float* w32, float* dwk32,
                             float* dw_in32, float* ddw32, float* sums, const int* plan, int vcb,
                             int B, int H, int W, int C, int M, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int vc = plan[kBVecC], vm = plan[kBVecM];
  // recompute h = bf16(x @ W_in^T), as the forward rounds it
  RCOT_TRY((product<false, kEpiStore>(x, C, vcb, w_in, vcb, hb, M, n, SPLIT(kBSplit, kProdH),
                                      sums, st)));
  Widen up;
  up.add(x, C, x32, C, n, C);
  up.add(g, M, g32, M, n, M);
  up.add(hb, M, h32, M, n, M);
  up.add(w_in, C, w32, C, M, C);
  up.add(dwk, 9, dwk32, 9, M, 9);
  RCOT_TRY(up.run(st));
  // dconv = g: dh = the rotated forward of g, ddw = dtaps(h, g)
  RCOT_TRY(rcot_dwconv::conv(g32, dwk32, dh, B, H, W, M, plan[kDwRot], plan[kDwRot + 1],
                             plan[kDwRot + 2], plan[kDwRot + 3], true, st));
  RCOT_TRY(rcot_dwconv::dtaps(h32, g32, sums, ddw32, B, H, W, M, plan[kDwTaps],
                              plan[kDwTaps + 1], plan[kDwTaps + 2], plan[kDwTaps + 3], st));
  // dx = dh @ W_in, dW_in = dh^T x
  RCOT_TRY((product<true, kEpiStore>(dh, M, vm, w32, vc, dx32, C, n, SPLIT(kBSplit, kProdDx),
                                     sums, st)));
  RCOT_TRY(pixel_sum(dh, vm, x32, vc, dw_in32, sums, M, C, n, plan[kSumIn], st));
  Narrow down;
  down.add(dx32, C, dx, C, n, C);
  down.add(dw_in32, C, dw_in, C, M, C);
  down.add(ddw32, 9, ddw, 9, M, 9);
  return down.run(st);
}

}  // extern "C"
