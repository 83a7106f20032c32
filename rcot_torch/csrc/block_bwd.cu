// Fused transformer-block backward for Hopper (sm_90a).
//
// Replaces the TPU kernel rcot_tpu/ops/pallas_block.py fused_block_bwd
// (pallas_call at :515, kernel body :208-398) in its two configurations:
//
//   block head (forward: qkv = dw3x3( LN1(x) @ W_qkv ), pallas_block.py:586)
//       g (B,H,W,3C) -> dx, dln_w, dln_b, dW_qkv, ddw
//   block tail (forward: t = x + a @ W_proj,
//                        y = t + (gelu(c1) * c2) @ W_out,
//                        [c1 | c2] = dw3x3( LN2(t) @ W_in ), :597)
//       g (B,H,W,C) -> dx, da, dW_proj, dln_w, dln_b, dW_in, ddw, dW_out
//
// Like the TPU kernel it recomputes the forward from the saved inputs
// (t, the LN statistics, h = LN(t) @ W_in^T, conv = dw3x3(h)) and takes
// nothing else from the forward. Weights and weight grads are in the port's
// layouts: 1x1 weights (out, in), depthwise taps (M, 3, 3).
//
// Bound on an H100 SXM. The tail does 2 N (3 C^2 + 8 h C) flops of 1x1
// products per N pixels (three C x C and eight C x h products a pixel, the
// forward's recompute included) and ~60 h a pixel of stencils and gate,
// against 16 C bytes a pixel of inputs and outputs: bound by operations,
// as is the head (2 N 3 * 3C C). On the CUDA cores (67 TFLOP/s fp32) that
// bound is what chip_smoke.py states; as 3xTF32 on the tensor cores (495
// TF32 / 3 = 165 TFLOP/s) the products' floor is 2.5x lower. The design's
// own launches move the wide intermediates (h, conv, dconv, dh: N x 2h
// floats each; gate N x h) through device memory: 24 h N floats read or
// written in the tail, 7 M N in the head, beside ~19 C N and 8 C N narrow
// ones (tools/port_block_bwd_times.py design_floors), which at the level-1
// shapes is a larger floor than the products'.
//
// Design. The Pallas kernel walked row bands on a sequential grid, kept
// every intermediate in VMEM with a two-row halo, and summed the weight
// grads into grid-revisited blocks. Blocks on the card run in no order, so
// here the backward is a chain of launches on one stream, with the wide
// intermediates (h, conv, dconv, dh, gate) in a workspace the caller
// allocates and the launch plan (ops/block.py block_bwd_plan) passed in as
// ints:
//   - every 1x1 product is mm.cuh's mm_kernel: 3xTF32 mma.sync m16n8k8
//     with fp32 accumulation, 128 x 64 output tiles, 32-deep steps through
//     a three-stage cp.async ring, an epilogue staged through shared memory
//     (mm.cuh says more). Per-pixel products (t, h, dgate, du, da) take
//     the pixels as rows; t's epilogue adds x (no copy of x, no
//     read-modify-write), and dgate's is the gate's backward: it reads conv and writes dconv and gate, so
//     dgate is never stored. One whose tiles alone leave the card short
//     (the latent's du) splits K into ranges (the plan's). Pixel sums
//     (dW_out, dW_in, dW_proj, dW_qkv; mm.cuh pixel_sum) take the pixels as
//     depth, split into ranges of at most 512 pixels (a block's fp32 sum
//     grows in error with its pixels; ops/gram.py GRAM_MAX_PIXELS). Every
//     split stores its partials with plain stores, and sum_parts_kernel
//     adds them in a fixed order;
//   - the depthwise stages are row 11's kernels (dwconv.cuh): conv = the
//     forward of h, dh = the rotated forward of dconv, ddw = dtaps(h,
//     dconv), with h in device memory for every pixel, so the conv's zero
//     padding is "outside the image reads 0" and the halo trap of the
//     banded kernel (LN(0) = ln_b on out-of-image rows) cannot occur;
//   - LayerNorm is one warp a pixel, a lane holding up to 16 channels in
//     registers (C <= 512) or, above, walking them in device memory; its
//     backward's per-channel sums (dln_w, dln_b) are per-block partials
//     added over the warps in a fixed order and then over the blocks by
//     sum_parts_kernel (above 512 channels the warps' partials take up to
//     227 KB of shared memory: C <= kLnMaxChannels = 3,632).
// No atomics and no memsets: two calls on the same inputs give the same
// bits. The gelu derivative is exact: Phi(x) + x phi(x) with erff.
//
// bf16 operands (RCOT_BWD_BF16's "block" tier, pallas_block.py's
// _bwd_dot(..., tier="block") at :305-306, :324-325, :356-357, :375-376,
// :384-385, :398; the `ops16` argument): the backward products (dgate, du,
// da, dW_out, dW_in, dW_proj, dW_qkv) take mm.cuh's OPS16 policy, each
// operand rounded to bf16 as it enters its fragment, one tf32 mma.sync a
// step; the recompute's products (t, h) stay 3xTF32, and the LayerNorm
// backward, the residual, dx, dln_w, dln_b and ddw read the unrounded
// values, as the TPU kernel's do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dwconv.cuh"
#include "ln_bwd.cuh"
#include "mm.cuh"

namespace {

// The launch plan, ops/block.py block_bwd_plan: ints at these offsets.
enum Plan {
  kLnBlocks,  // blocks of the LayerNorm forward
  kLnPer,     // pixels a block of the LayerNorm backward
  kSumPer0,   // pixels a range of each pixel sum: dW_out (dW_qkv in the head),
  kSumPer1,   //   dW_in,
  kSumPer2,   //   dW_proj
  kVecC,      // floats a copy of the C-wide operands,
  kVecH,      //   of the h-wide ones (W_out's rows, gate),
  kVecM,      //   of the 2h- or 3C-wide one (dh)
  kSplit,     // (K ranges, depth a range) of the per-pixel products t, h,
              // du, da, at kSplit + 2 * kProd*
  kDwFwd = kSplit + 8,   // (vec, cv, tc, rows) of the depthwise forward,
  kDwRot = kDwFwd + 4,   // of its rotated forward (dh),
  kDwTaps = kDwRot + 4,  // of its dtaps
  kPlanInts = kDwTaps + 4
};
enum Prod { kProdT, kProdH, kProdDu, kProdDa };

// The depthwise forward (or, rot, its rotated forward) by row 11's kernel
// with the plan's (vec, cv, tc, rows) at plan[at]
cudaError_t dw(const float* x, const float* taps, float* out, int B, int H, int W, int M,
               const int* plan, int at, bool rot, cudaStream_t st) {
  return rcot_dwconv::conv(x, taps, out, B, H, W, M, plan[at], plan[at + 1], plan[at + 2],
                           plan[at + 3], rot, st);
}

cudaError_t dw_taps(const float* x, const float* g, float* ws, float* ddw, int B, int H, int W,
                    int M, const int* plan, cudaStream_t st) {
  return rcot_dwconv::dtaps(x, g, ws, ddw, B, H, W, M, plan[kDwTaps], plan[kDwTaps + 1],
                            plan[kDwTaps + 2], plan[kDwTaps + 3], st);
}

// the plan's (K ranges, depth a range) of per-pixel product k
#define SPLIT(k) plan[kSplit + 2 * (k)], plan[kSplit + 2 * (k) + 1]

template <bool OPS16>
int head_bwd(const float* x, const float* ln_w, const float* ln_b, const float* w_qkv,
             const float* dwk, const float* g, float* dx, float* dln_w, float* dln_b,
             float* dw_qkv, float* ddw, float* u, float* stats, float* h, float* dh, float* du,
             float* sums, const int* plan, int B, int H, int W, int C, int M, cudaStream_t st) {
  const long long n = (long long)B * H * W;
  const int vc = plan[kVecC], vm = plan[kVecM];
  // recompute: u = LN1(x), h = u @ W_qkv^T
  RCOT_TRY(ln_fwd(x, ln_w, ln_b, u, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(u, C, vc, w_qkv, vc, h, M, n, SPLIT(kProdH), sums, st)));
  // depthwise backward, dconv = g: dh = the rotated forward of g, ddw
  RCOT_TRY(dw(g, dwk, dh, B, H, W, M, plan, kDwRot, true, st));
  RCOT_TRY(dw_taps(h, g, sums, ddw, B, H, W, M, plan, st));
  // 1x1 backward: du = dh @ W_qkv, dW_qkv = dh^T u
  RCOT_TRY((product<true, kEpiStore, float, OPS16>(dh, M, vm, w_qkv, vc, du, C, n, SPLIT(kProdDu),
                                                   sums, st)));
  RCOT_TRY(pixel_sum<OPS16>(dh, vm, u, vc, dw_qkv, sums, M, C, n, plan[kSumPer0], st));
  return ln_bwd(x, du, stats, ln_w, ln_b, nullptr, dx, dln_w, dln_b, sums, n, C,
                plan[kLnPer], st);
}

template <bool OPS16>
int tail_bwd(const float* x, const float* a, const float* w_proj, const float* ln_w,
             const float* ln_b, const float* w_in, const float* dwk, const float* w_out,
             const float* g, float* dx, float* da, float* dw_proj, float* dln_w, float* dln_b,
             float* dw_in, float* ddw, float* dw_out, float* t, float* stats, float* u, float* h,
             float* conv_dh, float* dconv, float* gate, float* du, float* sums, const int* plan,
             int B, int H, int W, int C, int hid, cudaStream_t st) {
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid, vc = plan[kVecC], vh = plan[kVecH], vm = plan[kVecM];
  // recompute: t = x + a @ W_proj^T, u = LN2(t), h = u @ W_in^T, conv = dw(h)
  RCOT_TRY((product<false, kEpiAdd>(a, C, vc, w_proj, vc, t, C, n, SPLIT(kProdT), sums, st, x)));
  RCOT_TRY(ln_fwd(t, ln_w, ln_b, u, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(u, C, vc, w_in, vc, h, m2, n, SPLIT(kProdH), sums, st)));
  RCOT_TRY(dw(h, dwk, conv_dh, B, H, W, m2, plan, kDwFwd, false, st));
  // W_out: dgate = g @ W_out, its epilogue the gate's backward (dconv and
  // gate from conv); dW_out = g^T gate
  RCOT_TRY((product<true, kEpiGate, float, OPS16>(g, C, vc, w_out, vh, dconv, hid, n, 1, 0, nullptr,
                                                  st, conv_dh, gate)));
  RCOT_TRY(pixel_sum<OPS16>(g, vc, gate, vh, dw_out, sums, C, hid, n, plan[kSumPer0], st));
  // depthwise backward (conv is dead now: its buffer takes dh)
  RCOT_TRY(dw(dconv, dwk, conv_dh, B, H, W, m2, plan, kDwRot, true, st));
  RCOT_TRY(dw_taps(h, dconv, sums, ddw, B, H, W, m2, plan, st));
  // W_in: du = dh @ W_in, dW_in = dh^T u
  RCOT_TRY((product<true, kEpiStore, float, OPS16>(conv_dh, m2, vm, w_in, vc, du, C, n,
                                                   SPLIT(kProdDu), sums, st)));
  RCOT_TRY(pixel_sum<OPS16>(conv_dh, vm, u, vc, dw_in, sums, m2, C, n, plan[kSumPer1], st));
  // LN2 and the residual: dx = dt = LN-VJP(du) + g
  RCOT_TRY(ln_bwd(t, du, stats, ln_w, ln_b, g, dx, dln_w, dln_b, sums, n, C, plan[kLnPer], st));
  // W_proj: da = dt @ W_proj, dW_proj = dt^T a
  RCOT_TRY((product<true, kEpiStore, float, OPS16>(dx, C, vc, w_proj, vc, da, C, n, SPLIT(kProdDa),
                                                   sums, st)));
  return pixel_sum<OPS16>(dx, vc, a, vc, dw_proj, sums, C, C, n, plan[kSumPer2], st);
}

}  // namespace

extern "C" {

// Block-head backward. Inputs x (B,H,W,C), ln_w, ln_b (C; ln_b null for
// BiasFree), w_qkv (M,C), dwk (M,3,3), g (B,H,W,M). Outputs dx (B,H,W,C),
// dln_w, dln_b (C; null with ln_b), dw_qkv (M,C), ddw (M,3,3). Workspace:
// u (N,C), stats (2N), h (N,M), dh (N,M), du (N,C), N = B*H*W, and sums
// (ops/block.py block_bwd_plan's). plan: kPlanInts ints (kSumPer0 is
// dW_qkv's; kVecH, kSumPer1, kSumPer2, kProdT, kProdDa and kDwFwd unused).
// ops16: 1 takes the bf16-operand policy in the backward products.
int rcot_block_head_bwd(const float* x, const float* ln_w, const float* ln_b,
                        const float* w_qkv, const float* dwk, const float* g, float* dx,
                        float* dln_w, float* dln_b, float* dw_qkv, float* ddw, float* u,
                        float* stats, float* h, float* dh, float* du, float* sums,
                        const int* plan, int B, int H, int W, int C, int M, int ops16,
                        void* stream) {
  return (ops16 ? head_bwd<true> : head_bwd<false>)(x, ln_w, ln_b, w_qkv, dwk, g, dx, dln_w, dln_b,
                                                    dw_qkv, ddw, u, stats, h, dh, du, sums, plan, B,
                                                    H, W, C, M, (cudaStream_t)stream);
}

// Block-tail backward. Inputs x, a (B,H,W,C), w_proj (C,C), ln_w, ln_b (C;
// ln_b null for BiasFree), w_in (2h,C), dwk (2h,3,3), w_out (C,h),
// g (B,H,W,C). Outputs dx, da (B,H,W,C), dw_proj (C,C), dln_w, dln_b (C;
// null with ln_b), dw_in (2h,C), ddw (2h,3,3), dw_out (C,h). Workspace:
// t (N,C), stats (2N), u (N,C), h (N,2h), conv_dh (N,2h), dconv (N,2h),
// gate (N,h), du (N,C), N = B*H*W, and sums (ops/block.py
// block_bwd_plan's). plan: kPlanInts ints. ops16: as the head's.
int rcot_block_tail_bwd(const float* x, const float* a, const float* w_proj,
                        const float* ln_w, const float* ln_b, const float* w_in,
                        const float* dwk, const float* w_out, const float* g, float* dx,
                        float* da, float* dw_proj, float* dln_w, float* dln_b, float* dw_in,
                        float* ddw, float* dw_out, float* t, float* stats, float* u, float* h,
                        float* conv_dh, float* dconv, float* gate, float* du, float* sums,
                        const int* plan, int B, int H, int W, int C, int hid, int ops16,
                        void* stream) {
  return (ops16 ? tail_bwd<true> : tail_bwd<false>)(x, a, w_proj, ln_w, ln_b, w_in, dwk, w_out, g,
                                                    dx, da, dw_proj, dln_w, dln_b, dw_in, ddw,
                                                    dw_out, t, stats, u, h, conv_dh, dconv, gate,
                                                    du, sums, plan, B, H, W, C, hid,
                                                    (cudaStream_t)stream);
}

}  // extern "C"
