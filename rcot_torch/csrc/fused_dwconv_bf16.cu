// Fused 1x1 -> depthwise 3x3 [-> gelu gate -> 1x1] in bf16 for Hopper
// (sm_90a), forward and backward: the MDTA qkv path of bf16 training in
// "tail" and "off", and the whole GDFN of bf16 serving and training in
// "head" and "off" (cli.train --dtype bfloat16, cli.test --dtype bfloat16).
//
// Replaces the TPU kernels of rcot_tpu/ops/pallas_fused.py in both
// configurations, the qkv (conv1x1_dw_fused, :568) and the GDFN
// (gdfn_fused, :549), as the JAX package runs them on bf16 activations
// and bf16 weights:
//
//   conv1x1_dw_bf16 (fused_dwconv_fwd, pallas_call at :274, body :153-183):
//       h = bf16(x @ W_in^T); qkv = bf16(dw3x3(h)), the stencil in fp32;
//   gdfn_fused_bf16 (the same kernel with the gate and W_out):
//       h = bf16(x @ W_in^T); [c1 | c2] = dw3x3(h) in fp32;
//       gate = bf16(gelu(c1) c2); y = bf16(gate @ W_out^T), fp32 sums;
//   conv1x1_dw_bwd_bf16 (fused_dwconv_bwd, pallas_call at :456, body
//   :297-410), which recomputes h = bf16(x @ W_in^T) and then works in
//   fp32: dconv = g, dh = the rotated dw3x3 of g, dx = bf16(dh @ W_in),
//   dW_in = bf16(dh^T x), ddw = bf16(sum of dconv times the h taps);
//   gdfn_fused_bwd_bf16 (the same kernel with the gate and W_out): h
//   recomputed and rounded, conv fp32, then in fp32 on the bf16 values:
//   dgate = g @ W_out, dconv through the gate's derivative, dh = the
//   rotated dw3x3 of dconv, dx = bf16(dh @ W_in), dW_in = bf16(dh^T x),
//   ddw = bf16(sum of dconv times the h taps), dW_out = bf16(g^T gate)
//   with the unrounded fp32 gate (:405-412).
//
// Weights in the port's layouts, read in place: W_in (M, C), taps (M, 3, 3),
// W_out (C, h) with M = 2h in the GDFN. The JAX package pads each gate half
// to 128 lanes with zeros (pad_gate_halves, :512-536), a TPU layout that
// changes no value; here odd h (127, 255, 1,021) takes narrower copies and
// the gate's rows are padded to 8 bf16 (gate_ld), as block_fwd_bf16.cu's.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores,
// 67 TFLOP/s fp32 outside them). The qkv forward reads 2C and writes 2M
// bytes a pixel against 2 M C flops of product (bf16) and 18 M of stencil
// (fp32): bound by its bytes up to about C = 96 and by the stencil's
// operations above it. The GDFN forward reads and writes 2C bytes a pixel
// each against 6 h C flops of bf16 products and ~46 h of stencil and gate
// (fp32): bound by those operations. The backwards read 2C + 2M bytes a
// pixel (the GDFN 4C) and write 2C against 4 M C flops of products (the
// GDFN 8 h C; the recompute's 2 M C in bf16; the backward's on 495 TFLOP/s
// TF32 terms, two a step, one for two bf16 operands or in ops16) and 36 M of
// fp32 stencils: bound by their operations (chip_smoke.py
// bf16_bwd_work states the bound, each product at its operands' rate).
//
// Design. The forwards are block_fwd_bf16.cu's head and tail without their
// LayerNorm and residuals: the qkv one launch of the product-depthwise
// (pw_dw.cuh: the W_in product inside the depthwise's band, h never in
// device memory), with the bits of the two launches it replaced, mm.cuh's
// bf16 product (mma.sync m16n8k16, fp32 sums, the epilogue rounding h to
// bf16) into a bf16 workspace and row 11's depthwise kernel on bf16
// (dwconv.cuh conv_bf16) into bf16, which stay for C past its shared
// memory; the GDFN mm.cuh's bf16 product into h, then the gated
// depthwise (conv_gate_bf16: conv summed as
// conv_bf16 sums it, kept in registers, the gate taken there and rounded
// once) into a bf16 gate workspace, read by a bf16 W_out product that
// stores bf16: three launches, no fp32 conv in device memory. The backwards recompute h with the same
// bf16 product, so that h is rounded where the forward rounds it. The qkv
// backwards then run fused_dwconv.cu's fp32 backwards on the bf16 tensors
// themselves, with no fp32 copy of an operand. The qkv's: dh = the rotated
// depthwise of the bf16 g on the bf16 taps into fp32 (dwconv.cuh
// conv_bf16_rot), ddw = dtaps of the bf16 h and g on the fp32 plan's
// columns and band, rounded in its reduce (dtaps_16). The GDFN's: conv =
// the depthwise of the bf16 h into fp32 (conv_bf16), dgate = g W_out on
// bf16 tiles of both (one mma.sync a step), its epilogue the gate's
// backward into fp32 dconv and gate, dW_out = g^T gate rounded, dh = the
// rotated depthwise of the fp32 dconv on the bf16 taps (conv_taps16), ddw
// = dtaps of the bf16 h with dconv on the fp32 plan's tiles (dtaps_16).
// Both then take dx = dh W_in, dW_in = dh^T x on mm.cuh's tf32 path with
// W_in and x in bf16 tiles (each value widened into its fragment, two
// mma.sync a step; one in ops16), dx and dW_in rounded once where written:
// every sum in the fp32 design's order, so the bits of that design on the
// widened operands, rounded once (seven launches in the qkv, eleven in the
// GDFN at the level-1 shapes). No atomics and no memsets: two calls on the
// same inputs give the same bits. The plans are ops/fused.py's
// (fused_fwd_plan with copy widths in bf16 elements and the GDFN's gated
// depthwise on ops/dwconv.py conv_gate_plan, fused_bwd_plan's fp32 design,
// and for each backward a
// second of its bf16 pieces: ops/block.py qkv_bwd_bf16_plan for the qkv's,
// gated_bwd_bf16_plan for the GDFN's). The backwards' `ops16`
// argument takes RCOT_BWD_BF16's "fused" tier, as fused_dwconv.cu's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dwconv.cuh"
#include "mm.cuh"
#include "pw_dw.cuh"

namespace {

// The forward's plan, ops/fused.py fused_fwd_plan (as fused_dwconv.cu's).
enum FwdPlan {
  kGateBlocks,
  kFVecC,  // bf16 a copy of the C-wide operands (x, W_in)
  kFVecH,  //   of W_out's rows (h),
  kFVecG,  //   of the gate's padded rows (gate_ld<bf16> apart)
  kFSplit,  // (K ranges, depth a range) of the products h and out
  kFDw = kFSplit + 4,  // (vec, cv, tc, rows) of the depthwise forward: conv_bf16
                       //   into bf16 (qkv), conv_gate_bf16 (GDFN)
  kGatePass = kFDw + 4,  // 1: a gate pass (the fp32 GDFN's; 0 in bf16)
  kFwdInts
};
// The backward's plan, ops/fused.py fused_bwd_plan (as fused_dwconv.cu's),
// its copy widths those of the fp32 workspaces.
enum BwdPlan {
  kSumOut,  // pixels a range of the pixel sums dW_out,
  kSumIn,   //   and dW_in
  kBVecC,   // floats a copy of the C-wide operands (x32, W_in32, dx32, the GDFN's g32),
  kBVecH,   //   of the h-wide ones (W_out32's rows, the gate),
  kBVecM,   //   of the M-wide ones (h32, dh, dconv, the qkv's g32)
  kBSplit,  // (K ranges, depth a range) of the products h and dx
  kDwFwd = kBSplit + 4,  // (vec, cv, tc, rows) of the depthwise forward (GDFN),
  kDwRot = kDwFwd + 4,   //   of its rotated forward (dh),
  kDwTaps = kDwRot + 4,  //   of the dtaps
  kBwdInts = kDwTaps + 4
};
enum Prod { kProdH, kProdOut, kProdDx = kProdOut };
// The qkv backward's bf16 plan: bf16 a copy of x and W_in, and the (vec,
// cv, tc, rows) of the rotated depthwise of g and of dtaps (bf16 a copy;
// dtaps's tc and rows those of the fp32 plan)
enum Bwd16Plan { kVecC16, kRot16, kTaps16 = kRot16 + 4, kBwd16Ints = kTaps16 + 4 };
// The GDFN backward's bf16 plan (the bf16 block tail backward's layout):
// bf16 a copy of x and W_in, of g and of W_out's rows, and the bf16
// depthwise forward's (vec, cv, tc, rows) into fp32 conv
enum Gdfn16Plan { kGVecC16, kGVecG16, kGVecH16, kGDw16, kGdfn16Ints = kGDw16 + 4 };

}  // namespace

#define SPLIT(at, k) plan[(at) + 2 * (k)], plan[(at) + 2 * (k) + 1]

namespace {

template <bool OPS16>
int conv1x1_dw_bwd_bf16(const bf16* x, const bf16* w_in, const bf16* dwk, const bf16* g, bf16* dx,
                        bf16* dw_in, bf16* ddw, bf16* hb, float* dh, float* sums, const int* plan,
                        const int* plan16, int B, int H, int W, int C, int M, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int vm = plan[kBVecM], vcb = plan16[kVecC16];
  const int* rot = plan16 + kRot16;
  const int* taps = plan16 + kTaps16;
  // recompute h = bf16(x @ W_in^T), as the forward rounds it
  RCOT_TRY((product<false, kEpiStore>(x, C, vcb, w_in, vcb, hb, M, n, SPLIT(kBSplit, kProdH),
                                      sums, st)));
  // dconv = g: dh = the rotated forward of g, ddw = bf16(dtaps(h, g))
  RCOT_TRY(rcot_dwconv::conv_bf16_rot(g, dwk, dh, B, H, W, M, rot[0], rot[1], rot[2], rot[3],
                                      st));
  RCOT_TRY(rcot_dwconv::dtaps_16(hb, g, true, sums, ddw, B, H, W, M, taps[0], taps[1], taps[2],
                                 taps[3], st));
  // dx = bf16(dh @ W_in), dW_in = bf16(dh^T x) on bf16 tiles of W_in and x
  RCOT_TRY((product<true, kEpiStore, float, OPS16>(dh, M, vm, w_in, vcb, dx, C, n,
                                                 SPLIT(kBSplit, kProdDx), sums, st)));
  return pixel_sum<OPS16>(dh, vm, x, vcb, dw_in, sums, M, C, n, plan[kSumIn], st);
}

template <bool OPS16>
int gdfn_fused_bwd_bf16(const bf16* x, const bf16* w_in, const bf16* dwk, const bf16* w_out,
                        const bf16* g, bf16* dx, bf16* dw_in, bf16* ddw, bf16* dw_out, bf16* hb,
                        float* conv_dh, float* dconv, float* gate, float* sums, const int* plan,
                        const int* plan16, int B, int H, int W, int C, int hid, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid, vh = plan[kBVecH], vm = plan[kBVecM];
  const int vcb = plan16[kGVecC16], vg = plan16[kGVecG16], vw = plan16[kGVecH16];
  const int* dw16 = plan16 + kGDw16;
  // recompute h = bf16(x @ W_in^T), as the forward rounds it, and conv =
  // dw3x3(h) in fp32
  RCOT_TRY((product<false, kEpiStore>(x, C, vcb, w_in, vcb, hb, m2, n, SPLIT(kBSplit, kProdH),
                                      sums, st)));
  RCOT_TRY(rcot_dwconv::conv_bf16(hb, dwk, conv_dh, false, B, H, W, m2, dw16[0], dw16[1],
                                  dw16[2], dw16[3], st));
  // W_out: dgate = g @ W_out on bf16 tiles, its epilogue the gate's backward
  // (dconv and the fp32 gate from conv); dW_out = bf16(g^T gate)
  RCOT_TRY((product<true, kEpiGate, float, OPS16>(g, C, vg, w_out, vw, dconv, hid, n, 1, 0,
                                                nullptr, st, conv_dh, gate)));
  RCOT_TRY(pixel_sum<OPS16>(g, vg, gate, vh, dw_out, sums, C, hid, n, plan[kSumOut], st));
  // depthwise backward on the bf16 taps and h (conv is dead now: its
  // buffer takes dh); ddw rounded in its reduce
  RCOT_TRY(rcot_dwconv::conv_taps16(dconv, dwk, conv_dh, B, H, W, m2, plan[kDwRot],
                                    plan[kDwRot + 1], plan[kDwRot + 2], plan[kDwRot + 3], true,
                                    st));
  RCOT_TRY(rcot_dwconv::dtaps_16(hb, dconv, false, sums, ddw, B, H, W, m2, plan[kDwTaps],
                                 plan[kDwTaps + 1], plan[kDwTaps + 2], plan[kDwTaps + 3], st));
  // W_in: dx = bf16(dh @ W_in), dW_in = bf16(dh^T x) on bf16 tiles of W_in and x
  RCOT_TRY((product<true, kEpiStore, float, OPS16>(conv_dh, m2, vm, w_in, vcb, dx, C, n,
                                                 SPLIT(kBSplit, kProdDx), sums, st)));
  return pixel_sum<OPS16>(conv_dh, vm, x, vcb, dw_in, sums, m2, C, n, plan[kSumIn], st);
}

}  // namespace

extern "C" {

// qkv = bf16(dw3x3(bf16(x @ W_in^T))). Inputs x (B,H,W,C), w_in (M,C), dwk
// (M,3,3), bf16; output out (B,H,W,M) bf16. With pw (pw_dw.cuh's plan): one
// launch of the product-depthwise, no workspace. Without (where C's rows
// pass its shared memory, ops/dwconv.py pw_dw_plan): two launches, the
// product and the depthwise, through the workspace h (N,M) bf16, N =
// B*H*W, and sums (fp32, the plan's); plan: kFwdInts ints (kGateBlocks,
// kFVecH, kFVecG, out's split and kGatePass unused).
int rcot_conv1x1_dw_bf16(const bf16* x, const bf16* w_in, const bf16* dwk, bf16* out, bf16* h,
                         float* sums, const int* plan, const int* pw, int B, int H, int W, int C,
                         int M, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (pw) return rcot_pwdw::pw_dw_bf16(x, w_in, dwk, out, B, H, W, C, M, pw, st);
  const long long n = (long long)B * H * W;
  const int vc = plan[kFVecC];
  RCOT_TRY((product<false, kEpiStore>(x, C, vc, w_in, vc, h, M, n, SPLIT(kFSplit, kProdH), sums,
                                      st)));
  return rcot_dwconv::conv_bf16(h, dwk, out, true, B, H, W, M, plan[kFDw], plan[kFDw + 1],
                                plan[kFDw + 2], plan[kFDw + 3], st);
}

// Backward of rcot_conv1x1_dw_bf16 for the cotangent g (B,H,W,M) bf16.
// Outputs dx (B,H,W,C), dw_in (M,C), ddw (M,3,3), bf16. Workspace: hb (N,M)
// bf16; dh (N,M) and sums (the plan's) fp32; N = B*H*W. plan: kBwdInts ints
// (kSumOut, kBVecC, kBVecH, kDwFwd and kDwRot unused: the fp32 design's);
// plan16: kBwd16Ints ints.
int rcot_conv1x1_dw_bwd_bf16(const bf16* x, const bf16* w_in, const bf16* dwk, const bf16* g,
                             bf16* dx, bf16* dw_in, bf16* ddw, bf16* hb, float* dh, float* sums,
                             const int* plan, const int* plan16, int B, int H, int W, int C,
                             int M, int ops16, void* stream) {
  return (ops16 ? conv1x1_dw_bwd_bf16<true> : conv1x1_dw_bwd_bf16<false>)(x, w_in, dwk, g, dx,
      dw_in, ddw, hb, dh, sums, plan, plan16, B, H, W, C, M, stream);
}

// y = bf16(gate @ W_out^T), gate = bf16(gelu(c1) c2), [c1 | c2] =
// dw3x3(bf16(x @ W_in^T)) in fp32. Inputs x (B,H,W,C), w_in (2h,C), dwk
// (2h,3,3), w_out (C,h), bf16; output y (B,H,W,C) bf16. Workspace: h (N,2h)
// bf16, gate (N, gate_ld<bf16>(h)) bf16, and sums (fp32, the plan's).
// plan: kFwdInts ints, kFDw the gated depthwise's, kGatePass 0.
int rcot_gdfn_fused_bf16(const bf16* x, const bf16* w_in, const bf16* dwk, const bf16* w_out,
                         bf16* y, bf16* h, bf16* gate, float* sums, const int* plan, int B,
                         int H, int W, int C, int hid, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid, vc = plan[kFVecC], vh = plan[kFVecH], vg = plan[kFVecG];
  if (plan[kGatePass]) return cudaErrorInvalidValue;
  RCOT_TRY((product<false, kEpiStore>(x, C, vc, w_in, vc, h, m2, n, SPLIT(kFSplit, kProdH),
                                      sums, st)));
  RCOT_TRY(rcot_dwconv::conv_gate_bf16(h, dwk, gate, B, H, W, hid, gate_ld<bf16>(hid),
                                       plan[kFDw], plan[kFDw + 1], plan[kFDw + 2],
                                       plan[kFDw + 3], st));
  return product<false, kEpiStore>(gate, hid, vg, w_out, vh, y, C, n, SPLIT(kFSplit, kProdOut),
                                   sums, st, nullptr, nullptr, gate_ld<bf16>(hid));
}

// Backward of rcot_gdfn_fused_bf16 for the cotangent g (B,H,W,C) bf16.
// Outputs dx (B,H,W,C), dw_in (2h,C), ddw (2h,3,3), dw_out (C,h), bf16.
// Workspace: hb (N,2h) bf16; conv_dh (N,2h), dconv (N,2h), gate (N,h)
// fp32; sums (fp32, the plan's); N = B*H*W. plan: kBwdInts ints (kBVecC
// and kDwFwd unused: the fp32 design's); plan16: kGdfn16Ints ints.
int rcot_gdfn_fused_bwd_bf16(const bf16* x, const bf16* w_in, const bf16* dwk, const bf16* w_out,
                             const bf16* g, bf16* dx, bf16* dw_in, bf16* ddw, bf16* dw_out,
                             bf16* hb, float* conv_dh, float* dconv, float* gate, float* sums,
                             const int* plan, const int* plan16, int B, int H, int W, int C,
                             int hid, int ops16, void* stream) {
  return (ops16 ? gdfn_fused_bwd_bf16<true> : gdfn_fused_bwd_bf16<false>)(x, w_in, dwk, w_out, g,
      dx, dw_in, ddw, dw_out, hb, conv_dh, dconv, gate, sums, plan, plan16, B, H, W, C, hid,
      stream);
}

}  // extern "C"
