// Fused transformer-block backward in bf16 for Hopper (sm_90a), in both
// configurations: the block tail of bf16 training in "tail" and "full",
// the block head in "full" and "head" (cli.train --dtype bfloat16).
//
// Replaces the TPU kernel rcot_tpu/ops/pallas_block.py fused_block_bwd
// (pallas_call at :515, kernel body :208-397) in its tail configuration
// (block_tail, :597) and its head configuration (block_head, :586) as the
// JAX package runs them on bf16 activations and bf16 weights, its
// LayerNorm weights fp32:
//
//   tail recompute: pre = bf16(a @ W_proj^T), t = bf16(x + pre),
//              u = bf16(LN2(t)) (fp32 statistics), h = bf16(u @ W_in^T),
//              conv = dw3x3(h) in fp32;
//   tail backward, all in fp32 on the widened values: dgate = g @ W_out, the
//   gate's backward from conv; dW_out = g^T gate with the fp32 gate (the
//   forward rounds it to bf16, the backward takes it unrounded, :392-397);
//   dh, ddw, du = dh @ W_in, dW_in = dh^T u; the LN backward at t;
//   dt = that + g; da = dt @ W_proj, dW_proj = dt^T a;
//   outputs dx = bf16(dt), da in bf16, the four weight grads rounded to
//   bf16 (the JAX VJP's .astype(w.dtype), :573-578), dln_w, dln_b fp32.
//
//   head recompute: u = bf16(LN1(x)) (fp32 statistics), h = bf16(u @
//              W_qkv^T) (:280-285); no conv: with no gate dconv = g (:309);
//   head backward, in fp32 on the bf16 values: dh = the rotated dw3x3
//   of g, ddw = the pixel sum of g times the h taps, du = dh @ W_qkv,
//   dW_qkv = dh^T u, the LN backward at x; outputs dx = bf16(dx), dW_qkv
//   and ddw rounded to bf16, dln_w, dln_b fp32.
//
// Bound on an H100 SXM: as block_bwd.cu's, bound by its operations (the
// tail 2 N (3 C^2 + 8 h C) flops of products, the head 2 N 2 * 3C C, the
// recompute's part and every product of two bf16 operands in bf16 on the
// tensor cores, a product of a bf16 and an fp32 operand as two TF32 terms;
// the rest fp32), with half its input bytes (chip_smoke.py bf16_bwd_work
// states the bound).
//
// Design. The tail's recompute is block_fwd_bf16.cu's tail forward up to
// conv: mm.cuh's bf16 products (mma.sync m16n8k16, fp32 sums, the
// epilogues rounding as JAX rounds: t = bf16(x + bf16(acc))), ln_fwd on
// bf16, row 11's depthwise kernel bf16 into fp32 (dwconv.cuh conv_bf16);
// the head's is block_fwd_bf16.cu's head up to h (ln_fwd, the bf16
// product). So the backward starts from the rounded u and h, as JAX's
// does.
//
// Both backwards are block_bwd.cu's on the bf16 tensors themselves: their
// 1x1 products and pixel sums are mm.cuh's tf32 path on bf16 tiles
// (product with T = float, pixel_sum: a bf16 operand staged by cp.async at
// half the bytes, each value widened into its tf32 fragment, the 3xTF32
// terms of its zero low half left out: the tail's dgate = g W_out one
// mma.sync a step, the rest two). The tail's depthwise backward is the
// rotated depthwise of the fp32 dconv on the bf16 taps (conv_taps16) and
// dtaps of the bf16 h with dconv (dtaps_16) on the fp32 plan's tiles; the
// head's, whose dconv is its bf16 cotangent g, the rotated depthwise of g
// on the bf16 taps into fp32 (conv_bf16_rot) and dtaps of the bf16 h and g
// (dtaps_16) on the fp32 plan's columns and band. ln_bwd.cuh reads the
// bf16 t (the head's x) as it is: the tail's adds the residual g and
// writes the fp32 dt for da and dW_proj beside the bf16 dx in the same
// launch, the head's writes the bf16 dx alone. Each bf16 output (da,
// dW_out, dW_in, dW_proj, dW_qkv, ddw, dx) is rounded once where it is
// written, by an epilogue or after a fixed-order sum. Every sum keeps the
// fp32 design's order and ranges, and every value the fp32 design took
// widened is exact, so the outputs are the bits of that design on the
// widened operands, rounded once: no widening or rounding launch, no fp32
// copy of an operand (eighteen launches in the tail, ten in the head at
// the level-1 shapes). No atomics and no memsets: two calls on the same
// inputs give the same bits. The plan is ops/block.py block_bwd_plan's,
// the fp32 design's (copy widths in floats of the fp32 operands), and a
// second for the bf16 ones: the tail's seven ints (bf16 a copy of the
// C-wide operands, of g and of W_out's rows, and the depthwise forward's
// (vec, cv, tc, rows), bf16 into fp32), the head's nine (ops/block.py
// qkv_bwd_bf16_plan: bf16 a copy of u and W_qkv, the (vec, cv, tc, rows)
// of the rotated depthwise of g and of dtaps).
//
// bf16 operands (RCOT_BWD_BF16's "block" tier, the `ops16` argument): the
// backward products take mm.cuh's OPS16 policy, as in block_bwd.cu; a bf16
// value is exact in bf16, so only the fp32 intermediates (dh, dt, the gate)
// round, and a bf16 tile's fragments are its values widened.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dwconv.cuh"
#include "ln_bwd.cuh"
#include "mm.cuh"

namespace {

// The launch plan, ops/block.py block_bwd_plan: ints at these offsets (as
// block_bwd.cu's), copy widths those of the fp32 workspaces.
enum Plan {
  kLnBlocks,  // blocks of the LayerNorm forward
  kLnPer,     // pixels a block of the LayerNorm backward
  kSumPer0,   // pixels a range of each pixel sum: dW_out (dW_qkv in the head),
  kSumPer1,   //   dW_in,
  kSumPer2,   //   dW_proj
  kVecC,      // floats a copy of the C-wide operands,
  kVecH,      //   of the h-wide ones (W_out's rows, gate),
  kVecM,      //   of the 2h- or 3C-wide ones (h, dh, the head's g)
  kSplit,     // (K ranges, depth a range) of the per-pixel products t, h,
              // du, da, at kSplit + 2 * kProd*
  kDwFwd = kSplit + 8,   // (vec, cv, tc, rows) of the depthwise forward (unused:
                         //   the recompute's is bf16's, below),
  kDwRot = kDwFwd + 4,   // of its rotated forward (dh),
  kDwTaps = kDwRot + 4,  // of its dtaps
  kPlanInts = kDwTaps + 4
};
enum Prod { kProdT, kProdH, kProdDu, kProdDa };
// The tail's bf16 plan: bf16 a copy of the C-wide bf16 operands (a, W_proj,
// u, W_in), of g and of W_out's rows, and the bf16 depthwise forward's
// (vec, cv, tc, rows) into fp32 conv
enum Plan16 { kVecC16, kVecG16, kVecH16, kDw16, kPlan16Ints = kDw16 + 4 };
// The head's bf16 plan: bf16 a copy of u and W_qkv, and the (vec, cv, tc,
// rows) of the rotated depthwise of g and of dtaps (bf16 a copy; dtaps's tc
// and rows those of the fp32 plan)
enum Head16 { kHVecC16, kHRot16, kHTaps16 = kHRot16 + 4, kHead16Ints = kHTaps16 + 4 };

}  // namespace

#define SPLIT(k) plan[kSplit + 2 * (k)], plan[kSplit + 2 * (k) + 1]

namespace {

template <bool OPS16>
int block_tail_bwd_bf16(const bf16* x, const bf16* a, const bf16* w_proj, const float* ln_w,
                        const float* ln_b, const bf16* w_in, const bf16* dwk, const bf16* w_out,
                        const bf16* g, bf16* dx, bf16* da, bf16* dw_proj, float* dln_w,
                        float* dln_b, bf16* dw_in, bf16* ddw, bf16* dw_out, bf16* tb, bf16* ub,
                        bf16* hb, float* stats, float* conv_dh, float* dconv, float* gate,
                        float* du, float* dt, float* sums, const int* plan, const int* plan16,
                        int B, int H, int W, int C, int hid, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid, vc = plan[kVecC], vh = plan[kVecH], vm = plan[kVecM];
  const int vb = plan16[kVecC16], vg = plan16[kVecG16], vw = plan16[kVecH16];
  // recompute in bf16, rounding as the forward: t = bf16(x + bf16(a @ W_proj^T)),
  // u = bf16(LN2(t)), h = bf16(u @ W_in^T), conv = dw3x3(h) in fp32
  RCOT_TRY((product<false, kEpiAdd>(a, C, vb, w_proj, vb, tb, C, n, SPLIT(kProdT), sums, st, x)));
  RCOT_TRY(ln_fwd(tb, ln_w, ln_b, ub, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(ub, C, vb, w_in, vb, hb, m2, n, SPLIT(kProdH), sums, st)));
  RCOT_TRY(rcot_dwconv::conv_bf16(hb, dwk, conv_dh, false, B, H, W, m2, plan16[kDw16],
                                  plan16[kDw16 + 1], plan16[kDw16 + 2], plan16[kDw16 + 3], st));
  // W_out: dgate = g @ W_out on bf16 tiles, its epilogue the gate's backward
  // (dconv and the fp32 gate from conv); dW_out = g^T gate, rounded
  RCOT_TRY((product<true, kEpiGate, float, OPS16>(g, C, vg, w_out, vw, dconv, hid, n, 1, 0, nullptr,
                                                st, conv_dh, gate)));
  RCOT_TRY(pixel_sum<OPS16>(g, vg, gate, vh, dw_out, sums, C, hid, n, plan[kSumPer0], st));
  // depthwise backward on the bf16 taps and h (conv is dead now: its
  // buffer takes dh); ddw rounded in its reduce
  RCOT_TRY(rcot_dwconv::conv_taps16(dconv, dwk, conv_dh, B, H, W, m2, plan[kDwRot],
                                    plan[kDwRot + 1], plan[kDwRot + 2], plan[kDwRot + 3], true,
                                    st));
  RCOT_TRY(rcot_dwconv::dtaps_16(hb, dconv, false, sums, ddw, B, H, W, m2, plan[kDwTaps],
                                 plan[kDwTaps + 1], plan[kDwTaps + 2], plan[kDwTaps + 3], st));
  // W_in: du = dh @ W_in, dW_in = dh^T u, rounded
  RCOT_TRY((product<true, kEpiStore, float, OPS16>(conv_dh, m2, vm, w_in, vb, du, C, n,
                                                 SPLIT(kProdDu), sums, st)));
  RCOT_TRY(pixel_sum<OPS16>(conv_dh, vm, ub, vb, dw_in, sums, m2, C, n, plan[kSumPer1], st));
  // LN2 and the residual: dt = LN-VJP(du) at t, plus g; dx = bf16(dt)
  RCOT_TRY(ln_bwd(tb, du, stats, ln_w, ln_b, g, dt, dln_w, dln_b, sums, n, C, plan[kLnPer], st,
                  dx));
  // W_proj: da = bf16(dt @ W_proj), dW_proj = dt^T a, rounded
  RCOT_TRY((product<true, kEpiStore, float, OPS16>(dt, C, vc, w_proj, vb, da, C, n, SPLIT(kProdDa),
                                                 sums, st)));
  return pixel_sum<OPS16>(dt, vc, a, vb, dw_proj, sums, C, C, n, plan[kSumPer2], st);
}

template <bool OPS16>
int block_head_bwd_bf16(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w_qkv,
                        const bf16* dwk, const bf16* g, bf16* dx, float* dln_w, float* dln_b,
                        bf16* dw_qkv, bf16* ddw, bf16* ub, bf16* hb, float* stats, float* dh,
                        float* du, float* sums, const int* plan, const int* plan16, int B, int H,
                        int W, int C, int M, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int vm = plan[kVecM], vcb = plan16[kHVecC16];
  const int* rot = plan16 + kHRot16;
  const int* taps = plan16 + kHTaps16;
  // recompute in bf16, rounding as the forward: u = bf16(LN1(x)), h = bf16(u @ W_qkv^T)
  RCOT_TRY(ln_fwd(x, ln_w, ln_b, ub, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(ub, C, vcb, w_qkv, vcb, hb, M, n, SPLIT(kProdH), sums,
                                      st)));
  // depthwise backward, dconv = g: dh = the rotated forward of the bf16 g
  // on the bf16 taps into fp32, ddw = bf16(dtaps(h, g))
  RCOT_TRY(rcot_dwconv::conv_bf16_rot(g, dwk, dh, B, H, W, M, rot[0], rot[1], rot[2], rot[3],
                                      st));
  RCOT_TRY(rcot_dwconv::dtaps_16(hb, g, true, sums, ddw, B, H, W, M, taps[0], taps[1], taps[2],
                                 taps[3], st));
  // W_qkv: du = dh @ W_qkv, dW_qkv = bf16(dh^T u) on bf16 tiles of W_qkv and u
  RCOT_TRY((product<true, kEpiStore, float, OPS16>(dh, M, vm, w_qkv, vcb, du, C, n,
                                                 SPLIT(kProdDu), sums, st)));
  RCOT_TRY(pixel_sum<OPS16>(dh, vm, ub, vcb, dw_qkv, sums, M, C, n, plan[kSumPer0], st));
  // LN1: dx = bf16(LN-VJP(du) at x), no fp32 dt
  return ln_bwd(x, du, stats, ln_w, ln_b, nullptr, nullptr, dln_w, dln_b, sums, n, C,
                plan[kLnPer], st, dx);
}

}  // namespace

extern "C" {

// Block-tail backward on bf16. Inputs x, a (B,H,W,C), w_proj (C,C), w_in
// (2h,C), dwk (2h,3,3), w_out (C,h), g (B,H,W,C), bf16; ln_w, ln_b (C,
// fp32; ln_b null for BiasFree). Outputs dx, da (B,H,W,C), dw_proj (C,C),
// dw_in (2h,C), ddw (2h,3,3), dw_out (C,h), bf16; dln_w, dln_b (C, fp32;
// null with ln_b). Workspace: tb, ub (N,C), hb (N,2h) bf16; stats (2N),
// conv_dh, dconv (N,2h), gate (N,h), du, dt (N,C), sums (the plan's), fp32;
// N = B*H*W. plan: kPlanInts ints; plan16: kPlan16Ints ints.
int rcot_block_tail_bwd_bf16(const bf16* x, const bf16* a, const bf16* w_proj, const float* ln_w,
                             const float* ln_b, const bf16* w_in, const bf16* dwk,
                             const bf16* w_out, const bf16* g, bf16* dx, bf16* da, bf16* dw_proj,
                             float* dln_w, float* dln_b, bf16* dw_in, bf16* ddw, bf16* dw_out,
                             bf16* tb, bf16* ub, bf16* hb, float* stats, float* conv_dh,
                             float* dconv, float* gate, float* du, float* dt, float* sums,
                             const int* plan, const int* plan16, int B, int H, int W, int C,
                             int hid, int ops16, void* stream) {
  return (ops16 ? block_tail_bwd_bf16<true> : block_tail_bwd_bf16<false>)(x, a, w_proj, ln_w, ln_b,
      w_in, dwk, w_out, g, dx, da, dw_proj, dln_w, dln_b, dw_in, ddw, dw_out, tb, ub, hb, stats,
      conv_dh, dconv, gate, du, dt, sums, plan, plan16, B, H, W, C, hid, stream);
}

// Block-head backward on bf16. Inputs x (B,H,W,C), w_qkv (M,C), dwk
// (M,3,3), g (B,H,W,M), bf16; ln_w, ln_b (C, fp32; ln_b null for BiasFree).
// Outputs dx (B,H,W,C), dw_qkv (M,C), ddw (M,3,3), bf16; dln_w, dln_b (C,
// fp32; null with ln_b). Workspace: ub (N,C), hb (N,M) bf16; stats (2N),
// dh (N,M), du (N,C), sums (the plan's), fp32; N = B*H*W. plan: kPlanInts
// ints (block_head_bwd's); plan16: kHead16Ints ints.
int rcot_block_head_bwd_bf16(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w_qkv,
                             const bf16* dwk, const bf16* g, bf16* dx, float* dln_w, float* dln_b,
                             bf16* dw_qkv, bf16* ddw, bf16* ub, bf16* hb, float* stats, float* dh,
                             float* du, float* sums, const int* plan, const int* plan16, int B,
                             int H, int W, int C, int M, int ops16, void* stream) {
  return (ops16 ? block_head_bwd_bf16<true> : block_head_bwd_bf16<false>)(x, ln_w, ln_b, w_qkv,
      dwk, g, dx, dln_w, dln_b, dw_qkv, ddw, ub, hb, stats, dh, du, sums, plan, plan16, B, H, W, C,
      M, stream);
}

}  // extern "C"
