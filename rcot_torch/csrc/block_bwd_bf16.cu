// Fused transformer-block tail backward in bf16 for Hopper (sm_90a): the
// block tail of bf16 training in "tail" (cli.train --dtype bfloat16).
//
// Replaces the TPU kernel rcot_tpu/ops/pallas_block.py fused_block_bwd
// (pallas_call at :515, kernel body :208-397) in its tail configuration
// (block_tail, :597) as the JAX package runs it on bf16 activations and
// bf16 weights, its LayerNorm weights fp32:
//
//   recompute: pre = bf16(a @ W_proj^T), t = bf16(x + pre),
//              u = bf16(LN2(t)) (fp32 statistics), h = bf16(u @ W_in^T),
//              conv = dw3x3(h) in fp32;
//   backward, all in fp32 on the widened values: dgate = g @ W_out, the
//   gate's backward from conv; dW_out = g^T gate with the fp32 gate (the
//   forward rounds it to bf16, the backward takes it unrounded, :392-397);
//   dh, ddw, du = dh @ W_in, dW_in = dh^T u; the LN backward at t;
//   dt = that + g; da = dt @ W_proj, dW_proj = dt^T a;
//   outputs dx = bf16(dt), da in bf16, the four weight grads rounded to
//   bf16 (the JAX VJP's .astype(w.dtype), :573-578), dln_w, dln_b fp32.
//
// Bound on an H100 SXM: as block_bwd.cu's tail, bound by its operations
// (2 N (3 C^2 + 8 h C) flops of products, the recompute's part in bf16 on
// the tensor cores, the rest fp32), with half its input bytes
// (chip_smoke.py states the bound).
//
// Design. The recompute is block_fwd_bf16.cu's tail forward up to conv:
// mm.cuh's bf16 products (mma.sync m16n8k16, fp32 sums, the epilogues
// rounding as JAX rounds: t = bf16(x + bf16(acc))), ln_fwd on bf16, row
// 11's depthwise kernel bf16 into fp32 (dwconv.cuh conv_bf16). One launch
// then widens t, u, h, g, a and the four weights into fp32 workspaces
// (cast.cuh), and the rest is block_bwd.cu's tail backward on them (the
// 3xTF32 products with dgate's gate epilogue, the rotated depthwise and
// dtaps, ln_bwd.cuh, the pixel sums), every sum in a fixed order; one last
// launch rounds dx, da and the four weight grads to bf16. No atomics and
// no memsets: two calls on the same inputs give the same bits. The plan is
// ops/block.py block_bwd_plan's on the fp32 workspaces, and a second, of
// five ints, for the bf16 recompute: bf16 a copy of the C-wide operands,
// and the depthwise forward's (vec, cv, tc, rows), bf16 into fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cast.cuh"
#include "dwconv.cuh"
#include "ln_bwd.cuh"
#include "mm.cuh"

namespace {

// The launch plan, ops/block.py block_bwd_plan: ints at these offsets (as
// block_bwd.cu's), copy widths those of the fp32 workspaces.
enum Plan {
  kLnBlocks,  // blocks of the LayerNorm forward
  kLnPer,     // pixels a block of the LayerNorm backward
  kSumPer0,   // pixels a range of each pixel sum: dW_out,
  kSumPer1,   //   dW_in,
  kSumPer2,   //   dW_proj
  kVecC,      // floats a copy of the C-wide operands,
  kVecH,      //   of the h-wide ones (W_out's rows, gate),
  kVecM,      //   of the 2h-wide one (dh)
  kSplit,     // (K ranges, depth a range) of the per-pixel products t, h,
              // du, da, at kSplit + 2 * kProd*
  kDwFwd = kSplit + 8,   // (vec, cv, tc, rows) of the depthwise forward (unused:
                         //   the recompute's is bf16's, below),
  kDwRot = kDwFwd + 4,   // of its rotated forward (dh),
  kDwTaps = kDwRot + 4,  // of its dtaps
  kPlanInts = kDwTaps + 4
};
enum Prod { kProdT, kProdH, kProdDu, kProdDa };
// The recompute's plan: bf16 a copy of the C-wide bf16 operands (a, x,
// W_proj, u, W_in), and the bf16 depthwise forward's (vec, cv, tc, rows)
enum Plan16 { kVecC16, kDw16, kPlan16Ints = kDw16 + 4 };

}  // namespace

#define SPLIT(k) plan[kSplit + 2 * (k)], plan[kSplit + 2 * (k) + 1]

extern "C" {

// Block-tail backward on bf16. Inputs x, a (B,H,W,C), w_proj (C,C), w_in
// (2h,C), dwk (2h,3,3), w_out (C,h), g (B,H,W,C), bf16; ln_w, ln_b (C,
// fp32; ln_b null for BiasFree). Outputs dx, da (B,H,W,C), dw_proj (C,C),
// dw_in (2h,C), ddw (2h,3,3), dw_out (C,h), bf16; dln_w, dln_b (C, fp32;
// null with ln_b). Workspace: tb, ub (N,C), hb (N,2h) bf16; stats (2N),
// conv_dh, dconv (N,2h), gate (N,h), du (N,C), t32, u32 (N,C), h32 (N,2h),
// g32, a32, dx32, da32 (N,C), wp32 (C,C), win32 (2h,C), dwk32 (2h,9),
// wout32 (C,h), dwp32 (C,C), dwin32 (2h,C), ddw32 (2h,9), dwout32 (C,h),
// sums (the plan's), fp32; N = B*H*W. plan: kPlanInts ints; plan16:
// kPlan16Ints ints.
int rcot_block_tail_bwd_bf16(
    const bf16* x, const bf16* a, const bf16* w_proj, const float* ln_w, const float* ln_b,
    const bf16* w_in, const bf16* dwk, const bf16* w_out, const bf16* g, bf16* dx, bf16* da,
    bf16* dw_proj, float* dln_w, float* dln_b, bf16* dw_in, bf16* ddw, bf16* dw_out, bf16* tb,
    bf16* ub, bf16* hb, float* stats, float* conv_dh, float* dconv, float* gate, float* du,
    float* t32, float* u32, float* h32, float* g32, float* a32, float* dx32, float* da32,
    float* wp32, float* win32, float* dwk32, float* wout32, float* dwp32, float* dwin32,
    float* ddw32, float* dwout32, float* sums, const int* plan, const int* plan16, int B, int H,
    int W, int C, int hid, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid, vc = plan[kVecC], vh = plan[kVecH], vm = plan[kVecM];
  const int vb = plan16[kVecC16];
  // recompute in bf16, rounding as the forward: t = bf16(x + bf16(a @ W_proj^T)),
  // u = bf16(LN2(t)), h = bf16(u @ W_in^T), conv = dw3x3(h) in fp32
  RCOT_TRY((product<false, kEpiAdd>(a, C, vb, w_proj, vb, tb, C, n, SPLIT(kProdT), sums, st, x)));
  RCOT_TRY(ln_fwd(tb, ln_w, ln_b, ub, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(ub, C, vb, w_in, vb, hb, m2, n, SPLIT(kProdH), sums, st)));
  RCOT_TRY(rcot_dwconv::conv_bf16(hb, dwk, conv_dh, false, B, H, W, m2, plan16[kDw16],
                                  plan16[kDw16 + 1], plan16[kDw16 + 2], plan16[kDw16 + 3], st));
  // every operand of the backward, widened to fp32
  Widen up;
  up.add(tb, C, t32, C, n, C);
  up.add(ub, C, u32, C, n, C);
  up.add(hb, m2, h32, m2, n, m2);
  up.add(g, C, g32, C, n, C);
  up.add(a, C, a32, C, n, C);
  up.add(w_proj, C, wp32, C, C, C);
  up.add(w_in, C, win32, C, m2, C);
  up.add(dwk, 9, dwk32, 9, m2, 9);
  up.add(w_out, hid, wout32, hid, C, hid);
  RCOT_TRY(up.run(st));
  // W_out: dgate = g @ W_out, its epilogue the gate's backward (dconv and
  // the fp32 gate from conv); dW_out = g^T gate
  RCOT_TRY((product<true, kEpiGate>(g32, C, vc, wout32, vh, dconv, hid, n, 1, 0, nullptr, st,
                                    conv_dh, gate)));
  RCOT_TRY(pixel_sum(g32, vc, gate, vh, dwout32, sums, C, hid, n, plan[kSumPer0], st));
  // depthwise backward (conv is dead now: its buffer takes dh)
  RCOT_TRY(rcot_dwconv::conv(dconv, dwk32, conv_dh, B, H, W, m2, plan[kDwRot], plan[kDwRot + 1],
                             plan[kDwRot + 2], plan[kDwRot + 3], true, st));
  RCOT_TRY(rcot_dwconv::dtaps(h32, dconv, sums, ddw32, B, H, W, m2, plan[kDwTaps],
                              plan[kDwTaps + 1], plan[kDwTaps + 2], plan[kDwTaps + 3], st));
  // W_in: du = dh @ W_in, dW_in = dh^T u
  RCOT_TRY((product<true, kEpiStore>(conv_dh, m2, vm, win32, vc, du, C, n, SPLIT(kProdDu), sums,
                                     st)));
  RCOT_TRY(pixel_sum(conv_dh, vm, u32, vc, dwin32, sums, m2, C, n, plan[kSumPer1], st));
  // LN2 and the residual: dt = LN-VJP(du) at t, plus g
  RCOT_TRY(ln_bwd(t32, du, stats, ln_w, ln_b, g32, dx32, dln_w, dln_b, sums, n, C, plan[kLnPer],
                  st));
  // W_proj: da = dt @ W_proj, dW_proj = dt^T a
  RCOT_TRY((product<true, kEpiStore>(dx32, C, vc, wp32, vc, da32, C, n, SPLIT(kProdDa), sums,
                                     st)));
  RCOT_TRY(pixel_sum(dx32, vc, a32, vc, dwp32, sums, C, C, n, plan[kSumPer2], st));
  Narrow down;
  down.add(dx32, C, dx, C, n, C);
  down.add(da32, C, da, C, n, C);
  down.add(dwp32, C, dw_proj, C, C, C);
  down.add(dwin32, C, dw_in, C, m2, C);
  down.add(ddw32, 9, ddw, 9, m2, 9);
  down.add(dwout32, hid, dw_out, hid, C, hid);
  return down.run(st);
}

}  // extern "C"
