// Fused [1x1 ->] depthwise 3x3 [-> gelu gate -> 1x1] for Hopper (sm_90a),
// forward and backward.
//
// Replaces the TPU kernels of rcot_tpu/ops/pallas_fused.py in the two
// configurations the model calls:
//
//   conv1x1_dw (conv1x1_dw_fused, pallas_fused.py:568; the MDTA qkv path):
//       qkv = dw3x3( x @ W_in^T )                       x (B,H,W,C) -> (B,H,W,M)
//   gdfn_fused (gdfn_fused, pallas_fused.py:549; the whole GDFN):
//       y = ( gelu(c1) * c2 ) @ W_out^T,  [c1 | c2] = dw3x3( x @ W_in^T )
//                                                       x (B,H,W,C) -> (B,H,W,C)
//
// forward: fused_dwconv_fwd (pallas_call at :274); backward: fused_dwconv_bwd
// (pallas_call at :456), which recomputes the forward from x and the weights.
// Weights are in the port's layouts, read in place: W_in (M, C), taps
// (M, 3, 3), W_out (C, h) with M = 2h in the GDFN. gelu is the exact-erf
// form (erff); the TPU kernel's erf was the Abramowitz-Stegun 7.1.26
// polynomial (|error| < 1.5e-7).
//
// Bound on an H100 SXM. The qkv configuration does 2 N M C flops of 1x1
// product and 18 M of stencil a pixel against 4 (C + M) bytes, the GDFN
// 6 N h C and ~46 h against 8 C: on the CUDA cores (67 TFLOP/s fp32, the
// bound chip_smoke.py states) both are bound by operations at every block
// shape. As 3xTF32 on the tensor cores (495 TF32 / 3 = 165 TFLOP/s) the
// products' floor is 2.5x lower, and the design's own launches (below)
// move the wide intermediates through device memory: C + 3M floats a pixel
// in the qkv forward, 2C + 8h in the GDFN's (10h with a gate pass), 3C + 7M
// and 5C + 24h in the backwards, which at the level-1 shapes is a larger
// floor than the products' (tools/port_fused_times.py design_floors).
//
// Design. These are the block kernels without the LayerNorm and the
// residuals (block_fwd.cu, block_bwd.cu), a chain of launches on one
// stream, the plan (ops/fused.py fused_fwd_plan, fused_bwd_plan) passed in
// as ints and the intermediates in workspaces the caller allocates:
//   qkv forward:  h = x @ W_in^T (mm.cuh's 3xTF32 product); out = dw3x3(h)
//                 (row 11's kernel, dwconv.cuh);
//   GDFN forward: h = x @ W_in^T; conv = dw3x3(h); y = gate @ W_out^T,
//                 gate = gelu(c1) c2, taken in the product as it stages conv
//                 where C fits one output tile, else written once by a gate
//                 pass into h's buffer (dead by then), as the block tail;
//   qkv backward: h = x @ W_in^T again; dh = the rotated dw3x3 of g;
//                 ddw = dtaps(h, g); dx = dh @ W_in; dW_in = dh^T x;
//   GDFN backward: h and conv again; dgate = g @ W_out, its epilogue the
//                 gate's backward (writes dconv and the gate, so dgate is
//                 never stored); dW_out = g^T gate; dh = the rotated dw3x3
//                 of dconv (into conv's buffer); ddw = dtaps(h, dconv);
//                 dx = dh @ W_in; dW_in = dh^T x.
// h lies in device memory for every pixel, so the conv's zero padding is
// "outside the image reads 0". Pixel sums take the pixels as depth in
// ranges of at most 512 pixels, a product whose tiles alone leave the card
// short splits K, and every split's partials are added in a fixed order by
// sum_parts: no atomics and no memsets, so two calls on the same inputs
// give the same bits. Odd h (127, 255, 1,021) takes the narrower copies
// that the plan gives its width class; nothing is padded but a gate pass's
// rows.

#include <cuda_runtime.h>

#include "dwconv.cuh"
#include "mm.cuh"

namespace {

// The forward's plan, ops/fused.py fused_fwd_plan: ints at these offsets.
enum FwdPlan {
  kGateBlocks,  // blocks of a gate pass
  kFVecC,       // floats a copy of the C-wide operands (x, W_in),
  kFVecH,       //   of the h-wide ones (either half of conv, W_out's rows),
  kFVecG,       //   of a gate pass's padded rows
  kFSplit,      // (K ranges, depth a range) of the products h and out
  kFDw = kFSplit + 4,      // (vec, cv, tc, rows) of the depthwise forward
  kGatePass = kFDw + 4,    // 1: the gate as a pass of its own
  kFwdInts
};
// The backward's plan, ops/fused.py fused_bwd_plan.
enum BwdPlan {
  kSumOut,  // pixels a range of the pixel sums dW_out,
  kSumIn,   //   and dW_in
  kBVecC,   // floats a copy of the C-wide operands (x, W_in, the GDFN's g),
  kBVecH,   //   of the h-wide ones (W_out's rows, the gate),
  kBVecM,   //   of the M-wide ones (h, dh, dconv, the qkv's g)
  kBSplit,  // (K ranges, depth a range) of the products h and dx
  kDwFwd = kBSplit + 4,  // (vec, cv, tc, rows) of the depthwise forward,
  kDwRot = kDwFwd + 4,   //   of its rotated forward (dh),
  kDwTaps = kDwRot + 4,  //   of its dtaps
  kBwdInts = kDwTaps + 4
};
enum Prod { kProdH, kProdOut, kProdDx = kProdOut };

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

}  // namespace

// the plan's (K ranges, depth a range) of product k, at plan[at + 2k]
#define SPLIT(at, k) plan[(at) + 2 * (k)], plan[(at) + 2 * (k) + 1]

namespace {

template <bool OPS16>
int conv1x1_dw_bwd(const float* x, const float* w_in, const float* dwk, const float* g, float* dx,
                   float* dw_in, float* ddw, float* h, float* dh, float* sums, const int* plan,
                   int B, int H, int W, int C, int M, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int vc = plan[kBVecC], vm = plan[kBVecM];
  // recompute h = x @ W_in^T; with no gate and no W_out, dconv = g
  RCOT_TRY((product<false, kEpiStore>(x, C, vc, w_in, vc, h, M, n, SPLIT(kBSplit, kProdH), sums,
                                      st)));
  RCOT_TRY(dw(g, dwk, dh, B, H, W, M, plan, kDwRot, true, st));
  RCOT_TRY(dw_taps(h, g, sums, ddw, B, H, W, M, plan, st));
  // dx = dh @ W_in, dW_in = dh^T x
  RCOT_TRY((product<true, kEpiStore, float, OPS16>(dh, M, vm, w_in, vc, dx, C, n,
                                                   SPLIT(kBSplit, kProdDx), sums, st)));
  return pixel_sum<OPS16>(dh, vm, x, vc, dw_in, sums, M, C, n, plan[kSumIn], st);
}

template <bool OPS16>
int gdfn_fused_bwd(const float* x, const float* w_in, const float* dwk, const float* w_out,
                   const float* g, float* dx, float* dw_in, float* ddw, float* dw_out, float* h,
                   float* conv_dh, float* dconv, float* gate, float* sums, const int* plan, int B,
                   int H, int W, int C, int hid, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid, vc = plan[kBVecC], vh = plan[kBVecH], vm = plan[kBVecM];
  // recompute h = x @ W_in^T, conv = dw3x3(h)
  RCOT_TRY((product<false, kEpiStore>(x, C, vc, w_in, vc, h, m2, n, SPLIT(kBSplit, kProdH),
                                      sums, st)));
  RCOT_TRY(dw(h, dwk, conv_dh, B, H, W, m2, plan, kDwFwd, false, st));
  // W_out: dgate = g @ W_out, its epilogue the gate's backward (dconv and
  // gate from conv); dW_out = g^T gate
  RCOT_TRY((product<true, kEpiGate, float, OPS16>(g, C, vc, w_out, vh, dconv, hid, n, 1, 0, nullptr,
                                                  st, conv_dh, gate)));
  RCOT_TRY(pixel_sum<OPS16>(g, vc, gate, vh, dw_out, sums, C, hid, n, plan[kSumOut], st));
  // depthwise backward (conv is dead now: its buffer takes dh)
  RCOT_TRY(dw(dconv, dwk, conv_dh, B, H, W, m2, plan, kDwRot, true, st));
  RCOT_TRY(dw_taps(h, dconv, sums, ddw, B, H, W, m2, plan, st));
  // W_in: dx = dh @ W_in, dW_in = dh^T x
  RCOT_TRY((product<true, kEpiStore, float, OPS16>(conv_dh, m2, vm, w_in, vc, dx, C, n,
                                                   SPLIT(kBSplit, kProdDx), sums, st)));
  return pixel_sum<OPS16>(conv_dh, vm, x, vc, dw_in, sums, m2, C, n, plan[kSumIn], st);
}

}  // namespace

extern "C" {

// qkv = dw3x3(x @ W_in^T). Inputs x (B,H,W,C), w_in (M,C), dwk (M,3,3);
// output out (B,H,W,M). Workspace: h (N,M), N = B*H*W, and sums
// (ops/fused.py fused_fwd_plan's). plan: kFwdInts ints (kGateBlocks,
// kFVecH, kFVecG, out's split and kGatePass unused).
int rcot_conv1x1_dw(const float* x, const float* w_in, const float* dwk, float* out, float* h,
                    float* sums, const int* plan, int B, int H, int W, int C, int M,
                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int vc = plan[kFVecC];
  RCOT_TRY((product<false, kEpiStore>(x, C, vc, w_in, vc, h, M, n, SPLIT(kFSplit, kProdH), sums,
                                      st)));
  return dw(h, dwk, out, B, H, W, M, plan, kFDw, false, st);
}

// y = (gelu(c1) c2) @ W_out^T, [c1 | c2] = dw3x3(x @ W_in^T). Inputs x
// (B,H,W,C), w_in (2h,C), dwk (2h,3,3), w_out (C,h); output y (B,H,W,C).
// Workspace: h (N, max(2h, gate_ld(h))), conv (N,2h), N = B*H*W, and sums
// (ops/fused.py fused_fwd_plan's). plan: kFwdInts ints.
int rcot_gdfn_fused(const float* x, const float* w_in, const float* dwk, const float* w_out,
                    float* y, float* h, float* conv, float* sums, const int* plan, int B, int H,
                    int W, int C, int hid, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid, vc = plan[kFVecC], vh = plan[kFVecH];
  RCOT_TRY((product<false, kEpiStore>(x, C, vc, w_in, vc, h, m2, n, SPLIT(kFSplit, kProdH),
                                      sums, st)));
  RCOT_TRY(dw(h, dwk, conv, B, H, W, m2, plan, kFDw, false, st));
  // no input to add: the gated product stores its product alone
  if (!plan[kGatePass])
    return product<false, kEpiGatedAdd>(conv, hid, vh, w_out, vh, y, C, n,
                                        SPLIT(kFSplit, kProdOut), sums, st);
  // h is dead: its buffer takes the gate
  RCOT_TRY(gate_pass(conv, h, n, hid, plan[kGateBlocks], st));
  return product<false, kEpiStore>(h, hid, plan[kFVecG], w_out, vh, y, C, n,
                                   SPLIT(kFSplit, kProdOut), sums, st, nullptr, nullptr,
                                   gate_ld(hid));
}

// Backward of rcot_conv1x1_dw for the cotangent g (B,H,W,M). Outputs dx
// (B,H,W,C), dw_in (M,C), ddw (M,3,3). Workspace: h (N,M), dh (N,M),
// N = B*H*W, and sums (ops/fused.py fused_bwd_plan's). plan: kBwdInts ints
// (kSumOut, kBVecH and kDwFwd unused).
int rcot_conv1x1_dw_bwd(const float* x, const float* w_in, const float* dwk, const float* g,
                        float* dx, float* dw_in, float* ddw, float* h, float* dh, float* sums,
                        const int* plan, int B, int H, int W, int C, int M, int ops16,
                        void* stream) {
  return (ops16 ? conv1x1_dw_bwd<true> : conv1x1_dw_bwd<false>)(x, w_in, dwk, g, dx, dw_in, ddw, h,
                                                                dh, sums, plan, B, H, W, C, M,
                                                                stream);
}

// Backward of rcot_gdfn_fused for the cotangent g (B,H,W,C). Outputs dx
// (B,H,W,C), dw_in (2h,C), ddw (2h,3,3), dw_out (C,h). Workspace: h (N,2h),
// conv_dh (N,2h), dconv (N,2h), gate (N,h), N = B*H*W, and sums
// (ops/fused.py fused_bwd_plan's). plan: kBwdInts ints.
int rcot_gdfn_fused_bwd(const float* x, const float* w_in, const float* dwk, const float* w_out,
                        const float* g, float* dx, float* dw_in, float* ddw, float* dw_out,
                        float* h, float* conv_dh, float* dconv, float* gate, float* sums,
                        const int* plan, int B, int H, int W, int C, int hid, int ops16,
                        void* stream) {
  return (ops16 ? gdfn_fused_bwd<true> : gdfn_fused_bwd<false>)(x, w_in, dwk, w_out, g, dx, dw_in,
                                                                ddw, dw_out, h, conv_dh, dconv,
                                                                gate, sums, plan, B, H, W, C, hid,
                                                                stream);
}

}  // extern "C"
