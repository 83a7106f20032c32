// Fused transformer-block forward in bf16 for Hopper (sm_90a): serving's
// bf16 path (make_restorer(dtype=torch.bfloat16), cli.test --dtype
// bfloat16).
//
// Replaces the TPU kernel rcot_tpu/ops/pallas_block.py fused_block_fwd
// (pallas_call at :189) as the JAX package runs it on bf16 activations and
// bf16 weights (block_head :586, block_tail :597), rounding to bf16 where
// its _fwd_kernel (:111-142) rounds:
//
//   head: u = bf16(LN1(x)); h = bf16(u @ W_qkv^T); qkv = bf16(dw3x3(h))
//   tail: t = bf16(x + bf16(a @ W_proj^T)); u = bf16(LN2(t));
//         h = bf16(u @ W_in^T); [c1 | c2] = dw3x3(h) (fp32);
//         g = bf16(gelu(c1) c2); y = bf16(t + bf16(g @ W_out^T))
//
// The LayerNorm's statistics, the depthwise sums and the gate are fp32;
// the products take bf16 operands on mma.sync m16n8k16 and accumulate in
// fp32 (a bf16 product is exact in fp32). LN weights are fp32, every other
// weight bf16, as the JAX block dispatch passes them (rcot_tpu/models/
// restormer.py:77-89). gelu is the exact-erf form (erff), as the fp32
// kernel's; the JAX kernel's A&S 7.1.26 erf differs by < 1.5e-7, far below
// a bf16 ulp.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores):
// the head reads 2C and writes 6C bytes a pixel against 6 C^2 flops, bound
// by its bytes at every block shape; the tail reads 4C and writes 2C
// against about 18 C^2, bound by its bytes up to C = 96 and by its
// operations above (chip_smoke.py's bound). The design's own launches move
// the intermediates through device memory in bf16 (u, h, t, the gate); the
// fp32 conv, which the gate takes unrounded, never leaves the SM.
//
// Design: the head is ln_fwd into u and one launch of the product-depthwise
// on it (pw_dw.cuh: the W_qkv product taken inside the depthwise's band, h
// never in device memory, ops/dwconv.py pw_dw_plan), with the bits of the
// bf16 product and the depthwise it replaced, which stay for C past its
// shared memory. The tail is block_fwd.cu's chain
// of launches on mm.cuh's products, ln_fwd and row 11's depthwise forward,
// instantiated for bf16 (mm.cuh, dwconv.cu), with the same plan
// (ops/block.py block_fwd_plan, copy widths in bf16 elements). The tail's
// depthwise takes the gate itself (dwconv.cuh
// conv_gate_bf16: both halves of conv summed as conv_bf16 sums them, the
// gate taken in registers and rounded once) into a workspace in rows of
// gate_ld<bf16>(h) = h rounded up to 8, which the W_out product reads:
// five launches (proj product, LN, W_in product, the gated depthwise, the
// W_out product), more where a product splits. Split products add their
// fp32 partials in a fixed order and round after the sum. No atomics and
// no memsets: two calls on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dwconv.cuh"
#include "mm.cuh"
#include "pw_dw.cuh"

namespace {

// The launch plan, ops/block.py block_fwd_plan: ints at these offsets (as
// block_fwd.cu's).
enum Plan {
  kLnBlocks,  // blocks of the LayerNorm forward
  kVecC,      // bf16 a copy of the C-wide operands (a, u, W_proj, W_in, W_qkv),
  kVecH,      //   of W_out's rows (h),
  kVecG,      //   of the gate's padded rows (gate_ld<bf16> apart)
  kSplit,     // (K ranges, depth a range) of the products t, h and out,
              // at kSplit + 2 * kProd*
  kDw = kSplit + 6,      // (vec, cv, tc, rows) of the depthwise forward (the
                         //   head's conv_bf16, the tail's conv_gate_bf16)
  kGatePass = kDw + 4,   // 1: a gate pass (the fp32 tail's; 0 in bf16)
  kPlanInts
};
enum Prod { kProdT, kProdH, kProdOut };

cudaError_t dw(const bf16* x, const bf16* taps, void* out, bool out_bf16, int B, int H, int W,
               int M, const int* plan, cudaStream_t st) {
  return rcot_dwconv::conv_bf16(x, taps, out, out_bf16, B, H, W, M, plan[kDw], plan[kDw + 1],
                                plan[kDw + 2], plan[kDw + 3], st);
}

}  // namespace

#define SPLIT(k) plan[kSplit + 2 * (k)], plan[kSplit + 2 * (k) + 1]

extern "C" {

// qkv = bf16(dw3x3(bf16(bf16(LN1(x)) @ W_qkv^T))). Inputs x (B,H,W,C) bf16,
// ln_w, ln_b (C, fp32; ln_b null for BiasFree), w_qkv (M,C) and dwk (M,3,3)
// bf16; output out (B,H,W,M) bf16. Workspace: u (N,C) bf16, stats (2N)
// fp32, N = B*H*W. With pw (pw_dw.cuh's plan): ln_fwd, then one launch of
// the product-depthwise on u. Without (where C's rows pass its shared
// memory, ops/dwconv.py pw_dw_plan): ln_fwd, the product and the
// depthwise, through h (N,M) bf16 and sums (fp32, the plan's).
int rcot_block_head_bf16(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w_qkv,
                         const bf16* dwk, bf16* out, bf16* u, float* stats, bf16* h, float* sums,
                         const int* plan, const int* pw, int B, int H, int W, int C, int M,
                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int vc = plan[kVecC];
  RCOT_TRY(ln_fwd(x, ln_w, ln_b, u, stats, n, C, plan[kLnBlocks], st));
  if (pw) return rcot_pwdw::pw_dw_bf16(u, w_qkv, dwk, out, B, H, W, C, M, pw, st);
  RCOT_TRY((product<false, kEpiStore>(u, C, vc, w_qkv, vc, h, M, n, SPLIT(kProdH), sums, st)));
  return dw(h, dwk, out, true, B, H, W, M, plan, st);
}

// y = bf16(t + bf16(g @ W_out^T)), g = bf16(gelu(c1) c2), [c1 | c2] =
// dw3x3(bf16(bf16(LN2(t)) @ W_in^T)), t = bf16(x + bf16(a @ W_proj^T)).
// Inputs x, a (B,H,W,C), w_proj (C,C), w_in (2h,C), dwk (2h,3,3), w_out
// (C,h) bf16, ln_w, ln_b (C, fp32; ln_b null for BiasFree); output y
// (B,H,W,C) bf16. Workspace: t (N,C) bf16, stats (2N) fp32, u (N,C) bf16,
// h (N,2h) bf16, gate (N, gate_ld<bf16>(h)) bf16, and sums (fp32, the
// plan's). plan: kPlanInts ints, kDw the gated depthwise's, kGatePass 0.
int rcot_block_tail_bf16(const bf16* x, const bf16* a, const bf16* w_proj, const float* ln_w,
                         const float* ln_b, const bf16* w_in, const bf16* dwk, const bf16* w_out,
                         bf16* y, bf16* t, float* stats, bf16* u, bf16* h, bf16* gate,
                         float* sums, const int* plan, int B, int H, int W, int C, int hid,
                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid, vc = plan[kVecC], vh = plan[kVecH], vg = plan[kVecG];
  if (plan[kGatePass]) return cudaErrorInvalidValue;
  RCOT_TRY((product<false, kEpiAdd>(a, C, vc, w_proj, vc, t, C, n, SPLIT(kProdT), sums, st, x)));
  RCOT_TRY(ln_fwd(t, ln_w, ln_b, u, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(u, C, vc, w_in, vc, h, m2, n, SPLIT(kProdH), sums, st)));
  RCOT_TRY(rcot_dwconv::conv_gate_bf16(h, dwk, gate, B, H, W, hid, gate_ld<bf16>(hid),
                                       plan[kDw], plan[kDw + 1], plan[kDw + 2], plan[kDw + 3],
                                       st));
  return product<false, kEpiAdd>(gate, hid, vg, w_out, vh, y, C, n, SPLIT(kProdOut), sums, st, t,
                                 nullptr, gate_ld<bf16>(hid));
}

}  // extern "C"
