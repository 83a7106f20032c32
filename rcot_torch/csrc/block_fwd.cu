// Fused transformer-block forward for Hopper (sm_90a).
//
// Replaces the TPU kernel rcot_tpu/ops/pallas_block.py fused_block_fwd
// (pallas_call at :189) in its two configurations:
//
//   block head (block_head, pallas_block.py:586):
//       qkv = dw3x3( LN1(x) @ W_qkv )
//   block tail (block_tail, pallas_block.py:597):
//       t = x + a @ W_proj
//       y = t + ( gelu(c1) * c2 ) @ W_out,   [c1 | c2] = dw3x3( LN2(t) @ W_in )
//
// LayerNorm as mm.cuh's ln_fwd says; the 3x3 depthwise conv zero-pads h
// (the value after LN and the 1x1 product), not x; gelu is the exact-erf
// form (erff). Weights come in PyTorch's conv layouts, read in place:
// W_qkv (3C, C), dw kernels (M, 3, 3), W_proj (C, C), W_in (2h, C),
// W_out (C, h).
//
// Bound on an H100 SXM. The head does 2 N 3C C flops of 1x1 products per N
// pixels and 18 flops a tap set of stencils against 4 (C + 3C) bytes a
// pixel of input and output, the tail 2 N (C^2 + 3 h C) flops against
// 12 C bytes: on the CUDA cores (67 TFLOP/s fp32, the bound chip_smoke.py
// states) both are bound by operations at every block shape. As 3xTF32 on
// the tensor cores (495 TF32 / 3 = 165 TFLOP/s) the products' floor is
// 2.5x lower, and the design's own launches (below) move the wide
// intermediates through device memory: 3 M + 3 C floats a pixel in the
// head (M = 3C), 8 h + 8 C in the tail, which at the level-1 shapes is a
// larger floor than the products' (tools/port_block_fwd_times.py
// design_floors).
//
// Design. The Pallas kernel walked row bands with a halo and kept every
// intermediate in VMEM. Here each configuration is a chain of launches on
// one stream, the plan (ops/block.py block_fwd_plan) passed in as ints and
// the intermediates in workspaces that the caller allocates:
//   head: u = LN1(x) (ln_fwd); h = u @ W_qkv^T (mm.cuh's 3xTF32 product);
//         qkv = dw3x3(h) (row 11's kernel, dwconv.cuh);
//   tail: t = x + a @ W_proj^T (a product whose epilogue adds x);
//         u = LN2(t); h = u @ W_in^T; conv = dw3x3(h);
//         y = t + gate @ W_out^T, gate = gelu(c1) c2, with t added in the
//         product's epilogue. Where C fits one output tile, the product
//         stages both halves of conv and takes the gate in shared memory
//         before its mma (kEpiGatedAdd), so the gate is never stored;
//         where C spans several, each of them would take the gate anew, and
//         the plan's gate_pass writes it once into h's buffer (dead by
//         then), in rows padded to 16 bytes, for a plain product (both
//         measured: PERF.md).
// h lies in device memory for every pixel, so the conv's zero padding is
// "outside the image reads 0": no halo is recomputed, and LN(0) = ln_b
// never reaches the conv. A product whose tiles alone leave the card short
// splits K into ranges whose partials sum_parts adds in a fixed order. No
// atomics and no memsets: two calls on the same inputs give the same bits.
// Odd widths (h = 127, 255, 1,021) take the narrower copies that the plan
// gives their width class (each half of conv starts at column 0 or h), but
// for the gate of a gate pass, padded.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dwconv.cuh"
#include "mm.cuh"

namespace {

// The launch plan, ops/block.py block_fwd_plan: ints at these offsets.
enum Plan {
  kLnBlocks,  // blocks of the LayerNorm forward
  kVecC,      // floats a copy of the C-wide operands (a, u, W_proj, W_in, W_qkv),
  kVecH,      //   of the h-wide ones (either half of conv, W_out's rows),
  kVecG,      //   of the gate's padded rows (gate_ld floats apart)
  kSplit,     // (K ranges, depth a range) of the products t, h and out,
              // at kSplit + 2 * kProd*
  kDw = kSplit + 6,      // (vec, cv, tc, rows) of the depthwise forward
  kGatePass = kDw + 4,   // 1: the tail's gate as a pass of its own
  kPlanInts
};
enum Prod { kProdT, kProdH, kProdOut };

// gate = gelu(c1) c2 of conv = [c1 | c2] (n_pix x 2 hid), in rows of
// gate_ld(hid) floats whose columns past hid hold 0, so that the product
// reading it takes 16-byte copies at any hid; one warp a pixel, as the
// LayerNorm forward (and with its blocks)
__host__ __device__ constexpr int gate_ld(int hid) { return (hid + 3) / 4 * 4; }

__global__ void __launch_bounds__(kThreads)
gate_pass_kernel(const float* __restrict__ conv, float* __restrict__ gate, long long n_pix,
                 int hid) {
  const int lane = threadIdx.x % 32, ld = gate_ld(hid);
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long m = blockIdx.x * kWarps + threadIdx.x / 32; m < n_pix; m += warps) {
    const float* row = conv + m * 2 * hid;
#pragma unroll 4
    for (int j = lane; j < ld; j += 32)
      gate[m * ld + j] = j < hid ? gate_fwd(row[j], row[hid + j]) : 0.f;
  }
}

cudaError_t gate_pass(const float* conv, float* gate, long long n_pix, int hid, int blocks,
                      cudaStream_t st) {
  gate_pass_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(conv, gate, n_pix, hid);
  return cudaGetLastError();
}

// The depthwise forward by row 11's kernel with the plan's (vec, cv, tc, rows)
cudaError_t dw(const float* x, const float* taps, float* out, int B, int H, int W, int M,
               const int* plan, cudaStream_t st) {
  return rcot_dwconv::conv(x, taps, out, B, H, W, M, plan[kDw], plan[kDw + 1], plan[kDw + 2],
                           plan[kDw + 3], false, st);
}

}  // namespace

// the plan's (K ranges, depth a range) of product k
#define SPLIT(k) plan[kSplit + 2 * (k)], plan[kSplit + 2 * (k) + 1]

extern "C" {

// qkv = dw3x3(LN1(x) @ W_qkv^T). Inputs x (B,H,W,C), ln_w, ln_b (C; ln_b
// null for BiasFree), w_qkv (M,C), dwk (M,3,3); output out (B,H,W,M).
// Workspace: u (N,C), stats (2N), h (N,M), N = B*H*W, and sums
// (ops/block.py block_fwd_plan's). plan: kPlanInts ints (kVecH, kProdT,
// kProdOut and kGatePass unused).
int rcot_block_head(const float* x, const float* ln_w, const float* ln_b, const float* w_qkv,
                    const float* dwk, float* out, float* u, float* stats, float* h,
                    float* sums, const int* plan, int B, int H, int W, int C, int M,
                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int vc = plan[kVecC];
  RCOT_TRY(ln_fwd(x, ln_w, ln_b, u, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(u, C, vc, w_qkv, vc, h, M, n, SPLIT(kProdH), sums, st)));
  return dw(h, dwk, out, B, H, W, M, plan, st);
}

// y = t + (gelu(c1) c2) @ W_out^T, [c1 | c2] = dw3x3(LN2(t) @ W_in^T),
// t = x + a @ W_proj^T. Inputs x, a (B,H,W,C), w_proj (C,C), ln_w, ln_b
// (C; ln_b null for BiasFree), w_in (2h,C), dwk (2h,3,3), w_out (C,h);
// output y (B,H,W,C). Workspace: t (N,C), stats (2N), u (N,C), h (N,2h),
// conv (N,2h), N = B*H*W, and sums (ops/block.py block_fwd_plan's). plan:
// kPlanInts ints.
int rcot_block_tail(const float* x, const float* a, const float* w_proj, const float* ln_w,
                    const float* ln_b, const float* w_in, const float* dwk,
                    const float* w_out, float* y, float* t, float* stats, float* u, float* h,
                    float* conv, float* sums, const int* plan, int B, int H, int W, int C,
                    int hid, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid, vc = plan[kVecC], vh = plan[kVecH], vg = plan[kVecG];
  RCOT_TRY((product<false, kEpiAdd>(a, C, vc, w_proj, vc, t, C, n, SPLIT(kProdT), sums, st, x)));
  RCOT_TRY(ln_fwd(t, ln_w, ln_b, u, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(u, C, vc, w_in, vc, h, m2, n, SPLIT(kProdH), sums, st)));
  RCOT_TRY(dw(h, dwk, conv, B, H, W, m2, plan, st));
  if (!plan[kGatePass])
    return product<false, kEpiGatedAdd>(conv, hid, vh, w_out, vh, y, C, n, SPLIT(kProdOut),
                                        sums, st, t);
  // h is dead: its buffer takes the gate
  RCOT_TRY(gate_pass(conv, h, n, hid, plan[kLnBlocks], st));
  return product<false, kEpiAdd>(h, hid, vg, w_out, vh, y, C, n, SPLIT(kProdOut), sums, st, t,
                                 nullptr, gate_ld(hid));
}

}  // extern "C"
