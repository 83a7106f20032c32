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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dwconv.cuh"
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

// dt = VJP of LN at t for the cotangent du (plus g_res when not null), and
// the block's partial of dln_w = sum du * that and dln_b = sum du at
// ws[blockIdx.x * 2C + c] and [.. + C + c]. With gw = du * w:
//   WithBias: that = (t - mean) inv, dt = inv (gw - mean(gw) - that mean(gw that))
//   BiasFree: that = t inv,          dt = inv gw - inv^3 (t - mean) mean(gw t)
// One warp a pixel (L channels a lane, as mm.cuh's ln_fwd), warp w taking
// pixels w, w + 8, ... of the block's range; the warps' partials meet in
// shared memory, added in warp order.
template <int L>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const float* __restrict__ t, const float* __restrict__ du,
              const float* __restrict__ mean_in, const float* __restrict__ inv_in,
              const float* __restrict__ ln_w, const float* __restrict__ ln_b,
              const float* __restrict__ g_res, float* __restrict__ dt,
              float* __restrict__ ws, long long n_pix, int C, long long per) {
  extern __shared__ float part[];  // [kWarps][2C]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long p0 = blockIdx.x * per;
  const long long p1 = p0 + per < n_pix ? p0 + per : n_pix;
  const bool with_bias = ln_b != nullptr;
  float wv[L], sw[L], sb[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int c = lane + 32 * i;
    wv[i] = c < C ? ln_w[c] : 0.f;
    sw[i] = sb[i] = 0.f;
  }
  for (long long p = p0 + warp; p < p1; p += kWarps) {
    const float mean = mean_in[p], inv = inv_in[p];
    float tv[L], dv[L], gv[L];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int c = lane + 32 * i;
      tv[i] = c < C ? t[p * C + c] : 0.f;
      dv[i] = c < C ? du[p * C + c] : 0.f;
      gv[i] = c < C && g_res ? g_res[p * C + c] : 0.f;
      const float gw = dv[i] * wv[i];
      const float that = with_bias ? (tv[i] - mean) * inv : tv[i] * inv;
      s1 += gw;
      s2 += with_bias ? gw * that : gw * tv[i];
      sw[i] += dv[i] * that;
      sb[i] += dv[i];
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int c = lane + 32 * i;
      if (c >= C) continue;
      const float gw = dv[i] * wv[i];
      float v;
      if (with_bias)
        v = inv * (gw - s1 - (tv[i] - mean) * inv * s2);
      else
        v = inv * gw - inv * inv * inv * (tv[i] - mean) * s2;
      dt[p * C + c] = v + gv[i];
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      part[warp * 2 * C + c] = sw[i];
      part[warp * 2 * C + C + c] = sb[i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * C; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w * 2 * C + e];
    ws[blockIdx.x * 2LL * C + e] = s;
  }
}

template <int L>
cudaError_t ln_bwd_l(const float* t, const float* du, const float* stats, const float* ln_w,
                     const float* ln_b, const float* g_res, float* dt, float* ws,
                     long long n_pix, int C, long long per, long long blocks, cudaStream_t st) {
  ln_bwd_kernel<L><<<(unsigned)blocks, kThreads, sizeof(float) * kWarps * 2 * C, st>>>(
      t, du, stats, stats + n_pix, ln_w, ln_b, g_res, dt, ws, n_pix, C, per);
  return cudaGetLastError();
}

// C > kLnRegChannels: as ln_bwd_kernel, a lane walking its channels in
// device memory (the row read once for s1 and s2 and once for dt) and its
// warp's partials of dln_w, dln_b kept in shared memory from the start,
// each lane adding into its own channels in the order of the warp's pixels
__global__ void __launch_bounds__(kThreads)
ln_bwd_wide_kernel(const float* __restrict__ t, const float* __restrict__ du,
                   const float* __restrict__ mean_in, const float* __restrict__ inv_in,
                   const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                   const float* __restrict__ g_res, float* __restrict__ dt,
                   float* __restrict__ ws, long long n_pix, int C, long long per) {
  extern __shared__ float part[];  // [kWarps][2C]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long p0 = blockIdx.x * per;
  const long long p1 = p0 + per < n_pix ? p0 + per : n_pix;
  const bool with_bias = ln_b != nullptr;
  float* sw = part + warp * 2 * C;
  float* sb = sw + C;
  for (int c = lane; c < C; c += 32) sw[c] = sb[c] = 0.f;
  for (long long p = p0 + warp; p < p1; p += kWarps) {
    const float mean = mean_in[p], inv = inv_in[p];
    const float* tp = t + p * C;
    const float* dp = du + p * C;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gw = dp[c] * ln_w[c];
      const float that = with_bias ? (tp[c] - mean) * inv : tp[c] * inv;
      s1 += gw;
      s2 += with_bias ? gw * that : gw * tp[c];
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float tv = tp[c], dv = dp[c], gw = dv * ln_w[c];
      const float that = with_bias ? (tv - mean) * inv : tv * inv;
      const float v = with_bias ? inv * (gw - s1 - (tv - mean) * inv * s2)
                                : inv * gw - inv * inv * inv * (tv - mean) * s2;
      dt[p * C + c] = v + (g_res ? g_res[p * C + c] : 0.f);
      sw[c] += dv * that;
      sb[c] += dv;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * C; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w * 2 * C + e];
    ws[blockIdx.x * 2LL * C + e] = s;
  }
}

// dt and dln_w, dln_b (null with ln_b) through the workspace ws of
// ceil(n_pix / per) * 2C floats; above kLnRegChannels the partials take
// kWarps * 2C floats of shared memory, up to kLnMaxChannels
constexpr int kLnMaxChannels = kMaxSmemBytes / (int)sizeof(float) / (2 * kWarps);

cudaError_t ln_bwd(const float* t, const float* du, const float* stats, const float* ln_w,
                   const float* ln_b, const float* g_res, float* dt, float* dln_w,
                   float* dln_b, float* ws, long long n_pix, int C, long long per,
                   cudaStream_t st) {
  if (per < 1 || C > kLnMaxChannels) return cudaErrorInvalidValue;
  const long long blocks = (n_pix + per - 1) / per;
  const cudaError_t err = [&]() -> cudaError_t {
    if (C > kLnRegChannels) {
      static bool done[kMaxDevices];
      RCOT_TRY(allow_smem(done, ln_bwd_wide_kernel, ln_bwd_wide_kernel,
                          2 * kWarps * kLnMaxChannels));
      ln_bwd_wide_kernel<<<(unsigned)blocks, kThreads, sizeof(float) * kWarps * 2 * C, st>>>(
          t, du, stats, stats + n_pix, ln_w, ln_b, g_res, dt, ws, n_pix, C, per);
      return cudaGetLastError();
    }
#define RCOT_CALL(L) ln_bwd_l<L>(t, du, stats, ln_w, ln_b, g_res, dt, ws, n_pix, C, per, blocks, st)
    RCOT_BY_LANES(C, RCOT_CALL)
#undef RCOT_CALL
  }();
  RCOT_TRY(err);
  return sum_parts(ws, dln_w, dln_b, ln_b ? 2 * C : C, C, 2LL * C, blocks, st);
}

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

// the plan's (K ranges, depth a range) of per-pixel product k
#define SPLIT(k) plan[kSplit + 2 * (k)], plan[kSplit + 2 * (k) + 1]

extern "C" {

// Block-head backward. Inputs x (B,H,W,C), ln_w, ln_b (C; ln_b null for
// BiasFree), w_qkv (M,C), dwk (M,3,3), g (B,H,W,M). Outputs dx (B,H,W,C),
// dln_w, dln_b (C; null with ln_b), dw_qkv (M,C), ddw (M,3,3). Workspace:
// u (N,C), stats (2N), h (N,M), dh (N,M), du (N,C), N = B*H*W, and sums
// (ops/block.py block_bwd_plan's). plan: kPlanInts ints (kSumPer0 is
// dW_qkv's; kVecH, kSumPer1, kSumPer2, kProdT, kProdDa and kDwFwd unused).
int rcot_block_head_bwd(const float* x, const float* ln_w, const float* ln_b,
                        const float* w_qkv, const float* dwk, const float* g, float* dx,
                        float* dln_w, float* dln_b, float* dw_qkv, float* ddw, float* u,
                        float* stats, float* h, float* dh, float* du, float* sums,
                        const int* plan, int B, int H, int W, int C, int M, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int vc = plan[kVecC], vm = plan[kVecM];
  // recompute: u = LN1(x), h = u @ W_qkv^T
  RCOT_TRY(ln_fwd(x, ln_w, ln_b, u, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(u, C, vc, w_qkv, vc, h, M, n, SPLIT(kProdH), sums, st)));
  // depthwise backward, dconv = g: dh = the rotated forward of g, ddw
  RCOT_TRY(dw(g, dwk, dh, B, H, W, M, plan, kDwRot, true, st));
  RCOT_TRY(dw_taps(h, g, sums, ddw, B, H, W, M, plan, st));
  // 1x1 backward: du = dh @ W_qkv, dW_qkv = dh^T u
  RCOT_TRY((product<true, kEpiStore>(dh, M, vm, w_qkv, vc, du, C, n, SPLIT(kProdDu), sums, st)));
  RCOT_TRY(pixel_sum(dh, vm, u, vc, dw_qkv, sums, M, C, n, plan[kSumPer0], st));
  return ln_bwd(x, du, stats, ln_w, ln_b, nullptr, dx, dln_w, dln_b, sums, n, C,
                plan[kLnPer], st);
}

// Block-tail backward. Inputs x, a (B,H,W,C), w_proj (C,C), ln_w, ln_b (C;
// ln_b null for BiasFree), w_in (2h,C), dwk (2h,3,3), w_out (C,h),
// g (B,H,W,C). Outputs dx, da (B,H,W,C), dw_proj (C,C), dln_w, dln_b (C;
// null with ln_b), dw_in (2h,C), ddw (2h,3,3), dw_out (C,h). Workspace:
// t (N,C), stats (2N), u (N,C), h (N,2h), conv_dh (N,2h), dconv (N,2h),
// gate (N,h), du (N,C), N = B*H*W, and sums (ops/block.py
// block_bwd_plan's). plan: kPlanInts ints.
int rcot_block_tail_bwd(const float* x, const float* a, const float* w_proj,
                        const float* ln_w, const float* ln_b, const float* w_in,
                        const float* dwk, const float* w_out, const float* g, float* dx,
                        float* da, float* dw_proj, float* dln_w, float* dln_b, float* dw_in,
                        float* ddw, float* dw_out, float* t, float* stats, float* u, float* h,
                        float* conv_dh, float* dconv, float* gate, float* du, float* sums,
                        const int* plan, int B, int H, int W, int C, int hid, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid, vc = plan[kVecC], vh = plan[kVecH], vm = plan[kVecM];
  // recompute: t = x + a @ W_proj^T, u = LN2(t), h = u @ W_in^T, conv = dw(h)
  RCOT_TRY((product<false, kEpiAdd>(a, C, vc, w_proj, vc, t, C, n, SPLIT(kProdT), sums, st, x)));
  RCOT_TRY(ln_fwd(t, ln_w, ln_b, u, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(u, C, vc, w_in, vc, h, m2, n, SPLIT(kProdH), sums, st)));
  RCOT_TRY(dw(h, dwk, conv_dh, B, H, W, m2, plan, kDwFwd, false, st));
  // W_out: dgate = g @ W_out, its epilogue the gate's backward (dconv and
  // gate from conv); dW_out = g^T gate
  RCOT_TRY((product<true, kEpiGate>(g, C, vc, w_out, vh, dconv, hid, n, 1, 0, nullptr, st,
                                    conv_dh, gate)));
  RCOT_TRY(pixel_sum(g, vc, gate, vh, dw_out, sums, C, hid, n, plan[kSumPer0], st));
  // depthwise backward (conv is dead now: its buffer takes dh)
  RCOT_TRY(dw(dconv, dwk, conv_dh, B, H, W, m2, plan, kDwRot, true, st));
  RCOT_TRY(dw_taps(h, dconv, sums, ddw, B, H, W, m2, plan, st));
  // W_in: du = dh @ W_in, dW_in = dh^T u
  RCOT_TRY((product<true, kEpiStore>(conv_dh, m2, vm, w_in, vc, du, C, n, SPLIT(kProdDu), sums,
                                     st)));
  RCOT_TRY(pixel_sum(conv_dh, vm, u, vc, dw_in, sums, m2, C, n, plan[kSumPer1], st));
  // LN2 and the residual: dx = dt = LN-VJP(du) + g
  RCOT_TRY(ln_bwd(t, du, stats, ln_w, ln_b, g, dx, dln_w, dln_b, sums, n, C, plan[kLnPer], st));
  // W_proj: da = dt @ W_proj, dW_proj = dt^T a
  RCOT_TRY((product<true, kEpiStore>(dx, C, vc, w_proj, vc, da, C, n, SPLIT(kProdDa), sums, st)));
  return pixel_sum(dx, vc, a, vc, dw_proj, sums, C, C, n, plan[kSumPer2], st);
}

}  // extern "C"
