// The LayerNorm backward of the block backward kernels (block_bwd.cu, row
// 5; block_bwd_bf16.cu, row 5 in bf16 training): dt and the fixed-order
// sums dln_w, dln_b (block_bwd.cu's header says more).

#pragma once

#include <cuda_runtime.h>

#include "mm.cuh"

namespace {

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

}  // namespace
