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
// Design. The Pallas kernel walked row bands on a sequential grid, kept
// every intermediate in VMEM with a two-row halo, and summed the weight
// grads into grid-revisited blocks. Blocks on the card run in no order, so
// here the backward is a chain of plain kernels on one stream, with the
// wide intermediates (h, conv, dconv, dh; N x 2h floats each) in a
// workspace the caller allocates:
//   - every 1x1 product, per pixel (h, dgate, du, da) or summed over all
//     pixels (dW_qkv, dW_in, dW_out, dW_proj), is one tiled fp32 GEMM with
//     strides, so a transposed operand costs nothing; the pixel sums split
//     K over enough blocks to fill the card and atomicAdd into outputs
//     zeroed on the stream first (the order of those adds varies from run
//     to run in the last bits);
//   - the depthwise backward is two stencils over the whole tensor: dh is
//     the rot180 correlation of dconv with the taps, ddw the 9-tap sum of
//     dconv times the shifted h. With h in device memory for every pixel,
//     the conv's zero padding is simply "outside the image reads 0", and
//     the halo trap of the banded kernel (LN(0) = ln_b on out-of-image
//     rows) cannot occur;
//   - LayerNorm's backward is one warp per pixel, the per-channel sums of
//     dln_w and dln_b gathered in shared memory and added once per block.
// The gelu derivative is exact: Phi(x) + x phi(x) with erff.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s):
// the tail does 2*N*(3C^2 + 8*h*C) flops of 1x1 products (three C x C and
// eight C x h products per pixel, the forward recompute included) plus
// ~60*h per pixel of stencils, against 16*C bytes per pixel of inputs and
// outputs, so it is bound by operations; so is the head (2*N*3*3C*C). The
// workspace adds ~8 * 2h * 4 bytes per pixel of traffic on top of that
// bound; fusing it away, and tensor cores, are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-5f;

// ------------------------------------------------------------------ GEMM

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int kStore = 0;   // C = A B
constexpr int kAdd = 1;     // C += A B
constexpr int kReduce = 2;  // C += A B by atomicAdd, K split over blocks

// C (M x N, row-major, ldc) op= A B with A(m, k) = A[m*sam + k*sak] and
// B(k, n) = B[k*sbk + n*sbn]. Block z covers K in [z*k_split, +k_split).
// Each thread owns a 4 x 4 micro-tile: rows 4*ty.., columns 4*tx...
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ A, long long sam, long long sak,
            const float* __restrict__ B, long long sbk, long long sbn,
            float* __restrict__ Cm, long long ldc, int M, int N, long long K,
            long long k_split, int mode) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long kb = (long long)blockIdx.z * k_split;
  const long long ke = kb + k_split < K ? kb + k_split : K;
  // stage each tile along the operand's unit stride, for coalesced loads
  const bool a_m_fast = sam == 1 && sak != 1;
  const bool b_n_fast = sbn == 1;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = kb; k0 < ke; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int m = a_m_fast ? e % BM : e / BK;
      const int k = a_m_fast ? e / BM : e % BK;
      const long long kk = k0 + k;
      const int mm = m0 + m;
      As[k][m] = (mm < M && kk < ke) ? A[mm * sam + kk * sak] : 0.f;
    }
    for (int e = tid; e < BN * BK; e += kThreads) {
      const int n = b_n_fast ? e % BN : e / BK;
      const int k = b_n_fast ? e / BN : e % BK;
      const long long kk = k0 + k;
      const int nn = n0 + n;
      Bs[k][n] = (nn < N && kk < ke) ? B[kk * sbk + nn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= N) continue;
      float* c = Cm + m * ldc + n;
      if (mode == kReduce)
        atomicAdd(c, acc[i][j]);
      else if (mode == kAdd)
        *c += acc[i][j];
      else
        *c = acc[i][j];
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// blocks for a grid-stride loop over `work` items: about eight per SM
unsigned grid_for(long long work) {
  const long long cap = 8LL * sm_count();
  const long long need = (work + kThreads - 1) / kThreads;
  return (unsigned)(need < 1 ? 1 : (need < cap ? need : cap));
}

cudaError_t gemm(const float* A, long long sam, long long sak, const float* B,
                 long long sbk, long long sbn, float* C, long long ldc, int M,
                 int N, long long K, int mode, cudaStream_t st) {
  const long long tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  long long k_split = K, splits = 1;
  if (mode == kReduce) {
    // split the pixel sum until the grid holds about four blocks per SM
    const long long k_tiles = (K + BK - 1) / BK;
    splits = (4LL * sm_count() + tiles_m * tiles_n - 1) / (tiles_m * tiles_n);
    splits = splits < 1 ? 1 : (splits > k_tiles ? k_tiles : splits);
    k_split = (k_tiles + splits - 1) / splits * BK;
    splits = (K + k_split - 1) / k_split;
  }
  if (splits < 1) splits = 1;
  dim3 grid((unsigned)tiles_m, (unsigned)tiles_n, (unsigned)splits);
  gemm_kernel<<<grid, kThreads, 0, st>>>(A, sam, sak, B, sbk, sbn, C, ldc, M,
                                         N, K, k_split, mode);
  return cudaGetLastError();
}

// ------------------------------------------------------------ LayerNorm

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// u = LN(t) per pixel, with its mean and inv = rsqrt(var + eps); one warp
// per pixel. ln_b null: BiasFree (u = t * inv * w).
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const float* __restrict__ t, const float* __restrict__ ln_w,
              const float* __restrict__ ln_b, float* __restrict__ u,
              float* __restrict__ mean_out, float* __restrict__ inv_out,
              long long n_pix, int C) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long p = blockIdx.x * kWarps + threadIdx.x / 32; p < n_pix;
       p += warps) {
    const float* tp = t + p * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += tp[c];
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = tp[c] - mean;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / C + kLnEps);
    float* up = u + p * C;
    for (int c = lane; c < C; c += 32)
      up[c] = ln_b ? (tp[c] - mean) * inv * ln_w[c] + ln_b[c]
                   : tp[c] * inv * ln_w[c];
    if (lane == 0) {
      mean_out[p] = mean;
      inv_out[p] = inv;
    }
  }
}

// dt = VJP of LN at t for the cotangent du (plus g_res when not null);
// dln_w += sum_p du * that, dln_b += sum_p du (ln_b not null). With
// gw = du * w:
//   WithBias: that = (t - mean) inv, dt = inv (gw - mean(gw) - that mean(gw that))
//   BiasFree: that = t inv,          dt = inv gw - inv^3 (t - mean) mean(gw t)
// One warp per pixel; the block's per-channel sums meet in shared memory.
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const float* __restrict__ t, const float* __restrict__ du,
              const float* __restrict__ mean_in, const float* __restrict__ inv_in,
              const float* __restrict__ ln_w, const float* __restrict__ ln_b,
              const float* __restrict__ g_res, float* __restrict__ dt,
              float* __restrict__ dln_w, float* __restrict__ dln_b,
              long long n_pix, int C, long long pix_per_block) {
  extern __shared__ float sacc[];  // [2C]: sum du*that, sum du
  for (int c = threadIdx.x; c < 2 * C; c += kThreads) sacc[c] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const long long p0 = blockIdx.x * pix_per_block;
  const long long p1 = p0 + pix_per_block < n_pix ? p0 + pix_per_block : n_pix;
  const bool with_bias = ln_b != nullptr;
  for (long long p = p0 + threadIdx.x / 32; p < p1; p += kWarps) {
    const float* tp = t + p * C;
    const float* dp = du + p * C;
    const float mean = mean_in[p], inv = inv_in[p];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gw = dp[c] * ln_w[c];
      const float that = with_bias ? (tp[c] - mean) * inv : tp[c] * inv;
      s1 += gw;
      s2 += with_bias ? gw * that : gw * tp[c];
      atomicAdd(&sacc[c], dp[c] * that);
      if (with_bias) atomicAdd(&sacc[C + c], dp[c]);
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float gw = dp[c] * ln_w[c];
      float v;
      if (with_bias)
        v = inv * (gw - s1 - (tp[c] - mean) * inv * s2);
      else
        v = inv * gw - inv * inv * inv * (tp[c] - mean) * s2;
      if (g_res) v += g_res[p * C + c];
      dt[p * C + c] = v;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    atomicAdd(dln_w + c, sacc[c]);
    if (with_bias) atomicAdd(dln_b + c, sacc[C + c]);
  }
}

// ------------------------------------------------------ depthwise 3x3

// out[b,y,x,m] = sum_{dy,dx} in[b, y + S*(dy-1), x + S*(dx-1), m] * w[m, dy, dx]
// with zero outside the image. S = +1 is the forward conv; S = -1 is the
// rot180 correlation that gives dh from dconv.
template <int S>
__global__ void __launch_bounds__(kThreads)
dw3x3_kernel(const float* __restrict__ in, const float* __restrict__ w,
             float* __restrict__ out, int B, int H, int W, int M) {
  const long long total = (long long)B * H * W * M;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const int m = (int)(idx % M);
    const long long pix = idx / M;
    const int x = (int)(pix % W);
    const long long row = pix / W;
    const int y = (int)(row % H);
    const long long b = row / H;
    float s = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = y + S * (dy - 1);
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = x + S * (dx - 1);
        if (xx < 0 || xx >= W) continue;
        s = fmaf(in[((b * H + yy) * W + xx) * M + m], w[m * 9 + dy * 3 + dx], s);
      }
    }
    out[idx] = s;
  }
}

// ddw[m, dy, dx] += sum over pixels of dconv[b,y,x,m] * h[b, y+dy-1, x+dx-1, m]
// (h zero outside the image). Block (channel chunk of 32, pixel range):
// lane = channel, warps stride over the range, nine sums per thread, then
// the warps' sums meet in shared memory and one atomicAdd per (m, tap).
__global__ void __launch_bounds__(kThreads)
ddw_kernel(const float* __restrict__ dconv, const float* __restrict__ h,
           float* __restrict__ ddw, int B, int H, int W, int M,
           long long pix_per_block) {
  __shared__ float part[kWarps][9][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m = blockIdx.x * 32 + lane;
  const long long n_pix = (long long)B * H * W;
  const long long p0 = blockIdx.y * pix_per_block;
  const long long p1 = p0 + pix_per_block < n_pix ? p0 + pix_per_block : n_pix;
  float acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0.f;
  if (m < M) {
    for (long long p = p0 + warp; p < p1; p += kWarps) {
      const int x = (int)(p % W);
      const long long row = p / W;
      const int y = (int)(row % H);
      const long long b = row / H;
      const float d = dconv[p * M + m];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = y + dy - 1;
        if (yy < 0 || yy >= H) continue;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int xx = x + dx - 1;
          if (xx < 0 || xx >= W) continue;
          acc[dy * 3 + dx] = fmaf(d, h[((b * H + yy) * W + xx) * M + m],
                                  acc[dy * 3 + dx]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  for (int e = threadIdx.x; e < 9 * 32; e += kThreads) {
    const int tap = e / 32, l = e % 32, mm = blockIdx.x * 32 + l;
    if (mm >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int wv = 0; wv < kWarps; ++wv) s += part[wv][tap][l];
    atomicAdd(ddw + mm * 9 + tap, s);
  }
}

cudaError_t launch_dw_fwd(const float* in, const float* w, float* out, int B,
                          int H, int W, int M, cudaStream_t st) {
  dw3x3_kernel<1><<<grid_for((long long)B * H * W * M), kThreads, 0, st>>>(
      in, w, out, B, H, W, M);
  return cudaGetLastError();
}

cudaError_t launch_dw_corr(const float* in, const float* w, float* out, int B,
                           int H, int W, int M, cudaStream_t st) {
  dw3x3_kernel<-1><<<grid_for((long long)B * H * W * M), kThreads, 0, st>>>(
      in, w, out, B, H, W, M);
  return cudaGetLastError();
}

cudaError_t launch_ddw(const float* dconv, const float* h, float* ddw, int B,
                       int H, int W, int M, cudaStream_t st) {
  const long long n_pix = (long long)B * H * W;
  const int chunks = (M + 31) / 32;
  // split the pixels until the grid holds about four blocks per SM
  long long splits = (4LL * sm_count() + chunks - 1) / chunks;
  if (splits > n_pix) splits = n_pix;
  if (splits < 1) splits = 1;
  const long long per = (n_pix + splits - 1) / splits;
  splits = (n_pix + per - 1) / per;
  dim3 grid(chunks, (unsigned)splits);
  ddw_kernel<<<grid, kThreads, 0, st>>>(dconv, h, ddw, B, H, W, M, per);
  return cudaGetLastError();
}

cudaError_t launch_ln_fwd(const float* t, const float* ln_w, const float* ln_b,
                          float* u, float* mean, float* inv, long long n_pix,
                          int C, cudaStream_t st) {
  ln_fwd_kernel<<<grid_for(n_pix * 32), kThreads, 0, st>>>(t, ln_w, ln_b, u,
                                                           mean, inv, n_pix, C);
  return cudaGetLastError();
}

cudaError_t launch_ln_bwd(const float* t, const float* du, const float* mean,
                          const float* inv, const float* ln_w,
                          const float* ln_b, const float* g_res, float* dt,
                          float* dln_w, float* dln_b, long long n_pix, int C,
                          cudaStream_t st) {
  const long long blocks_want = 4LL * sm_count();
  long long per = (n_pix + blocks_want - 1) / blocks_want;
  if (per < kWarps) per = kWarps;
  const long long blocks = (n_pix + per - 1) / per;
  ln_bwd_kernel<<<(unsigned)blocks, kThreads, 2 * C * sizeof(float), st>>>(
      t, du, mean, inv, ln_w, ln_b, g_res, dt, dln_w, dln_b, n_pix, C, per);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- gate

// conv = [c1 | c2] (N, 2h), dgate (N, h) ->
//   dconv = [dgate * c2 * gelu'(c1) | dgate * gelu(c1)],  gate = gelu(c1) * c2
__global__ void __launch_bounds__(kThreads)
gate_bwd_kernel(const float* __restrict__ conv, const float* __restrict__ dgate,
                float* __restrict__ dconv, float* __restrict__ gate,
                long long n_pix, int hid) {
  const long long total = n_pix * hid;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const long long p = idx / hid;
    const int j = (int)(idx % hid);
    const long long base = p * 2 * hid;
    const float x1 = conv[base + j], x2 = conv[base + hid + j];
    const float dg = dgate[idx];
    const float cdf = 0.5f * (1.0f + erff(x1 * 0.70710678118654752f));
    const float pdf = 0.39894228040143268f * expf(-0.5f * x1 * x1);
    const float gl = x1 * cdf;
    dconv[base + j] = dg * x2 * (cdf + x1 * pdf);
    dconv[base + hid + j] = dg * gl;
    gate[idx] = gl * x2;
  }
}

#define RCOT_TRY(expr)                       \
  do {                                       \
    cudaError_t err_ = (expr);               \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

}  // namespace

extern "C" {

// Block-head backward. Inputs x (B,H,W,C), ln_w, ln_b (C; ln_b null for
// BiasFree), w_qkv (M,C), dwk (M,3,3), g (B,H,W,M). Outputs dx (B,H,W,C),
// dln_w, dln_b (C; null with ln_b), dw_qkv (M,C), ddw (M,3,3). Workspace:
// u (N,C), stats (2N), h (N,M), dh (N,M), du (N,C), N = B*H*W.
int rcot_block_head_bwd(const float* x, const float* ln_w, const float* ln_b,
                        const float* w_qkv, const float* dwk, const float* g,
                        float* dx, float* dln_w, float* dln_b, float* dw_qkv,
                        float* ddw, float* u, float* stats, float* h, float* dh,
                        float* du, int B, int H, int W, int C, int M,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  RCOT_TRY(cudaMemsetAsync(dln_w, 0, sizeof(float) * C, st));
  if (ln_b) RCOT_TRY(cudaMemsetAsync(dln_b, 0, sizeof(float) * C, st));
  RCOT_TRY(cudaMemsetAsync(dw_qkv, 0, sizeof(float) * M * C, st));
  RCOT_TRY(cudaMemsetAsync(ddw, 0, sizeof(float) * M * 9, st));
  // recompute: u = LN1(x), h = u @ W_qkv^T
  RCOT_TRY(launch_ln_fwd(x, ln_w, ln_b, u, stats, stats + n, n, C, st));
  RCOT_TRY(gemm(u, C, 1, w_qkv, 1, C, h, M, (int)n, M, C, kStore, st));
  // depthwise backward: dconv = g
  RCOT_TRY(launch_dw_corr(g, dwk, dh, B, H, W, M, st));
  RCOT_TRY(launch_ddw(g, h, ddw, B, H, W, M, st));
  // 1x1 backward: du = dh @ W_qkv, dW_qkv = dh^T u
  RCOT_TRY(gemm(dh, M, 1, w_qkv, C, 1, du, C, (int)n, C, M, kStore, st));
  RCOT_TRY(gemm(dh, 1, M, u, C, 1, dw_qkv, C, M, C, n, kReduce, st));
  return launch_ln_bwd(x, du, stats, stats + n, ln_w, ln_b, nullptr, dx,
                       dln_w, dln_b, n, C, st);
}

// Block-tail backward. Inputs x, a (B,H,W,C), w_proj (C,C), ln_w, ln_b (C;
// ln_b null for BiasFree), w_in (2h,C), dwk (2h,3,3), w_out (C,h),
// g (B,H,W,C). Outputs dx, da (B,H,W,C), dw_proj (C,C), dln_w, dln_b (C;
// null with ln_b), dw_in (2h,C), ddw (2h,3,3), dw_out (C,h). Workspace:
// t (N,C), stats (2N), u (N,C), h (N,2h), conv_dh (N,2h), dconv (N,2h),
// dgate (N,h), gate (N,h), du (N,C), N = B*H*W.
int rcot_block_tail_bwd(const float* x, const float* a, const float* w_proj,
                        const float* ln_w, const float* ln_b,
                        const float* w_in, const float* dwk,
                        const float* w_out, const float* g, float* dx,
                        float* da, float* dw_proj, float* dln_w, float* dln_b,
                        float* dw_in, float* ddw, float* dw_out, float* t,
                        float* stats, float* u, float* h, float* conv_dh,
                        float* dconv, float* dgate, float* gate, float* du,
                        int B, int H, int W, int C, int hid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid;
  RCOT_TRY(cudaMemsetAsync(dw_proj, 0, sizeof(float) * C * C, st));
  RCOT_TRY(cudaMemsetAsync(dln_w, 0, sizeof(float) * C, st));
  if (ln_b) RCOT_TRY(cudaMemsetAsync(dln_b, 0, sizeof(float) * C, st));
  RCOT_TRY(cudaMemsetAsync(dw_in, 0, sizeof(float) * m2 * C, st));
  RCOT_TRY(cudaMemsetAsync(ddw, 0, sizeof(float) * m2 * 9, st));
  RCOT_TRY(cudaMemsetAsync(dw_out, 0, sizeof(float) * C * hid, st));
  // recompute: t = x + a @ W_proj^T, u = LN2(t), h = u @ W_in^T, conv = dw(h)
  RCOT_TRY(cudaMemcpyAsync(t, x, sizeof(float) * n * C,
                           cudaMemcpyDeviceToDevice, st));
  RCOT_TRY(gemm(a, C, 1, w_proj, 1, C, t, C, (int)n, C, C, kAdd, st));
  RCOT_TRY(launch_ln_fwd(t, ln_w, ln_b, u, stats, stats + n, n, C, st));
  RCOT_TRY(gemm(u, C, 1, w_in, 1, C, h, m2, (int)n, m2, C, kStore, st));
  RCOT_TRY(launch_dw_fwd(h, dwk, conv_dh, B, H, W, m2, st));
  // W_out: dgate = g @ W_out, dW_out = g^T gate
  RCOT_TRY(gemm(g, C, 1, w_out, hid, 1, dgate, hid, (int)n, hid, C, kStore, st));
  gate_bwd_kernel<<<grid_for(n * hid), kThreads, 0, st>>>(conv_dh, dgate, dconv,
                                                          gate, n, hid);
  RCOT_TRY(cudaGetLastError());
  RCOT_TRY(gemm(g, 1, C, gate, hid, 1, dw_out, hid, C, hid, n, kReduce, st));
  // depthwise backward (conv is dead now: its buffer takes dh)
  RCOT_TRY(launch_dw_corr(dconv, dwk, conv_dh, B, H, W, m2, st));
  RCOT_TRY(launch_ddw(dconv, h, ddw, B, H, W, m2, st));
  // W_in: du = dh @ W_in, dW_in = dh^T u
  RCOT_TRY(gemm(conv_dh, m2, 1, w_in, C, 1, du, C, (int)n, C, m2, kStore, st));
  RCOT_TRY(gemm(conv_dh, 1, m2, u, C, 1, dw_in, C, m2, C, n, kReduce, st));
  // LN2 and the residual: dx = dt = LN-VJP(du) + g
  RCOT_TRY(launch_ln_bwd(t, du, stats, stats + n, ln_w, ln_b, g, dx, dln_w,
                         dln_b, n, C, st));
  // W_proj: da = dt @ W_proj, dW_proj = dt^T a
  RCOT_TRY(gemm(dx, C, 1, w_proj, C, 1, da, C, (int)n, C, C, kStore, st));
  return gemm(dx, 1, C, a, C, 1, dw_proj, C, C, C, n, kReduce, st);
}

}  // extern "C"
