// The pieces that the MDTA core's kernels in fp32 (gram.cu) and in bf16
// (gram_bf16.cu) share: the channel-block pairs of a head wider than 128
// channels, the fixed-order reduce of the Gram's (and dattn's) pixel-range
// partials, and the choice of a kernel's width R from the channel block.

#pragma once

#include <cuda_runtime.h>

#include "tc.cuh"

namespace {

constexpr int kThreads = 256;

// The channel-block pair (i, j) of a block and the two blocks' widths:
// with BLK, pair p = i * nb + j of the grid; without, the one pair of a
// head of ch <= 128 channels, whose kernels then compile to the arithmetic
// of a single block (i = j = 0, wi = wj = ch).
struct Pair {
  int i, j, wi, wj;
};
template <bool BLK>
__device__ __forceinline__ Pair pair_of(int p, int ch, int cb) {
  if (!BLK) return {0, 0, ch, ch};
  const int nb = (ch + cb - 1) / cb, i = p / nb, j = p - i * nb;
  return {i, j, block_width(i, ch, cb), block_width(j, ch, cb)};
}

// out = sum over s of the workspace's partials in a fixed order (warp w
// of W adds s = w, w + W, ...; then the W warps' sums in order), so the
// result is the same bitwise on every call. Workspace (B*heads, splits, E)
// -> G | nq | nk (the Gram, E = ch*ch + 2ch) or G alone (dattn, E = ch*ch,
// nq and nk null); block (x, bh) sums 32 entries of (b, h), with
// W = min(splits, kReduceWarps) warps.
constexpr int kReduceWarps = 16;

__global__ void __launch_bounds__(32 * kReduceWarps)
gram_reduce_kernel(const float* __restrict__ ws, float* __restrict__ gram,
                   float* __restrict__ nq, float* __restrict__ nk, int ch, int E,
                   int splits) {
  __shared__ float part[kReduceWarps][32];
  const int bh = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int n_g = ch * ch;
  const int e = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (e < E) {
    const float* src = ws + (long long)bh * splits * E + e;
#pragma unroll 8
    for (int s = w; s < splits; s += W) v += src[(long long)s * E];
  }
  part[w][lane] = v;
  __syncthreads();
  if (w != 0 || e >= E) return;
  float t = 0.f;
  for (int i = 0; i < W; ++i) t += part[i][lane];
  if (e < n_g)
    gram[(long long)bh * n_g + e] = t;
  else if (e < n_g + ch)
    nq[(long long)bh * ch + e - n_g] = t;
  else
    nk[(long long)bh * ch + e - n_g - ch] = t;
}

// Sum a workspace of `splits` partials of E floats per (b, h) in order.
cudaError_t launch_reduce(const float* ws, float* gram, float* nq, float* nk, int B, int heads,
                          int ch, int E, int splits, cudaStream_t st) {
  const cudaError_t err = cudaGetLastError();  // the launch that filled ws
  if (err != cudaSuccess) return err;
  const int warps = splits < kReduceWarps ? splits : kReduceWarps;
  gram_reduce_kernel<<<dim3((unsigned)((E + 31) / 32), (unsigned)(B * heads)), 32 * warps, 0,
                       st>>>(ws, gram, nq, nk, ch, E, splits);
  return cudaGetLastError();
}

// A plan's channel blocks: 1 <= cb <= 128 (R <= 8) and cb <= ch, and more
// than 64 wide where a head is cut (kBlocked).
bool bad_blocks(int ch, int cb) { return cb < 1 || cb > 128 || cb > ch || (cb < ch && cb <= 64); }

}  // namespace

// The channel-block width cb (1..128, ops/gram.py channel_blocks) picks
// R = ceil(cb / 16) in 1..8; the kernels take a head of any width ch in
// blocks of cb.
#define RCOT_BY_WIDTH(ch, cb, CALL)                   \
  if (bad_blocks((ch), (cb))) return cudaErrorInvalidValue; \
  switch (((cb) + 15) / 16) {                         \
    case 1: return CALL(1);                           \
    case 2: return CALL(2);                           \
    case 3: return CALL(3);                           \
    case 4: return CALL(4);                           \
    case 5: return CALL(5);                           \
    case 6: return CALL(6);                           \
    case 7: return CALL(7);                           \
    default: return CALL(8);                          \
  }

