// The pieces that the MDTA core's kernels in fp32 (gram.cu, gram_bwd.cuh)
// and in bf16 (gram_bf16.cu) share: the channel-block pairs of a head wider
// than 128 channels, the fixed-order reduce of the Gram's (and dattn's)
// pixel-range partials, and the choice of a kernel's width R from the
// channel block; and what the fp32 forward and backward kernels share: the
// staging of a head's rows, the Gram's warp layout (GramCfg, which the
// apply backward's dattn takes too) and a kernel's variants by copy width
// and channel blocks; and the bf16 kernels' row copies in and out of
// shared memory at any copy width (gram_bf16.cu, gram_bwd.cuh's bf16 form).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kGramStages = 3;   // depth of each kernel's cp.async ring

// Rows [p0, p0 + rows) of a head slice (row r at src + r * stride, ch
// floats) into a tile of pitch ld; rows at or past `end` are zero-filled.
// Thread t copies pieces t, t + kThreads, ... of the row-major tile; with
// SWZ, element (r, c) goes to r * ld + (c ^ (r & 4)) (gram_bwd.cuh swz: a piece
// of four floats stays whole).
template <bool VEC, bool SWZ = false>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src,
                                           long long stride, long long p0,
                                           long long end, int rows, int ch) {
  const int w = VEC ? 4 : 1, per_row = ch / w;  // pieces of w floats per row
  const int dr = kThreads / per_row, dc = kThreads - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  while (r < rows) {
    const bool in = p0 + r < end;
    const float* from = src + (in ? (p0 + r) * stride : 0) + c * w;
    const int col = SWZ ? (c * w) ^ (r & 4) : c * w;
    if (VEC)
      cp_async16(dst + r * ld + col, from, in);
    else
      cp_async4(dst + r * ld + col, from, in);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Rows [p0, p0 + rows) of a head slice (row r at src + r * stride, w bf16)
// into a tile of pitch ld; rows at or past `end` are zero-filled. V bf16 a
// copy (8: 16 bytes, 2: 4 bytes, 1: a load by the thread); V divides w
// (gram_bf16.cu, gram_bwd.cuh).
template <int V>
__device__ __forceinline__ void stage_rows_bf16(bf16* dst, int ld, const bf16* src,
                                                long long stride, long long p0, long long end,
                                                int rows, int w) {
  const int per_row = w / V;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    const bool in = p0 + r < end;
    const bf16* from = src + (in ? (p0 + r) * stride : 0) + c;
    bf16* to = dst + r * ld + c;
    if constexpr (V == 1)
      *to = in ? *from : __float2bfloat16_rn(0.f);
    else
      cp_async_bytes<2 * V>(to, from, in);
  }
}

// The same with the copy width v (8, 2 or 1) chosen at run time: one
// kernel for every width, the branch uniform and outside the products.
__device__ __forceinline__ void stage_rows_bf16_v(bf16* dst, int ld, const bf16* src,
                                                  long long stride, long long p0, long long end,
                                                  int rows, int w, int v) {
  if (v == 8)
    stage_rows_bf16<8>(dst, ld, src, stride, p0, end, rows, w);
  else if (v == 2)
    stage_rows_bf16<2>(dst, ld, src, stride, p0, end, rows, w);
  else
    stage_rows_bf16<1>(dst, ld, src, stride, p0, end, rows, w);
}

// Rows [0, rows) of a bf16 tile staged in shared memory (pitch ld), those
// with r0 + r below `end`, into out (row r at out + (r0 + r) * stride),
// columns below w, by the `n` threads t = 0 .. n - 1 (t the caller's index
// among them): V bf16 a store (16, 4 or 2 bytes), neighbouring threads on
// neighbouring addresses of a row.
template <int V>
__device__ __forceinline__ void store_staged(bf16* out, long long stride, const bf16* st, int ld,
                                             long long r0, long long end, int rows, int w,
                                             int t, int n) {
  const int per_row = w / V;
  for (int i = t; i < rows * per_row; i += n) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    if (r0 + r >= end) break;  // i grows with r
    bf16* to = out + (r0 + r) * stride + c;
    const bf16* from = st + r * ld + c;
    if constexpr (V == 8)
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    else if constexpr (V == 2)
      *reinterpret_cast<uint32_t*>(to) = *reinterpret_cast<const uint32_t*>(from);
    else
      *to = *from;
  }
}
__device__ __forceinline__ void store_staged_v(bf16* out, long long stride, const bf16* st,
                                               int ld, long long r0, long long end, int rows,
                                               int w, int t, int n, int v) {
  if (v == 8)
    store_staged<8>(out, stride, st, ld, r0, end, rows, w, t, n);
  else if (v == 2)
    store_staged<2>(out, stride, st, ld, r0, end, rows, w, t, n);
  else
    store_staged<1>(out, stride, st, ld, r0, end, rows, w, t, n);
}

// The Gram at head width ch <= 16R: G (16R x 16R, zero-padded) in 16 x 8
// mma tiles, R row tiles by 2R column tiles. The eight warps split the
// tiles (WTM x WTN) and the pixels of each stage (WK groups); each warp
// holds MW x NW tiles in registers.
template <int R>
struct GramCfg {
  static constexpr int CHP = 16 * R;
  static constexpr int LD = CHP + 8;  // pitch: fragment reads hit 32 banks
  static constexpr int MT = R, NT = 2 * R;
  static constexpr int WK = R <= 2 ? 8 : (R <= 4 ? 4 : 1);
  static constexpr int WTM = R <= 4 ? 1 : 2;
  static constexpr int WTN = R <= 2 ? 1 : (R <= 4 ? 2 : 4);
  static constexpr int MW = (MT + WTM - 1) / WTM, NW = (NT + WTN - 1) / WTN;
  static constexpr int TP = R <= 4 ? 64 : 32;   // pixels per stage
  static constexpr int KS = TP / (8 * WK);      // 8-pixel steps per warp and stage
  static constexpr int STAGE = 2 * TP * LD;     // q tile, k tile
  static constexpr int RP = CHP + 1;             // pitch of a partial G: stores spread over banks
  static constexpr int E = CHP * RP + 2 * CHP;   // one warp group's partial
  static constexpr int FLOATS =
      kGramStages * STAGE > WK * E ? kGramStages * STAGE : WK * E;
  static_assert(WK * WTM * WTN == kThreads / 32, "eight warps");
  static_assert(KS >= 1, "a stage feeds every warp group");
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The channel blocks of a head of ch channels, cut into blocks of cb
// (ops/gram.py channel_blocks): nb blocks, nb * nb pairs.
int n_blocks(int ch, int cb) { return (ch + cb - 1) / cb; }

// A kernel's four variants, by copy width (VEC) and channel blocks (BLK),
// with the shared-memory limit of each raised once per device. A head cut
// into blocks has blocks of 65..128 channels (R >= 5; ops/gram.py
// channel_blocks): below, the BLK slot holds the single-block variant,
// which no plan launches there, so that it is not compiled for nothing.
template <int R>
constexpr bool kBlocked = R >= 5;

template <typename Kernel>
struct Variants {
  Kernel k[2][2];  // [VEC][BLK]
  cudaError_t allow(bool (&done)[2][kMaxDevices], int floats) const {
    for (int blk = 0; blk < 2; ++blk) {
      const cudaError_t e = allow_smem(done[blk], k[1][blk], k[0][blk], floats);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

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

