// Fused MDTA transposed attention for Hopper (sm_90a), forward.
//
// Replaces the TPU kernel of rcot_tpu/ops/pallas_mdta.py, `_kernel`
// (:41-76) launched by mdta_attend_fused (pallas_call at :116). Per
// (b, head), on q, k and v of shape (c, N), channels by pixels (the layout
// the caller's transposes give, as rcot_tpu/ops/attention.py:75-76 does):
//
//   attn = softmax_d( (q_hat k_hat^T)[i, d] * temperature[head] ),
//   q_hat = q / max(|q_i|, 1e-12) along N (k_hat likewise),
//   out  = attn v,
//
// through the identity q_hat k_hat^T = (q k^T) / (max(|q_i|, eps)
// max(|k_d|, eps)): the Gram and the two sums of squares are pixel sums of
// the raw inputs, and the normalisation touches only the c x c matrix.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
// q, k and v are read and out written once, 16 bytes per element of (c, N),
// against 4c + 4 flops per element (2c for the Gram, 2c for the apply, the
// squares); at c = 48 bytes bound it: about 15 us at serve L1
// (1 x 48 x 65536).
//
// Design. The TPU kernel runs one sequential program per (b, head) that
// streams N twice, its sums carried in scratch across the grid
// (BH, 2, N / chunk). At serve L1 B * heads is 1: one CUDA block per head
// would use one SM of 132. Here N is split over blocks, in two launches:
//   1. mdta_sums: blocks over (N-chunk, bh) sum G = q k^T, sum q^2 and
//      sum k^2 over their pixels (32-pixel tiles staged in shared memory; a
//      16 x 16 thread grid keeps an R x R tile of G in registers, thread
//      (ty, tx) owning rows ty + 16i and columns tx + 16j) and add them into
//      a workspace zeroed on the stream first, with atomicAdd. The adds come
//      in no fixed order: the sums agree with a fixed-order sum to about
//      1e-6 relative, not bitwise.
//   2. mdta_emit: blocks over (N-chunk, bh) rebuild the normalised,
//      temperature-scaled row softmax P (c x c, at most 128 x 129 floats)
//      in shared memory from the workspace (one warp per row), then write
//      out = P v over their pixels in 64-pixel tiles, v staged in shared
//      memory, thread (ty, tx) owning rows ty + 16i and pixels tx + 16j.
// Each block of launch 2 recomputes P (c^2 exponentials, against c * 64
// outputs per tile). No TPU fallback is carried over: every N and every
// c <= 128 is taken, with no chunk search and no c % 8 condition.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumTile = 32;   // pixels per shared-memory stage (mdta_sums)
constexpr int kEmitTile = 64;  // pixels per output tile (mdta_emit)
constexpr int kMaxCh = 128;    // 16 * R with R <= 8
constexpr float kEps = 1e-12f;

// ws_g (BH, c, c) += q k^T, ws_nq (BH, c) += sum q^2, ws_nk += sum k^2
// over pixels [blockIdx.x * per, ...) of head bh = blockIdx.y.
template <int R>
__global__ void __launch_bounds__(kThreads)
mdta_sums_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 float* __restrict__ ws_g, float* __restrict__ ws_nq,
                 float* __restrict__ ws_nk, long long n, int c, long long per) {
  __shared__ float qs[kMaxCh * (kSumTile + 1)];  // [c][kSumTile + 1]
  __shared__ float ks[kMaxCh * (kSumTile + 1)];
  constexpr int ld = kSumTile + 1;
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long begin = blockIdx.x * per;
  const long long end = begin + per < n ? begin + per : n;
  const float* qb = q + bh * c * n;
  const float* kb = k + bh * c * n;

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  float sq = 0.f;  // thread tid < c sums q^2 of row tid, c <= tid < 2c
                   // sums k^2 of row tid - c

  for (long long p0 = begin; p0 < end; p0 += kSumTile) {
    __syncthreads();
    for (int idx = tid; idx < c * kSumTile; idx += kThreads) {
      const int i = idx / kSumTile, p = idx % kSumTile;
      const long long pix = p0 + p;
      const bool in = pix < end;
      qs[i * ld + p] = in ? qb[i * n + pix] : 0.f;
      ks[i * ld + p] = in ? kb[i * n + pix] : 0.f;
    }
    __syncthreads();
    for (int p = 0; p < kSumTile; ++p) {
      float a[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
        a[i] = r < c ? qs[r * ld + p] : 0.f;
        const int d = tx + 16 * i;
        bv[i] = d < c ? ks[d * ld + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (tid < 2 * c) {
      const float* src = tid < c ? qs + tid * ld : ks + (tid - c) * ld;
      for (int p = 0; p < kSumTile; ++p) sq = fmaf(src[p], src[p], sq);
    }
  }

  float* g = ws_g + bh * c * c;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int d = tx + 16 * j;
      if (r < c && d < c) atomicAdd(g + r * c + d, acc[i][j]);
    }
  }
  if (tid < c)
    atomicAdd(ws_nq + bh * c + tid, sq);
  else if (tid < 2 * c)
    atomicAdd(ws_nk + bh * c + tid - c, sq);
}

// out[bh] = softmax(G / (rq rk^T) * temp[bh % heads]) v[bh] over pixels
// [blockIdx.x * per, ...) of head bh = blockIdx.y.
template <int R>
__global__ void __launch_bounds__(kThreads)
mdta_emit_kernel(const float* __restrict__ v, const float* __restrict__ ws_g,
                 const float* __restrict__ ws_nq,
                 const float* __restrict__ ws_nk, const float* __restrict__ temp,
                 float* __restrict__ out, long long n, int c, int heads,
                 long long per) {
  extern __shared__ float smem[];
  const int lp = c + 1;
  float* P = smem;            // [c][c + 1]
  float* vs = smem + c * lp;  // [c][kEmitTile]
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long begin = blockIdx.x * per;
  const long long end = begin + per < n ? begin + per : n;

  // logits, then a numerically stable row softmax, one warp per row
  const float t = temp[bh % heads];
  const float* g = ws_g + bh * c * c;
  const float* nq = ws_nq + bh * c;
  const float* nk = ws_nk + bh * c;
  for (int idx = tid; idx < c * c; idx += kThreads) {
    const int i = idx / c, d = idx % c;
    const float rq = fmaxf(sqrtf(nq[i]), kEps), rk = fmaxf(sqrtf(nk[d]), kEps);
    P[i * lp + d] = g[idx] / (rq * rk) * t;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < c; i += kThreads / 32) {
    float* prow = P + i * lp;
    float m = -INFINITY;
    for (int d = lane; d < c; d += 32) m = fmaxf(m, prow[d]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
    for (int d = lane; d < c; d += 32) {
      const float e = expf(prow[d] - m);
      prow[d] = e;
      s += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float inv = 1.f / s;
    for (int d = lane; d < c; d += 32) prow[d] *= inv;
  }

  const float* vb = v + bh * c * n;
  float* ob = out + bh * c * n;
  constexpr int PJ = kEmitTile / 16;
  for (long long p0 = begin; p0 < end; p0 += kEmitTile) {
    __syncthreads();  // P is written; the last tile's vs is read
    for (int idx = tid; idx < c * kEmitTile; idx += kThreads) {
      const int d = idx / kEmitTile, p = idx % kEmitTile;
      const long long pix = p0 + p;
      vs[idx] = pix < end ? vb[d * n + pix] : 0.f;
    }
    __syncthreads();
    float acc[R][PJ];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
    for (int d = 0; d < c; ++d) {
      float w[R], x[PJ];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
        w[i] = r < c ? P[r * lp + d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < PJ; ++j) x[j] = vs[d * kEmitTile + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(w[i], x[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
      if (r >= c) continue;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const long long pix = p0 + tx + 16 * j;
        if (pix < end) ob[r * n + pix] = acc[i][j];
      }
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Pixels per block, a whole number of tiles: about four blocks per SM over
// all BH heads, at least one tile each.
long long pixels_per_block(long long n, int bh, int tile) {
  const long long tiles = (n + tile - 1) / tile;
  long long blocks = (4LL * sm_count() + bh - 1) / bh;
  if (blocks > tiles) blocks = tiles;
  if (blocks < 1) blocks = 1;
  return (tiles + blocks - 1) / blocks * tile;
}

template <int R>
cudaError_t attend(const float* q, const float* k, const float* v,
                   const float* temp, float* out, float* ws, int BH, int heads,
                   int c, long long n, cudaStream_t st) {
  float* ws_g = ws;
  float* ws_nq = ws + (long long)BH * c * c;
  float* ws_nk = ws_nq + (long long)BH * c;
  cudaError_t err =
      cudaMemsetAsync(ws, 0, sizeof(float) * (size_t)BH * c * (c + 2), st);
  if (err != cudaSuccess) return err;

  long long per = pixels_per_block(n, BH, kSumTile);
  dim3 grid((unsigned)((n + per - 1) / per), (unsigned)BH);
  mdta_sums_kernel<R><<<grid, kThreads, 0, st>>>(q, k, ws_g, ws_nq, ws_nk, n,
                                                 c, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = sizeof(float) * ((size_t)c * (c + 1) + (size_t)c * kEmitTile);
  err = cudaFuncSetAttribute(mdta_emit_kernel<R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  per = pixels_per_block(n, BH, kEmitTile);
  grid = dim3((unsigned)((n + per - 1) / per), (unsigned)BH);
  mdta_emit_kernel<R><<<grid, kThreads, smem, st>>>(v, ws_g, ws_nq, ws_nk,
                                                    temp, out, n, c, heads, per);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v (BH, c, N) with bh = b * heads + head, temp (heads,) -> out
// (BH, c, N); ws holds BH * c * (c + 2) floats (G, sum q^2, sum k^2) and is
// zeroed here, on the stream. c <= 128 picks R = ceil(c / 16) in 1..8;
// anything wider is refused.
int rcot_mdta_attend(const float* q, const float* k, const float* v,
                     const float* temp, float* out, float* ws, int BH,
                     int heads, int c, long long n, void* stream) {
  if ((long long)BH * c * n == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) attend<R>(q, k, v, temp, out, ws, BH, heads, c, n, st)
  switch ((c + 15) / 16) {
    case 1: return RCOT_CALL(1);
    case 2: return RCOT_CALL(2);
    case 3: return RCOT_CALL(3);
    case 4: return RCOT_CALL(4);
    case 5: return RCOT_CALL(5);
    case 6: return RCOT_CALL(6);
    case 7: return RCOT_CALL(7);
    case 8: return RCOT_CALL(8);
    default: return cudaErrorInvalidValue;
  }
#undef RCOT_CALL
}

}  // extern "C"
