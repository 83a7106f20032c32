// The fused MDTA attend's kernels (row 10), templated on the element type
// of q, k, v and out: mdta.cu's header describes the design. mdta.cu
// compiles the fp32 form (rcot_mdta_attend), mdta_bf16.cu the bf16 form
// (rcot_mdta_attend_bf16).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGramTP = 64;       // pixels a Gram stage
constexpr int kApplyTP = 128;     // pixels an apply tile: eight warps of 16
constexpr int kChain = 4;         // k-steps of 8 in one mma chain: 32 deep
constexpr int kMaxBlock = 128;    // the widest channel block
constexpr int kSoftmaxWarps = 32; // the most warps a softmax block sums with
constexpr float kEps = 1e-12f;

// acc = 0 at the start of a chain; total += acc at its end
template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}
template <int M, int N>
__device__ __forceinline__ void join(float (&total)[M][N][4], const float (&acc)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) total[i][j][r] += acc[i][j][r];
}

template <typename T>
constexpr bool kBf16 = std::is_same<T, bf16>::value;

// Rows [0, rows) of a (., n) row-major matrix at src, pixels [p0, p0 + TP)
// (zeros at or past `end`), into dst rows of pitch ld, V elements of T a
// copy (V floats: cp.async; bf16: 8 by cp.async, or 1 loaded and stored by
// the thread). V divides TP and, with V > 1, n and end (whole copies in or
// out).
template <int TP, int V, typename T>
__device__ __forceinline__ void stage_pixels(T* dst, int ld, const T* src, long long n,
                                             int rows, long long p0, long long end) {
  constexpr int PER = TP / V;
  for (int idx = threadIdx.x; idx < rows * PER; idx += kThreads) {
    const int r = idx / PER, off = (idx - r * PER) * V;
    const long long pix = p0 + off;
    const bool in = pix < end;
    if constexpr (!kBf16<T>)
      cp_async_v<V>(dst + r * ld + off, src + r * n + (in ? pix : 0), in);
    else if constexpr (V == 1)
      dst[r * ld + off] = in ? src[r * n + pix] : __float2bfloat16_rn(0.f);
    else
      cp_async_bytes<2 * V>(dst + r * ld + off, src + r * n + (in ? pix : 0), in);
  }
}

// ------------------------------------------------------------ the Gram

// G (16R x 16R, zero-padded) in 16 x 8 mma tiles, R row tiles by 2R column
// tiles; the eight warps split the tiles (WTM x WTN) and each stage's
// pixels (WK groups, KS k-steps each), as gram.cu's GramCfg. The ring holds
// elements of T; FLOATS counts floats.
template <int R, typename T = float>
struct GramCfg {
  static constexpr int CHP = 16 * R;
  // pitch in elements: fragment reads hit 32 banks (bf16: two lanes a
  // word), rows 16-byte aligned
  static constexpr int LD = kGramTP + (kBf16<T> ? 8 : 4);
  static constexpr int MT = R, NT = 2 * R;
  static constexpr int WK = R <= 2 ? 8 : (R <= 4 ? 4 : 1);
  static constexpr int WTM = R <= 4 ? 1 : 2;
  static constexpr int WTN = R <= 2 ? 1 : (R <= 4 ? 2 : 4);
  static constexpr int MW = (MT + WTM - 1) / WTM, NW = (NT + WTN - 1) / WTN;
  static constexpr int KS = kGramTP / (8 * WK);
  static constexpr int STAGES = R <= 4 ? 4 : 3;  // the ring's depth, as fits 227 KB
  static constexpr int STAGE = 2 * CHP * LD;     // q rows, k rows
  static constexpr int RP = CHP + 1;             // pitch of a partial G
  static constexpr int E = CHP * RP + 2 * CHP;
  static constexpr int RING = STAGES * STAGE * (int)sizeof(T) / 4;  // in floats
  static constexpr int FLOATS = RING > WK * E ? RING : WK * E;
  static_assert(WK * WTM * WTN == kThreads / 32, "eight warps");
  static_assert(KS >= 1, "a stage feeds every warp group");
};

// Block (s, bh, i * nb + j): over pixels [s * per, (s + 1) * per) of bh,
// G_ij = q_i k_j^T, nq_i = sum q_i^2 (pairs (i, 0)) and nk_j = sum k_j^2
// (pairs (0, j)), written with plain stores into the record
// ws + (bh * splits + s) * (c * c + 2c): G at row i cb, column j cb (pitch
// c), then nq, then nk.
template <int R, int V, typename T = float>
__global__ void __launch_bounds__(kThreads)
mdta_gram_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 float* __restrict__ ws, long long n, int c, int cb, int splits, int per) {
  using Cfg = GramCfg<R, T>;
  constexpr int LD = Cfg::LD, TP = kGramTP, CHP = Cfg::CHP, MW = Cfg::MW, NW = Cfg::NW;
  constexpr int kStages = Cfg::STAGES;
  extern __shared__ __align__(16) float smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int s = blockIdx.x, bh = blockIdx.y;
  const int nb = (c + cb - 1) / cb, pi = blockIdx.z / nb, pj = blockIdx.z - pi * nb;
  const int wi = block_width(pi, c, cb), wj = block_width(pj, c, cb);
  const long long begin = (long long)s * per;
  const long long end = begin + per < n ? begin + per : n;
  const T* qb = q + ((long long)bh * c + pi * cb) * n;
  const T* kb = k + ((long long)bh * c + pj * cb) * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wk = warp % Cfg::WK, wt = warp / Cfg::WK;
  const int wm = wt / Cfg::WTN, wn = wt % Cfg::WTN;
  // warps whose share runs past the padded G (odd R) skip those tiles; the
  // hot loop has no other branch (rows past a block's width add zeros)
  bool use_m[MW], use_n[NW];
#pragma unroll
  for (int i = 0; i < MW; ++i) use_m[i] = Cfg::MT % Cfg::WTM == 0 || wm * MW + i < Cfg::MT;
#pragma unroll
  for (int j = 0; j < NW; ++j) use_n[j] = Cfg::NT % Cfg::WTN == 0 || wn * NW + j < Cfg::NT;

  // the copies never write rows [wi, CHP) of q or [wj, CHP) of k: zero them once
  const int zq = CHP - wi, zk = CHP - wj;
  for (int idx = tid; idx < kStages * (zq + zk) * LD; idx += kThreads) {
    const int r = idx / LD, col = idx - r * LD;
    const int st = r / (zq + zk), rr = r - st * (zq + zk);
    ring[st * Cfg::STAGE + (rr < zq ? wi + rr : CHP + wj + rr - zq) * LD + col] =
        from_f<T>(0.f);
  }
  const int n_tiles = (int)((end - begin + TP - 1) / TP);
  auto load = [&](int t) {
    T* dst = ring + (t % kStages) * Cfg::STAGE;
    const long long p0 = begin + (long long)t * TP;
    stage_pixels<TP, V>(dst, LD, qb, n, wi, p0, end);
    stage_pixels<TP, V>(dst + CHP * LD, LD, kb, n, wj, p0, end);
  };

  float acc[MW][NW][4], total[MW][NW][4];
  float sq_q[MW][2], sq_k[NW];
  zero(total);
#pragma unroll
  for (int i = 0; i < MW; ++i) sq_q[i][0] = sq_q[i][1] = 0.f;
#pragma unroll
  for (int j = 0; j < NW; ++j) sq_k[j] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_commit();
  }
  int step = 0;  // this warp's k-steps so far: a chain is kChain of them
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<kStages - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + kStages - 1 < n_tiles) load(t + kStages - 1);
    cp_commit();
    const T* qs = ring + (t % kStages) * Cfg::STAGE;
    const T* ks = qs + CHP * LD;
#pragma unroll
    for (int kk = 0; kk < Cfg::KS; ++kk) {
      const int p = (wk * Cfg::KS + kk) * 8 + tig;  // this lane's pixels: p, p + 4
      if (step % kChain == 0) zero(acc);
      uint32_t ah[MW][4], al[MW][4], bh_[NW][2], bl[NW][2];
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        const int r = (wm * MW + i) * 16 + gid;
        if (!use_m[i]) continue;
        const float x[4] = {to_f(qs[r * LD + p]), to_f(qs[(r + 8) * LD + p]),
                            to_f(qs[r * LD + p + 4]), to_f(qs[(r + 8) * LD + p + 4])};
        sq_q[i][0] = fmaf(x[2], x[2], fmaf(x[0], x[0], sq_q[i][0]));
        sq_q[i][1] = fmaf(x[3], x[3], fmaf(x[1], x[1], sq_q[i][1]));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_fast(x[e], ah[i][e], al[i][e]);
      }
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int d = (wn * NW + j) * 8 + gid;
        if (!use_n[j]) continue;
        const float y[2] = {to_f(ks[d * LD + p]), to_f(ks[d * LD + p + 4])};
        sq_k[j] = fmaf(y[1], y[1], fmaf(y[0], y[0], sq_k[j]));
#pragma unroll
        for (int e = 0; e < 2; ++e) split_fast(y[e], bh_[j][e], bl[j][e]);
      }
      if constexpr (kBf16<T>)
        mma_1xtf32(acc, ah, bh_, use_m, use_n);
      else
        mma_3xtf32(acc, ah, al, bh_, bl, use_m, use_n);
      if (step % kChain == kChain - 1) join(total, acc);
      ++step;
    }
  }
  if (step % kChain != 0) join(total, acc);
  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the warp groups' partials now

  constexpr int RP = Cfg::RP, SQ = CHP * RP;  // partial: [G (CHP rows of RP) | nq | nk]
  float* red = smem + wk * Cfg::E;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    if (!use_m[i]) continue;
    const int r = (wm * MW + i) * 16 + gid;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (!use_n[j]) continue;
      const int d = (wn * NW + j) * 8 + 2 * tig;
      red[r * RP + d] = total[i][j][0];
      red[r * RP + d + 1] = total[i][j][1];
      red[(r + 8) * RP + d] = total[i][j][2];
      red[(r + 8) * RP + d + 1] = total[i][j][3];
    }
    // each channel's squares sit in the four lanes of its group
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = sq_q[i][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (wn == 0 && tig == 0) red[SQ + r + 8 * h] = v;
    }
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if (!use_n[j]) continue;
    float v = sq_k[j];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (wm == 0 && tig == 0) red[SQ + CHP + (wn * NW + j) * 8 + gid] = v;
  }
  __syncthreads();

  // the WK partials in a fixed order, written once: warp w rows w, w + 8, ...
  float* rec = ws + ((long long)bh * splits + s) * ((long long)c * c + 2 * c);
  float* go = rec + (long long)pi * cb * c + pj * cb;
  for (int r = warp; r < wi; r += kThreads / 32)
    for (int d = lane; d < wj; d += 32) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < Cfg::WK; ++w) v += smem[w * Cfg::E + r * RP + d];
      go[(long long)r * c + d] = v;
    }
  for (int e = tid; e < 2 * CHP; e += kThreads) {
    const int which = e / CHP, r = e - which * CHP;
    // nq from the pairs (i, 0), nk from the pairs (0, j)
    if (r >= (which ? wj : wi) || (which ? pi : pj) != 0) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < Cfg::WK; ++w) v += smem[w * Cfg::E + SQ + e];
    rec[(long long)c * c + (which ? c + pj * cb : pi * cb) + r] = v;
  }
}

// ------------------------------------------------------- the softmax

// Row i of P[bh] (c x c) from the `splits` records of bh: logits
// G[i, d] / (max(sqrt(nq[i]), eps) max(sqrt(nk[d]), eps)) * temp[bh % heads],
// then a numerically stable softmax over d. Warp w of W adds the records
// w, w + W, ... in order (a few each, their loads issued together), and
// warp 0 adds the W sums in order, 32 columns at a time, keeping the row
// in shared memory (dynamic, c floats) up to kRowFloats columns and in P
// itself above.
constexpr int kRowFloats = 8192;

__global__ void __launch_bounds__(32 * kSoftmaxWarps)
mdta_softmax_kernel(const float* __restrict__ ws, const float* __restrict__ temp,
                    float* __restrict__ P, int c, int heads, int splits) {
  __shared__ float part[2][kSoftmaxWarps][32];
  __shared__ float part_q[kSoftmaxWarps];
  extern __shared__ float row_smem[];
  const int i = blockIdx.x, bh = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, W = blockDim.x >> 5;
  const long long E = (long long)c * c + 2 * c;
  const float* rec = ws + (long long)bh * splits * E;
  const float t = temp[bh % heads];
  float* prow = P + ((long long)bh * c + i) * c;
  float* x = c <= kRowFloats ? row_smem : prow;  // the row until it is final
  float rq = 0.f, m = -INFINITY;
  for (int d0 = 0; d0 < c; d0 += 32) {
    const int d = d0 + lane;
    const bool in = d < c;
    float g = 0.f, nk = 0.f, nq = 0.f;  // nq[i]: with the first 32 columns
#pragma unroll 4
    for (int s = w; s < splits; s += W) {
      const float* r = rec + s * E;
      if (in) {
        g += r[(long long)i * c + d];
        nk += r[(long long)c * c + c + d];
      }
      if (d0 == 0) nq += r[(long long)c * c + i];
    }
    part[0][w][lane] = g;
    part[1][w][lane] = nk;
    if (d0 == 0 && lane == 0) part_q[w] = nq;
    __syncthreads();
    if (w == 0) {
      if (d0 == 0) {
        float q = 0.f;
#pragma unroll 8
        for (int u = 0; u < W; ++u) q += part_q[u];
        rq = fmaxf(sqrtf(q), kEps);
      }
      if (in) {
        float gs = 0.f, ks = 0.f;
#pragma unroll 8
        for (int u = 0; u < W; ++u) {
          gs += part[0][u][lane];
          ks += part[1][u][lane];
        }
        const float l = gs / (rq * fmaxf(sqrtf(ks), kEps)) * t;
        x[d] = l;
        m = fmaxf(m, l);
      }
    }
    __syncthreads();  // warp 0 is done with `part` before the next columns
  }
  if (w != 0) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sum = 0.f;
  for (int d = lane; d < c; d += 32) {  // each lane rereads what it wrote
    const float e = expf(x[d] - m);
    x[d] = e;
    sum += e;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float inv = 1.f / sum;
  for (int d = lane; d < c; d += 32) prow[d] = x[d] * inv;
}

// ---------------------------------------------------------- the apply

// out (16R x 128 pixels) = P (16R x 16R, zero-padded) v (16R x 128): P
// staged row-major [r][d] (pitch CHP + 4), split into its tf32 parts where
// both copies fit beside the ring (SPLIT), else whole and split at each
// use; the v ring [d][pixel] (pitch 136 elements of T).
template <int R, typename T = float>
struct ApplyCfg {
  static constexpr int CHP = 16 * R;
  static constexpr int LDA = CHP + 4;       // A fragment reads hit 32 banks
  static constexpr int LDV = kApplyTP + 8;  // and so do B's
  static constexpr int STAGES = R <= 4 ? 3 : 2;
  static constexpr bool SPLIT = R <= 7;
  static constexpr int RING = STAGES * CHP * LDV * (int)sizeof(T) / 4;  // in floats
  static constexpr int MAT = CHP * LDA;
  static constexpr int FLOATS = RING + (SPLIT ? 2 : 1) * MAT;
  static_assert(kApplyTP == 16 * (kThreads / 32), "a warp per 16 pixels");
  static_assert(CHP * CHP == R * R * kThreads, "P is R^2 entries a thread");
};

// Tiles t = bh * tiles_per_bh + x (pixels [x TP, (x + 1) TP) of bh); block
// (k, i * nb + j) walks tiles [k * per_block, (k + 1) * per_block) and
// writes out_i's part P_ij v_j to out + j * slot, restaging P_ij only where
// bh changes. v of type T, out of type TO (T, or fp32 slots).
template <int R, int V, typename T = float, typename TO = T>
__global__ void __launch_bounds__(kThreads)
mdta_apply_kernel(const T* __restrict__ v, const float* __restrict__ P,
                  TO* __restrict__ out, long long slot, long long n, int c, int cb,
                  long long tiles_per_bh, long long n_tiles_all, int per_block) {
  using Cfg = ApplyCfg<R, T>;
  constexpr int LDA = Cfg::LDA, LDV = Cfg::LDV, TP = kApplyTP, CHP = Cfg::CHP;
  constexpr int STAGES = Cfg::STAGES, KSTEPS = CHP / 8;
  extern __shared__ __align__(16) float smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* ph = smem + Cfg::RING;  // P(r, d) at [r * LDA + d]: its high part, or itself
  float* pl = ph + Cfg::MAT;     // its low part (SPLIT)
  const long long t0 = (long long)blockIdx.x * per_block;
  const long long t1 = t0 + per_block < n_tiles_all ? t0 + per_block : n_tiles_all;
  if (t0 >= t1) return;
  const int nt = (int)(t1 - t0);
  const int nb = (c + cb - 1) / cb, pi = blockIdx.y / nb, pj = blockIdx.y - pi * nb;
  const int wi = block_width(pi, c, cb), wj = block_width(pj, c, cb);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = warp * 16;  // this warp's pixels in a tile

  // the copies never write rows [wj, CHP) of a v tile: zero them once
  const int zr = CHP - wj;
  for (int idx = tid; idx < STAGES * zr * LDV; idx += kThreads) {
    const int r = idx / LDV, col = idx - r * LDV;
    const int st = r / zr;
    ring[(st * CHP + wj + r - st * zr) * LDV + col] = from_f<T>(0.f);
  }
  auto load = [&](int x) {
    const long long t = t0 + x, bh = t / tiles_per_bh;
    stage_pixels<TP, V>(ring + (x % STAGES) * CHP * LDV, LDV, v + (bh * c + pj * cb) * n, n, wj,
                        (t - bh * tiles_per_bh) * TP, n);
  };
  auto stage_p = [&](long long bh) {  // zero outside wi x wj; R^2 entries a thread
    const float* a = P + (bh * c + pi * cb) * c + pj * cb;
#pragma unroll 8
    for (int it = 0; it < R * R; ++it) {
      const int idx = tid + it * kThreads, r = idx / CHP, d = idx - r * CHP;
      const float x = r < wi && d < wj ? a[(long long)r * c + d] : 0.f;
      if (Cfg::SPLIT) {
        uint32_t hi, lo;
        split_fast(x, hi, lo);
        ph[r * LDA + d] = __uint_as_float(hi);
        pl[r * LDA + d] = __uint_as_float(lo);
      } else {
        ph[r * LDA + d] = x;
      }
    }
  };

#pragma unroll
  for (int x = 0; x < STAGES - 1; ++x) {
    if (x < nt) load(x);
    cp_commit();
  }
  long long staged = t0 / tiles_per_bh;  // the bh whose P is in shared memory
  stage_p(staged);
  for (int x = 0; x < nt; ++x) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile x has landed; every warp is done with tile x - 1
    if (x + STAGES - 1 < nt) load(x + STAGES - 1);
    cp_commit();
    const long long t = t0 + x, bh = t / tiles_per_bh;
    if (bh != staged) {  // a run that crosses into the next bh
      stage_p(bh);
      staged = bh;
      __syncthreads();
    }
    const T* vs = ring + (x % STAGES) * CHP * LDV;
    float acc[R][2][4], total[R][2][4];
    zero(total);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int k0 = ks * 8;
      if (ks % kChain == 0) zero(acc);
      // B(d, p) = v(d, p): rows k0 + tig, k0 + tig + 4, this warp's pixels
      uint32_t bh_[2][2], bl[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = n0 + j * 8 + gid;
        split_fast(to_f(vs[(k0 + tig) * LDV + p]), bh_[j][0], bl[j][0]);
        split_fast(to_f(vs[(k0 + tig + 4) * LDV + p]), bh_[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int o = (i * 16 + gid) * LDA + k0 + tig;
        const int os[4] = {o, o + 8 * LDA, o + 4, o + 8 * LDA + 4};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (Cfg::SPLIT) {
            ah[e] = __float_as_uint(ph[os[e]]);
            al[e] = __float_as_uint(pl[os[e]]);
          } else {
            split_fast(ph[os[e]], ah[e], al[e]);
          }
        }
        // al bh + ah bl + ah bh, each term over both tiles before the next
        // (bf16 v: bl is zero, its term left out)
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (!kBf16<T> || term != 1)
              mma_tf32(acc[i][j], term == 0 ? al : ah, term == 1 ? bl[j] : bh_[j]);
      }
      if (ks % kChain == kChain - 1 || ks == KSTEPS - 1) join(total, acc);
    }
    const long long p0 = (t - bh * tiles_per_bh) * TP + n0 + 2 * tig;
    TO* ob = out + pj * slot + (bh * c + pi * cb) * n;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = i * 16 + gid + 8 * h;
        if (r >= wi) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const long long p = p0 + j * 8;
          TO* dst = ob + r * n + p;
          const float e0 = total[i][j][2 * h], e1 = total[i][j][2 * h + 1];
          if (V > 1) {  // n % V == 0, p even: p + 1 < n where p < n
            if (p >= n) continue;
            if constexpr (kBf16<TO>)
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(e0, e1);
            else
              *reinterpret_cast<float2*>(dst) = make_float2(e0, e1);
          } else {
            if (p < n) dst[0] = from_f<TO>(e0);
            if (p + 1 < n) dst[1] = from_f<TO>(e1);
          }
        }
      }
  }
}

// ------------------------------------------------------------- the call

// out = P v for one T: v's copy width VV (4 or 1 floats, 8 or 1 bf16), out
// of type TO (T, or the fp32 slots of a head cut into channel blocks)
template <int R, typename T, typename TO>
cudaError_t apply_to(const T* v, const float* P, TO* out, long long slot, long long n, int c,
                     int cb, int BH, int apply_blocks, int apply_per, int vec, cudaStream_t st) {
  constexpr int VV = kBf16<T> ? 8 : 4;
  static bool done[kMaxDevices];
  const cudaError_t err = allow_smem(done, mdta_apply_kernel<R, VV, T, TO>,
                                     mdta_apply_kernel<R, 1, T, TO>, ApplyCfg<R, T>::FLOATS);
  if (err != cudaSuccess) return err;
  const int nb = (c + cb - 1) / cb;
  const long long tiles_per_bh = (n + kApplyTP - 1) / kApplyTP;
  const auto apply =
      vec == VV ? mdta_apply_kernel<R, VV, T, TO> : mdta_apply_kernel<R, 1, T, TO>;
  apply<<<dim3((unsigned)apply_blocks, (unsigned)(nb * nb)), kThreads,
          sizeof(float) * ApplyCfg<R, T>::FLOATS, st>>>(v, P, out, slot, n, c, cb, tiles_per_bh,
                                                        tiles_per_bh * BH, apply_per);
  return cudaGetLastError();
}

template <int R, typename T>
cudaError_t attend(const T* q, const T* k, const T* v, const float* temp, T* out, float* ws,
                   int BH, int heads, int c, long long n, int splits, int per, int cb,
                   int apply_blocks, int apply_per, int warps, int vec, cudaStream_t st) {
  constexpr int VV = kBf16<T> ? 8 : 4;
  static bool done_g[kMaxDevices];
  cudaError_t err = allow_smem(done_g, mdta_gram_kernel<R, VV, T>, mdta_gram_kernel<R, 1, T>,
                               GramCfg<R, T>::FLOATS);
  if (err != cudaSuccess) return err;
  const int nb = (c + cb - 1) / cb;
  const long long slot = (long long)BH * c * n;
  // the workspace: [nb slots of out where nb > 1 | Gram records | P]
  float* slots = ws;
  float* records = ws + (nb > 1 ? nb * slot : 0);
  float* P = records + (long long)splits * BH * ((long long)c * c + 2 * c);

  const auto gram = vec == VV ? mdta_gram_kernel<R, VV, T> : mdta_gram_kernel<R, 1, T>;
  gram<<<dim3((unsigned)splits, (unsigned)BH, (unsigned)(nb * nb)), kThreads,
         sizeof(float) * GramCfg<R, T>::FLOATS, st>>>(q, k, records, n, c, cb, splits, per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mdta_softmax_kernel<<<dim3((unsigned)c, (unsigned)BH), 32 * warps,
                        c <= kRowFloats ? sizeof(float) * c : 0, st>>>(records, temp, P, c,
                                                                        heads, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (nb == 1)
    return apply_to<R>(v, P, out, slot, n, c, cb, BH, apply_blocks, apply_per, vec, st);
  err = apply_to<R>(v, P, slots, slot, n, c, cb, BH, apply_blocks, apply_per, vec, st);
  if (err != cudaSuccess) return err;
  return sum_slots(slots, out, slot, nb, st);
}

// A plan the kernels take (ops/mdta.py mdta_plan): channel blocks of 1..128
// channels, ranges of whole stages, 1..32 softmax warps, copies of `wide`
// (4 floats or 8 bf16) or 1 element.
bool bad_plan(int c, int splits, int per, int cb, int apply_blocks, int apply_per, int warps,
              int vec, int wide) {
  return cb < 1 || cb > kMaxBlock || cb > c || splits < 1 || per < 1 || per % kGramTP != 0 ||
         apply_blocks < 1 || apply_per < 1 || warps < 1 || warps > kSoftmaxWarps ||
         (vec != wide && vec != 1);
}

// The call on q, k, v and out of type T: R = ceil(cb / 16) in 1..8.
template <typename T>
int attend_call(const T* q, const T* k, const T* v, const float* temp, T* out, float* ws,
                int BH, int heads, int c, long long n, int splits, int per, int cb,
                int apply_blocks, int apply_per, int warps, int vec, void* stream) {
  if ((long long)BH * c * n == 0) return cudaSuccess;
  if (bad_plan(c, splits, per, cb, apply_blocks, apply_per, warps, vec, kBf16<T> ? 8 : 4))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R)                                                                       \
  attend<R>(q, k, v, temp, out, ws, BH, heads, c, n, splits, per, cb, apply_blocks, apply_per, \
            warps, vec, st)
  switch ((cb + 15) / 16) {
    case 1: return RCOT_CALL(1);
    case 2: return RCOT_CALL(2);
    case 3: return RCOT_CALL(3);
    case 4: return RCOT_CALL(4);
    case 5: return RCOT_CALL(5);
    case 6: return RCOT_CALL(6);
    case 7: return RCOT_CALL(7);
    default: return RCOT_CALL(8);
  }
#undef RCOT_CALL
}

}  // namespace
