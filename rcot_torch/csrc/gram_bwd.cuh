// The MDTA core's backward kernels (rows 6 and 7: mdta_gram_bwd and
// attn_apply_bwd of rcot_tpu/ops/pallas_gram.py), templated on the operand
// policy of their products: 3xTF32 (gram_bwd.cu's rcot_mdta_gram_bwd and
// apply_bwd.cu's rcot_attn_apply_bwd) or bf16 operands, the JAX package's
// RCOT_BWD_BF16 "gram" tier (_bwd_dot(..., tier="gram") at
// pallas_gram.py:129-130 and :211-212; gram_bwd_b16ops.cu and
// apply_bwd_b16ops.cu). gram.cu's header describes the design.
//
// bf16 operands (OPS16): every operand of a product (k, q and dG for
// d[q|k]; g, attn and v for dv and dattn) is rounded to bf16 (RNE) as it
// enters its mma fragment (tc.cuh bf16_tf32; dG and attn once, as they are
// staged), and one tf32 mma.sync m16n8k8 a step takes the bf16 x bf16
// products exactly, summed in fp32. The tiles of q and k stay fp32 in
// shared memory, so 2 q dnq and 2 k dnk take them unrounded, as the TPU
// kernel's fp32 q and k (:129-131). Everything else (the rings, the
// swizzle, the fixed-order sums, the channel blocks) is the 3xTF32
// kernels'. Each policy is compiled in a source of its own, so that the
// two build in parallel.
//
// Both kernels are also templated on the element type of their pixel
// tensors (qkv and d[q|k]; qkv, g and dv): float (the kernels above) or
// bf16 (gram_bwd_bf16.cu, apply_bwd_bf16.cu, bf16 training). On bf16 they
// stage bf16 tiles (BwdBfCfg, ApplyBwdBfCfg) and widen each value as it
// enters its tf32 fragment: a bf16 value is exact in tf32, so the 3xTF32
// policy's terms of a zero low part add exact zeros and are left out (two
// mma.sync a step where the other operand is fp32, d[q|k]'s dG and dv's
// attn; one where both are bf16, dattn's g and v) and the ops16 policy's
// rounding of it is the identity; the sums are those of the fp32 kernels
// on the widened values, in their order. d[q|k] and dv are rounded to bf16
// in the epilogue and leave through shared memory in stores of 16 bytes
// where the widths allow.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gram.cuh"
#include "tc.cuh"

namespace {

constexpr int kBwdTP = 64;  // pixels per backward tile: four warps of 16 rows

// Both backward kernels at head width ch <= 16R. Every tile and matrix in
// their shared memory has pitch LD and is swizzled (swz): the mma
// fragments read rows gid and columns tig of one operand and rows tig and
// columns gid of another, and this layout serves both from 32 banks. A
// stage of the ring holds two tiles of kBwdTP rows; the ch x ch matrix
// (dG or attn) is staged split into its tf32 parts (SPLIT) where both
// copies fit beside the ring, else whole and split at each use.
template <int R>
struct BwdCfg {
  static constexpr int CHP = 16 * R;
  static constexpr int LD = CHP + 8;
  static constexpr int NT = 2 * R;  // 8-wide column tiles, and 8-deep steps over a channel
  static constexpr int STAGES = R <= 4 ? 3 : 2;
  static constexpr bool SPLIT = R <= 7;
  static constexpr int TILES = 2 * kBwdTP * LD;  // one stage
  static constexpr int RING = STAGES * TILES;
  static constexpr int MAT = CHP * LD;
  static constexpr int MATS = (SPLIT ? 2 : 1) * MAT;
  // gram_bwd_kernel: ring | dG | dnq, dnk
  static constexpr int GRAM_FLOATS = RING + MATS + 2 * CHP;
  // apply_bwd_kernel: ring (at the end the warp groups' dattn partials,
  // ch rows of pitch CHP + 1 each) | attn
  static constexpr int RED = GramCfg<R>::WK * CHP * (CHP + 1);
  static constexpr int APPLY_FLOATS = (RING > RED ? RING : RED) + MATS;
  static_assert(kBwdTP == 16 * (kThreads / 32) / 2, "four warps of 16 rows per tile");
  static_assert(kBwdTP % (8 * GramCfg<R>::WK) == 0, "a tile feeds every warp group");
};

// Element (r, c) of a swizzled tile or matrix of pitch ld.
__device__ __forceinline__ int swz(int r, int c, int ld) { return r * ld + (c ^ (r & 4)); }

// The bf16 Gram backward's shared memory: a ring of STAGES stages of a bf16
// q and k tile each, of pitch LDB, then dG (BwdCfg's MATS, fp32, swizzled)
// and dnq | dnk. The tiles are not swizzled: a row of LDB bf16 is 8R + 4
// words, 4 mod 8, so the rows gid = 0..7 of a fragment read start in
// different groups of four banks and its columns tig, tig + 4 (two words)
// fall inside them: the 32 lanes read 16 words from 16 banks. The
// epilogue stages each warp's d[q|k] rows in place of its own rows of the
// tiles. The plan (ops/gram.py gram_bwd_bf16_plan) takes the same sizes.
template <int R>
struct BwdBfCfg {
  using F = BwdCfg<R>;
  static constexpr int LDB = F::CHP + 8;
  static constexpr int STAGES = R <= 4 ? 4 : 3;
  static constexpr int TILES = 2 * kBwdTP * LDB;  // bf16, one stage
  static constexpr int BYTES = 2 * STAGES * TILES + 4 * (F::MATS + 2 * F::CHP);
  // blocks an SM: the registers allowed a thread (__launch_bounds__) leave
  // room for MIN_BLOCKS (ops/gram.py _gram_bwd_bf16_reg_blocks)
  static constexpr int MIN_BLOCKS = R <= 3 ? 2 : 1;
  static_assert(BYTES % 16 == 0 && BYTES <= kMaxSmemBytes, "fits a block");
};

// Blocks an SM that a Gram backward kernel's registers are held to leave
// room for: one for the fp32 kernels (their __launch_bounds__ as before).
template <typename T, int R>
constexpr int kGramBwdMinBlocks = std::is_same<T, float>::value ? 1 : BwdBfCfg<R>::MIN_BLOCKS;

// The bf16 apply backward's shared memory: a ring of STAGES stages of a bf16
// g and v tile each (pitch LDB, not swizzled: BwdBfCfg's argument holds for
// the fragment reads of both products), dv's bf16 staging tile (kBwdTP rows,
// pitch LDB; each warp its own rows and columns), then attn (BwdCfg's MATS,
// fp32, swizzled). After the pixel loop the front (ring and staging) holds
// the warp groups' dattn partials (BwdCfg's RED floats). The plan's copy:
// ops/gram.py apply_bwd_bf16_smem, apply_bwd_bf16_per_sm.
template <int R>
struct ApplyBwdBfCfg {
  using F = BwdCfg<R>;
  static constexpr int LDB = F::CHP + 8;
  static constexpr int STAGES = R <= 4 ? 4 : 3;
  static constexpr int TILES = 2 * kBwdTP * LDB;  // bf16, one stage
  static constexpr int DV = kBwdTP * LDB;         // bf16, dv's staging
  static constexpr int TILE_BYTES = 2 * (STAGES * TILES + DV);
  static constexpr int FRONT = TILE_BYTES > 4 * F::RED ? TILE_BYTES : 4 * F::RED;
  static constexpr int BYTES = FRONT + 4 * F::MATS;
  // up to R = 3 each warp holds its attn fragments in registers (HOLD), and
  // the registers allowed a thread (__launch_bounds__) leave room for
  // MIN_BLOCKS blocks an SM (ops/gram.py _apply_bwd_bf16_reg_blocks): two at
  // R = 1, one above (the main path's grids are one block an SM at most)
  static constexpr bool HOLD = R <= 3;
  static constexpr int MIN_BLOCKS = R <= 1 ? 2 : 1;
  static_assert(FRONT % 16 == 0 && BYTES <= kMaxSmemBytes, "fits a block");
};

template <typename T, int R>
constexpr int kApplyBwdMinBlocks = std::is_same<T, float>::value ? 1 : ApplyBwdBfCfg<R>::MIN_BLOCKS;

// A named barrier of the bf16 Gram backward's four warps that read rows
// [32 rh, 32 rh + 32) of a stage's tiles (ids 1 and 2; 0 is
// __syncthreads').
__device__ __forceinline__ void rows_sync(int rh) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + rh) : "memory");
}

// Zero columns [w, CHP) of the rows of the ring's `stages` stages of two
// kBwdTP-row tiles each, w = w0 in a stage's first tile and w1 in its
// second: the copies never write them, and the products run over all CHP.
// fp32 tiles are swizzled (pitch LD), bf16 ones not (pitch BwdBfCfg's LDB).
template <int R, typename T>
__device__ __forceinline__ void zero_pad(T* tiles, int stages, int w0, int w1) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int CHP = BwdCfg<R>::CHP, LD = BwdCfg<R>::LD, LDB = BwdBfCfg<R>::LDB;
  const int wmin = w0 < w1 ? w0 : w1, pad = CHP - wmin;
  for (int i = threadIdx.x; i < stages * 2 * kBwdTP * pad; i += kThreads) {
    const int r = i / pad, c = wmin + i - r * pad;
    if (c >= ((r / kBwdTP) & 1 ? w1 : w0))
      tiles[F32 ? swz(r, c, LD) : r * LDB + c] = from_f<T>(0.f);
  }
}

// A rows x cols block of a row-major matrix of pitch ld at m, zero-padded
// to CHP x CHP, into shared memory swizzled: its tf32 high and low parts
// (SPLIT) or itself; with OPS16 (the bf16-operand policy) in mh alone,
// rounded to bf16.
template <int R, bool OPS16>
__device__ __forceinline__ void stage_matrix(float* mh, float* ml, const float* m, int rows,
                                             int cols, int ld) {
  using Cfg = BwdCfg<R>;
  for (int idx = threadIdx.x; idx < Cfg::CHP * Cfg::CHP; idx += kThreads) {
    const int r = idx / Cfg::CHP, c = idx - r * Cfg::CHP;
    const float x = r < rows && c < cols ? m[r * ld + c] : 0.f;
    const int o = swz(r, c, Cfg::LD);
    if (OPS16) {
      mh[o] = __uint_as_float(bf16_tf32(x));
    } else if (Cfg::SPLIT) {
      uint32_t hi, lo;
      split_tf32(x, hi, lo);
      mh[o] = __uint_as_float(hi);
      ml[o] = __uint_as_float(lo);
    } else {
      mh[o] = x;
    }
  }
}

// The fragments of B(k, n) at k = k0 + tig and k0 + tig + 4 of the staged
// matrix M for column tiles j0 .. j0 + NJ - 1 (tile_product's M'): its tf32
// high part bh and low part bl (bl not read with OPS16).
template <int R, int NJ, bool TRANS, bool OPS16>
__device__ __forceinline__ void matrix_frags(uint32_t (&bh)[NJ][2], uint32_t (&bl)[NJ][2],
                                             int k0, int j0, const float* mh, const float* ml,
                                             int gid, int tig) {
  using Cfg = BwdCfg<R>;
  constexpr int LD = Cfg::LD;
  // columns k0 + tig and k0 + tig + 4 of a row with swizzle bit s
  const int s = gid & 4, x0 = tig + s, x1 = tig + 4 - s;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int n = (j0 + jj) * 8 + gid;
    const int o0 = TRANS ? (k0 + tig) * LD + n : n * LD + k0 + x0;
    const int o1 = TRANS ? (k0 + tig + 4) * LD + (n ^ 4) : n * LD + k0 + x1;
    if (OPS16 || Cfg::SPLIT) {
      bh[jj][0] = __float_as_uint(mh[o0]);
      bh[jj][1] = __float_as_uint(mh[o1]);
      if (!OPS16) {
        bl[jj][0] = __float_as_uint(ml[o0]);
        bl[jj][1] = __float_as_uint(ml[o1]);
      }
    } else {
      split_tf32(mh[o0], bh[jj][0], bl[jj][0]);
      split_tf32(mh[o1], bh[jj][1], bl[jj][1]);
    }
  }
}

// acc (16 rows from m0 of a tile, NJ column tiles) = A M' over all CHP
// steps, A the swizzled tile `as` (rows are pixels), the fragments of M'
// from frags(k0, bh, bl) at each 8-deep step k0 (matrix_frags's, or ones
// the caller holds). Lane (gid, tig) reads A at rows m0 + gid (+ 8), whose
// swizzle bit is gid & 4. OPS16: the bf16-operand policy, A rounded as it
// enters its fragment, M staged rounded (stage_matrix), one tf32 term. T =
// bf16: A a bf16 tile of pitch BwdBfCfg's LDB, not swizzled, each value
// widened into its fragment (exact: the ops16 rounding is the identity on
// it, and 3xTF32 drops its zero low part's term). MT row tiles of 16 from m0
// (acc[i] at m0 + 16 i) share each M fragment a step; every output's sum is
// the same.
template <int R, int NJ, bool OPS16, typename T, int MT, typename Frags>
__device__ __forceinline__ void tile_product_by(float (&acc)[MT][NJ][4], const T* as, int m0,
                                                int gid, int tig, Frags frags) {
  using Cfg = BwdCfg<R>;
  constexpr int LD = Cfg::LD;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int LDA = F32 ? LD : BwdBfCfg<R>::LDB;
  bool use_m[MT], use_n[NJ];
#pragma unroll
  for (int i = 0; i < MT; ++i) use_m[i] = true;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    use_n[j] = true;  // no branch in the hot loop: padding adds zeros
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  }
  // columns k0 + tig and k0 + tig + 4 of a row with swizzle bit s
  const int s = gid & 4, x0 = tig + s, x1 = tig + 4 - s;
  const T* a0 = as + (m0 + gid) * LDA;
#pragma unroll
  for (int k0 = 0; k0 < Cfg::CHP; k0 += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const T* ai = a0 + 16 * i * LDA;
      if constexpr (F32) {
        const float x[4] = {ai[k0 + x0], ai[8 * LD + k0 + x0], ai[k0 + x1], ai[8 * LD + k0 + x1]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (OPS16)
            ah[i][r] = bf16_tf32(x[r]);
          else
            split_tf32(x[r], ah[i][r], al[i][r]);
        }
      } else {  // al = 0, never read
        const T x[4] = {ai[k0 + tig], ai[8 * LDA + k0 + tig], ai[k0 + tig + 4],
                        ai[8 * LDA + k0 + tig + 4]};
#pragma unroll
        for (int r = 0; r < 4; ++r) ah[i][r] = widen_tf32(x[r]);
      }
    }
    frags(k0, bh, bl);
    if constexpr (OPS16)
      mma_1xtf32(acc, ah, bh, use_m, use_n);
    else
      mma_3xtf32<MT, NJ, !F32>(acc, ah, al, bh, bl, use_m, use_n);
  }
}

// tile_product_by with the fragments read from the staged matrix (mh, ml)
// at each step: M' = M^T (out[n, c] = sum_d a[n, d] M(c, d)) or, with
// TRANS, M' = M (out[n, d] = sum_c a[n, c] M(c, d)), column tiles j0 ..
template <int R, int NJ, bool TRANS, bool OPS16, typename T = float, int MT = 1>
__device__ __forceinline__ void tile_product(float (&acc)[MT][NJ][4], const T* as, int m0,
                                             int j0, const float* mh, const float* ml,
                                             int gid, int tig) {
  tile_product_by<R, NJ, OPS16, T, MT>(acc, as, m0, gid, tig, [&](int k0, auto& bh, auto& bl) {
    matrix_frags<R, NJ, TRANS, OPS16>(bh, bl, k0, j0, mh, ml, gid, tig);
  });
}

// Rows r0 and r0 + 8 (each stored only below `end`) of a warp's 16 x 8NJ
// result into out (row r at out + r * stride), columns below ch.
template <int NJ, bool VEC>
__device__ __forceinline__ void store_rows(float* out, long long stride, long long r0,
                                           long long end, int j0, int tig, int ch,
                                           const float (&v)[NJ][4]) {
  const long long r1 = r0 + 8;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int c = (j0 + jj) * 8 + 2 * tig;
    if (c >= ch) continue;
    if (VEC) {  // ch is even: c + 1 < ch
      if (r0 < end) *reinterpret_cast<float2*>(out + r0 * stride + c) = make_float2(v[jj][0], v[jj][1]);
      if (r1 < end) *reinterpret_cast<float2*>(out + r1 * stride + c) = make_float2(v[jj][2], v[jj][3]);
    } else {
      const bool c1 = c + 1 < ch;
      if (r0 < end) {
        out[r0 * stride + c] = v[jj][0];
        if (c1) out[r0 * stride + c + 1] = v[jj][1];
      }
      if (r1 < end) {
        out[r1 * stride + c] = v[jj][2];
        if (c1) out[r1 * stride + c + 1] = v[jj][3];
      }
    }
  }
}

// Row 6. Tiles t = bh * tiles_per_bh + i (pixels [i TP, (i + 1) TP) of
// (b, h)); block (k, i * nb + j) walks tiles [k * per_block, (k + 1) *
// per_block), restaging dG_ij, dnq_i and dnk_j only where bh changes, with
// the tiles of q_i and k_j streaming through the ring. Warp w < 4 writes
// dq_i's part from block j (to parts + j * slot), warp w >= 4 dk_j's part
// from block i (to parts + i * slot); a head of one block writes d[q|k]
// itself to out. In fp32 a warp takes rows 16 (w % 4) of each tile and
// every column; on bf16 rows 32 ((w / 2) % 2) and half the columns (w %
// 2), so that each dG fragment it reads from shared memory serves two row
// tiles (half the fragment reads a row). OPS16: the bf16-operand policy in
// both products. T: the element type of qkv and out (float, or bf16 with
// bf16 tiles, copies of v bf16 and the staged epilogue; the parts stay
// fp32); VEC is the fp32 kernels' copy width. The bf16 kernel is compiled
// once for both kinds of head (BLK true, the kind read from cb < ch), which
// halves what gram_bwd_bf16.cu compiles.
template <typename T, int R, bool VEC, bool BLK, bool OPS16>
__global__ void __launch_bounds__(kThreads, kGramBwdMinBlocks<T, R>)
gram_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ dgram,
                const float* __restrict__ dnq, const float* __restrict__ dnk,
                T* __restrict__ out, float* __restrict__ parts, long long slot, long long hw,
                int heads, int ch, int cb, long long tiles_per_bh, long long n_tiles_all,
                long long per_block, int v) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using Cfg = BwdCfg<R>;
  using Bf = BwdBfCfg<R>;
  constexpr int LD = Cfg::LD, TP = kBwdTP, CHP = Cfg::CHP, NT = Cfg::NT;
  constexpr int STAGES = F32 ? Cfg::STAGES : Bf::STAGES;
  constexpr int LDA = F32 ? LD : Bf::LDB;             // the tiles' pitch
  constexpr int TILES = F32 ? Cfg::TILES : Bf::TILES;  // elements a stage
  extern __shared__ __align__(16) float smem[];
  T* ring = reinterpret_cast<T*>(smem);
  // dG(c, d) at swz(c, d): its high part, or itself
  float* mh = reinterpret_cast<float*>(ring + STAGES * TILES);
  float* ml = mh + Cfg::MAT;     // its low part (SPLIT)
  float* dn = mh + Cfg::MATS;    // dnq | dnk, CHP each, zero past ch
  const long long t0 = blockIdx.x * per_block;
  const long long t1 = t0 + per_block < n_tiles_all ? t0 + per_block : n_tiles_all;
  if (t0 >= t1) return;
  const int n = (int)(t1 - t0);
  const long long C = (long long)heads * ch, stride = 3 * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const bool is_dq = warp < 4;
  // this warp's MT row tiles from m0 and NJ column tiles from j0
  constexpr int MT = F32 ? 1 : 2, NJ = NT / MT;
  const int rh = (warp >> 1) & 1;  // bf16: the half of a tile's rows
  const int m0 = F32 ? (warp & 3) * 16 : rh * 32, j0 = F32 ? 0 : (warp & 1) * NJ;
  const Pair pr = pair_of<BLK>(blockIdx.y, ch, cb);
  const int pi = pr.i, pj = pr.j, wi = pr.wi, wj = pr.wj;
  const bool blocked = F32 ? BLK : cb < ch;
  // 2 q dnq joins dq_i in the pair (i, 0) alone, 2 k dnk joins dk_j in (0, j)
  const bool add_dn = (is_dq ? pj : pi) == 0;

  zero_pad<R>(ring, STAGES, wi, wj);
  auto load = [&](int i) {
    const long long t = t0 + i, bh = t / tiles_per_bh, b = bh / heads;
    const T* head = qkv + b * hw * stride + (bh - b * heads) * ch;
    const long long p0 = (t - bh * tiles_per_bh) * TP;
    T* dst = ring + (i % STAGES) * TILES;
    if constexpr (F32) {
      stage_rows<VEC, true>(dst, LD, head + pi * cb, stride, p0, hw, TP, wi);
      stage_rows<VEC, true>(dst + TP * LD, LD, head + C + pj * cb, stride, p0, hw, TP, wj);
    } else {
      stage_rows_bf16_v(dst, LDA, head + pi * cb, stride, p0, hw, TP, wi, v);
      stage_rows_bf16_v(dst + TP * LDA, LDA, head + C + pj * cb, stride, p0, hw, TP, wj, v);
    }
  };
  auto stage = [&](long long bh) {
    stage_matrix<R, OPS16>(mh, ml, dgram + bh * ch * ch + (long long)pi * cb * ch + pj * cb, wi, wj,
                    ch);
    for (int c = tid; c < 2 * CHP; c += kThreads) {
      const int which = c / CHP, cc = c - which * CHP;
      dn[c] = cc < (which ? wj : wi) ? (which ? dnk + pj * cb : dnq + pi * cb)[bh * ch + cc]
                                     : 0.f;
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load(i);
    cp_commit();
  }
  long long staged = t0 / tiles_per_bh;  // the (b, h) whose dG is in shared memory
  stage(staged);
  for (int i = 0; i < n; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    if (i + STAGES - 1 < n) load(i + STAGES - 1);
    cp_commit();
    const long long t = t0 + i, bh = t / tiles_per_bh;
    if (bh != staged) {  // a run that crosses into the next (b, h)
      stage(bh);
      staged = bh;
      __syncthreads();
    }
    T* qs = ring + (i % STAGES) * TILES;
    T* ks = qs + TP * LDA;
    // dq = k dG^T + 2 q dnq; dk = q dG + 2 k dnk
    const T* self = is_dq ? qs : ks;
    const float* dnv = dn + (is_dq ? 0 : CHP);
    float acc[MT][NJ][4];
    if (is_dq)
      tile_product<R, NJ, false, OPS16, T, MT>(acc, ks, m0, j0, mh, ml, gid, tig);
    else
      tile_product<R, NJ, true, OPS16, T, MT>(acc, qs, m0, j0, mh, ml, gid, tig);
    const int rl = m0 + gid, s = F32 ? gid & 4 : 0;  // rows rl (+ 16 i), + 8: swizzle bit s
    if (add_dn) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = (j0 + j) * 8 + 2 * tig, sc = c ^ s;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = to_f(self[(rl + 16 * i + (e >> 1) * 8) * LDA + sc + (e & 1)]);
            acc[i][j][e] = fmaf(2.0f * x, dnv[c + (e & 1)], acc[i][j][e]);
          }
        }
    }
    const long long b = bh / heads, p0 = (t - bh * tiles_per_bh) * TP;
    const long long off = b * hw * 2 * C + (is_dq ? 0 : C) + (bh - b * heads) * ch +
                          (is_dq ? pi : pj) * cb;
    const int w = is_dq ? wi : wj;
    if (blocked) {  // the fp32 part of a head cut into channel blocks
#pragma unroll
      for (int i = 0; i < MT; ++i)
        store_rows<NJ, F32 && VEC>(parts + (is_dq ? pj : pi) * slot + off, 2 * C,
                                   p0 + rl + 16 * i, hw, j0, tig, w, acc[i]);
    } else if constexpr (F32) {
      store_rows<NT, VEC>(out + off, 2 * C, p0 + rl, hw, 0, tig, w, acc[0]);
    } else {
      // Rounded to bf16 and staged in place of the rows [m0, m0 + 32) of
      // this warp's tile (q for dq, k for dk), in its own columns, once the
      // four warps that read those rows have read them; the pad columns
      // [w, CHP) keep their zeros. Then, the columns of both halves staged,
      // the warp's 16 rows from m0 + 16 (w % 2) leave in stores of v bf16.
      rows_sync(rh);
      T* st = (is_dq ? qs : ks) + m0 * LDA;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = (j0 + j) * 8 + 2 * tig;
          if (c >= w) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            T* o = st + (16 * i + gid + 8 * half) * LDA + c;
            if (c + 1 < w)
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __floats2bfloat162_rn(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
            else
              *o = __float2bfloat16_rn(acc[i][j][2 * half]);
          }
        }
      rows_sync(rh);
      const int r16 = 16 * (warp & 1);
      store_staged_v(out + off, 2 * C, st + r16 * LDA, LDA, p0 + m0 + r16, hw, 16, w, lane,
                     32, v);
    }
  }
}

// Row 7. Block (s, bh, i * nb + j) owns pixels [s * per, (s + 1) * per) of
// (b, h) and reads each 64-pixel tile of g_i and v_j once: warp w writes
// dv_j's part from block i, g_i attn_ij, at rows 16 (w % 4) of the tile and
// column tiles [R (w / 4), R (w / 4 + 1)) (on bf16 at even R rows 32 (w % 2)
// and column tiles [R / 2 (w / 2), R / 2 (w / 2 + 1))) (to dv + i * slot); the warps'
// dattn_ij = g_i^T v_j partials stay in registers (GramCfg's layout, the
// pixel steps split over WK warp groups) and are written with plain stores
// to out + (bh * splits + s) * ch * ch at row i cb and column j cb: dattn
// itself when splits == 1, else the workspace that gram_reduce_kernel sums.
// OPS16: the bf16-operand policy in both products. T: the element type of
// qkv, g and dv (float, or bf16 with bf16 tiles, copies of v bf16 and the
// staged epilogue; a head cut into channel blocks writes fp32 parts to
// `parts`, dattn stays fp32); VEC is the fp32 kernels' copy width. The bf16
// kernel is compiled once for both kinds of head (BLK true, the kind read
// from cb < ch).
template <typename T, int R, bool VEC, bool BLK, bool OPS16>
__global__ void __launch_bounds__(kThreads, kApplyBwdMinBlocks<T, R>)
apply_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ attn,
                 const T* __restrict__ g, T* __restrict__ dv, float* __restrict__ parts,
                 long long slot, float* __restrict__ dattn_out, long long hw, int heads, int ch,
                 int cb, int splits, long long per, int v) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using Cfg = BwdCfg<R>;
  using Bf = ApplyBwdBfCfg<R>;
  using G = GramCfg<R>;
  constexpr int LD = Cfg::LD, TP = kBwdTP, CHP = Cfg::CHP, LDB = Bf::LDB;
  constexpr int STAGES = F32 ? Cfg::STAGES : Bf::STAGES;
  constexpr int TILES = F32 ? Cfg::TILES : Bf::TILES;  // elements a stage
  constexpr int MW = G::MW, NW = G::NW, KS = TP / (8 * G::WK);
  // attn after the ring (fp32: or the partials, if larger) or the front
  constexpr int MH = F32 ? (Cfg::RING > Cfg::RED ? Cfg::RING : Cfg::RED) : Bf::FRONT / 4;
  extern __shared__ __align__(16) float smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* mh = smem + MH;  // attn(c, d) at swz(c, d)
  float* ml = mh + Cfg::MAT;
  const int s = blockIdx.x, bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const Pair pr = pair_of<BLK>(blockIdx.z, ch, cb);
  const int pi = pr.i, pj = pr.j, wi = pr.wi, wj = pr.wj;
  const bool blocked = F32 ? BLK : cb < ch;
  const long long C = (long long)heads * ch;
  const long long begin = s * per;
  const long long end = begin + per < hw ? begin + per : hw;
  const T* g_rows = g + (long long)b * hw * C + (long long)h * ch + pi * cb;
  const T* v_rows = qkv + (long long)b * hw * 3 * C + 2 * C + (long long)h * ch + pj * cb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // this warp's dv rows and columns: DMT row tiles from m0, DNJ column tiles
  // from j0 (on bf16 at even R two row tiles and a quarter of the columns,
  // so that each attn fragment read from shared memory serves both)
  constexpr int DMT = !F32 && R % 2 == 0 ? 2 : 1, DNJ = R / DMT;
  // on bf16 up to R = 3 a warp holds its attn fragments in registers for the
  // whole block (its one (b, h)), read once, and dv reads only g's
  constexpr bool HOLD = Bf::HOLD && !F32;
  constexpr int KST = HOLD ? CHP / 8 : 1;
  uint32_t mfh[KST][DNJ][2], mfl[KST][DNJ][2];
  const int m0 = DMT == 2 ? (warp & 1) * 32 : (warp & 3) * 16;
  const int j0 = DMT == 2 ? (warp >> 1) * DNJ : (warp >> 2) * R;
  const int wk = warp % G::WK, wt = warp / G::WK;  // and its dattn tiles
  const int wm = wt / G::WTN, wn = wt % G::WTN;
  bool use_m[MW], use_n[NW];
#pragma unroll
  for (int i = 0; i < MW; ++i) use_m[i] = G::MT % G::WTM == 0 || wm * MW + i < G::MT;
#pragma unroll
  for (int j = 0; j < NW; ++j) use_n[j] = G::NT % G::WTN == 0 || wn * NW + j < G::NT;

  zero_pad<R>(ring, STAGES, wi, wj);
  const int n_tiles = (int)((end - begin + TP - 1) / TP);
  auto load = [&](int t) {
    T* dst = ring + (t % STAGES) * TILES;
    const long long p0 = begin + (long long)t * TP;
    if constexpr (F32) {
      stage_rows<VEC, true>(dst, LD, g_rows, C, p0, end, TP, wi);
      stage_rows<VEC, true>(dst + TP * LD, LD, v_rows, 3 * C, p0, end, TP, wj);
    } else {
      stage_rows_bf16_v(dst, LDB, g_rows, C, p0, end, TP, wi, v);
      stage_rows_bf16_v(dst + TP * LDB, LDB, v_rows, 3 * C, p0, end, TP, wj, v);
    }
  };
  float part[MW][NW][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_commit();
  }
  stage_matrix<R, OPS16>(mh, ml, attn + (long long)bh * ch * ch + (long long)pi * cb * ch + pj * cb,
                  wi, wj, ch);
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile t has landed (and attn, at t = 0); tile t - 1 is done with
    if (t + STAGES - 1 < n_tiles) load(t + STAGES - 1);
    cp_commit();
    const T* gs = ring + (t % STAGES) * TILES;
    const T* vs = gs + TP * (F32 ? LD : LDB);
    if constexpr (HOLD) {
      if (t == 0) {  // attn has landed
#pragma unroll
        for (int k = 0; k < KST; ++k)
          matrix_frags<R, DNJ, true, OPS16>(mfh[k], mfl[k], 8 * k, j0, mh, ml, gid, tig);
      }
    }
    {  // dv = g attn: rows m0 .. m0 + 16 DMT - 1, column tiles j0 .. j0 + DNJ - 1
      float acc[DMT][DNJ][4];
      if constexpr (HOLD)
        tile_product_by<R, DNJ, OPS16, T, DMT>(acc, gs, m0, gid, tig,
                                               [&](int k0, auto& bh, auto& bl) {
#pragma unroll
          for (int j = 0; j < DNJ; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              bh[j][r] = mfh[k0 / 8][j][r];
              bl[j][r] = mfl[k0 / 8][j][r];
            }
        });
      else
        tile_product<R, DNJ, true, OPS16, T, DMT>(acc, gs, m0, j0, mh, ml, gid, tig);
      const long long off = (long long)b * hw * C + (long long)h * ch + pj * cb;
      const long long p0 = begin + (long long)t * TP;
      if constexpr (F32) {
        store_rows<R, VEC>(dv + pi * slot + off, C, p0 + m0 + gid, end, j0, tig, wj, acc[0]);
      } else if (blocked) {  // the fp32 part of a head cut into channel blocks
#pragma unroll
        for (int i = 0; i < DMT; ++i)
          store_rows<DNJ, false>(parts + pi * slot + off, C, p0 + m0 + 16 * i + gid, end, j0,
                                 tig, wj, acc[i]);
      } else {
        // Rounded to bf16 and staged in this warp's own rows and columns of
        // the staging tile, then stored by the warp, v bf16 a lane along a
        // row; the tile's next use is past the next tile's __syncthreads.
        T* st = ring + STAGES * TILES + m0 * LDB;
#pragma unroll
        for (int i = 0; i < DMT; ++i)
#pragma unroll
          for (int j = 0; j < DNJ; ++j) {
            const int c = (j0 + j) * 8 + 2 * tig;
            if (c >= wj) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              T* o = st + (16 * i + gid + 8 * half) * LDB + c;
              if (c + 1 < wj)
                *reinterpret_cast<__nv_bfloat162*>(o) =
                    __floats2bfloat162_rn(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
              else
                *o = __float2bfloat16_rn(acc[i][j][2 * half]);
            }
          }
        __syncwarp();
        const int jc = 8 * j0, wc = wj - jc < 8 * DNJ ? wj - jc : 8 * DNJ;
        if (wc > 0)
          store_staged_v(dv + off + jc, C, st + jc, LDB, p0 + m0, end, 16 * DMT, wc, lane, 32,
                         v);
      }
    }
    // dattn += g^T v over this warp group's pixel steps: A(c, p) = g(p, c),
    // B(p, d) = v(p, d); lane rows p = step + tig (swizzle bit 0) and p + 4
    // (bit 1; the bf16 tiles are not swizzled). On bf16 the fragment's rows
    // gid and gid + 8 hold channels 2 gid and 2 gid + 1 of the row tile, one
    // 4-byte read, and dattn's rows are stored so (an mma row's sums do not
    // depend on its place)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int p = (wk * KS + kk) * 8 + tig;
      if constexpr (!F32) {  // both operands exact in tf32: one term, as 3xTF32's sums
        uint32_t ar[MW][4], br[NW][2];
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          const int c = (wm * MW + i) * 16 + 2 * gid;
          if (!use_m[i]) continue;
          const uint32_t x0 = *reinterpret_cast<const uint32_t*>(gs + p * LDB + c);
          const uint32_t x4 = *reinterpret_cast<const uint32_t*>(gs + (p + 4) * LDB + c);
          ar[i][0] = x0 << 16;
          ar[i][1] = x0 & 0xffff0000u;
          ar[i][2] = x4 << 16;
          ar[i][3] = x4 & 0xffff0000u;
        }
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int d = (wn * NW + j) * 8 + gid;
          if (!use_n[j]) continue;
          br[j][0] = widen_tf32(vs[p * LDB + d]);
          br[j][1] = widen_tf32(vs[(p + 4) * LDB + d]);
        }
        mma_1xtf32(part, ar, br, use_m, use_n);
      } else {
        const float* g0 = gs + p * LD;
        const float* g4 = g0 + 4 * LD;
        if constexpr (OPS16) {
          uint32_t ar[MW][4], br[NW][2];
#pragma unroll
          for (int i = 0; i < MW; ++i) {
            const int c = (wm * MW + i) * 16 + gid;
            if (!use_m[i]) continue;
            ar[i][0] = bf16_tf32(g0[c]);
            ar[i][1] = bf16_tf32(g0[c + 8]);
            ar[i][2] = bf16_tf32(g4[c ^ 4]);
            ar[i][3] = bf16_tf32(g4[(c + 8) ^ 4]);
          }
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            const int d = (wn * NW + j) * 8 + gid;
            if (!use_n[j]) continue;
            br[j][0] = bf16_tf32(vs[p * LD + d]);
            br[j][1] = bf16_tf32(vs[(p + 4) * LD + (d ^ 4)]);
          }
          mma_1xtf32(part, ar, br, use_m, use_n);
        } else {
          uint32_t ah[MW][4], al[MW][4], bh_[NW][2], bl[NW][2];
#pragma unroll
          for (int i = 0; i < MW; ++i) {
            const int c = (wm * MW + i) * 16 + gid;
            if (!use_m[i]) continue;
            const float x[4] = {g0[c], g0[c + 8], g4[c ^ 4], g4[(c + 8) ^ 4]};
#pragma unroll
            for (int r = 0; r < 4; ++r) split_tf32(x[r], ah[i][r], al[i][r]);
          }
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            const int d = (wn * NW + j) * 8 + gid;
            if (!use_n[j]) continue;
            const float y[2] = {vs[p * LD + d], vs[(p + 4) * LD + (d ^ 4)]};
#pragma unroll
            for (int r = 0; r < 2; ++r) split_tf32(y[r], bh_[j][r], bl[j][r]);
          }
          mma_3xtf32(part, ah, al, bh_, bl, use_m, use_n);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the warp groups' partials now

  constexpr int RP = CHP + 1, E = CHP * RP;
  float* red = smem + wk * E;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    if (!use_m[i]) continue;
    // the channels of the fragment's rows gid and gid + 8
    const int c = (wm * MW + i) * 16 + (F32 ? gid : 2 * gid), c8 = F32 ? c + 8 : c + 1;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (!use_n[j]) continue;
      const int d = (wn * NW + j) * 8 + 2 * tig;
      red[c * RP + d] = part[i][j][0];
      red[c * RP + d + 1] = part[i][j][1];
      red[c8 * RP + d] = part[i][j][2];
      red[c8 * RP + d + 1] = part[i][j][3];
    }
  }
  __syncthreads();
  // the WK partials in a fixed order, written once: warp w rows w, w + 8, ...
  float* out = dattn_out + ((long long)bh * splits + s) * ch * ch + (long long)pi * cb * ch + pj * cb;
  for (int c = warp; c < wi; c += kThreads / 32)
    for (int d = lane; d < wj; d += 32) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < G::WK; ++w) sum += smem[w * E + c * RP + d];
      out[c * ch + d] = sum;
    }
}

// `blocks` blocks of `per_block` 64-pixel tiles for each channel-block pair
// (ops/gram.py gram_bwd_plan); with nb > 1 blocks the parts of d[q|k] go to
// nb slots of ws and a second launch sums them
template <int R, bool OPS16>
cudaError_t gram_bwd(const float* qkv, const float* dgram, const float* dnq, const float* dnk,
                     float* dqdk, float* ws, int B, long long hw, int heads, int ch, int cb,
                     int blocks, long long per_block, cudaStream_t st) {
  using Cfg = BwdCfg<R>;
  static bool done[2][kMaxDevices];
  const Variants<decltype(&gram_bwd_kernel<float, R, true, false, OPS16>)> ks{
      {{gram_bwd_kernel<float, R, false, false, OPS16>,
        gram_bwd_kernel<float, R, false, kBlocked<R>, OPS16>},
       {gram_bwd_kernel<float, R, true, false, OPS16>,
        gram_bwd_kernel<float, R, true, kBlocked<R>, OPS16>}}};
  const cudaError_t attr = ks.allow(done, Cfg::GRAM_FLOATS);
  if (attr != cudaSuccess) return attr;
  const int nb = n_blocks(ch, cb);
  float* dst = nb > 1 ? ws : dqdk;
  const long long slot = (long long)B * hw * 2 * heads * ch;
  const bool vec = ch % 4 == 0 && aligned16(qkv) && aligned16(dst);
  const long long tiles_per_bh = (hw + kBwdTP - 1) / kBwdTP;
  const long long n_tiles = tiles_per_bh * B * heads;
  ks.k[vec][nb > 1]<<<dim3((unsigned)blocks, (unsigned)(nb * nb)), kThreads,
                      sizeof(float) * Cfg::GRAM_FLOATS, st>>>(
      qkv, dgram, dnq, dnk, dqdk, ws, slot, hw, heads, ch, cb, tiles_per_bh, n_tiles, per_block,
      0);
  if (nb > 1) return sum_slots(ws, dqdk, slot, nb, st);
  return cudaGetLastError();
}

// The same on a bf16 qkv into a bf16 d[q|k], in one launch where the head
// is one channel block (ops/gram.py gram_bwd_bf16_plan; copies of v bf16,
// bf16_copy_width); with nb > 1 blocks the fp32 parts go to nb slots of ws
// and tc.cuh's sum_slots adds them in order and rounds once.
template <int R, bool OPS16>
cudaError_t gram_bwd_bf16(const bf16* qkv, const float* dgram, const float* dnq,
                          const float* dnk, bf16* dqdk, float* ws, int B, long long hw,
                          int heads, int ch, int cb, int blocks, long long per_block, int v,
                          cudaStream_t st) {
  using Bf = BwdBfCfg<R>;
  static bool done[kMaxDevices];
  const auto kernel = gram_bwd_kernel<bf16, R, true, true, OPS16>;
  const cudaError_t attr = allow_smem(done, kernel, kernel, Bf::BYTES / 4);
  if (attr != cudaSuccess) return attr;
  const int nb = n_blocks(ch, cb);
  const long long slot = (long long)B * hw * 2 * heads * ch;
  const long long tiles_per_bh = (hw + kBwdTP - 1) / kBwdTP;
  const long long n_tiles = tiles_per_bh * B * heads;
  kernel<<<dim3((unsigned)blocks, (unsigned)(nb * nb)), kThreads, Bf::BYTES, st>>>(
      qkv, dgram, dnq, dnk, dqdk, ws, slot, hw, heads, ch, cb, tiles_per_bh, n_tiles, per_block,
      v);
  if (nb > 1) return sum_slots(ws, dqdk, slot, nb, st);
  return cudaGetLastError();
}

// Blocks an SM holds of the kernel gram_bwd_bf16 launches at width R, as
// the card's occupancy calculator reads it, and its BwdBfCfg's BYTES and
// MIN_BLOCKS.
template <int R, bool OPS16>
cudaError_t gram_bwd_bf16_blocks_per_sm(int* blocks, int* bytes, int* min_blocks) {
  using Bf = BwdBfCfg<R>;
  static bool done[kMaxDevices];
  const auto kernel = gram_bwd_kernel<bf16, R, true, true, OPS16>;
  *bytes = Bf::BYTES;
  *min_blocks = Bf::MIN_BLOCKS;
  const cudaError_t attr = allow_smem(done, kernel, kernel, Bf::BYTES / 4);
  if (attr != cudaSuccess) return attr;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, Bf::BYTES);
}

// The bf16 Gram backward's C entry points of the operand policy a source
// sets in kGbbOps16 (gram_bwd_bf16.cu, gram_bwd_bf16_b16ops.cu): NAME(qkv,
// dgram, dnq, dnk, dqdk, ws, B, hw, heads, ch, cb, blocks, per_block, vec,
// stream) and NAME_blocks_per_sm(ch, cb, blocks, bytes, min_blocks).
#define RCOT_GRAM_BWD_BF16_ENTRIES(NAME)                                                 \
  int NAME(const bf16* qkv, const float* dgram, const float* dnq, const float* dnk, bf16* dqdk, \
           float* ws, int B, long long hw, int heads, int ch, int cb, int blocks,               \
           long long per_block, int vec, void* stream) {                                       \
    cudaStream_t st = (cudaStream_t)stream;                                                     \
    if (!(vec == 8 || vec == 2 || vec == 1) || ch % vec != 0 || cb % vec != 0)                  \
      return cudaErrorInvalidValue;                                                             \
    RCOT_BY_WIDTH(ch, cb, RCOT_GBB_CALL)                                                        \
  }                                                                                             \
  int NAME##_blocks_per_sm(int ch, int cb, int* blocks, int* bytes, int* min_blocks) {         \
    RCOT_BY_WIDTH(ch, cb, RCOT_GBB_OCC)                                                         \
  }
#define RCOT_GBB_CALL(R)                                                                     \
  gram_bwd_bf16<R, kGbbOps16>(qkv, dgram, dnq, dnk, dqdk, ws, B, hw, heads, ch, cb, blocks, \
                              per_block, vec, st)
#define RCOT_GBB_OCC(R) gram_bwd_bf16_blocks_per_sm<R, kGbbOps16>(blocks, bytes, min_blocks)

// `splits` ranges of `per` pixels per (b, h) (ops/gram.py gram_plan) for
// each channel-block pair; with splits > 1 the dattn partials go to ws and
// a second launch sums them, with nb > 1 blocks the parts of dv go to nb
// slots of ws after them and another launch sums those
template <int R, bool OPS16>
cudaError_t apply_bwd(const float* qkv, const float* attn, const float* g, float* dv,
                      float* dattn, float* ws, int B, long long hw, int heads, int ch, int cb,
                      int splits, long long per, cudaStream_t st) {
  using Cfg = BwdCfg<R>;
  static bool done[2][kMaxDevices];
  const Variants<decltype(&apply_bwd_kernel<float, R, true, false, OPS16>)> ks{
      {{apply_bwd_kernel<float, R, false, false, OPS16>,
        apply_bwd_kernel<float, R, false, kBlocked<R>, OPS16>},
       {apply_bwd_kernel<float, R, true, false, OPS16>,
        apply_bwd_kernel<float, R, true, kBlocked<R>, OPS16>}}};
  const cudaError_t attr = ks.allow(done, Cfg::APPLY_FLOATS);
  if (attr != cudaSuccess) return attr;
  const int nb = n_blocks(ch, cb);
  float* ws_dv = ws + (splits > 1 ? (long long)splits * B * heads * ch * ch : 0);
  float* dv_dst = nb > 1 ? ws_dv : dv;
  const long long slot = (long long)B * hw * heads * ch;
  const bool vec = ch % 4 == 0 && aligned16(qkv) && aligned16(g) && aligned16(dv_dst);
  ks.k[vec][nb > 1]<<<dim3((unsigned)splits, (unsigned)(B * heads), (unsigned)(nb * nb)),
                      kThreads, sizeof(float) * Cfg::APPLY_FLOATS, st>>>(
      qkv, attn, g, dv_dst, dv_dst, slot, splits > 1 ? ws : dattn, hw, heads, ch, cb, splits,
      per, 0);
  if (splits > 1) {
    const cudaError_t err =
        launch_reduce(ws, dattn, nullptr, nullptr, B, heads, ch, ch * ch, splits, st);
    if (err != cudaSuccess) return err;
  }
  if (nb > 1) return sum_slots(ws_dv, dv, slot, nb, st);
  return cudaGetLastError();
}

// The same on a bf16 qkv and g into a bf16 dv (attn and dattn fp32), on
// bf16 tiles: one launch where splits == 1 and the head is one channel
// block (copies of v bf16, bf16_copy_width); with splits > 1 the dattn
// partials go to ws and gram.cuh's reduce sums them, with nb > 1 blocks the
// fp32 parts of dv go to nb slots of ws after them and tc.cuh's sum_slots
// adds them in order and rounds once.
template <int R, bool OPS16>
cudaError_t apply_bwd_bf16(const bf16* qkv, const float* attn, const bf16* g, bf16* dv,
                           float* dattn, float* ws, int B, long long hw, int heads, int ch,
                           int cb, int splits, long long per, int v, cudaStream_t st) {
  using Bf = ApplyBwdBfCfg<R>;
  static bool done[kMaxDevices];
  const auto kernel = apply_bwd_kernel<bf16, R, true, true, OPS16>;
  const cudaError_t attr = allow_smem(done, kernel, kernel, Bf::BYTES / 4);
  if (attr != cudaSuccess) return attr;
  const int nb = n_blocks(ch, cb);
  float* ws_dv = ws + (splits > 1 ? (long long)splits * B * heads * ch * ch : 0);
  const long long slot = (long long)B * hw * heads * ch;
  kernel<<<dim3((unsigned)splits, (unsigned)(B * heads), (unsigned)(nb * nb)), kThreads,
           Bf::BYTES, st>>>(qkv, attn, g, dv, ws_dv, slot, splits > 1 ? ws : dattn, hw, heads,
                            ch, cb, splits, per, v);
  if (splits > 1) {
    const cudaError_t err =
        launch_reduce(ws, dattn, nullptr, nullptr, B, heads, ch, ch * ch, splits, st);
    if (err != cudaSuccess) return err;
  }
  if (nb > 1) return sum_slots(ws_dv, dv, slot, nb, st);
  return cudaGetLastError();
}

// Blocks an SM holds of the kernel apply_bwd_bf16 launches at width R, as
// the card's occupancy calculator reads it, and its ApplyBwdBfCfg's BYTES
// and MIN_BLOCKS.
template <int R, bool OPS16>
cudaError_t apply_bwd_bf16_blocks_per_sm(int* blocks, int* bytes, int* min_blocks) {
  using Bf = ApplyBwdBfCfg<R>;
  static bool done[kMaxDevices];
  const auto kernel = apply_bwd_kernel<bf16, R, true, true, OPS16>;
  *bytes = Bf::BYTES;
  *min_blocks = Bf::MIN_BLOCKS;
  const cudaError_t attr = allow_smem(done, kernel, kernel, Bf::BYTES / 4);
  if (attr != cudaSuccess) return attr;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, Bf::BYTES);
}

// The bf16 apply backward's C entry points of the operand policy a source
// sets in kAbbOps16 (apply_bwd_bf16.cu, apply_bwd_bf16_b16ops.cu): NAME(qkv,
// attn, g, dv, dattn, ws, B, hw, heads, ch, cb, splits, per, vec, stream)
// and NAME_blocks_per_sm(ch, cb, blocks, bytes, min_blocks).
#define RCOT_APPLY_BWD_BF16_ENTRIES(NAME)                                                  \
  int NAME(const bf16* qkv, const float* attn, const bf16* g, bf16* dv, float* dattn,       \
           float* ws, int B, long long hw, int heads, int ch, int cb, int splits,           \
           long long per, int vec, void* stream) {                                          \
    cudaStream_t st = (cudaStream_t)stream;                                                 \
    if (!(vec == 8 || vec == 2 || vec == 1) || ch % vec != 0 || cb % vec != 0)              \
      return cudaErrorInvalidValue;                                                         \
    RCOT_BY_WIDTH(ch, cb, RCOT_ABB_CALL)                                                    \
  }                                                                                         \
  int NAME##_blocks_per_sm(int ch, int cb, int* blocks, int* bytes, int* min_blocks) {     \
    RCOT_BY_WIDTH(ch, cb, RCOT_ABB_OCC)                                                     \
  }
#define RCOT_ABB_CALL(R)                                                                  \
  apply_bwd_bf16<R, kAbbOps16>(qkv, attn, g, dv, dattn, ws, B, hw, heads, ch, cb, splits, \
                               per, vec, st)
#define RCOT_ABB_OCC(R) apply_bwd_bf16_blocks_per_sm<R, kAbbOps16>(blocks, bytes, min_blocks)

}  // namespace
