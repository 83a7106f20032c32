// MDTA attention core kernels for Hopper (sm_90a), forward and backward.
//
// Replace the TPU kernels of rcot_tpu/ops/pallas_gram.py:
//
//   mdta_gram (mdta_gram_fwd, pallas_gram.py:99, pallas_call at :106):
//       per (b, head h):  G = q^T k,  nq = sum q^2,  nk = sum k^2
//       summed over every pixel of the packed NHWC qkv = [q | k | v];
//   attn_apply (attn_apply_fwd, pallas_gram.py:178, pallas_call at :185):
//       out[pixel, h*ch + c] = sum_d v[pixel, h*ch + d] * attn[b, h, c, d];
//   mdta_gram_bwd (pallas_gram.py:141, pallas_call at :149, body :120-138):
//       dq = k dG^T + 2 q dnq,   dk = q dG + 2 k dnk,  written as d[q|k];
//   attn_apply_bwd (pallas_gram.py:219, pallas_call at :227, body :195-216):
//       dv = g attn,   dattn = sum over pixels of g^T v.
//
// Head h occupies channels [h*ch, (h+1)*ch) of each third of qkv and of g.
//
// Bounds on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores, 495
// TF32 on the tensor cores). Per pixel, in floats moved and flops: the Gram
// reads 2C and does 2*C*ch + 4*C; the apply moves 2C and does 2*C*ch; the
// Gram backward reads 2C (q, k), writes 2C (dq, dk) and does 4*C*ch + 4*C;
// the apply backward reads 2C (g, v), writes C (dv) and does 4*C*ch. On the
// tensor cores, even as 3xTF32 (three products each), every one of them is
// bound by its bytes at the main path's widths (ch = 24, 48, 96).
//
// Design, all four kernels. Each streams its inputs once through a cp.async
// ring (16-byte copies where ch % 4 == 0 and the rows are 16-byte aligned,
// 4-byte copies otherwise) and does its products on the tensor cores as
// 3xTF32 (mma.sync m16n8k8: a b ~ ah bh + ah bl + al bh with x = xh + xl
// split into two tf32 values), accumulating in fp32 registers, with ch
// zero-padded to 16R in shared memory. The hot loops have no branch
// (padding adds zeros) and issue each of the three terms over all of a
// warp's tiles before the next, so no product waits on another. Sums over
// pixels are written with plain stores and added in a fixed order: no
// memset, no atomics, the same bits on every call. Every launch plan
// (blocks, and the pixels or tiles each takes) is made in Python
// (ops/gram.py) from the SM count it reads once; each kernel's
// shared-memory limit is raised once per device.
//   - gram_fwd_kernel (row 3): the pixels of each (b, head) are split into
//     ranges (ops/gram.py gram_plan), one block each, so that the blocks
//     fill the card about once. A block's eight warps split the G tiles and
//     the pixels of each stage; the sums of squares come from the same
//     fragments. The warps' partials are added in shared memory in a fixed
//     order and written into G, nq, nk when a (b, head) is one range, else
//     into a workspace that gram_reduce_kernel sums over the ranges.
//   - apply_fwd_kernel (row 4): a grid of one or two blocks an SM walks
//     contiguous runs of 128-pixel tiles (apply_plan); attn[b, h], whose
//     row-major layout is the column-major B operand of out = v attn^T, is
//     staged once per (b, h) a block meets, already split into its tf32
//     parts. Each warp owns 16 rows of a tile and all its columns (each v
//     value is split once) and stores straight from its accumulators.
//   - gram_bwd_kernel (row 6), one launch: runs of 64-pixel tiles as the
//     apply's (gram_bwd_plan); each tile of q and of k is read once, and dq
//     and dk are written from the accumulators with the 2 x dn terms added
//     in fp32 from the staged tiles. Warps 0-3 own 16 rows of dq each,
//     warps 4-7 16 rows of dk, so every q and k value is split once (as
//     the A operand of the product it feeds). dq needs dG in one
//     orientation and dk in the other; no pitch serves both fragment
//     patterns without bank conflicts, so dG (and every tile of the
//     backward kernels) is stored swizzled: element (r, c) at
//     r * (16R + 8) + (c ^ (r & 4)), which both patterns read from 32
//     banks. dG is staged once per (b, h), split into its tf32 parts up to
//     ch = 112 (at 128 two split copies do not fit beside the ring).
//   - apply_bwd_kernel (row 7), one pass: a block owns one of gram_plan's
//     pixel ranges of a (b, head) and reads each 64-pixel tile of g and v
//     once. dv = g attn leaves from the accumulators (four warps over the
//     rows by two over the columns); the dattn = g^T v partial stays in
//     registers over the whole range (the Gram's warp layout), is added
//     over the warps in shared memory in a fixed order and written into
//     dattn, or into a workspace that gram_reduce_kernel sums in order.
//
// Heads of any width. A kernel is templated on a channel block of at most
// 128 channels (R <= 8). A wider head is cut into nb blocks of cb channels
// (the last one narrower; ops/gram.py channel_blocks), and every kernel
// runs over a grid of block pairs (i, j), one more grid dimension, each
// pair a head of today's kernels whose q-side operand is block i (wi
// channels) and whose k-side operand is block j (wj): G_ij = q_i^T k_j,
// out_i += v_j attn_ij^T, dq_i += k_j dG_ij^T, dk_j += q_i dG_ij,
// dv_j += g_i attn_ij, dattn_ij = g_i^T v_j. A pair reads its channels at
// offsets into the head and writes its block of a ch x ch matrix at pitch
// ch, so the Gram's and dattn's partials and their reduce are those of one
// head; nq comes from the pairs (i, 0), nk from (0, j). A sum over blocks
// (the apply's, and dq, dk and dv) goes to nb slots of a workspace, one
// per block of the summed index, that tc.cuh's sum_slots adds in order;
// 2 q dnq is added in the pairs (i, 0) alone, 2 k dnk in (0, j). A head of
// ch <= 128 is one pair (nb = 1, cb = ch) and runs each kernel's BLK =
// false variant, which compiles to a single block's arithmetic: the
// launches, the bits and the time of a head without blocks.
//
// The kernels that several sources share live in headers: stage_rows,
// GramCfg and the variants' table in gram.cuh, the two backward kernels in
// gram_bwd.cuh, templated on the operand policy of their products. This
// source compiles the forward kernels; gram_bwd.cu (row 6) and apply_bwd.cu
// (row 7) the backward's 3xTF32 form, gram_bwd_b16ops.cu and
// apply_bwd_b16ops.cu its bf16-operand form (RCOT_BWD_BF16's "gram" tier):
// five sources, so that nvcc builds them in parallel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gram.cuh"
#include "tc.cuh"

namespace {


// ------------------------------------------------- the forward kernels

constexpr int kApplyStages = 3;
constexpr int kApplyTP = 128;    // pixels per apply tile: eight warps of 16 rows

// Block (s, bh, i * nb + j) sums G_ij = q_i^T k_j, nq = sum q_i^2 and
// nk = sum k_j^2 over pixels [s * per, (s + 1) * per) of (b, h) and writes
// them with plain stores to g_out + (bh * splits + s) * g_stride, G_ij at
// row i cb and column j cb of a ch x ch matrix (nq, nk likewise with
// n_stride, from the pairs (i, 0) and (0, j)): the outputs themselves when
// splits == 1, else the workspace that gram_reduce_kernel sums.
template <int R, bool VEC, bool BLK>
__global__ void __launch_bounds__(kThreads)
gram_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ g_out,
                float* __restrict__ nq_out, float* __restrict__ nk_out,
                long long g_stride, long long n_stride, long long hw, int heads,
                int ch, int cb, int splits, long long per) {
  using Cfg = GramCfg<R>;
  constexpr int LD = Cfg::LD, TP = Cfg::TP, CHP = Cfg::CHP, MW = Cfg::MW, NW = Cfg::NW;
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x, bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const Pair pr = pair_of<BLK>(blockIdx.z, ch, cb);
  const int pi = pr.i, pj = pr.j, wi = pr.wi, wj = pr.wj;
  const long long C = (long long)heads * ch, stride = 3 * C;
  const long long begin = s * per;
  const long long end = begin + per < hw ? begin + per : hw;
  const float* head = qkv + (long long)b * hw * stride + (long long)h * ch;
  const float* q_rows = head + pi * cb;
  const float* k_rows = head + C + pj * cb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wk = warp % Cfg::WK, wt = warp / Cfg::WK;
  const int wm = wt / Cfg::WTN, wn = wt % Cfg::WTN;
  // warps whose share runs past the padded G (odd R) skip those tiles; the
  // hot loop has no other branch (tiles past ch add zeros)
  bool use_m[MW], use_n[NW];
#pragma unroll
  for (int i = 0; i < MW; ++i) use_m[i] = Cfg::MT % Cfg::WTM == 0 || wm * MW + i < Cfg::MT;
#pragma unroll
  for (int j = 0; j < NW; ++j) use_n[j] = Cfg::NT % Cfg::WTN == 0 || wn * NW + j < Cfg::NT;

  // the copies never write columns [wi, LD) of a q row or [wj, LD) of a k
  // row: zero them once
  const int wmin = wi < wj ? wi : wj, pad = LD - wmin;
  for (int i = tid; i < kGramStages * 2 * TP * pad; i += kThreads) {
    const int r = i / pad, c = wmin + (i - r * pad);
    if (c >= ((r / TP) & 1 ? wj : wi)) smem[r * LD + c] = 0.f;
  }
  const int n_tiles = (int)((end - begin + TP - 1) / TP);
  auto load = [&](int t) {
    float* dst = smem + (t % kGramStages) * Cfg::STAGE;
    const long long p0 = begin + (long long)t * TP;
    stage_rows<VEC>(dst, LD, q_rows, stride, p0, end, TP, wi);
    stage_rows<VEC>(dst + TP * LD, LD, k_rows, stride, p0, end, TP, wj);
  };

  float acc[MW][NW][4];
  float sq_q[MW][2], sq_k[NW];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    sq_q[i][0] = sq_q[i][1] = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) sq_k[j] = 0.f;

#pragma unroll
  for (int t = 0; t < kGramStages - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<kGramStages - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + kGramStages - 1 < n_tiles) load(t + kGramStages - 1);
    cp_commit();
    const float* qs = smem + (t % kGramStages) * Cfg::STAGE;
    const float* ks = qs + TP * LD;
#pragma unroll
    for (int kk = 0; kk < Cfg::KS; ++kk) {
      const int p = (wk * Cfg::KS + kk) * 8 + tig;  // this lane's pixels: p, p + 4
      uint32_t ah[MW][4], al[MW][4], bh_[NW][2], bl[NW][2];
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        const int c = (wm * MW + i) * 16 + gid;
        if (!use_m[i]) continue;
        const float x[4] = {qs[p * LD + c], qs[p * LD + c + 8], qs[(p + 4) * LD + c],
                            qs[(p + 4) * LD + c + 8]};
        sq_q[i][0] = fmaf(x[2], x[2], fmaf(x[0], x[0], sq_q[i][0]));
        sq_q[i][1] = fmaf(x[3], x[3], fmaf(x[1], x[1], sq_q[i][1]));
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(x[r], ah[i][r], al[i][r]);
      }
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int d = (wn * NW + j) * 8 + gid;
        if (!use_n[j]) continue;
        const float y[2] = {ks[p * LD + d], ks[(p + 4) * LD + d]};
        sq_k[j] = fmaf(y[1], y[1], fmaf(y[0], y[0], sq_k[j]));
#pragma unroll
        for (int r = 0; r < 2; ++r) split_tf32(y[r], bh_[j][r], bl[j][r]);
      }
      mma_3xtf32(acc, ah, al, bh_, bl, use_m, use_n);
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the warp groups' partials now

  constexpr int RP = Cfg::RP, SQ = CHP * RP;  // partial: [G (CHP rows of RP) | nq | nk]
  float* red = smem + wk * Cfg::E;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    if (!use_m[i]) continue;
    const int c = (wm * MW + i) * 16 + gid;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (!use_n[j]) continue;
      const int d = (wn * NW + j) * 8 + 2 * tig;
      red[c * RP + d] = acc[i][j][0];
      red[c * RP + d + 1] = acc[i][j][1];
      red[(c + 8) * RP + d] = acc[i][j][2];
      red[(c + 8) * RP + d + 1] = acc[i][j][3];
    }
    // each channel's squares sit in the four lanes of its group
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = sq_q[i][r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (wn == 0 && tig == 0) red[SQ + c + 8 * r] = v;
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
  const long long unit = (long long)bh * splits + s;
  float* go = g_out + unit * g_stride + (long long)pi * cb * ch + pj * cb;
  for (int c = warp; c < wi; c += kThreads / 32)
    for (int d = lane; d < wj; d += 32) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < Cfg::WK; ++w) v += smem[w * Cfg::E + c * RP + d];
      go[c * ch + d] = v;
    }
  for (int e = tid; e < 2 * CHP; e += kThreads) {
    const int which = e / CHP, c = e - which * CHP;
    // nq from the pairs (i, 0), nk from the pairs (0, j)
    if (c >= (which ? wj : wi) || (which ? pi : pj) != 0) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < Cfg::WK; ++w) v += smem[w * Cfg::E + SQ + e];
    (which ? nk_out + pj * cb : nq_out + pi * cb)[unit * n_stride + c] = v;
  }
}

// The apply at head width ch <= 16R: each tile of kApplyTP pixels is out
// (TP x 16R) = v (TP x 16R) attn^T, v and attn zero-padded along d, in
// 16 x 8 mma tiles; warp w owns pixel rows [16 w, 16 w + 16) and all 2R
// column tiles, so each v value is loaded and split once. attn is held in
// shared memory already split into its tf32 high and low parts (SPLIT, up
// to ch = 96), or whole and split at each use (wider heads, for room).
template <int R>
struct ApplyCfg {
  static constexpr int CHP = 16 * R;
  static constexpr int LD = CHP + 4;  // pitch of the v and attn tiles: conflict-free fragments
  static constexpr int NT = 2 * R;    // 8-wide column tiles, and 8-deep steps over d
  static constexpr int STAGES = R <= 4 ? kApplyStages : 2;
  static constexpr bool SPLIT = R <= 6;
  static constexpr int RING = STAGES * kApplyTP * LD;
  static constexpr int FLOATS = RING + (SPLIT ? 2 : 1) * CHP * LD;
  static_assert(kApplyTP == 16 * (kThreads / 32), "a warp per 16 rows");
};

// Tiles t = bh * tiles_per_bh + i (pixels [i TP, (i + 1) TP) of (b, h));
// block (k, i * nb + j) walks tiles [k * per_block, (k + 1) * per_block),
// restaging attn_ij only where bh changes, with the tiles of v_j streaming
// through the ring, and writes out_i's part from block j to out + j * slot.
// The results leave straight from the accumulators: each group of four
// lanes writes 32 contiguous bytes of a row.
template <int R, bool VEC, bool BLK>
__global__ void __launch_bounds__(kThreads)
apply_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ attn,
                 float* __restrict__ out, long long slot, long long hw, int heads, int ch,
                 int cb, long long tiles_per_bh, long long n_tiles_all, long long per_block) {
  using Cfg = ApplyCfg<R>;
  constexpr int LD = Cfg::LD, TP = kApplyTP, CHP = Cfg::CHP, NT = Cfg::NT;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* mh = ring + Cfg::RING;  // attn(c, d) at [c * LD + d]: its high part, or itself
  float* ml = mh + CHP * LD;     // its low part (SPLIT)
  const long long t0 = blockIdx.x * per_block;
  const long long t1 = t0 + per_block < n_tiles_all ? t0 + per_block : n_tiles_all;
  if (t0 >= t1) return;
  const int n = (int)(t1 - t0);
  const Pair pr = pair_of<BLK>(blockIdx.y, ch, cb);
  const int pi = pr.i, pj = pr.j, wi = pr.wi, wj = pr.wj;
  const long long C = (long long)heads * ch, stride = 3 * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = warp * 16;
  const bool use_m[1] = {true};
  bool use_n[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) use_n[j] = true;  // no branch in the hot loop: padding adds zeros

  // the product runs over d < CHP: the v columns [wj, LD) stay zero
  for (int i = tid; i < STAGES * TP * (LD - wj); i += kThreads) {
    const int r = i / (LD - wj);
    ring[r * LD + wj + (i - r * (LD - wj))] = 0.f;
  }
  auto load = [&](int i) {
    const long long t = t0 + i, bh = t / tiles_per_bh, b = bh / heads;
    stage_rows<VEC>(ring + (i % STAGES) * TP * LD, LD,
                    qkv + b * hw * stride + (bh - b * heads) * ch + 2 * C + pj * cb, stride,
                    (t - bh * tiles_per_bh) * TP, hw, TP, wj);
  };
  auto stage_attn = [&](long long bh) {  // zero outside wi x wj
    const float* a = attn + bh * ch * ch + (long long)pi * cb * ch + pj * cb;
    for (int idx = tid; idx < CHP * CHP; idx += kThreads) {
      const int c = idx / CHP, d = idx - c * CHP;
      const float x = c < wi && d < wj ? a[c * ch + d] : 0.f;
      if (Cfg::SPLIT) {
        uint32_t hi, lo;
        split_tf32(x, hi, lo);
        mh[c * LD + d] = __uint_as_float(hi);
        ml[c * LD + d] = __uint_as_float(lo);
      } else {
        mh[c * LD + d] = x;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load(i);
    cp_commit();
  }
  long long staged = t0 / tiles_per_bh;  // the (b, h) whose attn is in shared memory
  stage_attn(staged);
  for (int i = 0; i < n; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    if (i + STAGES - 1 < n) load(i + STAGES - 1);
    cp_commit();
    const long long t = t0 + i, bh = t / tiles_per_bh;
    if (bh != staged) {  // a run that crosses into the next (b, h)
      stage_attn(bh);
      staged = bh;
      __syncthreads();
    }
    const float* vs = ring + (i % STAGES) * TP * LD;
    float acc[1][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[0][j][r] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < CHP; k0 += 8) {
      const float* v0 = vs + (m0 + gid) * LD + k0 + tig;
      const float x[4] = {v0[0], v0[8 * LD], v0[4], v0[8 * LD + 4]};
      uint32_t ah[1][4], al[1][4], bh_[NT][2], bl[NT][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(x[r], ah[0][r], al[0][r]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int o = (j * 8 + gid) * LD + k0 + tig;
        if (Cfg::SPLIT) {
          bh_[j][0] = __float_as_uint(mh[o]);
          bh_[j][1] = __float_as_uint(mh[o + 4]);
          bl[j][0] = __float_as_uint(ml[o]);
          bl[j][1] = __float_as_uint(ml[o + 4]);
        } else {
          split_tf32(mh[o], bh_[j][0], bl[j][0]);
          split_tf32(mh[o + 4], bh_[j][1], bl[j][1]);
        }
      }
      mma_3xtf32(acc, ah, al, bh_, bl, use_m, use_n);
    }
    const long long b = bh / heads;
    const long long r0 = (t - bh * tiles_per_bh) * TP + m0 + gid, r1 = r0 + 8;
    float* ob = out + pj * slot + b * hw * C + (bh - b * heads) * ch + pi * cb;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * tig;
      if (c >= wi) continue;
      if (VEC) {  // wi is even: c + 1 < wi
        if (r0 < hw) *reinterpret_cast<float2*>(ob + r0 * C + c) = make_float2(acc[0][j][0], acc[0][j][1]);
        if (r1 < hw) *reinterpret_cast<float2*>(ob + r1 * C + c) = make_float2(acc[0][j][2], acc[0][j][3]);
      } else {
        const bool c1 = c + 1 < wi;
        if (r0 < hw) {
          ob[r0 * C + c] = acc[0][j][0];
          if (c1) ob[r0 * C + c + 1] = acc[0][j][1];
        }
        if (r1 < hw) {
          ob[r1 * C + c] = acc[0][j][2];
          if (c1) ob[r1 * C + c + 1] = acc[0][j][3];
        }
      }
    }
  }
}

template <int R>
cudaError_t gram_fwd(const float* qkv, float* gram, float* nq, float* nk, float* ws,
                     int B, long long hw, int heads, int ch, int cb, int splits, long long per,
                     cudaStream_t st) {
  using Cfg = GramCfg<R>;
  static bool done[2][kMaxDevices];
  const Variants<decltype(&gram_fwd_kernel<R, true, false>)> ks{
      {{gram_fwd_kernel<R, false, false>, gram_fwd_kernel<R, false, kBlocked<R>>},
       {gram_fwd_kernel<R, true, false>, gram_fwd_kernel<R, true, kBlocked<R>>}}};
  const cudaError_t attr = ks.allow(done, Cfg::FLOATS);
  if (attr != cudaSuccess) return attr;
  const bool vec = ch % 4 == 0 && aligned16(qkv);
  const int nb = n_blocks(ch, cb);
  const dim3 grid((unsigned)splits, (unsigned)(B * heads), (unsigned)(nb * nb));
  const size_t smem = sizeof(float) * Cfg::FLOATS;
  const long long E = (long long)ch * ch + 2 * ch;
  float* g_out = splits > 1 ? ws : gram;
  float* nq_out = splits > 1 ? ws + ch * ch : nq;
  float* nk_out = splits > 1 ? ws + ch * ch + ch : nk;
  const long long g_stride = splits > 1 ? E : (long long)ch * ch;
  const long long n_stride = splits > 1 ? E : ch;
  ks.k[vec][nb > 1]<<<grid, kThreads, smem, st>>>(qkv, g_out, nq_out, nk_out, g_stride,
                                                  n_stride, hw, heads, ch, cb, splits, per);
  if (splits > 1) return launch_reduce(ws, gram, nq, nk, B, heads, ch, (int)E, splits, st);
  return cudaGetLastError();
}

// `blocks` blocks of `per_block` tiles for each channel-block pair, as
// ops/gram.py apply_plan gives them; with nb > 1 blocks the parts of out
// go to nb slots of ws and a second launch sums them
template <int R>
cudaError_t apply_fwd(const float* qkv, const float* attn, float* out, float* ws, int B,
                      long long hw, int heads, int ch, int cb, int blocks, long long per_block,
                      cudaStream_t st) {
  using Cfg = ApplyCfg<R>;
  static bool done[2][kMaxDevices];
  const Variants<decltype(&apply_fwd_kernel<R, true, false>)> ks{
      {{apply_fwd_kernel<R, false, false>, apply_fwd_kernel<R, false, kBlocked<R>>},
       {apply_fwd_kernel<R, true, false>, apply_fwd_kernel<R, true, kBlocked<R>>}}};
  const cudaError_t attr = ks.allow(done, Cfg::FLOATS);
  if (attr != cudaSuccess) return attr;
  const int nb = n_blocks(ch, cb);
  float* dst = nb > 1 ? ws : out;
  const long long slot = (long long)B * hw * heads * ch;
  const bool vec = ch % 4 == 0 && aligned16(qkv) && aligned16(attn) && aligned16(dst);
  const long long tiles_per_bh = (hw + kApplyTP - 1) / kApplyTP;
  const long long n_tiles = tiles_per_bh * B * heads;
  ks.k[vec][nb > 1]<<<dim3((unsigned)blocks, (unsigned)(nb * nb)), kThreads,
                      sizeof(float) * Cfg::FLOATS, st>>>(qkv, attn, dst, slot, hw, heads, ch, cb,
                                                         tiles_per_bh, n_tiles, per_block);
  if (nb > 1) return sum_slots(ws, out, slot, nb, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (B, hw, 3*heads*ch) -> gram (B,heads,ch,ch), nq and nk (B,heads,ch),
// in channel blocks of cb. The pixels of each (b, head) are split into
// `splits` ranges of `per` (ops/gram.py gram_plan); with splits > 1 the
// partials go to ws (B*heads*splits*(ch*ch + 2ch) floats) and a second
// launch sums them.
int rcot_mdta_gram(const float* qkv, float* gram, float* nq, float* nk, float* ws,
                   int B, long long hw, int heads, int ch, int cb, int splits, long long per,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) gram_fwd<R>(qkv, gram, nq, nk, ws, B, hw, heads, ch, cb, splits, per, st)
  RCOT_BY_WIDTH(ch, cb, RCOT_CALL)
#undef RCOT_CALL
}

// qkv (B, hw, 3*heads*ch), attn (B,heads,ch,ch) -> out (B, hw, heads*ch),
// in channel blocks of cb, on `blocks` blocks of `per_block` 128-pixel
// tiles for each block pair (ops/gram.py apply_plan); ws holds nb slots of
// out where nb = ceil(ch / cb) > 1 (ops/gram.py apply_workspace_numel).
int rcot_attn_apply(const float* qkv, const float* attn, float* out, float* ws, int B,
                    long long hw, int heads, int ch, int cb, int blocks, long long per_block,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) \
  apply_fwd<R>(qkv, attn, out, ws, B, hw, heads, ch, cb, blocks, per_block, st)
  RCOT_BY_WIDTH(ch, cb, RCOT_CALL)
#undef RCOT_CALL
}

}  // extern "C"
