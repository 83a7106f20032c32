// MDTA attention core forward in bf16 for Hopper (sm_90a): serving's bf16
// path (make_restorer(dtype=torch.bfloat16)).
//
// Replaces the TPU kernels of rcot_tpu/ops/pallas_gram.py as the JAX
// package runs them on a bf16 qkv:
//
//   mdta_gram (mdta_gram_fwd, pallas_gram.py:99, pallas_call at :106):
//       per (b, head h):  G = q^T k,  nq = sum q^2,  nk = sum k^2, in fp32
//       (the kernel upcasts qkv, :81; a bf16 product is exact in fp32, so
//       bf16 operands with fp32 sums are the same arithmetic);
//   attn_apply (attn_apply_fwd, pallas_gram.py:178, pallas_call at :185):
//       out[pixel, h*ch + c] = bf16(sum_d v[pixel, h*ch + d] bf16(attn[b, h, c, d]))
//       (attn, fp32 from the glue, rounded to bf16 as :171 casts it; fp32
//       sums; the result rounded once).
//
// Bounds on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores):
// per pixel the Gram reads 2C bf16 (4C bytes) against 2 C ch flops, the
// apply reads C and writes C bf16 (4C bytes) against 2 C ch: both bound by
// their bytes at every head width the model has.
//
// Design: gram.cu's grids (ops/gram.py gram_pairs_plan for the Gram,
// apply_bf16_plan for the apply; channel blocks of at most 128 for wider
// heads, gram.cuh), on bf16 tiles staged by cp.async (16- or 4-byte
// copies, or 2-byte loads where a head's rows are only 2-byte aligned) and
// mma.sync m16n8k16 with fp32 accumulation, fragments by ldmatrix
// (transposed for the Gram, whose q and k tiles lie pixel-major and are
// summed over pixels).
//   - gram_bf16_kernel: a block sums one of gram_plan's pixel ranges of a
//     (b, head, block pair); its eight warps split the G tiles and the
//     pixels of each stage, and each stage's products start from zero and
//     join the running sums in IEEE fp32 (mm.cuh's note on a long mma
//     chain); the sums of squares are fp32 chains over a channel's pixels,
//     G a channel. A range is one wave of short blocks whose loads, products
//     and squares ran in turn (PERF.md, PR 20: the squares, a loop of
//     dependent shared-memory loads a stage, cost as much as the products),
//     so up to R = 6 four more warps take the chains, two channels a 4-byte
//     read, beside the products, and the copies' zero padding runs while the
//     first tiles fly. The warps' partials are added in shared memory in a
//     fixed order, and a split (b, head) adds its ranges in gram.cuh's
//     fixed-order reduce: every sum in the order it had, the same bits.
//   - apply_bf16_kernel: runs of 128-pixel tiles, each warp 16 rows and all
//     columns. Its bytes are few a block (a 256^2 image at ch = 48 is 512
//     tiles, two a block), so what bounds it is the latency of getting them
//     in flight: the plan holds as many blocks an SM as its shared memory
//     and registers take (two at ch = 48 and 96), each block's first
//     tiles leave with attn in one group of cp.async copies (attn as fp32,
//     converted to bf16 in shared memory once it lands, while the tiles are
//     still on their way), every later tile as soon as its slot frees, and
//     out leaves in bf16 through shared memory, 16 bytes a lane along a
//     row. Each output's sum is the same: 16-deep m16n8k16 steps from zero
//     over d. A head cut into channel blocks writes fp32 parts in nb slots
//     that tc.cuh's sum_slots adds in order and rounds.
// No atomics and no memsets: two calls on the same input give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram.cuh"
#include "tc.cuh"

namespace {

using bf162 = __nv_bfloat162;

constexpr int kStagesBf = 3;   // the Gram's cp.async ring
constexpr int kApplyTPBf = 128;  // pixels per apply tile: eight warps of 16 rows

// The Gram at channel-block width <= 16R: G (16R x 16R, zero-padded) in
// 16 x 8 mma tiles, R row tiles by 2R column tiles; the eight warps split
// the tiles (WTM x WTN) and the 16-pixel steps of each stage (WK groups);
// each warp holds MW x NW tiles in registers.
template <int R>
struct GramBf {
  static constexpr int CHP = 16 * R;
  static constexpr int LD = CHP + 8;  // bf16 pitch: ldmatrix's 16-byte rows hit 32 banks
  static constexpr int MT = R, NT = 2 * R;
  static constexpr int WK = R <= 2 ? 8 : (R <= 4 ? 4 : 1);
  static constexpr int WTM = R <= 4 ? 1 : 2;
  static constexpr int WTN = R <= 2 ? 1 : (R <= 4 ? 2 : 4);
  static constexpr int MW = (MT + WTM - 1) / WTM, NW = (NT + WTN - 1) / WTN;
  static constexpr int KS = R <= 4 ? 1 : 2;      // 16-pixel steps per warp and stage
  static constexpr int TP = 16 * WK * KS;        // pixels per stage
  // stages a slot of the ring holds, taken between two barriers: two, so
  // that a range takes half the barriers (the sums keep their stage order)
  static constexpr int SUB = 2;
  static constexpr int SLOT = SUB * TP;          // pixels a slot
  static constexpr int STAGE = 2 * SLOT * LD;    // q rows, k rows (bf16)
  // The sums of squares: chain (c, g) of q and of k sums channel c over the
  // pixels g, g + G, ... of each stage in order, G = kThreads / CHP chains a
  // channel; nq and nk add a channel's G chains in order. Up to R = 6 SQW
  // warps beside the eight of the products take the chains, so that the
  // squares run beside the products and not after them: a thread the chains
  // (c .. c + SQV - 1, g) of PT units (one 4-byte read a pixel where SQV =
  // 2), units s, s + 32 SQW, ...; above, the products' registers leave no
  // room for more threads and the eight warps' thread (c, g) takes chain
  // (c, g) after its products.
  static constexpr int G = kThreads / CHP;
  static constexpr int SQ = (TP + G - 1) / G;    // pixels a chain takes a stage, at most
  static constexpr int SQW = R <= 6 ? 4 : 0;
  static constexpr int SQV = SQW ? 2 : 1;
  static constexpr int THREADS = kThreads + 32 * SQW;
  static constexpr int UNITS = CHP / SQV * G;
  static constexpr int PT = SQW ? (UNITS + 32 * SQW - 1) / (32 * SQW) : 1;
  static constexpr int RP = CHP + 1;             // pitch of a partial G
  static constexpr int E = CHP * RP + 2 * CHP;   // one warp group's partial (floats)
  static constexpr int RED = WK * E + 2 * G * CHP;
  static constexpr int RING = (kStagesBf * STAGE * 2 + 3) / 4;  // in floats
  static constexpr int FLOATS = RING > RED ? RING : RED;
  static_assert(WK * WTM * WTN == kThreads / 32, "eight warps");
  static_assert(G >= 1, "a thread per channel at least");
};

// Block (s, bh, i * nb + j) sums G_ij, nq and nk over pixels [s * per,
// (s + 1) * per) of (b, h), as gram.cu's gram_fwd_kernel, from bf16 qkv.
// Warps below eight take the loads and the products; the squares are
// GramBf's chains.
template <int R, int V>
__global__ void __launch_bounds__(GramBf<R>::THREADS)
gram_bf16_kernel(const bf16* __restrict__ qkv, float* __restrict__ g_out,
                 float* __restrict__ nq_out, float* __restrict__ nk_out, long long g_stride,
                 long long n_stride, long long hw, int heads, int ch, int cb, int splits,
                 long long per) {
  using Cfg = GramBf<R>;
  constexpr int LD = Cfg::LD, TP = Cfg::TP, CHP = Cfg::CHP, MW = Cfg::MW, NW = Cfg::NW;
  constexpr int PT = Cfg::PT, G = Cfg::G, SQV = Cfg::SQV, SLOT = Cfg::SLOT;
  extern __shared__ __align__(16) float smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int s = blockIdx.x, bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const Pair pr = pair_of<true>(blockIdx.z, ch, cb);
  const int pi = pr.i, pj = pr.j, wi = pr.wi, wj = pr.wj;
  const long long C = (long long)heads * ch, stride = 3 * C;
  const long long begin = s * per;
  const long long end = begin + per < hw ? begin + per : hw;
  const bf16* head = qkv + (long long)b * hw * stride + (long long)h * ch;
  const bf16* q_rows = head + pi * cb;
  const bf16* k_rows = head + C + pj * cb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const bool mma_warp = warp < kThreads / 32;
  const int wk = warp % Cfg::WK, wt = warp / Cfg::WK;
  const int wm = wt / Cfg::WTN, wn = wt % Cfg::WTN;
  bool use_m[MW], use_n[NW];
#pragma unroll
  for (int i = 0; i < MW; ++i) use_m[i] = Cfg::MT % Cfg::WTM == 0 || wm * MW + i < Cfg::MT;
#pragma unroll
  for (int j = 0; j < NW; ++j) use_n[j] = Cfg::NT % Cfg::WTN == 0 || wn * NW + j < Cfg::NT;
  // this thread's chains of the squares: (sq_c + v, sq_g), v < SQV, of units
  // sq_c / SQV + CHP / SQV * sq_g
  int sq_c[PT], sq_g[PT];
  bool sq_on[PT];
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const int unit = Cfg::SQW ? tid - kThreads + k * 32 * Cfg::SQW : tid;
    sq_on[k] = (Cfg::SQW ? !mma_warp : true) && unit < Cfg::UNITS;
    sq_c[k] = sq_on[k] ? unit % (CHP / SQV) * SQV : 0;
    sq_g[k] = sq_on[k] ? unit / (CHP / SQV) : 0;
  }

  const int n_tiles = (int)((end - begin + SLOT - 1) / SLOT);
  auto load = [&](int t) {
    bf16* dst = ring + (t % kStagesBf) * Cfg::STAGE;
    const long long p0 = begin + (long long)t * SLOT;
    stage_rows_bf16<V>(dst, LD, q_rows, stride, p0, end, SLOT, wi);
    stage_rows_bf16<V>(dst + SLOT * LD, LD, k_rows, stride, p0, end, SLOT, wj);
  };

  float acc[MW][NW][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  float sq_q[PT][SQV], sq_k[PT][SQV];
#pragma unroll
  for (int k = 0; k < PT; ++k)
#pragma unroll
    for (int v = 0; v < SQV; ++v) sq_q[k][v] = sq_k[k][v] = 0.f;

  if (mma_warp) {
#pragma unroll
    for (int t = 0; t < kStagesBf - 1; ++t) {
      if (t < n_tiles) load(t);
      cp_commit();
    }
    // the copies never write columns [wi, CHP) of a q row or [wj, CHP) of a
    // k row, which the products read: zeroed while the first tiles fly
    const int wmin = wi < wj ? wi : wj, pad = CHP - wmin;
    for (int i = tid; i < kStagesBf * 2 * SLOT * pad; i += kThreads) {
      const int r = i / pad, c = wmin + (i - r * pad);
      if (c >= ((r / SLOT) & 1 ? wj : wi)) ring[r * LD + c] = __float2bfloat16_rn(0.f);
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<kStagesBf - 2>();  // (the squares' warps have no copies in flight)
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    const bf16* qs = ring + (t % kStagesBf) * Cfg::STAGE;
    const bf16* ks = qs + SLOT * LD;
    if (mma_warp) {
      if (t + kStagesBf - 1 < n_tiles) load(t + kStagesBf - 1);
      cp_commit();
#pragma unroll
      for (int u = 0; u < Cfg::SUB; ++u) {  // the slot's stages, in order
        float part[MW][NW][4];
#pragma unroll
        for (int i = 0; i < MW; ++i)
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < Cfg::KS; ++kk) {
          const int p0 = u * TP + (wk * Cfg::KS + kk) * 16;
          // A = q^T (channel x pixel) and B = k (pixel x channel), both from
          // pixel-major tiles: ldmatrix transposed, lane l at pixel
          // p0 + 8 (l / 16 or l / 8 % 2) + l % 8
          uint32_t af[MW][4], bfr[NW][2];
#pragma unroll
          for (int i = 0; i < MW; ++i) {
            if (!use_m[i]) continue;
            ldmatrix_x4<true>(af[i], qs + (p0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * LD +
                                         (wm * MW + i) * 16 + ((lane >> 3) & 1) * 8);
          }
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            if (!use_n[j]) continue;
            ldmatrix_x2<true>(bfr[j], ks + (p0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                          (wn * NW + j) * 8);
          }
#pragma unroll
          for (int i = 0; i < MW; ++i)
#pragma unroll
            for (int j = 0; j < NW; ++j)
              if (use_m[i] && use_n[j]) mma_bf16(part[i][j], af[i], bfr[j]);
        }
#pragma unroll
        for (int i = 0; i < MW; ++i)
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
      }
    }
    // each stage's squares: each unit's loads first, then its chains in pixel order
#pragma unroll
    for (int u = 0; u < Cfg::SUB; ++u) {
#pragma unroll
      for (int k = 0; k < PT; ++k) {
        if (!sq_on[k]) continue;
        float x[Cfg::SQ][SQV], y[Cfg::SQ][SQV];
#pragma unroll
        for (int i = 0; i < Cfg::SQ; ++i) {
          const int p = sq_g[k] + i * G, o = (u * TP + (p < TP ? p : 0)) * LD + sq_c[k];
          if constexpr (SQV == 2) {  // channels sq_c and sq_c + 1: one 4-byte read
            const float2 a = __bfloat1622float2(*reinterpret_cast<const bf162*>(qs + o));
            const float2 b = __bfloat1622float2(*reinterpret_cast<const bf162*>(ks + o));
            x[i][0] = a.x, x[i][1] = a.y, y[i][0] = b.x, y[i][1] = b.y;
          } else {
            x[i][0] = to_f(qs[o]), y[i][0] = to_f(ks[o]);
          }
        }
#pragma unroll
        for (int i = 0; i < Cfg::SQ; ++i) {
          if (sq_g[k] + i * G >= TP) break;
#pragma unroll
          for (int v = 0; v < SQV; ++v) {
            sq_q[k][v] = fmaf(x[i][v], x[i][v], sq_q[k][v]);
            sq_k[k][v] = fmaf(y[i][v], y[i][v], sq_k[k][v]);
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it holds the partials now

  constexpr int RP = Cfg::RP;
  if (mma_warp) {
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
    }
  }
  float* sq = smem + Cfg::WK * Cfg::E;  // [q | k][G][CHP]
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    if (!sq_on[k]) continue;
#pragma unroll
    for (int v = 0; v < SQV; ++v) {
      sq[sq_g[k] * CHP + sq_c[k] + v] = sq_q[k][v];
      sq[(G + sq_g[k]) * CHP + sq_c[k] + v] = sq_k[k][v];
    }
  }
  __syncthreads();

  // the partials in a fixed order, written once: warp w rows w, w + W, ...
  const long long unit = (long long)bh * splits + s;
  float* go = g_out + unit * g_stride + (long long)pi * cb * ch + pj * cb;
  for (int c = warp; c < wi; c += Cfg::THREADS / 32)
    for (int d = lane; d < wj; d += 32) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < Cfg::WK; ++w) v += smem[w * Cfg::E + c * RP + d];
      go[c * ch + d] = v;
    }
  for (int e = tid; e < 2 * CHP; e += Cfg::THREADS) {
    const int which = e / CHP, c = e - which * CHP;
    // nq from the pairs (i, 0), nk from the pairs (0, j)
    if (c >= (which ? wj : wi) || (which ? pi : pj) != 0) continue;
    float v = 0.f;
    for (int g = 0; g < G; ++g) v += sq[(which * G + g) * CHP + c];
    (which ? nk_out + pj * cb : nq_out + pi * cb)[unit * n_stride + c] = v;
  }
}

// The apply at channel-block width <= 16R: each 128-pixel tile is out
// (128 x 16R) = v (128 x 16R) attn^T in 16 x 8 mma tiles, 16-deep steps
// over d; warp w owns pixel rows [16 w, 16 w + 16) and all 2R column
// tiles. Shared memory: a ring of STAGES bf16 v tiles (pitch LD), attn in
// bf16 (rounded once, pitch LD) and attn's fp32 rows as they land (pitch
// CHP). A block holds BYTES; MIN_BLOCKS of them an SM, as many as its
// shared memory takes and at most REG_BLOCKS, the blocks whose share of the
// registers a thread needs without spilling (ptxas: 64 at R = 1, up to 80
// at R = 2, 122-130 at R = 3-6, 174-184 at R = 7-8); __launch_bounds__
// holds it to that (ops/gram.py apply_bf16_per_sm says the same).
template <int R>
struct ApplyBf {
  static constexpr int CHP = 16 * R;
  static constexpr int LD = CHP + 8;  // bf16 pitch of the v and attn tiles
  static constexpr int NT = 2 * R;
  static constexpr int STAGES = R <= 4 ? 4 : 2;
  static constexpr int RING = STAGES * kApplyTPBf * LD;  // bf16
  static constexpr int BYTES = 2 * (RING + CHP * LD) + 4 * CHP * CHP;
  static constexpr int SMEM_BLOCKS = kSmemPerSm / (BYTES + kSmemPerBlockReserved);
  static constexpr int REG_BLOCKS = R == 1 ? 4 : R == 2 ? 3 : R <= 6 ? 2 : 1;
  static constexpr int MIN_BLOCKS = SMEM_BLOCKS < REG_BLOCKS ? SMEM_BLOCKS : REG_BLOCKS;
  static_assert(kApplyTPBf == 16 * (kThreads / 32), "a warp per 16 rows");
  static_assert(BYTES % 16 == 0 && MIN_BLOCKS >= 1, "fits an SM");
};

// Tiles t = bh * tiles_per_bh + i; block (k, i * nb + j) walks tiles
// [k * per_block, (k + 1) * per_block) as gram.cu's apply_fwd_kernel. The
// run's first STAGES tiles and attn leave device memory together (cp.async;
// attn's fp32 rows in copies of av floats, converted to bf16 in shared
// memory once they land, while the other tiles are still on their way);
// each tile reloads the slot freed by the one before it. attn is restaged
// where the run crosses into the next (b, h). A head of one block (nb = 1)
// writes out (bf16), each warp's rows staged in place of its own v rows and
// stored v bf16 at a time; a blocked one writes its fp32 part of out_i from
// block j to slots + j * slot.
template <int R>
__global__ void __launch_bounds__(kThreads, ApplyBf<R>::MIN_BLOCKS)
apply_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ attn,
                  bf16* __restrict__ out, float* __restrict__ slots, long long slot,
                  long long hw, int heads, int ch, int cb, long long tiles_per_bh,
                  long long n_tiles_all, long long per_block, int v, int av) {
  using Cfg = ApplyBf<R>;
  constexpr int LD = Cfg::LD, TP = kApplyTPBf, CHP = Cfg::CHP, NT = Cfg::NT;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ __align__(16) float smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* ma = ring + Cfg::RING;                           // attn(c, d) at [c * LD + d]
  float* a32 = reinterpret_cast<float*>(ma + CHP * LD);  // attn(c, d) at [c * CHP + d]
  const long long t0 = blockIdx.x * per_block;
  const long long t1 = t0 + per_block < n_tiles_all ? t0 + per_block : n_tiles_all;
  if (t0 >= t1) return;
  const int n = (int)(t1 - t0);
  const Pair pr = pair_of<true>(blockIdx.y, ch, cb);
  const int pi = pr.i, pj = pr.j, wi = pr.wi, wj = pr.wj;
  const bool blocked = cb < ch;
  const long long C = (long long)heads * ch, stride = 3 * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = warp * 16;

  // the copies never write columns [wj, CHP) of a v row; the products read them
  if (wj < CHP) {
    for (int i = tid; i < STAGES * TP * (CHP - wj); i += kThreads) {
      const int r = i / (CHP - wj);
      ring[r * LD + wj + (i - r * (CHP - wj))] = __float2bfloat16_rn(0.f);
    }
  }
  auto load = [&](int i) {
    const long long t = t0 + i, bh = t / tiles_per_bh, b = bh / heads;
    stage_rows_bf16_v(ring + (i % STAGES) * TP * LD, LD,
                      qkv + b * hw * stride + (bh - b * heads) * ch + 2 * C + pj * cb, stride,
                      (t - bh * tiles_per_bh) * TP, hw, TP, wj, v);
  };
  auto load_attn = [&](long long bh) {  // its wi x wj block, fp32
    const float* a = attn + bh * ch * ch + (long long)pi * cb * ch + pj * cb;
    const int per_row = wj / av;
    for (int i = tid; i < wi * per_row; i += kThreads) {
      const int c = i / per_row, d = (i - c * per_row) * av;
      if (av == 4)
        cp_async16(a32 + c * CHP + d, a + (long long)c * ch + d, true);
      else
        cp_async4(a32 + c * CHP + d, a + (long long)c * ch + d, true);
    }
  };
  auto convert_attn = [&]() {  // rounded once; zero outside wi x wj
    for (int idx = tid; idx < CHP * CHP; idx += kThreads) {
      const int c = idx / CHP, d = idx - c * CHP;
      ma[c * LD + d] = __float2bfloat16_rn(c < wi && d < wj ? a32[c * CHP + d] : 0.f);
    }
  };

  long long staged = t0 / tiles_per_bh;  // the (b, h) whose attn is in shared memory
  load_attn(staged);  // in tile 0's group
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i < n) load(i);
    cp_commit();
  }
  // tile i is group i: STAGES groups before tile 0's wait, one more before each later one
  for (int i = 0; i < n; ++i) {
    if (i == 0)
      cp_wait<STAGES - 1>();
    else
      cp_wait<STAGES - 2>();
    __syncthreads();  // tile i (and attn, at i = 0) has landed; tile i - 1 is done with
    const long long t = t0 + i, bh = t / tiles_per_bh;
    if (i == 0) {
      convert_attn();
      __syncthreads();
    } else {
      if (i + STAGES - 1 < n) load(i + STAGES - 1);  // into tile i - 1's slot
      cp_commit();
      if (bh != staged) {  // a run that crosses into the next (b, h)
        load_attn(bh);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        convert_attn();
        staged = bh;
        __syncthreads();
      }
    }
    bf16* vs = ring + (i % STAGES) * TP * LD;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < CHP; k0 += 16) {
      // A = v (pixel x d) as it lies; B(d, c) = attn[c][d], n rows of d
      uint32_t af[4];
      ldmatrix_x4<false>(af, vs + (m0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r4[4];
        ldmatrix_x4<false>(r4, ma + ((j + (lane >> 4)) * 8 + (lane & 7)) * LD + k0 +
                                   ((lane >> 3) & 1) * 8);
        const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
        mma_bf16(acc[j], af, b0);
        mma_bf16(acc[j + 1], af, b1);
      }
    }
    const long long b = bh / heads, p0 = (t - bh * tiles_per_bh) * TP;
    const long long base = b * hw * C + (bh - b * heads) * ch + pi * cb;
    if (blocked) {
      const long long r0 = p0 + m0 + gid, r1 = r0 + 8;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j * 8 + 2 * tig;
        if (c >= wi) continue;
        const bool c1 = c + 1 < wi;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long r = half ? r1 : r0;
          if (r >= hw) continue;
          float* o = slots + pj * slot + base + r * C + c;
          o[0] = acc[j][2 * half];
          if (c1) o[1] = acc[j][2 * half + 1];
        }
      }
    } else {
      // rounded and staged in place of this warp's own 16 v rows (only this
      // warp reads them), columns below wi = wj, then stored v bf16 a lane
      __syncwarp();
      bf16* st = vs + m0 * LD;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j * 8 + 2 * tig;
        if (c >= wi) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          bf16* o = st + (gid + 8 * half) * LD + c;
          if (c + 1 < wi)
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
          else
            *o = __float2bfloat16_rn(acc[j][2 * half]);
        }
      }
      __syncwarp();
      store_staged_v(out + base, C, st, LD, p0 + m0, hw, 16, wi, lane, 32, v);
    }
  }
}

// V, the bf16 a copy of a head's rows (ops/gram.py bf16_copy_width): 8
// (16 bytes), 2 (4 bytes) or 1, dividing ch and cb
bool bad_copy(int v, int ch, int cb) {
  return !(v == 8 || v == 2 || v == 1) || ch % v != 0 || cb % v != 0;
}

#define RCOT_BY_COPY(v, CALL) \
  v == 8 ? CALL(8) : v == 2 ? CALL(2) : CALL(1)

template <int R, int V>
cudaError_t gram_bf16_v(const bf16* qkv, float* gram, float* nq, float* nk, float* ws, int B,
                        long long hw, int heads, int ch, int cb, int splits, long long per,
                        cudaStream_t st) {
  using Cfg = GramBf<R>;
  static bool done[kMaxDevices];
  const auto kernel = gram_bf16_kernel<R, V>;
  const cudaError_t attr = allow_smem(done, kernel, kernel, Cfg::FLOATS);
  if (attr != cudaSuccess) return attr;
  const int nb = (ch + cb - 1) / cb;
  const long long E = (long long)ch * ch + 2 * ch;
  float* g_out = splits > 1 ? ws : gram;
  float* nq_out = splits > 1 ? ws + ch * ch : nq;
  float* nk_out = splits > 1 ? ws + ch * ch + ch : nk;
  const long long g_stride = splits > 1 ? E : (long long)ch * ch;
  const long long n_stride = splits > 1 ? E : ch;
  kernel<<<dim3((unsigned)splits, (unsigned)(B * heads), (unsigned)(nb * nb)), Cfg::THREADS,
           sizeof(float) * Cfg::FLOATS, st>>>(qkv, g_out, nq_out, nk_out, g_stride, n_stride,
                                              hw, heads, ch, cb, splits, per);
  if (splits > 1) return launch_reduce(ws, gram, nq, nk, B, heads, ch, (int)E, splits, st);
  return cudaGetLastError();
}

template <int R>
cudaError_t gram_bf16(const bf16* qkv, float* gram, float* nq, float* nk, float* ws, int B,
                      long long hw, int heads, int ch, int cb, int splits, long long per, int v,
                      cudaStream_t st) {
  if (bad_copy(v, ch, cb)) return cudaErrorInvalidValue;
#define RCOT_CALL(V) \
  gram_bf16_v<R, V>(qkv, gram, nq, nk, ws, B, hw, heads, ch, cb, splits, per, st)
  return RCOT_BY_COPY(v, RCOT_CALL);
#undef RCOT_CALL
}

template <int R>
cudaError_t apply_bf16(const bf16* qkv, const float* attn, bf16* out, float* ws, int B,
                       long long hw, int heads, int ch, int cb, int blocks, long long per_block,
                       int v, cudaStream_t st) {
  if (bad_copy(v, ch, cb)) return cudaErrorInvalidValue;
  using Cfg = ApplyBf<R>;
  static bool done[kMaxDevices];
  const auto kernel = apply_bf16_kernel<R>;
  const cudaError_t attr = allow_smem(done, kernel, kernel, Cfg::BYTES / 4);
  if (attr != cudaSuccess) return attr;
  const int nb = (ch + cb - 1) / cb;
  const long long slot = (long long)B * hw * heads * ch;
  const long long tiles_per_bh = (hw + kApplyTPBf - 1) / kApplyTPBf;
  // attn's rows in 16-byte copies where every row of every block starts on 16 bytes
  const int av = ch % 4 == 0 && cb % 4 == 0 && aligned16(attn) ? 4 : 1;
  kernel<<<dim3((unsigned)blocks, (unsigned)(nb * nb)), kThreads, Cfg::BYTES, st>>>(
      qkv, attn, out, ws, slot, hw, heads, ch, cb, tiles_per_bh, tiles_per_bh * B * heads,
      per_block, v, av);
  if (nb == 1) return cudaGetLastError();
  return sum_slots(ws, out, slot, nb, st);
}

template <int R>
cudaError_t apply_bf16_occupancy(int* blocks, int* bytes, int* min_blocks) {
  using Cfg = ApplyBf<R>;
  static bool done[kMaxDevices];
  const auto kernel = apply_bf16_kernel<R>;
  *bytes = Cfg::BYTES;
  *min_blocks = Cfg::MIN_BLOCKS;
  const cudaError_t attr = allow_smem(done, kernel, kernel, Cfg::BYTES / 4);
  if (attr != cudaSuccess) return attr;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, Cfg::BYTES);
}

}  // namespace

extern "C" {

// qkv (B, hw, 3*heads*ch) bf16 -> gram (B,heads,ch,ch), nq and nk
// (B,heads,ch) fp32, as rcot_mdta_gram (the same plan and workspace), with
// copies of vec bf16 (ops/gram.py bf16_copy_width).
int rcot_mdta_gram_bf16(const bf16* qkv, float* gram, float* nq, float* nk, float* ws, int B,
                        long long hw, int heads, int ch, int cb, int splits, long long per,
                        int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) \
  gram_bf16<R>(qkv, gram, nq, nk, ws, B, hw, heads, ch, cb, splits, per, vec, st)
  RCOT_BY_WIDTH(ch, cb, RCOT_CALL)
#undef RCOT_CALL
}

// qkv (B, hw, 3*heads*ch) bf16, attn (B,heads,ch,ch) fp32 -> out
// (B, hw, heads*ch) bf16 (ws holds nb fp32 slots of out where the head is
// cut into nb > 1 channel blocks), on ops/gram.py apply_bf16_plan's
// blocks, with copies and stores of vec bf16 (ops/gram.py bf16_copy_width,
// out included).
int rcot_attn_apply_bf16(const bf16* qkv, const float* attn, bf16* out, float* ws, int B,
                         long long hw, int heads, int ch, int cb, int blocks,
                         long long per_block, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) \
  apply_bf16<R>(qkv, attn, out, ws, B, hw, heads, ch, cb, blocks, per_block, vec, st)
  RCOT_BY_WIDTH(ch, cb, RCOT_CALL)
#undef RCOT_CALL
}

// -> *blocks: the blocks of rcot_attn_apply_bf16's kernel for (ch, cb)
// that one SM holds; *bytes and *min_blocks: its ApplyBf's BYTES and
// MIN_BLOCKS (ops/gram.py apply_bf16_smem and apply_bf16_per_sm state them).
int rcot_attn_apply_bf16_blocks_per_sm(int ch, int cb, int* blocks, int* bytes,
                                       int* min_blocks) {
#define RCOT_CALL(R) apply_bf16_occupancy<R>(blocks, bytes, min_blocks)
  RCOT_BY_WIDTH(ch, cb, RCOT_CALL)
#undef RCOT_CALL
}

}  // extern "C"
