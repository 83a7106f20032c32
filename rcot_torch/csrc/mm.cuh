// The building blocks of the port's 1x1-product kernels (block_fwd.cu,
// rows 1-2; block_bwd.cu, row 5; fused_dwconv.cu, rows 8-9): the 1x1
// products on the tensor cores (mm_kernel and its launchers `product` and
// `pixel_sum`), the fixed-order sum of split partials (sum_parts), the
// LayerNorm forward (ln_fwd) and the GDFN gate as a pass of its own
// (gate_pass). Launch plans come from ops/block.py and ops/fused.py.
//
// mm_kernel: 3xTF32 mma.sync m16n8k8 with fp32 accumulation, 128 x 64
// output tiles of eight warps, 32-deep steps through a cp.async ring (16-,
// 8- or 4-byte copies, the widest that the operand's width and alignment
// allow; the plan's), each operand staged in the orientation it lies in
// memory (a transposed operand costs nothing), zero fill at every ragged
// edge, each value split into tf32 halves by integer ops (tc.cuh split_fast). The
// epilogue goes through shared memory, so rows leave in runs of 32 floats,
// and may add an input (kEpiAdd), apply the gate's backward (kEpiGate) or,
// with the gate taken where A is staged, add an input (kEpiGatedAdd); with
// no input (extra null) the last two store the product alone. A
// product whose tiles alone leave the card short splits K into ranges, and
// every split stores its partials with plain stores for sum_parts, which
// adds them in a fixed order. No atomics: two calls give the same bits.
//
// bf16 (block_fwd_bf16.cu, serving in bf16): the per-pixel products take
// the element type T = bf16 (mma_kernel's !A_KROW, !B_KROW, kEpiStore or
// kEpiAdd): tiles of bf16 in shared memory (a BK-deep step is two
// mma.sync m16n8k16 with fp32 accumulation, fragments by ldmatrix), copies
// of 16, 8 or 4 bytes where the plan allows and 2-byte loads where a
// weight's rows are only 2-byte aligned (W_out at odd h), and an epilogue
// that rounds as the JAX kernel does: out = bf16(extra + bf16(acc)) (a
// double rounding), with split partials in fp32 and the rounding after
// sum_parts's fixed-order sum. The LayerNorm takes bf16 inputs or outputs
// too, with fp32 arithmetic (the bf16 forwards' gate is taken in their
// depthwise, dwconv.cu). T = float keeps its code.
//
// bf16 operands (the backward products under RCOT_BWD_BF16, block_bwd.cu,
// fused_dwconv.cu and their bf16 forms: OPS16): the tiles stay fp32 in
// shared memory, exactly as staged, and each value is rounded to bf16 (RNE)
// as it enters its fragment (tc.cuh bf16_tf32), so one tf32 mma.sync per
// step takes the bf16 x bf16 products exactly, summed in fp32 as the
// 3xTF32 path sums. Nothing staged is rounded, so an epilogue or a later
// launch that reads the same operand reads it unrounded. OPS16 = false is
// the 3xTF32 path, unchanged.
//
// bf16 tiles on the tf32 path (the backward products of bf16 training,
// block_bwd_bf16.cu and fused_dwconv_bf16.cu: product with T = float and pixel_sum
// with element types TA, TB of the operands and TO of the output): a bf16
// operand is staged as bf16 (copy widths count bf16 elements, as above,
// 2-byte loads included) and each value is widened into its tf32 fragment
// (tc.cuh widen_tf32), which is exact, so the 3xTF32 terms of its low half
// add exact zeros and are left out (mma_3xtf32's A_EXACT, B_EXACT: two
// mma.sync a step with one bf16 operand, one with two); under OPS16 the
// widening is the bf16 rounding, which is the identity on a bf16 value. A
// bf16 output is the fp32 result rounded once (RNE) where it is written,
// by the epilogue or, where K is split, by sum_parts after the fixed-order
// sum. So these products give the bits of the fp32 products on the widened
// operands, rounded after.
//
// LayerNorm: one warp a pixel; fp32 statistics, biased variance, eps 1e-5
// inside the rsqrt; WithBias is (t - mean) inv w + b, BiasFree t inv w
// with the variance taken about the mean. Up to 512 channels a lane holds
// its (up to 16) channels in registers; above, it walks them in device
// memory, reading the row once for each of the sum, the variance and the
// output, in the same order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-5f;
constexpr int kLnRegChannels = 16 * 32;  // LayerNorm in registers up to here

#define RCOT_TRY(expr)                       \
  do {                                       \
    cudaError_t err_ = (expr);               \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

// ------------------------------------------------------------ products

constexpr int BM = 128, BN = 64, BK = 32, kStages = 3;
// eight warps, 4 over the rows by 2 over the columns; a warp owns 32 x 32
// of the output, MI x NI mma tiles of 16 x 8
constexpr int MI = 2, NI = 4;

// A tile of R rows (of the output's M or N) by BK (of K) in shared memory,
// stored k-major ([BK][R + 8]) where the operand lies k-major in memory
// (KROW), else [R][BK + 4] ([R][BK + 8] in bf16); each pitch spreads a
// warp's fragment reads (ldmatrix's eight 16-byte rows in bf16) over 32
// banks. Sizes count elements of T.
template <int R, bool KROW, typename T = float>
struct Tile {
  static constexpr int LD = KROW ? R + 8 : BK + (sizeof(T) == 2 ? 8 : 4);
  static constexpr int FLOATS = KROW ? BK * LD : R * LD;
  __device__ static __forceinline__ int at(int r, int k) { return KROW ? k * LD + r : r * LD + k; }
};

// Tile (r0.., k0..) of an operand whose element (r, k) is at
// src[KROW ? k * ld + r : r * ld + k] into dst, V elements a copy along the
// contiguous side; zeros at r >= r_end or k >= k_end. V divides the
// contiguous side's extent and src is V-element aligned (the plan's copy
// width), so a copy is wholly in or wholly out. A copy of 4 bytes or more
// is a cp.async; a single bf16 is loaded and stored by the thread.
template <int R, bool KROW, int V, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld, long long r0,
                                           long long r_end, long long k0, long long k_end) {
  constexpr int EXT = KROW ? R : BK, LINES = KROW ? BK : R;
  constexpr int PER_LINE = EXT / V, PIECES = LINES * PER_LINE;
#pragma unroll 4
  for (int i = threadIdx.x; i < PIECES; i += kThreads) {
    const int line = i / PER_LINE, off = (i - line * PER_LINE) * V;
    const long long r = KROW ? r0 + off : r0 + line;
    const long long k = KROW ? k0 + line : k0 + off;
    const bool in = r < r_end && k < k_end;
    T* to = dst + line * Tile<R, KROW, T>::LD + off;
    const T* from = src + (in ? (KROW ? k * ld + r : r * ld + k) : 0);
    if constexpr (sizeof(T) == 4)
      cp_async_v<V>(to, from, in);
    else if constexpr (V == 1)
      *to = in ? *from : from_f<T>(0.f);
    else
      cp_async_bytes<2 * V>(to, from, in);
  }
}

template <int R, bool KROW, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long ld, long long r0,
                                      long long r_end, long long k0, long long k_end, int v) {
  if constexpr (sizeof(T) == 2) {
    if (v == 8) return stage_tile<R, KROW, 8>(dst, src, ld, r0, r_end, k0, k_end);
  }
  if (v == 4)
    stage_tile<R, KROW, 4>(dst, src, ld, r0, r_end, k0, k_end);
  else if (v == 2)
    stage_tile<R, KROW, 2>(dst, src, ld, r0, r_end, k0, k_end);
  else
    stage_tile<R, KROW, 1>(dst, src, ld, r0, r_end, k0, k_end);
}

enum Epi {
  kEpiStore,     // out[m, n] = acc
  kEpiAdd,       // out[m, n] = extra[m, n] + acc
  kEpiGate,      // acc = dgate; extra = conv = [c1 | c2] (M x 2N): out = dconv
                 // = [dgate c2 gelu'(c1) | dgate gelu(c1)] (M x 2N), gate = gelu(c1) c2
  kEpiGatedAdd   // as kEpiAdd, with A = gelu(c1) c2 of conv = [c1 | c2] (M x 2K):
                 // c1 at a, c2 at a2, both staged and the gate taken in shared memory
};

// out (M x N) = sum over k of A(m, k) B(k, n). A(m, k) is a[m * lda + k]
// (a[k * lda + m] with A_KROW), B(k, n) is b[n * ldb + k] (b[k * ldb + n]
// with B_KROW). Block (x, z): output tile x (the N tiles fastest, so
// blocks that share A rows run together), K range [z k_per, (z + 1) k_per),
// written at out + z * z_stride. a, a2, b and extra hold the kernel's
// element type T; out holds T, or fp32 partials where z_stride != 0.
struct MmArgs {
  const void* a;
  const void* a2;  // kEpiGatedAdd: c2, staged beside a (c1)
  const void* b;
  void* out;
  const void* extra;
  float* gate;
  long long lda, ldb, ldo, M, K, k_per, z_stride;
  int N, n_tiles, va, vb;
};

__device__ __forceinline__ void gate_bwd(float dg, float x1, float x2, float* dconv,
                                         float* gate, long long m, int n, int hid) {
  const float cdf = 0.5f * (1.0f + erff(x1 * 0.70710678118654752f));
  const float pdf = 0.39894228040143268f * expf(-0.5f * x1 * x1);
  const float gl = x1 * cdf;
  dconv[m * 2 * hid + n] = dg * x2 * (cdf + x1 * pdf);
  dconv[m * 2 * hid + hid + n] = dg * gl;
  gate[m * hid + n] = gl * x2;
}

// The shared memory of a product: a ring of kStages steps, each an A and a
// B tile (two stages of two A tiles, c1 and c2, and a B tile with the
// gate: 90 KB, so that two blocks still fit an SM). A and B tiles hold TA
// and TB (TA unless given). Where both hold one type a
// stage is its A tile and then its B tile; else the ring is every stage's A
// tile and then every stage's B tile, so that each tile is addressed in its
// own elements. Sizes count bytes but SMEM_FLOATS, the ring's size in
// floats. Every tile's bytes are a multiple of 16, so each tile starts
// 16-byte aligned.
template <bool A_KROW, bool B_KROW, int EPI, typename TA = float, typename TB = TA>
struct MmRing {
  static constexpr int STAGES = EPI == kEpiGatedAdd ? 2 : kStages;
  static constexpr int A_BYTES =
      (EPI == kEpiGatedAdd ? 2 : 1) * (int)sizeof(TA) * Tile<BM, A_KROW, TA>::FLOATS;
  static constexpr int B_BYTES = (int)sizeof(TB) * Tile<BN, B_KROW, TB>::FLOATS;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM_FLOATS = (STAGES * STAGE_BYTES + 3) / 4;
  static_assert(A_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "16-byte aligned tiles");
};

// An operand's value as a tf32 fragment: under OPS16 rounded to bf16 (the
// identity on a bf16 value, which is widened); else its tf32 halves, a bf16
// value's high half alone (it is exact: the low half is zero and not read).
__device__ __forceinline__ uint32_t ops16_frag(float x) { return bf16_tf32(x); }
__device__ __forceinline__ uint32_t ops16_frag(bf16 x) { return widen_tf32(x); }
__device__ __forceinline__ void split_frag(float x, uint32_t& hi, uint32_t& lo) {
  split_fast(x, hi, lo);
}
__device__ __forceinline__ void split_frag(bf16 x, uint32_t& hi, uint32_t&) {
  hi = widen_tf32(x);
}

// The tensor cores add an mma's products to its accumulator with
// truncation after aligning them to the largest term, so a long chain of
// mma.sync into one accumulator drifts toward zero by about an ulp of the
// running sum a step: at K = 1,020-2,042 that bias reached 1.1e-5 of the
// float64 result in dln_b and dW_proj, past the 1e-5 gate. So each BK-deep
// step accumulates from zero on the tensor cores (12 mma at most a chain;
// 2 in bf16) and is added to the running sum in IEEE fp32, as a plain fp32
// loop would.
// T = bf16 is the bf16 product (mma.sync m16n8k16); T = float the tf32
// path, its tiles of EA and EB (float, or bf16 widened into the fragments)
// and its output of EO (float, or bf16 rounded once; stored).
template <bool A_KROW, bool B_KROW, int EPI, typename T = float, bool OPS16 = false,
          typename EA = T, typename EB = T, typename EO = T>
__global__ void __launch_bounds__(kThreads, 2) mm_kernel(const MmArgs p) {
  constexpr bool BF16 = sizeof(T) == 2;
  static_assert(!BF16 || (!A_KROW && !B_KROW && (EPI == kEpiStore || EPI == kEpiAdd)),
                "bf16 products: per-pixel, stored or added");
  static_assert(!(BF16 && OPS16), "the bf16-operand policy: fp32 tiles");
  static_assert(BF16 ? sizeof(EA) == 2 && sizeof(EB) == 2 && sizeof(EO) == 2
                     : sizeof(EO) == 4 || EPI == kEpiStore,
                "bf16 tiles on the tf32 path: a bf16 output is stored");
  static_assert(BF16 || EPI != kEpiGatedAdd || (sizeof(EA) == 4 && sizeof(EB) == 4),
                "the gate is taken on fp32 tiles");
  constexpr bool A16 = !BF16 && sizeof(EA) == 2, B16 = !BF16 && sizeof(EB) == 2;
  using TA = Tile<BM, A_KROW, EA>;
  using TB = Tile<BN, B_KROW, EB>;
  using Ring = MmRing<A_KROW, B_KROW, EPI, EA, EB>;
  // one type: stage s at ring + s STAGE, its B tile B_AT on; two types: A
  // tile s at ring + s STAGE, B tile s at ring_b + s B_STAGE (MmRing)
  constexpr bool SAME = sizeof(EA) == sizeof(EB);
  constexpr int STAGES = Ring::STAGES;
  constexpr int STAGE = (SAME ? Ring::STAGE_BYTES : Ring::A_BYTES) / (int)sizeof(EA);
  constexpr int B_AT = Ring::A_BYTES / (int)sizeof(EA), B_STAGE = Ring::B_BYTES / (int)sizeof(EB);
  constexpr bool GATED = EPI == kEpiGatedAdd;
  extern __shared__ __align__(16) float smem[];
  EA* ring = reinterpret_cast<EA*>(smem);
  EB* ring_b = reinterpret_cast<EB*>(reinterpret_cast<char*>(smem) + STAGES * Ring::A_BYTES);
  auto b_tile = [&](EA* a_tile, int slot) -> EB* {
    if constexpr (SAME)
      return reinterpret_cast<EB*>(a_tile + B_AT);
    else
      return ring_b + slot * B_STAGE;
  };
  const EA* a = static_cast<const EA*>(p.a);
  const EB* b = static_cast<const EB*>(p.b);
  const int tile_m = blockIdx.x / p.n_tiles;
  const long long m0 = (long long)tile_m * BM;
  const int n0 = (blockIdx.x - tile_m * p.n_tiles) * BN;
  const long long kb = (long long)blockIdx.z * p.k_per;
  const long long ke = kb + p.k_per < p.K ? kb + p.k_per : p.K;
  const int n_steps = (int)((ke - kb + BK - 1) / BK);
  auto load = [&](int s) {
    EA* dst = ring + (s % STAGES) * STAGE;
    const long long k0 = kb + (long long)s * BK;
    stage<BM, A_KROW>(dst, a, p.lda, m0, p.M, k0, ke, p.va);
    if constexpr (GATED)
      stage<BM, A_KROW>(dst + TA::FLOATS, static_cast<const EA*>(p.a2), p.lda, m0, p.M, k0, ke,
                        p.va);
    stage<BN, B_KROW>(b_tile(dst, s % STAGES), b, p.ldb, n0, p.N, k0, ke, p.vb);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3, wm = warp >> 1, wn = warp & 1;
  const bool use_m[MI] = {true, true};
  const bool use_n[NI] = {true, true, true, true};
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(s);
    cp_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // step s has landed; every warp is done with step s - 1
    if (s + STAGES - 1 < n_steps) load(s + STAGES - 1);
    cp_commit();
    EA* as = ring + (s % STAGES) * STAGE;
    const EB* bs = b_tile(as, s % STAGES);
    if constexpr (GATED) {
      // the gate in place of c1, once per value (zero fill gives 0)
      for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
        const int at = TA::at(i / BK, i % BK);
        as[at] = gate_fwd(as[at], as[TA::FLOATS + at]);
      }
      __syncthreads();
    }
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
    if constexpr (BF16) {
      // A (m, k) and B stored [n][k]: ldmatrix gives both fragments as
      // they lie; lane l points at row l % 16 (A) of the 16-row tile, or
      // row l % 8 of n tile j + l / 16 (B), at column k + 8 (l / 8 % 2)
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          ldmatrix_x4<false>(af[i], as + TA::at(wm * 32 + i * 16 + (lane & 15),
                                                kk + (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          uint32_t r4[4];
          ldmatrix_x4<false>(r4, bs + TB::at(wn * 32 + (j + (lane >> 4)) * 8 + (lane & 7),
                                             kk + ((lane >> 3) & 1) * 8));
          bfr[j][0] = r4[0], bfr[j][1] = r4[1], bfr[j + 1][0] = r4[2], bfr[j + 1][1] = r4[3];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_bf16(part[i][j], af[i], bfr[j]);
      }
    } else if constexpr (OPS16) {
      // each operand rounded to bf16 as it enters its fragment, one term
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ar[MI][4], br[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int r = wm * 32 + i * 16 + gid;
          ar[i][0] = ops16_frag(as[TA::at(r, kk + tig)]);
          ar[i][1] = ops16_frag(as[TA::at(r + 8, kk + tig)]);
          ar[i][2] = ops16_frag(as[TA::at(r, kk + tig + 4)]);
          ar[i][3] = ops16_frag(as[TA::at(r + 8, kk + tig + 4)]);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int n = wn * 32 + j * 8 + gid;
          br[j][0] = ops16_frag(bs[TB::at(n, kk + tig)]);
          br[j][1] = ops16_frag(bs[TB::at(n, kk + tig + 4)]);
        }
        mma_1xtf32(part, ar, br, use_m, use_n);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int r = wm * 32 + i * 16 + gid;
          split_frag(as[TA::at(r, kk + tig)], ah[i][0], al[i][0]);
          split_frag(as[TA::at(r + 8, kk + tig)], ah[i][1], al[i][1]);
          split_frag(as[TA::at(r, kk + tig + 4)], ah[i][2], al[i][2]);
          split_frag(as[TA::at(r + 8, kk + tig + 4)], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int n = wn * 32 + j * 8 + gid;
          split_frag(bs[TB::at(n, kk + tig)], bh[j][0], bl[j][0]);
          split_frag(bs[TB::at(n, kk + tig + 4)], bh[j][1], bl[j][1]);
        }
        mma_3xtf32<MI, NI, A16, B16>(part, ah, al, bh, bl, use_m, use_n);
      }
    }
    // the step's sum joins the total in IEEE fp32 (see the note above)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
  }

  // The epilogue goes through shared memory, so that each warp reads and
  // writes 32 consecutive elements of an output row (a thread's own
  // accumulators hold two of each of 8 rows). With a K range per
  // block (a pixel sum or a split product), partials go to
  // out + z * z_stride for sum_parts_kernel, in fp32.
  constexpr int OLD = BN + 8;  // pitch: the float2 stores below hit 32 banks
  static_assert(BM * OLD <= Ring::SMEM_FLOATS, "the tile fits in the ring");
  cp_wait<0>();
  __syncthreads();  // the ring is free
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        *reinterpret_cast<float2*>(smem + (wm * 32 + i * 16 + gid + 8 * half) * OLD + wn * 32 +
                                   j * 8 + 2 * tig) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
  __syncthreads();
  const bool partial = p.z_stride != 0;
  const T* extra = static_cast<const T*>(p.extra);
  // warp w takes rows w, w + 8, ..., lane l columns l and l + 32; every
  // input of a warp's rows is loaded before the first store
  constexpr int RW = BM / kWarps;
  float in1[RW][2], in2[RW][2];
#pragma unroll
  for (int q = 0; q < RW; ++q)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const long long m = m0 + warp + q * kWarps;
      const int n = n0 + lane + 32 * h2;
      const bool ok = m < p.M && n < p.N && EPI != kEpiStore && !partial && extra;
      in1[q][h2] = ok ? to_f(__ldg(extra + m * (EPI == kEpiGate ? 2 * p.N : p.ldo) + n)) : 0.f;
      in2[q][h2] = ok && EPI == kEpiGate ? to_f(__ldg(extra + m * 2 * p.N + p.N + n)) : 0.f;
    }
#pragma unroll
  for (int q = 0; q < RW; ++q)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = warp + q * kWarps;
      const long long m = m0 + r;
      const int n = n0 + lane + 32 * h2;
      if (m >= p.M || n >= p.N) continue;
      const float v = smem[r * OLD + lane + 32 * h2];
      if constexpr (BF16) {
        if (partial)
          static_cast<float*>(p.out)[blockIdx.z * p.z_stride + m * p.ldo + n] = v;
        else
          static_cast<T*>(p.out)[m * p.ldo + n] = from_f<T>(in1[q][h2] + round_to<T>(v));
      } else if constexpr (sizeof(EO) == 2) {
        if (partial)
          static_cast<float*>(p.out)[blockIdx.z * p.z_stride + m * p.ldo + n] = in1[q][h2] + v;
        else
          static_cast<EO*>(p.out)[m * p.ldo + n] = from_f<EO>(in1[q][h2] + v);
      } else {
        float* out = static_cast<float*>(p.out) + (long long)blockIdx.z * p.z_stride;
        if (EPI == kEpiGate && !partial)
          gate_bwd(v, in1[q][h2], in2[q][h2], out, p.gate, m, n, p.N);
        else
          out[m * p.ldo + n] = in1[q][h2] + v;
      }
    }
}

template <bool A_KROW, bool B_KROW, int EPI, typename T = float, bool OPS16 = false,
          typename EA = T, typename EB = T, typename EO = T>
cudaError_t mm(MmArgs p, int ranges, cudaStream_t st) {
  constexpr int FLOATS = MmRing<A_KROW, B_KROW, EPI, EA, EB>::SMEM_FLOATS;
  static bool done[kMaxDevices];
  const auto kernel = mm_kernel<A_KROW, B_KROW, EPI, T, OPS16, EA, EB, EO>;
  RCOT_TRY(allow_smem(done, kernel, kernel, FLOATS));
  p.n_tiles = (p.N + BN - 1) / BN;
  const long long tiles = (p.M + BM - 1) / BM * p.n_tiles;
  kernel<<<dim3((unsigned)tiles, 1, (unsigned)ranges), kThreads, sizeof(float) * FLOATS, st>>>(
      p);
  return cudaGetLastError();
}

// out[e] (e < split) or out2[e - split] = sum over parts q of ws[q * ld + e]
// (plus add[e] where add is not null), e < E; a bf16 out takes
// bf16(add[e] + bf16(sum)), as the products' epilogue. A block's eight warps are
// G = 8 / W groups of 32 entries by W warps over the parts (W, a power of
// two up to 8, the most that `parts` fills): warp w of a group adds parts
// w, w + W, ... in order, then the group's first warp adds its W sums in
// order, so the order is a function of `parts` alone.
constexpr int kReduceThreads = 256;

template <typename TO>
__global__ void __launch_bounds__(kReduceThreads)
sum_parts_kernel(const float* __restrict__ ws, const TO* __restrict__ add,
                 TO* __restrict__ out, float* __restrict__ out2, int E, int split, long long ld,
                 long long parts, int W) {
  __shared__ float part[kReduceThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / W, w = warp - group * W;
  const int e = (blockIdx.x * (kReduceThreads / 32 / W) + group) * 32 + lane;
  float v = 0.f;
  if (e < E) {
#pragma unroll 8
    for (long long q = w; q < parts; q += W) v += ws[q * ld + e];
  }
  part[warp][lane] = v;
  __syncthreads();
  if (w != 0 || e >= E) return;
  float sum = 0.f;
  for (int i = 0; i < W; ++i) sum += part[warp + i][lane];
  sum = round_to<TO>(sum);
  if (add) sum = to_f(add[e]) + sum;
  if (e < split)
    out[e] = from_f<TO>(sum);
  else
    out2[e - split] = sum;
}

template <typename TO = float>
cudaError_t sum_parts(const float* ws, TO* out, float* out2, int E, int split, long long ld,
                      long long parts, cudaStream_t st, const TO* add = nullptr) {
  int W = 1;
  while (W < kReduceThreads / 32 && 2 * W <= parts) W *= 2;
  const int per_block = kReduceThreads / W;  // entries a block
  sum_parts_kernel<TO><<<(unsigned)((E + per_block - 1) / per_block), kReduceThreads, 0, st>>>(
      ws, add, out, out2, E, split, ld, parts, W);
  return cudaGetLastError();
}

// Per-pixel product: out (n_pix x N) = A (n_pix x K, row-major) times W^T
// for a weight W (N, K) (!B_KROW) or times W for W (K, N) (B_KROW), plus
// extra (kEpiAdd); with kEpiGatedAdd A is the gate of a = conv (n_pix x
// 2K, row-major), gelu(c1) c2. A's rows lie lda floats apart (K, or 2K
// with kEpiGatedAdd, where 0): a padded A whose columns K..lda-1 hold 0
// may take copies of va floats that divide lda, not K (a copy that starts
// below K and runs past it reads the pad). With splits > 1 (the plan's, where the output has too
// few tiles to fill the card) K is cut into ranges of k_per, whose
// partials go to ws (splits * n_pix * N floats) and are added in a fixed
// order; kEpiGate is never split. T = bf16 rounds as mm_kernel says; OPS16
// takes the bf16-operand policy (fp32 T). Where the call names T = float,
// the operands and the output may lie in bf16 tiles (TA, TB, TO: the tf32
// path of mm_kernel's header, every split's partials in fp32 and a bf16
// output rounded once after sum_parts's fixed-order sum; stored, or the
// gate's backward); where it names no T, a, w and out share their type,
// which is T.
template <typename T>
struct Same {  // T where it is not to be deduced (a null extra)
  using type = T;
};

template <typename T, typename TA>
using ProductT = std::conditional_t<std::is_void<T>::value, TA, T>;

template <bool B_KROW, int EPI, typename T = void, bool OPS16 = false, typename TA, typename TB,
          typename TO>
cudaError_t product(const TA* a, int K, int va, const TB* w, int vb, TO* out, int N,
                    long long n_pix, int splits, long long k_per, float* ws, cudaStream_t st,
                    const ProductT<T, TA>* extra = nullptr, float* gate = nullptr,
                    long long lda = 0) {
  using MT = ProductT<T, TA>;
  constexpr bool MIXED = !std::is_same<TA, MT>::value || !std::is_same<TB, MT>::value ||
                         !std::is_same<TO, MT>::value;
  static_assert((std::is_same<TB, TA>::value && std::is_same<TO, TA>::value) ||
                    (std::is_same<MT, float>::value && (EPI == kEpiStore || EPI == kEpiGate)),
                "bf16 tiles on the tf32 path: T = float, stored or the gate's backward");
  if (splits < 1 || (splits > 1 && (EPI == kEpiGate || k_per < 1))) return cudaErrorInvalidValue;
  constexpr bool GATED = EPI == kEpiGatedAdd;
  MmArgs p{};
  p.a = a, p.a2 = GATED ? a + K : nullptr, p.va = va;
  p.lda = lda ? lda : GATED ? 2LL * K : K;
  p.b = w, p.ldb = B_KROW ? N : K, p.vb = vb;
  p.out = splits > 1 ? (void*)ws : (void*)out, p.ldo = N, p.extra = extra, p.gate = gate;
  p.z_stride = splits > 1 ? n_pix * N : 0;
  p.M = n_pix, p.N = N, p.K = K, p.k_per = splits > 1 ? k_per : K;
  RCOT_TRY((mm<false, B_KROW, EPI, MT, OPS16, TA, TB, TO>(p, splits, st)));
  if constexpr (MIXED) {
    if (splits > 1)
      return sum_parts<TO>(ws, out, nullptr, (int)(n_pix * N), (int)(n_pix * N), n_pix * N,
                           splits, st);
  } else {
    if (splits > 1)
      return sum_parts<MT>(ws, out, nullptr, (int)(n_pix * N), (int)(n_pix * N), n_pix * N,
                           splits, st, EPI == kEpiAdd || GATED ? extra : nullptr);
  }
  return cudaSuccess;
}

// Pixel sum: out (M x N) = sum over pixels q of A[q, m] B[q, n] for A
// (n_pix x M) and B (n_pix x N), in ranges of `per` pixels; with more than
// one range the partials go to ws (ranges * M * N floats) and are added
// in a fixed order. OPS16: the bf16-operand policy. TA, TB, TO as
// product's on the tf32 path.
template <bool OPS16 = false, typename TA = float, typename TB = float, typename TO = float>
cudaError_t pixel_sum(const TA* a, int va, const TB* b, int vb, TO* out, float* ws,
                      int M, int N, long long n_pix, long long per, cudaStream_t st) {
  if (per < 1) return cudaErrorInvalidValue;
  const long long ranges = (n_pix + per - 1) / per;
  MmArgs p{};
  p.a = a, p.lda = M, p.va = va;
  p.b = b, p.ldb = N, p.vb = vb;
  p.out = ranges > 1 ? (void*)ws : (void*)out, p.ldo = N;
  p.z_stride = ranges > 1 ? (long long)M * N : 0;
  p.M = M, p.N = N, p.K = n_pix, p.k_per = per;
  RCOT_TRY((mm<true, true, kEpiStore, float, OPS16, TA, TB, TO>(p, (int)ranges, st)));
  if (ranges > 1)
    return sum_parts<TO>(ws, out, nullptr, M * N, M * N, (long long)M * N, ranges, st);
  return cudaSuccess;
}

// ------------------------------------------------------------ LayerNorm

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// u = LN(t) per pixel, with its mean and inv = rsqrt(var + eps); one warp
// a pixel, lane l holding channels l, l + 32, ... (L of them, RCOT_BY_LANES:
// small C keeps few registers and many warps).
// ln_b null: BiasFree (u = t * inv * w). t and u are TI and TO (float, or
// bf16 in serving's bf16 path); the statistics and the weights are fp32.
template <int L, typename TI = float, typename TO = float>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const TI* __restrict__ t, const float* __restrict__ ln_w,
              const float* __restrict__ ln_b, TO* __restrict__ u,
              float* __restrict__ mean_out, float* __restrict__ inv_out,
              long long n_pix, int C) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long p = blockIdx.x * kWarps + threadIdx.x / 32; p < n_pix; p += warps) {
    const TI* tp = t + p * C;
    float v[L];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? to_f(tp[c]) : 0.f;
      s += v[i];
    }
    const float mean = warp_sum(s) / C;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i)
      if (lane + 32 * i < C) var += (v[i] - mean) * (v[i] - mean);
    const float inv = rsqrtf(warp_sum(var) / C + kLnEps);
    TO* up = u + p * C;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int c = lane + 32 * i;
      if (c < C)
        up[c] = from_f<TO>(ln_b ? (v[i] - mean) * inv * ln_w[c] + ln_b[c]
                                : v[i] * inv * ln_w[c]);
    }
    if (lane == 0) {
      mean_out[p] = mean;
      inv_out[p] = inv;
    }
  }
}

// L, the channels a lane holds, for C: the least power of two that reaches
// C, up to 16 (C <= kLnRegChannels)
#define RCOT_BY_LANES(C, CALL)                          \
  switch (((C) + 31) / 32) {                            \
    case 1: return CALL(1);                             \
    case 2: return CALL(2);                             \
    case 3: case 4: return CALL(4);                     \
    case 5: case 6: case 7: case 8: return CALL(8);     \
    case 9: case 10: case 11: case 12: case 13: case 14: \
    case 15: case 16: return CALL(16);                  \
    default: return cudaErrorInvalidValue;              \
  }

template <int L, typename TI, typename TO>
cudaError_t ln_fwd_l(const TI* t, const float* ln_w, const float* ln_b, TO* u,
                     float* stats, long long n_pix, int C, int blocks, cudaStream_t st) {
  ln_fwd_kernel<L, TI, TO><<<(unsigned)blocks, kThreads, 0, st>>>(t, ln_w, ln_b, u, stats,
                                                                  stats + n_pix, n_pix, C);
  return cudaGetLastError();
}

// C > kLnRegChannels: as ln_fwd_kernel, a lane walking its channels l,
// l + 32, ... in device memory, once for each of the sum, the variance and
// the output
template <typename TI = float, typename TO = float>
__global__ void __launch_bounds__(kThreads)
ln_fwd_wide_kernel(const TI* __restrict__ t, const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b, TO* __restrict__ u,
                   float* __restrict__ mean_out, float* __restrict__ inv_out,
                   long long n_pix, int C) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long p = blockIdx.x * kWarps + threadIdx.x / 32; p < n_pix; p += warps) {
    const TI* tp = t + p * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f(tp[c]);
    const float mean = warp_sum(s) / C;
    float var = 0.f;
    for (int c = lane; c < C; c += 32) var += (to_f(tp[c]) - mean) * (to_f(tp[c]) - mean);
    const float inv = rsqrtf(warp_sum(var) / C + kLnEps);
    TO* up = u + p * C;
    for (int c = lane; c < C; c += 32)
      up[c] = from_f<TO>(ln_b ? (to_f(tp[c]) - mean) * inv * ln_w[c] + ln_b[c]
                              : to_f(tp[c]) * inv * ln_w[c]);
    if (lane == 0) {
      mean_out[p] = mean;
      inv_out[p] = inv;
    }
  }
}

template <typename TI, typename TO>
cudaError_t ln_fwd(const TI* t, const float* ln_w, const float* ln_b, TO* u, float* stats,
                   long long n_pix, int C, int blocks, cudaStream_t st) {
  if (blocks < 1) return cudaErrorInvalidValue;
  if (C > kLnRegChannels) {
    ln_fwd_wide_kernel<TI, TO><<<(unsigned)blocks, kThreads, 0, st>>>(t, ln_w, ln_b, u, stats,
                                                                      stats + n_pix, n_pix, C);
    return cudaGetLastError();
  }
#define RCOT_CALL(L) ln_fwd_l<L>(t, ln_w, ln_b, u, stats, n_pix, C, blocks, st)
  RCOT_BY_LANES(C, RCOT_CALL)
#undef RCOT_CALL
}

// ------------------------------------------------------------ the gate

// gate = gelu(c1) c2 of conv = [c1 | c2] (n_pix x 2 hid, fp32), in rows of
// gate_ld(hid) floats (16 bytes' worth) whose columns past hid hold 0, so
// that the product reading it takes 16-byte copies at any hid; one warp a
// pixel, as the LayerNorm forward. The fp32 forwards' pass: the bf16 ones
// take the gate in their depthwise (dwconv.cuh conv_gate_bf16), into rows
// of gate_ld<bf16>(hid) (8 bf16 a row's unit).
template <typename TO = float>
__host__ __device__ constexpr int gate_ld(int hid) {
  return (hid + 16 / (int)sizeof(TO) - 1) / (16 / (int)sizeof(TO)) * (16 / (int)sizeof(TO));
}

__global__ void __launch_bounds__(kThreads)
gate_pass_kernel(const float* __restrict__ conv, float* __restrict__ gate, long long n_pix,
                 int hid) {
  const int lane = threadIdx.x % 32, ld = gate_ld(hid);
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long m = blockIdx.x * kWarps + threadIdx.x / 32; m < n_pix; m += warps) {
    const float* row = conv + m * 2 * hid;
#pragma unroll 4
    for (int j = lane; j < ld; j += 32)
      gate[m * ld + j] = j < hid ? gate_fwd(row[j], row[hid + j]) : 0.f;
  }
}

cudaError_t gate_pass(const float* conv, float* gate, long long n_pix, int hid, int blocks,
                      cudaStream_t st) {
  gate_pass_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(conv, gate, n_pix, hid);
  return cudaGetLastError();
}

}  // namespace
