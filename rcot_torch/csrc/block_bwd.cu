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
// Bound on an H100 SXM. The tail does 2 N (3 C^2 + 8 h C) flops of 1x1
// products per N pixels (three C x C and eight C x h products a pixel, the
// forward's recompute included) and ~60 h a pixel of stencils and gate,
// against 16 C bytes a pixel of inputs and outputs: bound by operations,
// as is the head (2 N 3 * 3C C). On the CUDA cores (67 TFLOP/s fp32) that
// bound is what chip_smoke.py states; as 3xTF32 on the tensor cores (495
// TF32 / 3 = 165 TFLOP/s) the products' floor is 2.5x lower. The design's
// own launches move the wide intermediates (h, conv, dconv, dh: N x 2h
// floats each; gate N x h) through device memory: 24 h N floats read or
// written in the tail, 7 M N in the head, beside ~19 C N and 8 C N narrow
// ones (tools/port_block_bwd_times.py design_floors), which at the level-1
// shapes is a larger floor than the products'.
//
// Design. The Pallas kernel walked row bands on a sequential grid, kept
// every intermediate in VMEM with a two-row halo, and summed the weight
// grads into grid-revisited blocks. Blocks on the card run in no order, so
// here the backward is a chain of launches on one stream, with the wide
// intermediates (h, conv, dconv, dh, gate) in a workspace the caller
// allocates and the launch plan (ops/block.py block_bwd_plan) passed in as
// ints:
//   - every 1x1 product is mm_kernel: 3xTF32 mma.sync m16n8k8 with fp32
//     accumulation, 128 x 64 output tiles of eight warps, 32-deep steps
//     through a three-stage cp.async ring (16-, 8- or 4-byte copies, the
//     widest that the operand's width and alignment allow; the plan's),
//     each operand staged in the orientation it lies in memory (a
//     transposed operand costs nothing), zero fill at every ragged edge,
//     each value split into tf32 halves by integer ops (split_fast). The epilogue
//     goes through shared memory, so rows leave in runs of 32 floats.
//     Per-pixel products (t, h, dgate, du, da) take the pixels as rows; t's
//     epilogue adds x (no copy of x, no read-modify-write), and dgate's is
//     the gate's backward: it reads conv and writes dconv and gate, so
//     dgate is never stored. One whose tiles alone leave the card short
//     (the latent's du) splits K into ranges (the plan's). Pixel sums
//     (dW_out, dW_in, dW_proj, dW_qkv) take the pixels as depth, split into
//     ranges of at most 512 pixels (a block's fp32 sum grows in error with
//     its pixels; ops/gram.py GRAM_MAX_PIXELS). Every split stores its
//     partials with plain stores, and sum_parts_kernel adds them in a fixed
//     order;
//   - the depthwise stages are row 11's kernels (dwconv.cuh): conv = the
//     forward of h, dh = the rotated forward of dconv, ddw = dtaps(h,
//     dconv), with h in device memory for every pixel, so the conv's zero
//     padding is "outside the image reads 0" and the halo trap of the
//     banded kernel (LN(0) = ln_b on out-of-image rows) cannot occur;
//   - LayerNorm is one warp a pixel, a lane holding up to 16 channels in
//     registers (C <= 512); its backward's per-channel sums (dln_w, dln_b)
//     are per-block partials added over the warps in a fixed order and
//     then over the blocks by sum_parts_kernel.
// No atomics and no memsets: two calls on the same inputs give the same
// bits. The gelu derivative is exact: Phi(x) + x phi(x) with erff.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dwconv.cuh"
#include "tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-5f;

#define RCOT_TRY(expr)                       \
  do {                                       \
    cudaError_t err_ = (expr);               \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

// The launch plan, ops/block.py block_bwd_plan: ints at these offsets.
enum Plan {
  kLnBlocks,  // blocks of the LayerNorm forward
  kLnPer,     // pixels a block of the LayerNorm backward
  kSumPer0,   // pixels a range of each pixel sum: dW_out (dW_qkv in the head),
  kSumPer1,   //   dW_in,
  kSumPer2,   //   dW_proj
  kVecC,      // floats a copy of the C-wide operands,
  kVecH,      //   of the h-wide ones (W_out's rows, gate),
  kVecM,      //   of the 2h- or 3C-wide one (dh)
  kSplit,     // (K ranges, depth a range) of the per-pixel products t, h,
              // du, da, at kSplit + 2 * kProd*
  kDwFwd = kSplit + 8,   // (vec, cv, tc, rows) of the depthwise forward,
  kDwRot = kDwFwd + 4,   // of its rotated forward (dh),
  kDwTaps = kDwRot + 4,  // of its dtaps
  kPlanInts = kDwTaps + 4
};
enum Prod { kProdT, kProdH, kProdDu, kProdDa };

// ------------------------------------------------------------ products

constexpr int BM = 128, BN = 64, BK = 32, kStages = 3;
// eight warps, 4 over the rows by 2 over the columns; a warp owns 32 x 32
// of the output, MI x NI mma tiles of 16 x 8
constexpr int MI = 2, NI = 4;

// A tile of R rows (of the output's M or N) by BK (of K) in shared memory,
// stored k-major ([BK][R + 8]) where the operand lies k-major in memory
// (KROW), else [R][BK + 4]; either pitch spreads a warp's fragment reads
// over 32 banks.
template <int R, bool KROW>
struct Tile {
  static constexpr int LD = KROW ? R + 8 : BK + 4;
  static constexpr int FLOATS = KROW ? BK * LD : R * LD;
  __device__ static __forceinline__ int at(int r, int k) { return KROW ? k * LD + r : r * LD + k; }
};

// Tile (r0.., k0..) of an operand whose element (r, k) is at
// src[KROW ? k * ld + r : r * ld + k] into dst, V floats a copy along the
// contiguous side; zeros at r >= r_end or k >= k_end. V divides the
// contiguous side's extent and src is 4V-byte aligned (the plan's copy
// width), so a copy is wholly in or wholly out.
template <int R, bool KROW, int V>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, long long ld,
                                           long long r0, long long r_end, long long k0,
                                           long long k_end) {
  constexpr int EXT = KROW ? R : BK, LINES = KROW ? BK : R;
  constexpr int PER_LINE = EXT / V, PIECES = LINES * PER_LINE;
#pragma unroll 4
  for (int i = threadIdx.x; i < PIECES; i += kThreads) {
    const int line = i / PER_LINE, off = (i - line * PER_LINE) * V;
    const long long r = KROW ? r0 + off : r0 + line;
    const long long k = KROW ? k0 + line : k0 + off;
    const bool in = r < r_end && k < k_end;
    cp_async_v<V>(dst + line * Tile<R, KROW>::LD + off,
                  src + (in ? (KROW ? k * ld + r : r * ld + k) : 0), in);
  }
}

template <int R, bool KROW>
__device__ __forceinline__ void stage(float* dst, const float* src, long long ld, long long r0,
                                      long long r_end, long long k0, long long k_end, int v) {
  if (v == 4)
    stage_tile<R, KROW, 4>(dst, src, ld, r0, r_end, k0, k_end);
  else if (v == 2)
    stage_tile<R, KROW, 2>(dst, src, ld, r0, r_end, k0, k_end);
  else
    stage_tile<R, KROW, 1>(dst, src, ld, r0, r_end, k0, k_end);
}

// x = hi + lo exactly, hi = x rounded to tf32 (to nearest, ties away from
// zero) by integer ops on its bits; lo goes to the tensor cores as it is,
// and they read its top 19 bits (|error| <= 2^-21 |x|, of either sign).
// Two integer ops and a subtraction, where two cvt.rna.tf32 and a
// subtraction (tc.cuh split_tf32) made the conversions the products' limit.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

enum Epi {
  kEpiStore,  // out[m, n] = acc
  kEpiAdd,    // out[m, n] = extra[m, n] + acc
  kEpiGate    // acc = dgate; extra = conv = [c1 | c2] (M x 2N): out = dconv
              // = [dgate c2 gelu'(c1) | dgate gelu(c1)] (M x 2N), gate = gelu(c1) c2
};

// out (M x N) = sum over k of A(m, k) B(k, n). A(m, k) is a[m * lda + k]
// (a[k * lda + m] with A_KROW), B(k, n) is b[n * ldb + k] (b[k * ldb + n]
// with B_KROW). Block (x, z): output tile x (the N tiles fastest, so
// blocks that share A rows run together), K range [z k_per, (z + 1) k_per),
// written at out + z * z_stride.
struct MmArgs {
  const float* a;
  const float* b;
  float* out;
  const float* extra;
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

// The tensor cores add an mma's products to its accumulator with
// truncation after aligning them to the largest term, so a long chain of
// mma.sync into one accumulator drifts toward zero by about an ulp of the
// running sum a step: at K = 1,020-2,042 that bias reached 1.1e-5 of the
// float64 result in dln_b and dW_proj, past the 1e-5 gate. So each BK-deep
// step accumulates from zero on the tensor cores (12 mma at most a chain)
// and is added to the running sum in IEEE fp32, as a plain fp32 loop would.
template <bool A_KROW, bool B_KROW, int EPI>
__global__ void __launch_bounds__(kThreads, 2) mm_kernel(const MmArgs p) {
  using TA = Tile<BM, A_KROW>;
  using TB = Tile<BN, B_KROW>;
  constexpr int STAGE = TA::FLOATS + TB::FLOATS;
  extern __shared__ __align__(16) float smem[];
  const int tile_m = blockIdx.x / p.n_tiles;
  const long long m0 = (long long)tile_m * BM;
  const int n0 = (blockIdx.x - tile_m * p.n_tiles) * BN;
  const long long kb = (long long)blockIdx.z * p.k_per;
  const long long ke = kb + p.k_per < p.K ? kb + p.k_per : p.K;
  const int n_steps = (int)((ke - kb + BK - 1) / BK);
  auto load = [&](int s) {
    float* dst = smem + (s % kStages) * STAGE;
    const long long k0 = kb + (long long)s * BK;
    stage<BM, A_KROW>(dst, p.a, p.lda, m0, p.M, k0, ke, p.va);
    stage<BN, B_KROW>(dst + TA::FLOATS, p.b, p.ldb, n0, p.N, k0, ke, p.vb);
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
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load(s);
    cp_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();  // step s has landed; every warp is done with step s - 1
    if (s + kStages - 1 < n_steps) load(s + kStages - 1);
    cp_commit();
    const float* as = smem + (s % kStages) * STAGE;
    const float* bs = as + TA::FLOATS;
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = wm * 32 + i * 16 + gid;
        split_fast(as[TA::at(r, kk + tig)], ah[i][0], al[i][0]);
        split_fast(as[TA::at(r + 8, kk + tig)], ah[i][1], al[i][1]);
        split_fast(as[TA::at(r, kk + tig + 4)], ah[i][2], al[i][2]);
        split_fast(as[TA::at(r + 8, kk + tig + 4)], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = wn * 32 + j * 8 + gid;
        split_fast(bs[TB::at(n, kk + tig)], bh[j][0], bl[j][0]);
        split_fast(bs[TB::at(n, kk + tig + 4)], bh[j][1], bl[j][1]);
      }
      mma_3xtf32(part, ah, al, bh, bl, use_m, use_n);
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
  // writes 32 consecutive floats of an output row (a thread's own
  // accumulators hold two floats of each of 8 rows). With a K range per
  // block (a pixel sum or a split product), partials go to
  // out + z * z_stride for sum_parts_kernel.
  constexpr int OLD = BN + 8;  // pitch: the float2 stores below hit 32 banks
  static_assert(BM * OLD <= kStages * STAGE, "the tile fits in the ring");
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
  float* out = p.out + (long long)blockIdx.z * p.z_stride;
  const bool partial = p.z_stride != 0;
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
      const bool ok = m < p.M && n < p.N && EPI != kEpiStore && !partial;
      in1[q][h2] = ok ? __ldg(p.extra + m * (EPI == kEpiGate ? 2 * p.N : p.ldo) + n) : 0.f;
      in2[q][h2] = ok && EPI == kEpiGate ? __ldg(p.extra + m * 2 * p.N + p.N + n) : 0.f;
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
      if (EPI == kEpiGate && !partial)
        gate_bwd(v, in1[q][h2], in2[q][h2], out, p.gate, m, n, p.N);
      else
        out[m * p.ldo + n] = in1[q][h2] + v;
    }
}

template <bool A_KROW, bool B_KROW, int EPI>
cudaError_t mm(MmArgs p, int ranges, cudaStream_t st) {
  constexpr int FLOATS = kStages * (Tile<BM, A_KROW>::FLOATS + Tile<BN, B_KROW>::FLOATS);
  static bool done[kMaxDevices];
  const auto kernel = mm_kernel<A_KROW, B_KROW, EPI>;
  RCOT_TRY(allow_smem(done, kernel, kernel, FLOATS));
  p.n_tiles = (p.N + BN - 1) / BN;
  const long long tiles = (p.M + BM - 1) / BM * p.n_tiles;
  kernel<<<dim3((unsigned)tiles, 1, (unsigned)ranges), kThreads, sizeof(float) * FLOATS, st>>>(
      p);
  return cudaGetLastError();
}

// out[e] (e < split) or out2[e - split] = sum over parts q of ws[q * ld + e]
// (plus add[e] where add is not null), e < E. A block's eight warps are
// G = 8 / W groups of 32 entries by W warps over the parts (W, a power of
// two up to 8, the most that `parts` fills): warp w of a group adds parts
// w, w + W, ... in order, then the group's first warp adds its W sums in
// order, so the order is a function of `parts` alone.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
sum_parts_kernel(const float* __restrict__ ws, const float* __restrict__ add,
                 float* __restrict__ out, float* __restrict__ out2, int E, int split, long long ld,
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
  if (add) sum = add[e] + sum;
  if (e < split)
    out[e] = sum;
  else
    out2[e - split] = sum;
}

cudaError_t sum_parts(const float* ws, float* out, float* out2, int E, int split, long long ld,
                      long long parts, cudaStream_t st, const float* add = nullptr) {
  int W = 1;
  while (W < kReduceThreads / 32 && 2 * W <= parts) W *= 2;
  const int per_block = kReduceThreads / W;  // entries a block
  sum_parts_kernel<<<(unsigned)((E + per_block - 1) / per_block), kReduceThreads, 0, st>>>(
      ws, add, out, out2, E, split, ld, parts, W);
  return cudaGetLastError();
}

// Per-pixel product: out (n_pix x N) = A (n_pix x K, row-major) times W^T
// for a weight W (N, K) (!B_KROW) or times W for W (K, N) (B_KROW), plus
// extra (kEpiAdd). With splits > 1 (the plan's, where the output has too
// few tiles to fill the card) K is cut into ranges of k_per, whose
// partials go to ws (splits * n_pix * N floats) and are added in a fixed
// order; kEpiGate is never split.
template <bool B_KROW, int EPI>
cudaError_t product(const float* a, int K, int va, const float* w, int vb, float* out, int N,
                    long long n_pix, int splits, long long k_per, float* ws, cudaStream_t st,
                    const float* extra = nullptr, float* gate = nullptr) {
  if (splits < 1 || (splits > 1 && (EPI == kEpiGate || k_per < 1))) return cudaErrorInvalidValue;
  MmArgs p{};
  p.a = a, p.lda = K, p.va = va;
  p.b = w, p.ldb = B_KROW ? N : K, p.vb = vb;
  p.out = splits > 1 ? ws : out, p.ldo = N, p.extra = extra, p.gate = gate;
  p.z_stride = splits > 1 ? n_pix * N : 0;
  p.M = n_pix, p.N = N, p.K = K, p.k_per = splits > 1 ? k_per : K;
  RCOT_TRY((mm<false, B_KROW, EPI>(p, splits, st)));
  if (splits > 1)
    return sum_parts(ws, out, nullptr, (int)(n_pix * N), (int)(n_pix * N), n_pix * N, splits,
                     st, EPI == kEpiAdd ? extra : nullptr);
  return cudaSuccess;
}

// Pixel sum: out (M x N) = sum over pixels q of A[q, m] B[q, n] for A
// (n_pix x M) and B (n_pix x N), in ranges of `per` pixels; with more than
// one range the partials go to ws (ranges * M * N floats) and are added
// in a fixed order.
cudaError_t pixel_sum(const float* a, int va, const float* b, int vb, float* out, float* ws,
                      int M, int N, long long n_pix, long long per, cudaStream_t st) {
  if (per < 1) return cudaErrorInvalidValue;
  const long long ranges = (n_pix + per - 1) / per;
  MmArgs p{};
  p.a = a, p.lda = M, p.va = va;
  p.b = b, p.ldb = N, p.vb = vb;
  p.out = ranges > 1 ? ws : out, p.ldo = N, p.z_stride = ranges > 1 ? (long long)M * N : 0;
  p.M = M, p.N = N, p.K = n_pix, p.k_per = per;
  RCOT_TRY((mm<true, true, kEpiStore>(p, (int)ranges, st)));
  if (ranges > 1) return sum_parts(ws, out, nullptr, M * N, M * N, (long long)M * N, ranges, st);
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
// ln_b null: BiasFree (u = t * inv * w).
template <int L>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const float* __restrict__ t, const float* __restrict__ ln_w,
              const float* __restrict__ ln_b, float* __restrict__ u,
              float* __restrict__ mean_out, float* __restrict__ inv_out,
              long long n_pix, int C) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long p = blockIdx.x * kWarps + threadIdx.x / 32; p < n_pix; p += warps) {
    const float* tp = t + p * C;
    float v[L];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? tp[c] : 0.f;
      s += v[i];
    }
    const float mean = warp_sum(s) / C;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i)
      if (lane + 32 * i < C) var += (v[i] - mean) * (v[i] - mean);
    const float inv = rsqrtf(warp_sum(var) / C + kLnEps);
    float* up = u + p * C;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int c = lane + 32 * i;
      if (c < C)
        up[c] = ln_b ? (v[i] - mean) * inv * ln_w[c] + ln_b[c] : v[i] * inv * ln_w[c];
    }
    if (lane == 0) {
      mean_out[p] = mean;
      inv_out[p] = inv;
    }
  }
}

// dt = VJP of LN at t for the cotangent du (plus g_res when not null), and
// the block's partial of dln_w = sum du * that and dln_b = sum du at
// ws[blockIdx.x * 2C + c] and [.. + C + c]. With gw = du * w:
//   WithBias: that = (t - mean) inv, dt = inv (gw - mean(gw) - that mean(gw that))
//   BiasFree: that = t inv,          dt = inv gw - inv^3 (t - mean) mean(gw t)
// One warp a pixel (L channels a lane, as the forward), warp w taking
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

// L, the channels a lane holds, for C: the least power of two that reaches
// C, up to 16 (C <= 512)
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

template <int L>
cudaError_t ln_fwd_l(const float* t, const float* ln_w, const float* ln_b, float* u,
                     float* stats, long long n_pix, int C, int blocks, cudaStream_t st) {
  ln_fwd_kernel<L><<<(unsigned)blocks, kThreads, 0, st>>>(t, ln_w, ln_b, u, stats,
                                                          stats + n_pix, n_pix, C);
  return cudaGetLastError();
}

cudaError_t ln_fwd(const float* t, const float* ln_w, const float* ln_b, float* u, float* stats,
                   long long n_pix, int C, int blocks, cudaStream_t st) {
  if (blocks < 1) return cudaErrorInvalidValue;
#define RCOT_CALL(L) ln_fwd_l<L>(t, ln_w, ln_b, u, stats, n_pix, C, blocks, st)
  RCOT_BY_LANES(C, RCOT_CALL)
#undef RCOT_CALL
}

template <int L>
cudaError_t ln_bwd_l(const float* t, const float* du, const float* stats, const float* ln_w,
                     const float* ln_b, const float* g_res, float* dt, float* ws,
                     long long n_pix, int C, long long per, long long blocks, cudaStream_t st) {
  ln_bwd_kernel<L><<<(unsigned)blocks, kThreads, sizeof(float) * kWarps * 2 * C, st>>>(
      t, du, stats, stats + n_pix, ln_w, ln_b, g_res, dt, ws, n_pix, C, per);
  return cudaGetLastError();
}

// dt and dln_w, dln_b (null with ln_b) through the workspace ws of
// ceil(n_pix / per) * 2C floats
cudaError_t ln_bwd(const float* t, const float* du, const float* stats, const float* ln_w,
                   const float* ln_b, const float* g_res, float* dt, float* dln_w,
                   float* dln_b, float* ws, long long n_pix, int C, long long per,
                   cudaStream_t st) {
  if (per < 1) return cudaErrorInvalidValue;
  const long long blocks = (n_pix + per - 1) / per;
  const cudaError_t err = [&]() -> cudaError_t {
#define RCOT_CALL(L) ln_bwd_l<L>(t, du, stats, ln_w, ln_b, g_res, dt, ws, n_pix, C, per, blocks, st)
    RCOT_BY_LANES(C, RCOT_CALL)
#undef RCOT_CALL
  }();
  RCOT_TRY(err);
  return sum_parts(ws, dln_w, dln_b, ln_b ? 2 * C : C, C, 2LL * C, blocks, st);
}

// The depthwise forward (or, rot, its rotated forward) by row 11's kernel
// with the plan's (vec, cv, tc, rows) at plan[at]
cudaError_t dw(const float* x, const float* taps, float* out, int B, int H, int W, int M,
               const int* plan, int at, bool rot, cudaStream_t st) {
  return rcot_dwconv::conv(x, taps, out, B, H, W, M, plan[at], plan[at + 1], plan[at + 2],
                           plan[at + 3], rot, st);
}

cudaError_t dw_taps(const float* x, const float* g, float* ws, float* ddw, int B, int H, int W,
                    int M, const int* plan, cudaStream_t st) {
  return rcot_dwconv::dtaps(x, g, ws, ddw, B, H, W, M, plan[kDwTaps], plan[kDwTaps + 1],
                            plan[kDwTaps + 2], plan[kDwTaps + 3], st);
}

}  // namespace

// the plan's (K ranges, depth a range) of per-pixel product k
#define SPLIT(k) plan[kSplit + 2 * (k)], plan[kSplit + 2 * (k) + 1]

extern "C" {

// Block-head backward. Inputs x (B,H,W,C), ln_w, ln_b (C; ln_b null for
// BiasFree), w_qkv (M,C), dwk (M,3,3), g (B,H,W,M). Outputs dx (B,H,W,C),
// dln_w, dln_b (C; null with ln_b), dw_qkv (M,C), ddw (M,3,3). Workspace:
// u (N,C), stats (2N), h (N,M), dh (N,M), du (N,C), N = B*H*W, and sums
// (ops/block.py block_bwd_plan's). plan: kPlanInts ints (kSumPer0 is
// dW_qkv's; kVecH, kSumPer1, kSumPer2, kProdT, kProdDa and kDwFwd unused).
int rcot_block_head_bwd(const float* x, const float* ln_w, const float* ln_b,
                        const float* w_qkv, const float* dwk, const float* g, float* dx,
                        float* dln_w, float* dln_b, float* dw_qkv, float* ddw, float* u,
                        float* stats, float* h, float* dh, float* du, float* sums,
                        const int* plan, int B, int H, int W, int C, int M, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int vc = plan[kVecC], vm = plan[kVecM];
  // recompute: u = LN1(x), h = u @ W_qkv^T
  RCOT_TRY(ln_fwd(x, ln_w, ln_b, u, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(u, C, vc, w_qkv, vc, h, M, n, SPLIT(kProdH), sums, st)));
  // depthwise backward, dconv = g: dh = the rotated forward of g, ddw
  RCOT_TRY(dw(g, dwk, dh, B, H, W, M, plan, kDwRot, true, st));
  RCOT_TRY(dw_taps(h, g, sums, ddw, B, H, W, M, plan, st));
  // 1x1 backward: du = dh @ W_qkv, dW_qkv = dh^T u
  RCOT_TRY((product<true, kEpiStore>(dh, M, vm, w_qkv, vc, du, C, n, SPLIT(kProdDu), sums, st)));
  RCOT_TRY(pixel_sum(dh, vm, u, vc, dw_qkv, sums, M, C, n, plan[kSumPer0], st));
  return ln_bwd(x, du, stats, ln_w, ln_b, nullptr, dx, dln_w, dln_b, sums, n, C,
                plan[kLnPer], st);
}

// Block-tail backward. Inputs x, a (B,H,W,C), w_proj (C,C), ln_w, ln_b (C;
// ln_b null for BiasFree), w_in (2h,C), dwk (2h,3,3), w_out (C,h),
// g (B,H,W,C). Outputs dx, da (B,H,W,C), dw_proj (C,C), dln_w, dln_b (C;
// null with ln_b), dw_in (2h,C), ddw (2h,3,3), dw_out (C,h). Workspace:
// t (N,C), stats (2N), u (N,C), h (N,2h), conv_dh (N,2h), dconv (N,2h),
// gate (N,h), du (N,C), N = B*H*W, and sums (ops/block.py
// block_bwd_plan's). plan: kPlanInts ints.
int rcot_block_tail_bwd(const float* x, const float* a, const float* w_proj,
                        const float* ln_w, const float* ln_b, const float* w_in,
                        const float* dwk, const float* w_out, const float* g, float* dx,
                        float* da, float* dw_proj, float* dln_w, float* dln_b, float* dw_in,
                        float* ddw, float* dw_out, float* t, float* stats, float* u, float* h,
                        float* conv_dh, float* dconv, float* gate, float* du, float* sums,
                        const int* plan, int B, int H, int W, int C, int hid, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid, vc = plan[kVecC], vh = plan[kVecH], vm = plan[kVecM];
  // recompute: t = x + a @ W_proj^T, u = LN2(t), h = u @ W_in^T, conv = dw(h)
  RCOT_TRY((product<false, kEpiAdd>(a, C, vc, w_proj, vc, t, C, n, SPLIT(kProdT), sums, st, x)));
  RCOT_TRY(ln_fwd(t, ln_w, ln_b, u, stats, n, C, plan[kLnBlocks], st));
  RCOT_TRY((product<false, kEpiStore>(u, C, vc, w_in, vc, h, m2, n, SPLIT(kProdH), sums, st)));
  RCOT_TRY(dw(h, dwk, conv_dh, B, H, W, m2, plan, kDwFwd, false, st));
  // W_out: dgate = g @ W_out, its epilogue the gate's backward (dconv and
  // gate from conv); dW_out = g^T gate
  RCOT_TRY((product<true, kEpiGate>(g, C, vc, w_out, vh, dconv, hid, n, 1, 0, nullptr, st,
                                    conv_dh, gate)));
  RCOT_TRY(pixel_sum(g, vc, gate, vh, dw_out, sums, C, hid, n, plan[kSumPer0], st));
  // depthwise backward (conv is dead now: its buffer takes dh)
  RCOT_TRY(dw(dconv, dwk, conv_dh, B, H, W, m2, plan, kDwRot, true, st));
  RCOT_TRY(dw_taps(h, dconv, sums, ddw, B, H, W, m2, plan, st));
  // W_in: du = dh @ W_in, dW_in = dh^T u
  RCOT_TRY((product<true, kEpiStore>(conv_dh, m2, vm, w_in, vc, du, C, n, SPLIT(kProdDu), sums,
                                     st)));
  RCOT_TRY(pixel_sum(conv_dh, vm, u, vc, dw_in, sums, m2, C, n, plan[kSumPer1], st));
  // LN2 and the residual: dx = dt = LN-VJP(du) + g
  RCOT_TRY(ln_bwd(t, du, stats, ln_w, ln_b, g, dx, dln_w, dln_b, sums, n, C, plan[kLnPer], st));
  // W_proj: da = dt @ W_proj, dW_proj = dt^T a
  RCOT_TRY((product<true, kEpiStore>(dx, C, vc, w_proj, vc, da, C, n, SPLIT(kProdDa), sums, st)));
  return pixel_sum(dx, vc, a, vc, dw_proj, sums, C, C, n, plan[kSumPer2], st);
}

}  // extern "C"
