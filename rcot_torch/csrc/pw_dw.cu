// The product-depthwise of the bf16 forwards for Hopper (sm_90a): a 1x1
// product taken inside a depthwise 3x3's band, as the TPU kernels take it.
// Serving's bf16 head (block_fwd_bf16.cu, row 1, after its LayerNorm) and
// bf16 training's qkv (fused_dwconv_bf16.cu, row 8) run through it:
//
//   qkv = bf16(dw3x3(h)), h = bf16(u @ W^T)   (the head's u = bf16(LN1(x)),
//                                              the qkv's u = x)
//
// Replaces, in those two forms, the TPU kernels rcot_tpu/ops/pallas_block.py
// fused_block_fwd (pallas_call at :189; the head's band body :107-129) and
// pallas_fused.py fused_dwconv_fwd (pallas_call at :274; body :161-169),
// which take a band of rows with one halo row above and below, apply the
// product (the head after its LayerNorm) to all of them in fast memory, zero
// the halo rows outside the image (:124-127) and run the stencil there. Here
// h never reaches device memory: the design it replaces wrote h and read it
// back with its halo for the depthwise (2M + 2M bytes a pixel and a launch
// more). The head's LayerNorm stays a launch of its own (mm.cuh ln_fwd):
// taken in the block, it was taken once for every channel chunk and cost
// more than its launch (PERF.md).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores,
// 67 TFLOP/s fp32 outside them): u in and qkv out, 2C + 2M bytes a pixel,
// against 2 M C flops of product (bf16) and 18 M of stencil (fp32): at M =
// 3C bound by the bytes at every block shape, the product passing them
// past C = 394 (chip_smoke.py bf16_fwd_work).
//
// Design. A block owns kPwCols output columns by cw of M's output channels
// and walks a band of `rows` rows of one image (grid: column tile, channel
// chunk, image x band; the plan is ops/dwconv.py pw_dw_plan), R input rows
// a step (pw_group). Its W chunk (cw rows of C, zeros past M and past C up
// to whole K steps) is staged once; each step's rows, kPwPix = kPwCols + 2
// pixels each (one 16-row mma tile), go through a cp.async ring. Each step
// then takes, after one barrier:
//   1. the stencil of the step before (the h rows it wrote last): a thread
//      owns one output column by kPwVec channels, keeps their 9 taps and
//      three output rows in registers and reads its three h columns from
//      shared memory, dwconv.cu's dwconv3x3_kernel fmaf chain in its order,
//      and stores an output row when its last input row has passed;
//   2. the product: 8 / R warps a row, each A fragment loaded once a K step
//      for the warp's 8-channel tiles of the chunk, whose chains interleave,
//      on mma.sync m16n8k16 with ldmatrix fragments; each BK-deep step two
//      mma from a zeroed accumulator joining the fp32 sum in step order, and
//      h rounded once, as mm.cuh's bf16 product (mm_kernel, kEpiStore) sums
//      and rounds it: the same element in the same steps gives the same
//      bits wherever it sits in a tile. Where ops/block.py split_plan splits
//      the product's K (only past C = 128), each range is its own chain and
//      the ranges are added in sum_parts's fixed order before the one
//      rounding. h goes to one of two steps' rows in shared memory, zeros at
//      pixels and rows outside the image.
// So one launch, u read once per channel chunk (its halo rows and columns
// again, mostly from L2) and qkv written once. No atomics: two calls give
// the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mm.cuh"
#include "pw_dw.cuh"

namespace {

constexpr int kPwThreads = 256;
constexpr int kPwWarps = kPwThreads / 32;
constexpr int kPwCols = 14;              // output columns a block (ops/dwconv.py PW_COLS)
constexpr int kPwPix = kPwCols + 2;      // pixels a staged row: one 16-row mma tile
constexpr int kPwVec = 4;                // channels a stencil thread (PW_VEC)
constexpr int kPwBlocksPerSm = 2;        // the launch bound (PW_BLOCKS_PER_SM)
constexpr int kPwMaxChunk = kPwThreads / kPwCols * kPwVec / 8 * 8;  // 72 (PW_MAX_CHUNK)

// Input rows a step of the band (ops/dwconv.py pw_dw_group): four up to C =
// 128, two up to 384, else one, so that a step's rows fit two blocks an SM
__host__ __device__ constexpr int pw_group(int C) { return C <= 128 ? 4 : C <= 384 ? 2 : 1; }
// bf16 between the staged rows of x (and of the W chunk): C rounded up to
// whole K steps, and 8 more, so that ldmatrix's eight rows hit 32 banks
__host__ __device__ constexpr int pw_ldk(int C) { return (C + BK - 1) / BK * BK + 8; }
// bf16 between h's pixels: cw or more, = 8 (mod 16), so that the product's
// fragment stores (eight pixels a store) hit 32 banks
__host__ __device__ constexpr int pw_ldh(int cw) { return cw + (24 - cw % 16) % 16; }

// The shared memory of a block (ops/dwconv.py pw_dw_smem): the ring of
// `stages` steps of R staged rows of x, the W chunk, two steps' h rows
// (bf16), then the chunk's 9 taps a channel (fp32); every part 16-byte
// aligned.
__host__ __device__ constexpr size_t pw_smem(int C, int cw, int stages) {
  return 2ull * (stages * pw_group(C) * kPwPix + cw) * pw_ldk(C) +
         2ull * 2 * pw_group(C) * kPwPix * pw_ldh(cw) + 4ull * 9 * cw;
}

// dst <- V bf16 at src, or zeros where !in (src is not read); a single
// bf16 is loaded and stored by the thread
template <int V>
__device__ __forceinline__ void copy_v(bf16* dst, const bf16* src, bool in) {
  if constexpr (V == 1)
    *dst = in ? *src : from_f<bf16>(0.f);
  else
    cp_async_bytes<2 * V>(dst, src, in);
}

// Lines [0, lines) of C bf16 into dst, ldk apart, V bf16 a copy across
// whole K steps: line l is src + off + l * ld where lo <= l < hi, zeros
// past C and in the other lines (src itself is any valid address). V
// divides C and the lines are V-aligned (the plan's copy width).
template <int V>
__device__ __forceinline__ void stage_lines(bf16* dst, int ldk, const bf16* src, long long off,
                                            long long ld, int lines, int lo, int hi, int C) {
  const int per = (C + BK - 1) / BK * BK / V, pieces = lines * per;
  for (int i = threadIdx.x; i < pieces; i += kPwThreads) {
    const int l = i / per, k = (i - l * per) * V;
    const bool in = l >= lo && l < hi && k < C;
    copy_v<V>(dst + l * ldk + k, in ? src + off + l * ld + k : src, in);
  }
}

// ldmatrix .x4 at a shared-memory address (tc.cuh ldmatrix_x4's, the
// address already in the shared window)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// acc[k] += the product over K steps [kb, ke) of 16 u rows by the W
// tiles of b: lane's A rows at a (the shared address of its row, k = 0,
// with its 8-column offset) and its W rows at b[k] (likewise), bf16 ldk
// apart: each BK-deep step two mma.sync m16n8k16 from a zeroed
// accumulator, then joined to acc in fp32 (mm_kernel's bf16 chain; the
// fragments by ldmatrix as mm_kernel addresses them, A's once a step).
// Every tile of b is taken, with no branch, so that their chains
// interleave: the caller points a warp's tiles past the chunk at its last
// and keeps their sums out of h.
template <int TPW>
__device__ __forceinline__ void chain(float (&acc)[TPW][4], uint32_t a, const uint32_t (&b)[TPW],
                                      int kb, int ke) {
#pragma unroll 4
  for (int k0 = kb; k0 < ke; k0 += BK) {
    uint32_t af[2][4];
    ldsm_x4(af[0], a + 2 * k0);
    ldsm_x4(af[1], a + 2 * (k0 + 16));
#pragma unroll
    for (int k = 0; k < TPW; ++k) {
      uint32_t bf[4];  // k0.. and k0 + 16.. of the tile's 8 rows
      ldsm_x4(bf, b[k] + 2 * k0);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(part, af[0], bf);
      mma_bf16(part, af[1], bf + 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][e] += part[e];
    }
  }
}

// The fp32 sums of a row's tiles as mm.cuh takes them, which the caller
// rounds once: one range, the chain of every K step; K split into `parts`
// ranges of k_per (SPLIT: only where C passes 128), each its own chain,
// added as sum_parts_kernel adds them (its W warps: warp g the ranges g,
// g + W, .. in order, then the W sums in order).
template <int TPW, bool SPLIT>
__device__ __forceinline__ void row_sums(float (&h)[TPW][4], uint32_t a,
                                         const uint32_t (&b)[TPW], int C, int parts,
                                         int k_per) {
#pragma unroll
  for (int k = 0; k < TPW; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) h[k][e] = 0.f;
  if (!SPLIT || parts == 1) {
    chain<TPW>(h, a, b, 0, C);
    return;
  }
  if constexpr (SPLIT) {
    int nw = 1;
    while (nw < kReduceThreads / 32 && 2 * nw <= parts) nw *= 2;
    for (int g = 0; g < nw; ++g) {
      float v[TPW][4] = {};
      for (int q = g; q < parts; q += nw) {
        float acc[TPW][4] = {};
        chain<TPW>(acc, a, b, q * k_per, min(q * k_per + k_per, C));
#pragma unroll
        for (int k = 0; k < TPW; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[k][e] += acc[k][e];
      }
#pragma unroll
      for (int k = 0; k < TPW; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[k][e] += v[k][e];
    }
  }
}

// Two sums rounded to bf16 (RNE) as mm_kernel's bf16 epilogue stores h,
// bf16(0 + bf16(acc)): a -0 becomes +0 (`plus`, one range); sum_parts's
// rounding keeps it (split K)
__device__ __forceinline__ uint32_t h_bits(float a, float b, bool plus) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
  return plus ? u & ~(__vcmpeq2(u, 0x80008000u) & 0x80008000u) : u;
}

__device__ __forceinline__ void load4(float (&d)[4], const bf16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  d[0] = a.x, d[1] = a.y, d[2] = b.x, d[3] = b.y;
}

// Where a thread's copies go, found once, where a step takes at most
// kPwPieces copies a thread: piece k is thread + k kPwThreads of a step's R
// x kPwPix pixels by C / V copies, for pixels inside the image only (the
// others are never read into h): its place in a slot, its element offset in
// the image at step 0 (row r of the band, at image row y0 - 1 + r) and that
// row r (-1: none)
constexpr int kPwPieces = 4;

struct Pieces {
  int s_off[kPwPieces], g_off[kPwPieces], row[kPwPieces];

  __device__ Pieces(int R, int C, int V, int ldk, int x0, int y0, int p_lo, int p_hi,
                    long long img_row) {
    const int per = C / V;
#pragma unroll
    for (int k = 0; k < kPwPieces; ++k) {
      const int i = threadIdx.x + k * kPwThreads, line = i / per, p = line % kPwPix;
      const int off = (i - line * per) * V, r = line / kPwPix;
      row[k] = line < R * kPwPix && p >= p_lo && p < p_hi ? r : -1;
      s_off[k] = line * ldk + off;
      g_off[k] = (int)((y0 - 1 + r) * img_row) + (x0 - 1 + p) * C + off;
    }
  }
};

// R input rows a step (pw_group)
template <int R>
__global__ void __launch_bounds__(kPwThreads, kPwBlocksPerSm)
pw_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const bf16* __restrict__ taps, bf16* __restrict__ out, int H, int W, int C, int M,
             int vec_c, int vec_out, int cw, int rows, int bands, int stages, int parts,
             int k_per) {
  constexpr int WPR = kPwWarps / R;                       // warps a row of the product
  constexpr int TPW = (kPwMaxChunk / 8 + WPR - 1) / WPR;  // its tiles a warp at most
  extern __shared__ __align__(16) float smem[];
  const int ldk = pw_ldk(C), ldh = pw_ldh(cw), kp = ldk - 8;
  const int slot = R * kPwPix * ldk, hslot = R * kPwPix * ldh;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* wch = ring + stages * slot;
  bf16* hrows = wch + cw * ldk;
  float* s_taps = reinterpret_cast<float*>(hrows + 2 * hslot);
  const int x0 = blockIdx.x * kPwCols, c0 = blockIdx.y * cw;
  const int b = blockIdx.z / bands, y0 = (blockIdx.z - b * bands) * rows;
  const int n_out = min(rows, H - y0), n_in = n_out + 2, steps = (n_in + R - 1) / R;
  const long long row = (long long)W * C;
  const bf16* img = x + (long long)b * H * row;
  // staged pixel p is column x0 - 1 + p: in the image for p_lo <= p < p_hi
  const int p_lo = max(0, 1 - x0), p_hi = min(kPwPix, W - x0 + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // input row i of the band (image row y0 - 1 + i) is in the image
  auto row_in = [&](int i) { return i < n_in && y0 - 1 + i >= 0 && y0 - 1 + i < H; };

  // the step's rows inside the image, their pixels inside it, into slot
  // `at`, vec_c bf16 a copy: at the places a thread found once (kept), or
  // piece i = thread + k kPwThreads as pixel line i / per of the step (row
  // line / kPwPix, pixel line % kPwPix) at its element (i % per) V, both
  // carried from piece to piece with no division
  const bool kept = R * kPwPix * (C / vec_c) <= kPwPieces * kPwThreads &&
                    (H + 1) * row < 0x7fffffffLL;  // offsets in an int
  const Pieces pc(R, C, vec_c, ldk, x0, y0, p_lo, p_hi, row);
  auto stage_v = [&](auto vt, int s, int at) {
    constexpr int V = decltype(vt)::value;
    bf16* dst = ring + at * slot;
    if (kept) {
      const int step_off = s * R * (int)row;
#pragma unroll
      for (int k = 0; k < kPwPieces; ++k)
        if (pc.row[k] >= 0 && row_in(s * R + pc.row[k]))
          copy_v<V>(dst + pc.s_off[k], img + pc.g_off[k] + step_off, true);
      return;
    }
    const int per = C / V, dl = kPwThreads / per, doff = kPwThreads - dl * per;
    const bf16* src = img + (long long)(y0 - 1 + s * R) * row + (long long)(x0 - 1) * C;
    int line = threadIdx.x / per, off = threadIdx.x - line * per;
    for (; line < R * kPwPix; line += dl) {
      const int p = line % kPwPix, r = line / kPwPix;
      if (p >= p_lo && p < p_hi && row_in(s * R + r))
        copy_v<V>(dst + line * ldk + off * V, src + r * row + p * C + off * V, true);
      off += doff;
      if (off >= per) off -= per, ++line;
    }
  };
  auto stage_step = [&](int s, int at) {
    using std::integral_constant;
    if (vec_c == 8)
      stage_v(integral_constant<int, 8>{}, s, at);
    else if (vec_c == 4)
      stage_v(integral_constant<int, 4>{}, s, at);
    else if (vec_c == 2)
      stage_v(integral_constant<int, 2>{}, s, at);
    else
      stage_v(integral_constant<int, 1>{}, s, at);
  };
  // zeros past C up to whole K steps in every staged row, once (nothing
  // else writes there); the W chunk with zeros past M and C; the first steps
  for (int i = threadIdx.x; i < stages * R * kPwPix * (kp - C); i += kPwThreads) {
    const int line = i / (kp - C);
    ring[line * ldk + C + i - line * (kp - C)] = from_f<bf16>(0.f);
  }
  if (vec_c == 8)
    stage_lines<8>(wch, ldk, w, (long long)c0 * C, C, cw, 0, M - c0, C);
  else if (vec_c == 4)
    stage_lines<4>(wch, ldk, w, (long long)c0 * C, C, cw, 0, M - c0, C);
  else if (vec_c == 2)
    stage_lines<2>(wch, ldk, w, (long long)c0 * C, C, cw, 0, M - c0, C);
  else
    stage_lines<1>(wch, ldk, w, (long long)c0 * C, C, cw, 0, M - c0, C);
  for (int s = 0; s < stages - 1; ++s) {
    if (s < steps) stage_step(s, s);
    cp_commit();
  }
  // the chunk's taps: 9 cc contiguous bf16, read once, coalesced; zeros past M
  const int cc = min(cw, M - c0);
  for (int f = threadIdx.x; f < 9 * cw; f += kPwThreads)
    s_taps[(f % 9) * cw + f / 9] = f < 9 * cc ? to_f(taps[9LL * c0 + f]) : 0.f;
  __syncthreads();
  // thread (j, v) of the stencil: column x0 + j, channels c0 + kPwVec v..
  const int cv = cw / kPwVec, j = threadIdx.x / cv, v = threadIdx.x - j * cv;
  const bool st_on = j < kPwCols;
  const int c = c0 + kPwVec * v;
  const bool active = st_on && x0 + j < W && c < M;
  float wt[9][kPwVec];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int e = 0; e < kPwVec; ++e) wt[k][e] = st_on ? s_taps[k * cw + kPwVec * v + e] : 0.f;
  bf16* dst = out + (((long long)b * H + y0) * W + x0 + j) * M + c;
  const long long out_row = (long long)W * M;
  // acc0, acc1, acc2: output rows y + 1, y, y - 1 of input row y
  float acc0[kPwVec], acc1[kPwVec], acc2[kPwVec];
#pragma unroll
  for (int e = 0; e < kPwVec; ++e) acc0[e] = acc1[e] = acc2[e] = 0.f;
  // the product's warp: row pi of a step, tiles pt, pt + WPR, ..; the
  // shared addresses of its lane's A row (slot 0) and W rows
  const int pi = warp / WPR, pt = warp - pi * WPR, nt = cw / 8;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t a0 = smem_addr(ring + (pi * kPwPix + (lane & 15)) * ldk + (lane >> 4) * 8);
  uint32_t bw[TPW];
#pragma unroll
  for (int k = 0; k < TPW; ++k)
    bw[k] = smem_addr(wch + (min(pt + WPR * k, nt - 1) * 8 + (lane & 7)) * ldk + (lane >> 3) * 8);

  // step s is in slot `at`; step s + stages - 1 goes to slot `next`
  for (int s = 0, at = 0, next = stages - 1; s <= steps; ++s) {
    if (s < steps) {
      if (stages == 3)
        cp_wait<1>();
      else
        cp_wait<0>();
    }
    // step s is in; its h rows of step s - 1 are written; every thread is
    // done with step s - 1's slot and with the h rows step s's product takes
    __syncthreads();
    if (s + stages - 1 < steps) stage_step(s + stages - 1, next);
    cp_commit();
    next = at;
    if (s >= 1 && st_on) {  // the stencil of step s - 1's rows, in order
      const bf16* hs0 = hrows + ((s - 1) & 1) * hslot + j * ldh + kPwVec * v;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int ri = (s - 1) * R + i;
        if (ri >= n_in) break;
        const bf16* hs = hs0 + i * kPwPix * ldh;
        float l[kPwVec], m[kPwVec], rt[kPwVec];
        load4(l, hs);
        load4(m, hs + ldh);
        load4(rt, hs + 2 * ldh);
#pragma unroll
        for (int e = 0; e < kPwVec; ++e) {
          acc0[e] = fmaf(wt[0][e], l[e], fmaf(wt[1][e], m[e], fmaf(wt[2][e], rt[e], acc0[e])));
          acc1[e] = fmaf(wt[3][e], l[e], fmaf(wt[4][e], m[e], fmaf(wt[5][e], rt[e], acc1[e])));
          acc2[e] = fmaf(wt[6][e], l[e], fmaf(wt[7][e], m[e], fmaf(wt[8][e], rt[e], acc2[e])));
        }
        if (ri >= 2 && active) {
          bf16* o = dst;
          dst += out_row;
          const __nv_bfloat162 lo = __floats2bfloat162_rn(acc2[0], acc2[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(acc2[2], acc2[3]);
          if (vec_out >= 4) {
            uint2 q;
            q.x = *reinterpret_cast<const uint32_t*>(&lo);
            q.y = *reinterpret_cast<const uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(o) = q;
          } else {
            *reinterpret_cast<__nv_bfloat162*>(o) = lo;
            if (c + 2 < M) *reinterpret_cast<__nv_bfloat162*>(o + 2) = hi;
          }
        }
#pragma unroll
        for (int e = 0; e < kPwVec; ++e) {
          acc2[e] = acc1[e];
          acc1[e] = acc0[e];
          acc0[e] = 0.f;
        }
      }
    }
    if (s == steps) break;
    // h of row pi of the step, tiles pt + WPR k (channels c0 + 8t..):
    // fragment rows gid, gid + 8 (pixels), columns 2 tig, 2 tig + 1
    float h[TPW][4];
    const bool rin = row_in(s * R + pi);
    if (rin) row_sums<TPW, (R < 4)>(h, a0 + 2 * at * slot, bw, C, parts, k_per);
    bf16* hr = hrows + (s & 1) * hslot + pi * kPwPix * ldh + 2 * tig;
#pragma unroll
    for (int k = 0; k < TPW; ++k) {
      const int t = pt + WPR * k;
      if (t >= nt) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = gid + 8 * half;
        *reinterpret_cast<uint32_t*>(hr + p * ldh + t * 8) =
            rin && p >= p_lo && p < p_hi ? h_bits(h[k][2 * half], h[k][2 * half + 1], parts == 1)
                                         : 0u;
      }
    }
    at = at + 1 == stages ? 0 : at + 1;
  }
}

// The kernel's instance for C: f(R) as a std::integral_constant, R =
// pw_group(C)
template <typename F>
cudaError_t by_instance(int C, F&& f) {
  using std::integral_constant;
  const int r = pw_group(C);
  return r == 4   ? f(integral_constant<int, 4>{})
         : r == 2 ? f(integral_constant<int, 2>{})
                  : f(integral_constant<int, 1>{});
}

// An instance may take the most shared memory a block has: set once per
// device
template <int R>
cudaError_t allow() {
  static bool done[kMaxDevices];
  const auto kernel = pw_dw_kernel<R>;
  return allow_smem(done, kernel, kernel, kMaxSmemBytes / (int)sizeof(float));
}

}  // namespace

namespace rcot_pwdw {

// mm.cuh's kStages (its products' ring) would hide the plan's in the
// anonymous namespace: the plan's ints are read here
static bool bad_plan(int C, int M, const int* plan) {
  const int vc = plan[kVecC], vo = plan[kVecOut], cw = plan[kChunk], stages = plan[kStages];
  const int parts = plan[kParts], k_per = plan[kKPer];
  return plan[kGroup] != pw_group(C) || !(vc == 1 || vc == 2 || vc == 4 || vc == 8) ||
         C % vc != 0 || !(vo == 2 || vo == 4) || M % vo != 0 || cw < 8 || cw % 8 != 0 ||
         cw > kPwMaxChunk || plan[kRows] < 1 || stages < 2 || stages > 3 || parts < 1 ||
         (parts > 1 && (pw_group(C) == 4 || k_per < BK || k_per % BK != 0 ||
                        (long long)(parts - 1) * k_per >= C)) ||
         pw_smem(C, cw, stages) > (size_t)kMaxSmemBytes;
}

cudaError_t pw_dw_bf16(const bf16* x, const bf16* w, const bf16* taps, bf16* out, int B, int H,
                       int W, int C, int M, const int* plan, cudaStream_t st) {
  if ((long long)B * H * W * M == 0) return cudaSuccess;
  if (C < 1 || bad_plan(C, M, plan)) return cudaErrorInvalidValue;
  const int cw = plan[kChunk], rows = plan[kRows], stages = plan[kStages];
  const int bands = (H + rows - 1) / rows;
  const dim3 grid((unsigned)((W + kPwCols - 1) / kPwCols), (unsigned)((M + cw - 1) / cw),
                  (unsigned)(B * bands));
  return by_instance(C, [&](auto r) {
    constexpr int R = decltype(r)::value;
    RCOT_TRY(allow<R>());
    pw_dw_kernel<R><<<grid, kPwThreads, pw_smem(C, cw, stages), st>>>(
        x, w, taps, out, H, W, C, M, plan[kVecC], plan[kVecOut], cw, rows, bands, stages,
        plan[kParts], plan[kKPer]);
    return cudaGetLastError();
  });
}

}  // namespace rcot_pwdw

extern "C" {

// The product-depthwise's instance for C at (cw, stages): the blocks an SM
// of the current device holds at once, its shared memory and its launch
// bound's blocks an SM, for ops/dwconv.py pw_dw_smem and pw_dw_per_sm.
int rcot_pw_dw_bf16_blocks_per_sm(int C, int cw, int stages, int* blocks, int* nbytes,
                                  int* least) {
  if (C < 1 || cw < 8 || cw % 8 != 0 || cw > kPwMaxChunk || stages < 2 || stages > 3)
    return cudaErrorInvalidValue;
  const size_t smem = pw_smem(C, cw, stages);
  *nbytes = (int)smem;
  *least = kPwBlocksPerSm;
  return by_instance(C, [&](auto r) {
    constexpr int R = decltype(r)::value;
    RCOT_TRY(allow<R>());
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, pw_dw_kernel<R>, kPwThreads,
                                                         smem);
  });
}

}  // extern "C"
