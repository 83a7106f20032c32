// Depthwise 3x3 SAME convolution for Hopper (sm_90a), bias-free, NHWC:
// the forward, its dx, and its dtaps.
//
// Replaces the TPU kernel of rcot_tpu/ops/pallas_dwconv.py, `_kernel`
// (:28-54) launched by dwconv3x3_fwd (pallas_call at :87):
//
//   out[b, y, x, c] = sum_{i, j in 0..2} taps[c, i, j] x[b, y + i - 1, x + j - 1, c]
//
// with zeros outside the image; taps are (C, 3, 3), the port's layout of a
// (C, 1, 3, 3) depthwise weight. The backward's dx is the same kernel on
// the cotangent with the taps rotated by 180 degrees (pallas_dwconv.py:
// 118-120); here the rotation is a template flag, so dx is one launch and
// no copy. The backward's dtaps, which the JAX package computes in jnp
// (pallas_dwconv.py:121-134),
//
//   dtaps[c, i, j] = sum_{b, y, x} g[b, y, x, c] x[b, y + i - 1, x + j - 1, c],
//
// is dwconv3x3_dtaps_kernel and a fixed-order reduce.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
// 18 flops per element against 8 bytes (the forward and dx read x and
// write out; dtaps reads x and g), so bytes bound all three: about 17 us
// at 3 x 128^2 x 144 channels (the qkv width at the first level in training).
//
// Design. Each block owns a tile of `tc` columns by `cv` channel vectors of
// V floats (V = 4, 2 or 1, the widest that divides C and keeps every row
// aligned; the wrapper picks it) and walks a band of rows of one image
// (grid: column tile, channel chunk, image x band). The plan comes from
// Python (ops/dwconv.py dwconv_tile, dwconv_rows): about three blocks an
// SM, on the longest bands that give them, since more blocks an SM on
// shorter bands ran slower on the card. Every input row of the band and
// its two halo rows, with a halo column on each side, goes through a
// four-stage cp.async ring in shared memory, 16 or 8 bytes a copy where V
// allows, each asking L2 for the 256 bytes around it; zero padding is the
// copy's zero fill, so nothing is padded in memory. Each input value is
// read from device memory once per band (the halo rows and columns again,
// mostly from L2), and each thread reads its left and right neighbours
// from shared memory. A thread owns one column-vector: the forward keeps
// its 9 V taps in registers (staged once per block, coalesced, and rotated
// for dx) and three output rows in flight, and stores an output row when
// its last input row has passed; dtaps keeps 9 V partial sums and a
// three-row window of g, and adds the 9 products of each input row. A
// dtaps block then adds its threads' partials over its columns in a fixed
// order and stores them to a workspace, and dwconv_reduce_kernel adds the
// blocks' partials in a fixed order: no atomics, no memset, the same bits
// on every call. No grid index needs a 64-bit division.
//
// bf16 (serving's bf16 block forward, block_fwd_bf16.cu): the forward also
// takes a bf16 x and bf16 taps (rcot_dwconv::conv_bf16), staged as bf16 in
// the same ring (copies of V = 8, 4 or 2 bf16: 16, 8 or 4 bytes), and
// accumulates in fp32 in the same order, writing fp32 (the tail's conv,
// which its gate reads unrounded, as the JAX kernel's) or bf16 (the head's
// qkv). The fp32 kernels keep their code.
//
// bf16 training's backward forms on bf16 tiles (block_bwd_bf16.cu's tail,
// fused_dwconv_bf16.cu's qkv): the rotated forward of an fp32 x on bf16
// taps (rcot_dwconv::conv_taps16) or of a bf16 x on bf16 taps, into fp32
// (conv_bf16_rot), and dtaps of a bf16 x with an fp32 or bf16 g
// (rcot_dwconv::dtaps_16: each stage's x rows and g row staged in their own
// types, 16-byte aligned apart where they differ), its fixed-order reduce
// rounding dtaps to bf16 once. Each widens its bf16 values exactly as they
// leave the ring or are staged, and takes the fp32 kernels' sums in their
// order: dtaps's bits follow only its tile's columns (tc) and band (rows),
// so the caller gives it the fp32 plan's. A bf16 operand that lies only
// 2-byte aligned takes 2-byte copies (V = 1), loaded and stored by the
// thread.
//
// bf16 in the standalone tier (row 11's bf16 forms: the JAX package passes
// the depthwise weight uncast there, rcot_tpu/ops/attention.py:112-114,
// gdfn.py:66-67, so its kernel multiplies widened bf16 values by fp32
// taps): the forward and dx take a bf16 x, fp32 taps (TW) and write bf16
// (rcot_dwconv::conv_w32); dtaps takes a bf16 x and g, staged as bf16 in
// its ring and widened as they leave it, and sums in fp32 in the same
// order into fp32 dtaps (rcot_dwconv::dtaps_w32), as the JAX backward
// sums its widened cotangent (pallas_dwconv.py:121-134).
//
// The gated depthwise of the bf16 tail and GDFN forwards (block_fwd_bf16.cu,
// fused_dwconv_bf16.cu; rcot_dwconv::conv_gate_bf16) takes the gate
// gelu(c1) c2 where the TPU kernels take it, from the fp32 conv in fast
// memory (pallas_block.py:135-138, pallas_fused.py:173-176): both halves of
// conv summed as the forward sums them, in registers, the gate rounded once
// to bf16; it reads h (4h bytes a pixel) and writes the gate (2 gate_ld),
// where a depthwise into fp32 conv and a gate pass moved 4h + 8h + 8h + 2
// gate_ld. Its copies stay 4 bytes wide at odd h (dwconv3x3_gate_kernel).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dwconv.cuh"
#include "tc.cuh"

namespace {

constexpr int kThreads = 256;  // the most threads (tc * cv) a block has
constexpr int kStages = 4;       // depth of the forward's cp.async ring of x rows
constexpr int kDtapsStages = 4;  // and of dtaps's ring of x and g rows
constexpr int kMaxVectors = 32;

#define RCOT_DW_TRY(expr)                    \
  do {                                       \
    cudaError_t err_ = (expr);               \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

// dst <- V elements at src, or zeros where !in (the source is not read);
// L2 fetches the 256 bytes around src. A single bf16 is loaded and stored
// by the thread (the ring's barriers order it as they order the copies).
template <int V, typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool in) {
  constexpr int B = V * (int)sizeof(T);
  const uint32_t to = smem_addr(dst);
  if constexpr (B == 2)
    *dst = in ? *src : from_f<T>(0.f);
  else if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src),
                 "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], %2, %3;\n" ::"r"(to), "l"(src),
                 "n"(B), "r"(in ? B : 0));
}
template <int V>
__device__ __forceinline__ void load_vec(float (&d)[V], const float* p) {
  if constexpr (V == 8) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    const float4 w = *reinterpret_cast<const float4*>(p + 4);
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w, d[4] = w.x, d[5] = w.y, d[6] = w.z,
    d[7] = w.w;
  } else if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x, d[1] = v.y;
  } else {
    d[0] = *p;
  }
}
// V (8, 4, 2 or 1) bf16 as floats; pairs of bf16 lie in 32-bit words
template <int V>
__device__ __forceinline__ void load_vec(float (&d)[V], const bf16* p) {
  if constexpr (V == 1) {
    d[0] = __bfloat162float(*p);
    return;
  }
  uint32_t w[V / 2 > 0 ? V / 2 : 1];
  if constexpr (V == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (V == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    d[2 * i] = f.x, d[2 * i + 1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&d)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(d[4], d[5], d[6], d[7]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  } else {
    *p = d[0];
  }
}
// V (8, 4, 2 or 1) floats rounded to bf16, stored in pairs
template <int V>
__device__ __forceinline__ void store_vec(bf16* p, const float (&d)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(d[0]);
    return;
  }
  uint32_t w[V / 2 > 0 ? V / 2 : 1];
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(d[2 * i], d[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  if constexpr (V == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (V == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}

// Bytes of n elements of T, rounded up to 16: where the forward's taps start
// after its ring (no rounding where cw is even in bf16, or in fp32).
template <typename T>
__host__ __device__ constexpr size_t ring_bytes(long long n) {
  return ((size_t)n * sizeof(T) + 15) / 16 * 16;
}

// A ring stage of dwconv3x3_dtaps_mixed_kernel, tc columns by cw channels:
// the tc + 2 bf16 x rows' pieces, then the fp32 g row (x_bytes on), each
// part 16-byte aligned, so that either copy width stays aligned.
struct MixedStage {
  __host__ __device__ static int x_bytes(int tc, int cw) {
    return ((tc + 2) * cw * (int)sizeof(bf16) + 15) / 16 * 16;
  }
  __host__ __device__ static int bytes(int tc, int cw) {
    return x_bytes(tc, cw) + (tc * cw * (int)sizeof(float) + 15) / 16 * 16;
  }
};

// Where a block sits and what each of its threads copies. Thread t owns
// column x0 + t / cv and channel vector t % cv of the chunk. A staged x row
// is (tc + 2) columns from x0 - 1 by cv vectors; piece i of it (column
// i / cv, vector i % cv) is copied by thread i % (tc cv), so each thread
// copies at most three (tc >= 1), at the same offsets in every row.
// Offsets count elements of T, the type of x.
template <int V, typename T = float>
struct Tile {
  int H, W, C, x0, c0, b, y0, n_out, j, v;
  long long row;  // floats per image row
  int s_off[3], g_off[3];
  bool ok[3];

  __device__ Tile(int H_, int W_, int C_, int cv, int tc, int rows, int bands)
      : H(H_), W(W_), C(C_) {
    row = (long long)W * C;
    x0 = blockIdx.x * tc;
    c0 = blockIdx.y * cv * V;
    b = blockIdx.z / bands;
    y0 = (blockIdx.z - b * bands) * rows;
    n_out = min(rows, H - y0);
    j = threadIdx.x / cv;
    v = threadIdx.x - j * cv;
    const int nt = tc * cv, pieces = (tc + 2) * cv;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = threadIdx.x + k * nt;
      const int col = i / cv, gx = x0 - 1 + col, gc = c0 + (i - col * cv) * V;
      s_off[k] = i < pieces ? i * V : -1;
      ok[k] = gx >= 0 && gx < W && gc < C;
      g_off[k] = ok[k] ? gx * C + gc : 0;
    }
  }

  // x row y0 - 1 + r (zeros outside the image) into `dst`
  __device__ __forceinline__ void stage_x(T* dst, const T* img, int r) const {
    const int y = y0 - 1 + r;
    const bool in_row = y >= 0 && y < H;
    const T* src = img + (in_row ? y * row : 0);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (s_off[k] >= 0) cp_async<V>(dst + s_off[k], src + g_off[k], in_row && ok[k]);
  }

  __device__ __forceinline__ bool active() const {
    return x0 + j < W && c0 + v * V < C;
  }
};

// The forward (ROT false) or dx (ROT true: taps rotated by 180 degrees);
// x of type TI, taps of type TW (TI unless given), out of type TO (float,
// or bf16 in and fp32 or bf16 out), fp32 arithmetic.
template <int V, bool ROT, typename TI = float, typename TO = float, typename TW = TI>
__global__ void __launch_bounds__(kThreads)
dwconv3x3_kernel(const TI* __restrict__ x, const TW* __restrict__ taps,
                 TO* __restrict__ out, int H, int W, int C, int cv, int tc, int rows,
                 int bands) {
  extern __shared__ __align__(16) float smem[];
  const Tile<V, TI> t(H, W, C, cv, tc, rows, bands);
  const int nt = tc * cv, cw = cv * V, ld = (tc + 2) * cw;
  TI* ring = reinterpret_cast<TI*>(smem);
  // 9 rows of cw floats, tap-major, past the ring (16-byte aligned)
  float* s_taps = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                           ring_bytes<TI>(kStages * ld));
  const TI* img = x + (long long)t.b * H * t.row;
  const int n_in = t.n_out + 2;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_in) t.stage_x(ring + s * ld, img, s);
    cp_commit();
  }
  // the chunk's taps: 9 * cc contiguous floats, read once, coalesced
  const int cc = min(cw, C - t.c0);
  for (int f = threadIdx.x; f < 9 * cc; f += nt)
    s_taps[(f % 9) * cw + f / 9] = to_f(taps[9LL * t.c0 + f]);
  __syncthreads();
  float w[9][V];
#pragma unroll
  for (int k = 0; k < 9; ++k) load_vec<V>(w[ROT ? 8 - k : k], s_taps + k * cw + t.v * V);

  const bool active = t.active();
  TO* dst = out + (long long)t.b * H * t.row + (long long)t.y0 * t.row + (t.x0 + t.j) * C +
            t.c0 + t.v * V;
  // acc0, acc1, acc2: output rows y + 1, y, y - 1 of input row y
  float acc0[V], acc1[V], acc2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc0[e] = acc1[e] = acc2[e] = 0.f;
  for (int r = 0; r < n_in; ++r) {
    cp_wait<kStages - 2>();
    __syncthreads();  // row r is in; every thread is done with row r - 1's slot
    if (r + kStages - 1 < n_in) t.stage_x(ring + ((r + kStages - 1) % kStages) * ld, img,
                                         r + kStages - 1);
    cp_commit();
    const TI* s = ring + (r % kStages) * ld + (t.j * cv + t.v) * V;
    float l[V], m[V], rt[V];
    load_vec<V>(l, s);
    load_vec<V>(m, s + cw);
    load_vec<V>(rt, s + 2 * cw);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc0[e] = fmaf(w[0][e], l[e], fmaf(w[1][e], m[e], fmaf(w[2][e], rt[e], acc0[e])));
      acc1[e] = fmaf(w[3][e], l[e], fmaf(w[4][e], m[e], fmaf(w[5][e], rt[e], acc1[e])));
      acc2[e] = fmaf(w[6][e], l[e], fmaf(w[7][e], m[e], fmaf(w[8][e], rt[e], acc2[e])));
    }
    if (r >= 2 && active) store_vec<V>(dst + (long long)(r - 2) * t.row, acc2);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc2[e] = acc1[e];
      acc1[e] = acc0[e];
      acc0[e] = 0.f;
    }
  }
}

// dtaps partials: block (tile, chunk, image x band) sums its pixels and
// stores 9 floats per channel of its chunk at ws[part * 9C + 9c + tap],
// part = (b * bands + band) * tiles + tile; x and g of type TI (float, or
// bf16 widened as they leave the ring).
template <int V, typename TI = float>
__global__ void __launch_bounds__(kThreads)
dwconv3x3_dtaps_kernel(const TI* __restrict__ x, const TI* __restrict__ g,
                       float* __restrict__ ws, int H, int W, int C, int cv, int tc, int rows,
                       int bands) {
  extern __shared__ __align__(16) float smem[];
  const Tile<V, TI> t(H, W, C, cv, tc, rows, bands);
  TI* ring = reinterpret_cast<TI*>(smem);
  const int cw = cv * V, ldx = (tc + 2) * cw, ld = ldx + tc * cw;
  const long long img_off = (long long)t.b * H * t.row;
  const TI* img = x + img_off;
  // each thread copies its own g vector: row y0 + r of the band
  const bool own = t.active();
  const TI* g_src = g + img_off + (long long)t.y0 * t.row +
                    (own ? (t.x0 + t.j) * C + t.c0 + t.v * V : 0);
  const int g_slot = ldx + threadIdx.x * V;
  const int n_in = t.n_out + 2;
  auto stage = [&](int r) {
    TI* dst = ring + (r % kDtapsStages) * ld;
    t.stage_x(dst, img, r);
    if (r < t.n_out) cp_async<V>(dst + g_slot, g_src + (own ? r * t.row : 0), own);
  };

#pragma unroll
  for (int s = 0; s < kDtapsStages - 1; ++s) {
    if (s < n_in) stage(s);
    cp_commit();
  }
  // acc[i][k][e]: tap (i, k) of channel c0 + v V + e; gp, g0, gm: g rows
  // y + 1, y, y - 1 of input row y (zeros outside the band)
  float acc[3][3][V], gp[V], g0[V], gm[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    g0[e] = gm[e] = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k / 3][k % 3][e] = 0.f;
  }
  for (int r = 0; r < n_in; ++r) {
    cp_wait<kDtapsStages - 2>();
    __syncthreads();
    if (r + kDtapsStages - 1 < n_in) stage(r + kDtapsStages - 1);
    cp_commit();
    const TI* slot = ring + (r % kDtapsStages) * ld;
    const TI* s = slot + (t.j * cv + t.v) * V;
    float xv[3][V];
    load_vec<V>(xv[0], s);
    load_vec<V>(xv[1], s + cw);
    load_vec<V>(xv[2], s + 2 * cw);
    if (r < t.n_out) {
      load_vec<V>(gp, slot + g_slot);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) gp[e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc[0][k][e] = fmaf(gp[e], xv[k][e], acc[0][k][e]);
        acc[1][k][e] = fmaf(g0[e], xv[k][e], acc[1][k][e]);
        acc[2][k][e] = fmaf(gm[e], xv[k][e], acc[2][k][e]);
      }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      gm[e] = g0[e];
      g0[e] = gp[e];
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it becomes red[tc][9 cw]
  float* red = smem + t.j * 9 * cw + t.v * V * 9;
#pragma unroll
  for (int e = 0; e < V; ++e)
#pragma unroll
    for (int k = 0; k < 9; ++k) red[e * 9 + k] = acc[k / 3][k % 3][e];
  __syncthreads();
  const int n = 9 * min(cw, C - t.c0);
  const int part = blockIdx.z * gridDim.x + blockIdx.x;
  float* dst = ws + (long long)part * 9 * C + 9 * t.c0;
  for (int o = threadIdx.x; o < n; o += tc * cv) {
    float sum = 0.f;
    for (int jj = 0; jj < tc; ++jj) sum += smem[jj * 9 * cw + o];
    dst[o] = sum;
  }
}

// dtaps partials of a bf16 x and an fp32 g (bf16 training's tail backward:
// its recomputed bf16 h with the fp32 dconv), as dwconv3x3_dtaps_kernel
// takes them: the same partials in the same order, the ring's stages
// MixedStage's (the x rows' pieces, then 16-byte aligned the g row). A
// kernel of its own: the one-type kernels' registers decide their plans'
// bands (ops/dwconv.py dwconv_rows), and the bands their sums' order, so
// they keep their code.
template <int V>
__global__ void __launch_bounds__(kThreads)
dwconv3x3_dtaps_mixed_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                             float* __restrict__ ws, int H, int W, int C, int cv, int tc,
                             int rows, int bands) {
  extern __shared__ __align__(16) float smem[];
  const Tile<V, bf16> t(H, W, C, cv, tc, rows, bands);
  char* ring = reinterpret_cast<char*>(smem);
  const int cw = cv * V, xb = MixedStage::x_bytes(tc, cw), sb = MixedStage::bytes(tc, cw);
  const long long img_off = (long long)t.b * H * t.row;
  const bf16* img = x + img_off;
  // each thread copies its own g vector: row y0 + r of the band
  const bool own = t.active();
  const float* g_src = g + img_off + (long long)t.y0 * t.row +
                       (own ? (t.x0 + t.j) * C + t.c0 + t.v * V : 0);
  const int g_slot = threadIdx.x * V;
  const int n_in = t.n_out + 2;
  auto stage = [&](int r) {
    char* dst = ring + (r % kDtapsStages) * sb;
    t.stage_x(reinterpret_cast<bf16*>(dst), img, r);
    if (r < t.n_out)
      cp_async<V>(reinterpret_cast<float*>(dst + xb) + g_slot, g_src + (own ? r * t.row : 0),
                  own);
  };

#pragma unroll
  for (int s = 0; s < kDtapsStages - 1; ++s) {
    if (s < n_in) stage(s);
    cp_commit();
  }
  float acc[3][3][V], gp[V], g0[V], gm[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    g0[e] = gm[e] = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k / 3][k % 3][e] = 0.f;
  }
  for (int r = 0; r < n_in; ++r) {
    cp_wait<kDtapsStages - 2>();
    __syncthreads();
    if (r + kDtapsStages - 1 < n_in) stage(r + kDtapsStages - 1);
    cp_commit();
    const char* slot = ring + (r % kDtapsStages) * sb;
    const bf16* s = reinterpret_cast<const bf16*>(slot) + (t.j * cv + t.v) * V;
    float xv[3][V];
    load_vec<V>(xv[0], s);
    load_vec<V>(xv[1], s + cw);
    load_vec<V>(xv[2], s + 2 * cw);
    if (r < t.n_out) {
      load_vec<V>(gp, reinterpret_cast<const float*>(slot + xb) + g_slot);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) gp[e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc[0][k][e] = fmaf(gp[e], xv[k][e], acc[0][k][e]);
        acc[1][k][e] = fmaf(g0[e], xv[k][e], acc[1][k][e]);
        acc[2][k][e] = fmaf(gm[e], xv[k][e], acc[2][k][e]);
      }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      gm[e] = g0[e];
      g0[e] = gp[e];
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it becomes red[tc][9 cw]
  float* red = smem + t.j * 9 * cw + t.v * V * 9;
#pragma unroll
  for (int e = 0; e < V; ++e)
#pragma unroll
    for (int k = 0; k < 9; ++k) red[e * 9 + k] = acc[k / 3][k % 3][e];
  __syncthreads();
  const int n = 9 * min(cw, C - t.c0);
  const int part = blockIdx.z * gridDim.x + blockIdx.x;
  float* dst = ws + (long long)part * 9 * C + 9 * t.c0;
  for (int o = threadIdx.x; o < n; o += tc * cv) {
    float sum = 0.f;
    for (int jj = 0; jj < tc; ++jj) sum += smem[jj * 9 * cw + o];
    dst[o] = sum;
  }
}

// The gated depthwise of the bf16 forwards (rcot_dwconv::conv_gate_bf16):
// [c1 | c2] = dw3x3(x) of a bf16 x (B, H, W, 2 hid) on bf16 taps, then
// gate = bf16(gelu(c1) c2) in rows of ld_gate bf16, zeros past hid. Block
// (tile, chunk, image x band) as dwconv3x3_kernel's, over ld_gate channels
// in vectors of kGateVec, its tile 2 tc columns wide: thread (j, v) owns
// channels c = c0 + v V.. of c1 and hid + c.. of c2 at the two columns
// x0 + 2j and x0 + 2j + 1, which share the middle two of the four input
// columns they read and the taps, keeps both halves' 9 V taps and three
// rows of each column in flight, and stores a gate row when its last
// input row has passed. Each of c1 and c2 is dwconv3x3_kernel's sum in its
// order, so the gate's inputs are conv_bf16's fp32 conv bit for bit; conv
// never leaves the SM. A ring stage holds (2 tc + 2) rows of c1's chunk
// (cw bf16) and then (2 tc + 2) of c2's (cw + V: at odd hid c2 starts one
// bf16 past a 4-byte column, and kGateShift stages it from that column
// with V-wide copies, one piece more a row, and reads it one element on).
enum GateMode { kGateAligned, kGateShift };
constexpr int kGateVec = 2;          // bf16 a vector (a copy of c1: 4 bytes)
constexpr int kGateCols = 2;         // output columns a thread
constexpr int kGateBlocksPerSm = 2;  // the launch bound (ops/dwconv.py GATE_BLOCKS_PER_SM)

__host__ __device__ constexpr int gate_slot(int cv, int tc) {  // bf16 a ring stage
  return (kGateCols * tc + 2) * (2 * cv * kGateVec + kGateVec);
}

// one half's FMAs at one input row, for both columns: a* (output rows y +
// 1, y, y - 1 of input row y) of the left column from inputs 0-2, b* of the
// right from 1-3, dwconv3x3_kernel's chains
template <int V>
__device__ __forceinline__ void gate_fmas(const float (&w)[9][V], const float (&in)[4][V],
                                          float (&a0)[V], float (&a1)[V], float (&a2)[V],
                                          float (&b0)[V], float (&b1)[V], float (&b2)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    a0[e] = fmaf(w[0][e], in[0][e], fmaf(w[1][e], in[1][e], fmaf(w[2][e], in[2][e], a0[e])));
    a1[e] = fmaf(w[3][e], in[0][e], fmaf(w[4][e], in[1][e], fmaf(w[5][e], in[2][e], a1[e])));
    a2[e] = fmaf(w[6][e], in[0][e], fmaf(w[7][e], in[1][e], fmaf(w[8][e], in[2][e], a2[e])));
    b0[e] = fmaf(w[0][e], in[1][e], fmaf(w[1][e], in[2][e], fmaf(w[2][e], in[3][e], b0[e])));
    b1[e] = fmaf(w[3][e], in[1][e], fmaf(w[4][e], in[2][e], fmaf(w[5][e], in[3][e], b1[e])));
    b2[e] = fmaf(w[6][e], in[1][e], fmaf(w[7][e], in[2][e], fmaf(w[8][e], in[3][e], b2[e])));
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, kGateBlocksPerSm)
dwconv3x3_gate_kernel(const bf16* __restrict__ x, const bf16* __restrict__ taps,
                      bf16* __restrict__ gate, int H, int W, int hid, int ld_gate, int cv,
                      int tc, int rows, int bands) {
  constexpr int V = kGateVec;
  extern __shared__ __align__(16) float smem[];
  const int nt = tc * cv, cw = cv * V, ld2 = cw + V, cols = kGateCols * tc + 2;
  const int c2_at = cols * cw, slot = gate_slot(cv, tc), d = MODE == kGateShift ? hid % V : 0;
  const long long pix = 2LL * hid, row = (long long)W * pix;
  const int x0 = blockIdx.x * kGateCols * tc, c0 = blockIdx.y * cw;
  const int b = blockIdx.z / bands, y0 = (blockIdx.z - b * bands) * rows;
  const int n_out = min(rows, H - y0), n_in = n_out + 2;
  const int j = threadIdx.x / cv, v = threadIdx.x - j * cv;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  // 18 rows of cw floats, tap-major, c1's then c2's, past the ring
  float* s_taps = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                           ring_bytes<bf16>(kStages * slot));
  const bf16* img = x + (long long)b * H * row;

  // piece i = threadIdx.x + k nt of a staged row (column i / cv, vector i %
  // cv, as Tile's): c1's at i V, c2's of the same column and vector at
  // c2_at + column ld2 + vector V; a thread copies at most four of each
  // ((2 tc + 2) cv pieces for tc cv threads); g < 0: outside
  int s1[4], s2[4], g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = threadIdx.x + k * nt, col = i / cv, gx = x0 - 1 + col;
    const int gc = c0 + (i - col * cv) * V;
    s1[k] = i < cols * cv ? i * V : -1;
    s2[k] = c2_at + i * V + col * V;
    g[k] = gx >= 0 && gx < W && gc < hid ? gx * (int)pix + gc : -1;
  }
  auto stage = [&](int r) {
    bf16* dst = ring + (r % kStages) * slot;
    const int y = y0 - 1 + r;
    const bool in_row = y >= 0 && y < H;
    const bf16* src = img + (in_row ? y * row : 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (s1[k] < 0) continue;
      const bool in = in_row && g[k] >= 0;
      const int at = in ? g[k] : 0;
      cp_async<V>(dst + s1[k], src + at, in);
      cp_async<V>(dst + s2[k], src + at + hid - d, in);
    }
    if constexpr (MODE == kGateShift) {
      // c2's last piece of each column, past the chunk: channels c0 + cw - d..
      for (int col = threadIdx.x; col < cols; col += nt) {
        const int gx = x0 - 1 + col;
        const bool in = in_row && gx >= 0 && gx < W && c0 + cw + V <= hid + d;
        cp_async<V>(dst + c2_at + col * ld2 + cw,
                    src + (in ? gx * (int)pix + hid - d + c0 + cw : 0), in);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_in) stage(s);
    cp_commit();
  }
  // the chunk's taps of c1 and of c2: 9 * cc contiguous bf16 each, coalesced
  const int cc = max(0, min(cw, hid - c0));
  for (int f = threadIdx.x; f < 9 * cc; f += nt) {
    s_taps[(f % 9) * cw + f / 9] = to_f(taps[9LL * c0 + f]);
    s_taps[(9 + f % 9) * cw + f / 9] = to_f(taps[9LL * (hid + c0) + f]);
  }
  __syncthreads();
  float w1[9][V], w2[9][V];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    load_vec<V>(w1[k], s_taps + k * cw + v * V);
    load_vec<V>(w2[k], s_taps + (9 + k) * cw + v * V);
  }

  const int c = c0 + v * V, xl = x0 + kGateCols * j;
  const bool on = c < ld_gate, left = on && xl < W, right = on && xl + 1 < W;
  bf16* dst = gate + ((long long)b * H + y0) * W * ld_gate + (long long)xl * ld_gate + c;
  // c1's (p) and c2's (q) rows in flight: *a the left column's, *b the right's
  float pa0[V], pa1[V], pa2[V], pb0[V], pb1[V], pb2[V];
  float qa0[V], qa1[V], qa2[V], qb0[V], qb1[V], qb2[V];
#pragma unroll
  for (int e = 0; e < V; ++e)
    pa0[e] = pa1[e] = pa2[e] = pb0[e] = pb1[e] = pb2[e] = qa0[e] = qa1[e] = qa2[e] = qb0[e] =
        qb1[e] = qb2[e] = 0.f;
  for (int r = 0; r < n_in; ++r) {
    cp_wait<kStages - 2>();
    __syncthreads();  // row r is in; every thread is done with row r - 1's slot
    if (r + kStages - 1 < n_in) stage(r + kStages - 1);
    cp_commit();
    const bf16* s = ring + (r % kStages) * slot;
    float in[4][V];
#pragma unroll
    for (int q = 0; q < 4; ++q) load_vec<V>(in[q], s + ((kGateCols * j + q) * cv + v) * V);
    gate_fmas<V>(w1, in, pa0, pa1, pa2, pb0, pb1, pb2);
    const bf16* s2p = s + c2_at + kGateCols * j * ld2 + v * V + d;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (MODE == kGateShift) {  // 2-byte aligned: a bf16 a load
#pragma unroll
        for (int e = 0; e < V; ++e) in[q][e] = to_f(s2p[q * ld2 + e]);
      } else {
        load_vec<V>(in[q], s2p + q * ld2);
      }
    }
    gate_fmas<V>(w2, in, qa0, qa1, qa2, qb0, qb1, qb2);
    if (r >= 2) {
      float ga[V], gb[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ga[e] = c + e < hid ? gate_fwd(pa2[e], qa2[e]) : 0.f;
        gb[e] = c + e < hid ? gate_fwd(pb2[e], qb2[e]) : 0.f;
      }
      bf16* out = dst + (long long)(r - 2) * W * ld_gate;
      if (left) store_vec<V>(out, ga);
      if (right) store_vec<V>(out + ld_gate, gb);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      pa2[e] = pa1[e], pa1[e] = pa0[e], pa0[e] = 0.f;
      pb2[e] = pb1[e], pb1[e] = pb0[e], pb0[e] = 0.f;
      qa2[e] = qa1[e], qa1[e] = qa0[e], qa0[e] = 0.f;
      qb2[e] = qb1[e], qb1[e] = qb0[e], qb0[e] = 0.f;
    }
  }
}

// out[e] = sum over parts p of ws[p * E + e]: warp w adds parts w, w + W,
// ... in order, then warp 0 adds the W warps' sums in order; a bf16 out
// takes the sum rounded once.
constexpr int kReduceWarps = 16;

template <typename TO = float>
__global__ void __launch_bounds__(32 * kReduceWarps)
dwconv_reduce_kernel(const float* __restrict__ ws, TO* __restrict__ out, int E, int parts) {
  __shared__ float part[kReduceWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (e < E) {
#pragma unroll 8
    for (int p = w; p < parts; p += W) v += ws[(long long)p * E + e];
  }
  part[w][lane] = v;
  __syncthreads();
  if (w != 0 || e >= E) return;
  float sum = 0.f;
  for (int i = 0; i < W; ++i) sum += part[i][lane];
  out[e] = from_f<TO>(sum);
}

// bf16: vec 8, 4 or 2 (and 1 with one16, the forms that take 2-byte copies)
bool bad_plan(int C, int vec, int cv, int tc, int rows, bool bf16 = false, bool one16 = false) {
  const bool vec_ok = bf16 ? vec == 2 || vec == 4 || vec == 8 || (one16 && vec == 1)
                           : vec == 1 || vec == 2 || vec == 4;
  return !vec_ok || C % vec != 0 || cv < 1 || cv > kMaxVectors || tc < 1 ||
         tc * cv > kThreads || rows < 1;
}

dim3 grid_of(int B, int H, int W, int C, int vec, int cv, int tc, int rows) {
  const int chunks = (C / vec + cv - 1) / cv, bands = (H + rows - 1) / rows;
  return dim3((unsigned)((W + tc - 1) / tc), (unsigned)chunks, (unsigned)(B * bands));
}

// the ring of x rows (elements of TI) and, 16-byte aligned after it, the
// taps (floats)
template <typename TI = float>
size_t fwd_smem(int vec, int cv, int tc) {
  return ring_bytes<TI>(kStages * (tc + 2) * cv * vec) + sizeof(float) * 9 * cv * vec;
}

// the ring of x and g rows (elements of TI), then the partials (floats)
template <typename TI = float>
size_t dtaps_smem(int vec, int cv, int tc) {
  const size_t ring = sizeof(TI) * kDtapsStages * (2 * tc + 2) * cv * vec,
               red = sizeof(float) * 9 * tc * cv * vec;
  return ring > red ? ring : red;
}

// the same for the mixed kernel (bf16 x, fp32 g)
size_t dtaps_mixed_smem(int vec, int cv, int tc) {
  const size_t ring = (size_t)kDtapsStages * MixedStage::bytes(tc, cv * vec),
               red = sizeof(float) * 9 * tc * cv * vec;
  return ring > red ? ring : red;
}

// the gated depthwise's ring and, 16-byte aligned after it, its 18 rows of
// taps (floats); ops/dwconv.py conv_gate_smem
size_t gate_smem(int cv, int tc) {
  return ring_bytes<bf16>((long long)kStages * gate_slot(cv, tc)) +
         sizeof(float) * 18 * cv * kGateVec;
}

// the gated depthwise's mode at this hid: c2 aligned with c1 where hid is
// even, else shifted copies
int gate_mode(int hid) { return hid % kGateVec == 0 ? kGateAligned : kGateShift; }

template <int V, bool ROT, typename TI = float, typename TO = float, typename TW = TI>
void launch_fwd(const TI* x, const TW* taps, TO* out, int B, int H, int W, int C,
                int cv, int tc, int rows, cudaStream_t st) {
  dwconv3x3_kernel<V, ROT, TI, TO, TW><<<grid_of(B, H, W, C, V, cv, tc, rows), tc * cv,
                                         fwd_smem<TI>(V, cv, tc), st>>>(
      x, taps, out, H, W, C, cv, tc, rows, (H + rows - 1) / rows);
}

// the bf16 forward with V bf16 a copy, into fp32 or bf16
template <int V>
void launch_fwd_bf16(const bf16* x, const bf16* taps, void* out, bool out_bf16, int B, int H,
                     int W, int C, int cv, int tc, int rows, cudaStream_t st) {
  if (out_bf16)
    launch_fwd<V, false>(x, taps, static_cast<bf16*>(out), B, H, W, C, cv, tc, rows, st);
  else
    launch_fwd<V, false>(x, taps, static_cast<float*>(out), B, H, W, C, cv, tc, rows, st);
}

template <int V, typename TI = float>
void launch_dtaps(const TI* x, const TI* g, float* ws, int B, int H, int W, int C,
                  int cv, int tc, int rows, cudaStream_t st) {
  dwconv3x3_dtaps_kernel<V, TI><<<grid_of(B, H, W, C, V, cv, tc, rows), tc * cv,
                                  dtaps_smem<TI>(V, cv, tc), st>>>(x, g, ws, H, W, C, cv, tc,
                                                                   rows, (H + rows - 1) / rows);
}

template <int V>
void launch_dtaps(const bf16* x, const float* g, float* ws, int B, int H, int W, int C,
                  int cv, int tc, int rows, cudaStream_t st) {
  dwconv3x3_dtaps_mixed_kernel<V><<<grid_of(B, H, W, C, V, cv, tc, rows), tc * cv,
                                    dtaps_mixed_smem(V, cv, tc), st>>>(
      x, g, ws, H, W, C, cv, tc, rows, (H + rows - 1) / rows);
}

// dtaps's fixed-order reduce of the blocks' partials, after the launch of
// dwconv3x3_dtaps_kernel (its error is returned first)
template <typename TO = float>
cudaError_t reduce_dtaps(const float* ws, TO* dtaps, int B, int H, int W, int C, int vec,
                         int cv, int tc, int rows, cudaStream_t st) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_of(B, H, W, C, vec, cv, tc, rows);
  const int parts = (int)(grid.x * grid.z), warps = parts < kReduceWarps ? parts : kReduceWarps;
  dwconv_reduce_kernel<TO><<<(unsigned)((9 * C + 31) / 32), 32 * warps, 0, st>>>(
      ws, dtaps, 9 * C, parts);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t occupancy(int* blocks, Kernel k, int threads, size_t smem) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, threads, smem);
}

// dtaps on bf16 sums twice the channels a block of fp32's (a copy moves 8
// bf16), and its 9 partials a channel pass 48 KB of shared memory at 256
// threads: its kernels may take what an SM gives a block, once per device.
template <int V>
cudaError_t allow_dtaps_w32_v() {
  static bool done[kMaxDevices];
  const auto k = dwconv3x3_dtaps_kernel<V, bf16>;
  return allow_smem(done, k, k, kMaxSmemBytes / (int)sizeof(float));
}

cudaError_t allow_dtaps_w32() {
  cudaError_t e = allow_dtaps_w32_v<8>();
  if (e == cudaSuccess) e = allow_dtaps_w32_v<4>();
  if (e == cudaSuccess) e = allow_dtaps_w32_v<2>();
  return e;
}

// dtaps on a bf16 x (dtaps_16) with V elements a copy and g of type TG,
// rounded to bf16; its partials may pass 48 KB, as dtaps_w32's
template <int V, typename TG>
cudaError_t dtaps_16_v(const bf16* x, const TG* g, float* ws, bf16* dtaps, int B, int H, int W,
                       int C, int cv, int tc, int rows, cudaStream_t st) {
  static bool done[kMaxDevices];
  if constexpr (sizeof(TG) == 2) {
    const auto k = dwconv3x3_dtaps_kernel<V, bf16>;
    RCOT_DW_TRY(allow_smem(done, k, k, kMaxSmemBytes / (int)sizeof(float)));
  } else {
    const auto k = dwconv3x3_dtaps_mixed_kernel<V>;
    RCOT_DW_TRY(allow_smem(done, k, k, kMaxSmemBytes / (int)sizeof(float)));
  }
  launch_dtaps<V>(x, g, ws, B, H, W, C, cv, tc, rows, st);
  return reduce_dtaps(ws, dtaps, B, H, W, C, V, cv, tc, rows, st);
}

}  // namespace

namespace rcot_dwconv {

cudaError_t conv(const float* x, const float* taps, float* out, int B, int H, int W, int C,
                 int vec, int cv, int tc, int rows, bool rot, cudaStream_t st) {
  if ((long long)B * H * W * C == 0) return cudaSuccess;
  if (bad_plan(C, vec, cv, tc, rows)) return cudaErrorInvalidValue;
  if (vec == 4)
    rot ? launch_fwd<4, true>(x, taps, out, B, H, W, C, cv, tc, rows, st)
        : launch_fwd<4, false>(x, taps, out, B, H, W, C, cv, tc, rows, st);
  else if (vec == 2)
    rot ? launch_fwd<2, true>(x, taps, out, B, H, W, C, cv, tc, rows, st)
        : launch_fwd<2, false>(x, taps, out, B, H, W, C, cv, tc, rows, st);
  else
    rot ? launch_fwd<1, true>(x, taps, out, B, H, W, C, cv, tc, rows, st)
        : launch_fwd<1, false>(x, taps, out, B, H, W, C, cv, tc, rows, st);
  return cudaGetLastError();
}

cudaError_t conv_bf16(const bf16* x, const bf16* taps, void* out, bool out_bf16, int B, int H,
                      int W, int C, int vec, int cv, int tc, int rows, cudaStream_t st) {
  if ((long long)B * H * W * C == 0) return cudaSuccess;
  if (bad_plan(C, vec, cv, tc, rows, true)) return cudaErrorInvalidValue;
  if (vec == 8)
    launch_fwd_bf16<8>(x, taps, out, out_bf16, B, H, W, C, cv, tc, rows, st);
  else if (vec == 4)
    launch_fwd_bf16<4>(x, taps, out, out_bf16, B, H, W, C, cv, tc, rows, st);
  else
    launch_fwd_bf16<2>(x, taps, out, out_bf16, B, H, W, C, cv, tc, rows, st);
  return cudaGetLastError();
}

cudaError_t conv_gate_bf16(const bf16* x, const bf16* taps, bf16* gate, int B, int H, int W,
                           int hid, int ld_gate, int vec, int cv, int tc, int rows,
                           cudaStream_t st) {
  if ((long long)B * H * W * hid == 0) return cudaSuccess;
  if (vec != kGateVec || ld_gate < hid || ld_gate % 8 != 0 ||
      bad_plan(ld_gate, vec, cv, tc, rows, true))
    return cudaErrorInvalidValue;
  // blocks of kGateCols tc columns
  const dim3 grid = grid_of(B, H, (W + kGateCols - 1) / kGateCols, ld_gate, vec, cv, tc, rows);
  const size_t smem = gate_smem(cv, tc);
  const int bands = (H + rows - 1) / rows;
#define RCOT_GATE(M)                                                                     \
  dwconv3x3_gate_kernel<M><<<grid, tc * cv, smem, st>>>(x, taps, gate, H, W, hid, ld_gate, \
                                                        cv, tc, rows, bands)
  if (gate_mode(hid) == kGateAligned)
    RCOT_GATE(kGateAligned);
  else
    RCOT_GATE(kGateShift);
#undef RCOT_GATE
  return cudaGetLastError();
}

cudaError_t dtaps(const float* x, const float* g, float* ws, float* dtaps, int B, int H, int W,
                  int C, int vec, int cv, int tc, int rows, cudaStream_t st) {
  if (C == 0) return cudaSuccess;
  if ((long long)B * H * W == 0 || bad_plan(C, vec, cv, tc, rows)) return cudaErrorInvalidValue;
  if (vec == 4)
    launch_dtaps<4>(x, g, ws, B, H, W, C, cv, tc, rows, st);
  else if (vec == 2)
    launch_dtaps<2>(x, g, ws, B, H, W, C, cv, tc, rows, st);
  else
    launch_dtaps<1>(x, g, ws, B, H, W, C, cv, tc, rows, st);
  return reduce_dtaps(ws, dtaps, B, H, W, C, vec, cv, tc, rows, st);
}

cudaError_t conv_taps16(const float* x, const bf16* taps, float* out, int B, int H, int W,
                        int C, int vec, int cv, int tc, int rows, bool rot, cudaStream_t st) {
  if ((long long)B * H * W * C == 0) return cudaSuccess;
  if (bad_plan(C, vec, cv, tc, rows)) return cudaErrorInvalidValue;
#define RCOT_FWD(V)                                                            \
  (rot ? launch_fwd<V, true>(x, taps, out, B, H, W, C, cv, tc, rows, st)       \
       : launch_fwd<V, false>(x, taps, out, B, H, W, C, cv, tc, rows, st))
  if (vec == 4)
    RCOT_FWD(4);
  else if (vec == 2)
    RCOT_FWD(2);
  else
    RCOT_FWD(1);
#undef RCOT_FWD
  return cudaGetLastError();
}

cudaError_t conv_bf16_rot(const bf16* x, const bf16* taps, float* out, int B, int H, int W,
                          int C, int vec, int cv, int tc, int rows, cudaStream_t st) {
  if ((long long)B * H * W * C == 0) return cudaSuccess;
  if (bad_plan(C, vec, cv, tc, rows, true, true)) return cudaErrorInvalidValue;
  if (vec == 8)
    launch_fwd<8, true>(x, taps, out, B, H, W, C, cv, tc, rows, st);
  else if (vec == 4)
    launch_fwd<4, true>(x, taps, out, B, H, W, C, cv, tc, rows, st);
  else if (vec == 2)
    launch_fwd<2, true>(x, taps, out, B, H, W, C, cv, tc, rows, st);
  else
    launch_fwd<1, true>(x, taps, out, B, H, W, C, cv, tc, rows, st);
  return cudaGetLastError();
}

cudaError_t dtaps_16(const bf16* x, const void* g, bool g_bf16, float* ws, bf16* dtaps, int B,
                     int H, int W, int C, int vec, int cv, int tc, int rows, cudaStream_t st) {
  if (C == 0) return cudaSuccess;
  if ((long long)B * H * W == 0 || bad_plan(C, vec, cv, tc, rows, true, true) ||
      (!g_bf16 && vec == 8))
    return cudaErrorInvalidValue;
  if (g_bf16) {
    const bf16* gb = static_cast<const bf16*>(g);
    return vec == 8   ? dtaps_16_v<8>(x, gb, ws, dtaps, B, H, W, C, cv, tc, rows, st)
           : vec == 4 ? dtaps_16_v<4>(x, gb, ws, dtaps, B, H, W, C, cv, tc, rows, st)
           : vec == 2 ? dtaps_16_v<2>(x, gb, ws, dtaps, B, H, W, C, cv, tc, rows, st)
                      : dtaps_16_v<1>(x, gb, ws, dtaps, B, H, W, C, cv, tc, rows, st);
  }
  const float* gf = static_cast<const float*>(g);
  return vec == 4   ? dtaps_16_v<4>(x, gf, ws, dtaps, B, H, W, C, cv, tc, rows, st)
         : vec == 2 ? dtaps_16_v<2>(x, gf, ws, dtaps, B, H, W, C, cv, tc, rows, st)
                    : dtaps_16_v<1>(x, gf, ws, dtaps, B, H, W, C, cv, tc, rows, st);
}

cudaError_t conv_w32(const bf16* x, const float* taps, bf16* out, int B, int H, int W, int C,
                     int vec, int cv, int tc, int rows, bool rot, cudaStream_t st) {
  if ((long long)B * H * W * C == 0) return cudaSuccess;
  if (bad_plan(C, vec, cv, tc, rows, true)) return cudaErrorInvalidValue;
#define RCOT_FWD(V)                                                            \
  (rot ? launch_fwd<V, true>(x, taps, out, B, H, W, C, cv, tc, rows, st)       \
       : launch_fwd<V, false>(x, taps, out, B, H, W, C, cv, tc, rows, st))
  if (vec == 8)
    RCOT_FWD(8);
  else if (vec == 4)
    RCOT_FWD(4);
  else
    RCOT_FWD(2);
#undef RCOT_FWD
  return cudaGetLastError();
}

cudaError_t dtaps_w32(const bf16* x, const bf16* g, float* ws, float* dtaps, int B, int H,
                      int W, int C, int vec, int cv, int tc, int rows, cudaStream_t st) {
  if (C == 0) return cudaSuccess;
  if ((long long)B * H * W == 0 || bad_plan(C, vec, cv, tc, rows, true))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_dtaps_w32();
  if (err != cudaSuccess) return err;
  if (vec == 8)
    launch_dtaps<8>(x, g, ws, B, H, W, C, cv, tc, rows, st);
  else if (vec == 4)
    launch_dtaps<4>(x, g, ws, B, H, W, C, cv, tc, rows, st);
  else
    launch_dtaps<2>(x, g, ws, B, H, W, C, cv, tc, rows, st);
  return reduce_dtaps(ws, dtaps, B, H, W, C, vec, cv, tc, rows, st);
}

}  // namespace rcot_dwconv

extern "C" {

// x (B, H, W, C), taps (C, 3, 3) -> out (B, H, W, C) (rcot_dwconv::conv)
int rcot_dwconv3x3(const float* x, const float* taps, float* out, int B, int H, int W, int C,
                   int vec, int cv, int tc, int rows, int rot, void* stream) {
  return rcot_dwconv::conv(x, taps, out, B, H, W, C, vec, cv, tc, rows, rot != 0,
                           (cudaStream_t)stream);
}

// Blocks of tc * cv threads that one SM of the current device holds at
// once, of the element types io (ops/dwconv.py DW_IO: 0 fp32, 1 bf16 into
// bf16, 2 bf16 into fp32, 3 bf16 on fp32 taps; vec elements a copy): the
// forward (dtaps == 0; dx takes as many) or dtaps (io 0 and 3).
int rcot_dwconv3x3_blocks_per_sm(int io, int vec, int cv, int tc, int dtaps, int* blocks) {
  const bool f32 = io == 0;
  if (io < 0 || io > 3 || (dtaps && io != 0 && io != 3) ||
      bad_plan(f32 ? 4 : 8, vec, cv, tc, 1, !f32))
    return cudaErrorInvalidValue;
  const int n = tc * cv;
  if (f32) {
    const size_t smem = dtaps ? dtaps_smem(vec, cv, tc) : fwd_smem(vec, cv, tc);
#define RCOT_OCC(V)                                                               \
  (dtaps ? occupancy(blocks, dwconv3x3_dtaps_kernel<V>, n, smem)                  \
         : occupancy(blocks, dwconv3x3_kernel<V, false>, n, smem))
    return vec == 4 ? RCOT_OCC(4) : vec == 2 ? RCOT_OCC(2) : RCOT_OCC(1);
#undef RCOT_OCC
  }
  if (dtaps) {
    const cudaError_t err = allow_dtaps_w32();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = dtaps ? dtaps_smem<bf16>(vec, cv, tc) : fwd_smem<bf16>(vec, cv, tc);
#define RCOT_OCC(V)                                                                       \
  (dtaps      ? occupancy(blocks, dwconv3x3_dtaps_kernel<V, bf16>, n, smem)               \
   : io == 1  ? occupancy(blocks, dwconv3x3_kernel<V, false, bf16, bf16>, n, smem)        \
   : io == 2  ? occupancy(blocks, dwconv3x3_kernel<V, false, bf16, float>, n, smem)       \
              : occupancy(blocks, dwconv3x3_kernel<V, false, bf16, bf16, float>, n, smem))
  return vec == 8 ? RCOT_OCC(8) : vec == 4 ? RCOT_OCC(4) : RCOT_OCC(2);
#undef RCOT_OCC
}

// bf16 h (B, H, W, 2 hid), bf16 taps (2 hid, 3, 3) -> the bf16 gate (B, H, W,
// ld_gate) (rcot_dwconv::conv_gate_bf16)
int rcot_conv_gate_bf16(const bf16* x, const bf16* taps, bf16* gate, int B, int H, int W,
                        int hid, int ld_gate, int vec, int cv, int tc, int rows, void* stream) {
  return rcot_dwconv::conv_gate_bf16(x, taps, gate, B, H, W, hid, ld_gate, vec, cv, tc, rows,
                                     (cudaStream_t)stream);
}

// The gated depthwise at (cv, tc): the blocks an SM of the current device
// holds at once (the less of its two modes'), its shared memory and its
// launch bound, for ops/dwconv.py conv_gate_smem and conv_gate_per_sm.
int rcot_conv_gate_bf16_blocks_per_sm(int cv, int tc, int* blocks, int* nbytes, int* least) {
  if (bad_plan(8, kGateVec, cv, tc, 1, true)) return cudaErrorInvalidValue;
  const size_t smem = gate_smem(cv, tc);
  int got[2] = {0, 0};
  cudaError_t e = occupancy(&got[0], dwconv3x3_gate_kernel<kGateAligned>, tc * cv, smem);
  if (e == cudaSuccess) e = occupancy(&got[1], dwconv3x3_gate_kernel<kGateShift>, tc * cv, smem);
  *blocks = got[0] < got[1] ? got[0] : got[1];
  *nbytes = (int)smem;
  *least = kGateBlocksPerSm;
  return e;
}

// bf16 x (B, H, W, C), fp32 taps (C, 3, 3) -> bf16 out (rcot_dwconv::conv_w32)
int rcot_dwconv3x3_w32(const bf16* x, const float* taps, bf16* out, int B, int H, int W,
                       int C, int vec, int cv, int tc, int rows, int rot, void* stream) {
  return rcot_dwconv::conv_w32(x, taps, out, B, H, W, C, vec, cv, tc, rows, rot != 0,
                               (cudaStream_t)stream);
}

// bf16 x, g (B, H, W, C) -> fp32 dtaps (C, 3, 3) (rcot_dwconv::dtaps_w32)
int rcot_dwconv3x3_dtaps_w32(const bf16* x, const bf16* g, float* ws, float* dtaps, int B,
                             int H, int W, int C, int vec, int cv, int tc, int rows,
                             void* stream) {
  return rcot_dwconv::dtaps_w32(x, g, ws, dtaps, B, H, W, C, vec, cv, tc, rows,
                                (cudaStream_t)stream);
}

// x, g (B, H, W, C) -> dtaps (C, 3, 3) (rcot_dwconv::dtaps)
int rcot_dwconv3x3_dtaps(const float* x, const float* g, float* ws, float* dtaps, int B,
                         int H, int W, int C, int vec, int cv, int tc, int rows,
                         void* stream) {
  return rcot_dwconv::dtaps(x, g, ws, dtaps, B, H, W, C, vec, cv, tc, rows,
                            (cudaStream_t)stream);
}

}  // extern "C"
