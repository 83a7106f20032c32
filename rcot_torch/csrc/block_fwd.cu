// Fused transformer-block kernels for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel rcot_tpu/ops/pallas_block.py fused_block_fwd
// (pallas_call at :189) in its two configurations:
//
//   block head (block_head, pallas_block.py:586):
//       qkv = dw3x3( LN1(x) @ W_qkv )
//   block tail (block_tail, pallas_block.py:597):
//       t = x + a @ W_proj
//       y = t + ( gelu(c1) * c2 ) @ W_out,   [c1 | c2] = dw3x3( LN2(t) @ W_in )
//
// LayerNorm: fp32 statistics, biased variance, eps 1e-5 inside the rsqrt;
// WithBias is (x - mean) * inv * w + b, BiasFree is x * inv * w with the
// variance taken about the mean. The 3x3 depthwise conv zero-pads h (the
// value after LN and the 1x1 product), not x: h is zero outside the image.
// gelu is the exact-erf form (erff).
//
// Weights come in PyTorch's conv layouts, read in place: W_qkv (3C, C),
// dw kernels (M, 3, 3), W_proj (C, C), W_in (2h, C), W_out (C, h).
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s):
// the head does 2*C*3C + 18*3C flops per pixel against 4*(C + 3C) bytes,
// the tail 2*C*(C + 2h + h) + 36h flops against 12*C bytes. At C = 48 the
// head is balanced (~16 us of flops, ~15 us of bytes at 256^2) and the tail
// is bound by operations (~45 us vs ~11 us); the deeper levels have the same
// flops and fewer bytes, so every tail and every deep head is bound by
// operations on the CUDA cores.
//
// Design against that bound. Each block owns a TILE x TILE tile of output
// pixels plus a one-pixel halo and recomputes LN and the 1x1 product on the
// halo (x1.27 at TILE 16, x1.56 at TILE 8), so the 3C-wide and 2h-wide
// intermediates never reach device memory: the head writes qkv only, the
// tail reads x and a and writes y plus one C-wide scratch copy of t. The
// 1x1 products stream the K dimension in chunks of 16 through shared memory;
// each lane owns one of 32 output channels and each warp a run of halo
// pixels, read as float4 broadcasts, so one shared load feeds four FMAs.
// No tensor cores yet: wgmma/TMA are later work.
//
// The tail is two launches, because the LN2 statistics of a halo pixel need
// the whole C-wide row of t = x + a @ W_proj, and at C = 384 that row for a
// whole tile does not fit beside the GDFN's buffers in 227 KB:
//   1. tail_proj_kernel: t = x + a @ W_proj, written to a scratch buffer
//      and to y;
//   2. tail_gdfn_kernel: LN2 on load from the scratch, the GDFN per chunk of
//      16 gate pairs (channels j and j + h stay in one chunk), and y += the
//      W_out product accumulated in shared memory. When the tiles alone do
//      not fill the card, the gate chunks of one tile are split over
//      several blocks that add into y with atomicAdd; the sum order then
//      varies from run to run in the last bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KC = 16;       // K chunk of the 1x1 products
constexpr int NC = 32;       // output channels per chunk: one per lane
constexpr int LDB = NC + 1;  // padded row stride of the weight chunk
constexpr int LDH = NC + 1;  // padded row stride of the h tile
constexpr int GC = NC / 2;   // gate pairs per chunk in the tail
constexpr float kLnEps = 1e-5f;
constexpr int kHeadTile = 16;  // block head: 16x16 output pixels per block
constexpr int kGdfnTile = 8;   // tail GDFN: 8x8, so that four blocks fit an SM

template <int TILE>
struct Tile {
  static constexpr int HWD = TILE + 2;                  // halo width
  static constexpr int NP = HWD * HWD;                  // halo pixels
  static constexpr int RPW = (NP + kWarps * 4 - 1) / (kWarps * 4) * 4;
  static constexpr int SLOTS = RPW * kWarps;            // >= NP
  static constexpr int LDA = SLOTS + 4;                 // 16-byte rows
  static constexpr int NI = TILE * TILE;                // interior pixels
};

// Shared buffers common to the head and the GDFN half of the tail.
template <int TILE>
struct HaloBuffers {
  float* mean;    // [SLOTS]
  float* inv;     // [SLOTS]
  long long* off; // [SLOTS] element offset of the pixel's row, -1 outside
  float* at;      // [KC][LDA]  transposed LN(x) chunk
  float* bw;      // [KC][LDB]  weight chunk
  float* h;       // [NP][LDH]  1x1 product of the halo tile
  float* dw;      // [9][NC]    depthwise taps of the chunk

  // Lays the buffers out from s (16-byte aligned); returns the first float
  // past them. host_halo_bytes<TILE>() is their size.
  __device__ float* carve(float* s) {
    using T = Tile<TILE>;
    off = reinterpret_cast<long long*>(s);
    s += 2 * T::SLOTS;
    at = s;  // 16-byte aligned: 2*SLOTS floats hold SLOTS 8-byte offsets
    s += KC * T::LDA;
    mean = s;
    s += T::SLOTS;
    inv = s;
    s += T::SLOTS;
    bw = s;
    s += KC * LDB;
    h = s;
    s += T::NP * LDH;
    dw = s;
    s += 9 * NC;
    return s;
  }
};

template <int TILE>
size_t host_halo_bytes() {
  using T = Tile<TILE>;
  return sizeof(float) * (2 * T::SLOTS + KC * T::LDA + KC * LDB +
                          T::NP * LDH + 9 * NC) +
         sizeof(long long) * T::SLOTS;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// Row offsets and LN statistics of the tile's halo pixels; one warp per
// pixel. Pixels outside the image get off = -1 (their h is zero).
template <int TILE>
__device__ void halo_stats(const float* __restrict__ src, int b, int H, int W,
                           int C, int gy0, int gx0, HaloBuffers<TILE>& sb) {
  using T = Tile<TILE>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < T::SLOTS; r += kWarps) {
    long long off = -1;
    float mean = 0.f, inv = 0.f;
    if (r < T::NP) {
      const int gy = gy0 - 1 + r / T::HWD, gx = gx0 - 1 + r % T::HWD;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        off = (((long long)b * H + gy) * W + gx) * C;
        const float* p = src + off;
        float s = 0.f;
        for (int k = lane; k < C; k += 32) s += p[k];
        mean = warp_sum(s) / C;
        float v = 0.f;
        for (int k = lane; k < C; k += 32) {
          const float d = p[k] - mean;
          v += d * d;
        }
        inv = rsqrtf(warp_sum(v) / C + kLnEps);
      }
    }
    if (lane == 0) {
      sb.off[r] = off;
      sb.mean[r] = mean;
      sb.inv[r] = inv;
    }
  }
}

// One K chunk of the halo product, staged through registers: fetch() starts
// the global loads of chunk k0 (x of the halo pixels, and the weight chunk),
// store() applies LN and writes them to shared memory. Fetching chunk k0+KC
// before the FMAs of chunk k0 keeps those loads in flight under the FMAs.
template <int TILE>
struct ChunkPrefetch {
  using T = Tile<TILE>;
  static constexpr int EA = (KC * T::SLOTS + kThreads - 1) / kThreads;
  static constexpr int EB = (KC * NC + kThreads - 1) / kThreads;
  float a[EA];
  float b[EB];

  // a: x[r][k0 + k] (0 outside the image and past C);
  // b: w[row(n)][k0 + k] for a weight stored (rows, C) row-major, where
  //    row(n) < 0 marks a masked column
  template <typename RowOf>
  __device__ __forceinline__ void fetch(const float* __restrict__ src,
                                        const float* __restrict__ w, int C,
                                        int k0, RowOf row_of,
                                        const HaloBuffers<TILE>& sb) {
#pragma unroll
    for (int e = 0; e < EA; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int k = idx % KC, r = idx / KC, kk = k0 + k;
      a[e] = 0.f;
      if (r < T::SLOTS) {
        const long long off = sb.off[r];
        if (off >= 0 && kk < C) a[e] = src[off + kk];
      }
    }
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int k = idx % KC, n = idx / KC, kk = k0 + k;
      const int row = n < NC ? row_of(n) : -1;
      b[e] = (row >= 0 && kk < C) ? w[(long long)row * C + kk] : 0.f;
    }
  }

  // at[k][r] = LN(x)[r][k0 + k] (0 outside the image), bw[k][n] = b
  __device__ __forceinline__ void store(const float* __restrict__ ln_w,
                                        const float* __restrict__ ln_b, int C,
                                        int k0, HaloBuffers<TILE>& sb) const {
#pragma unroll
    for (int e = 0; e < EA; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int k = idx % KC, r = idx / KC, kk = k0 + k;
      if (r < T::SLOTS) {
        float v = 0.f;
        if (sb.off[r] >= 0 && kk < C)
          v = ln_b ? (a[e] - sb.mean[r]) * sb.inv[r] * ln_w[kk] + ln_b[kk]
                   : a[e] * sb.inv[r] * ln_w[kk];
        sb.at[k * T::LDA + r] = v;
      }
    }
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int k = idx % KC, n = idx / KC;
      if (n < NC) sb.bw[k * LDB + n] = b[e];
    }
  }
};

// at[k][r] = LN(src)[r][k0 + k], zero outside the image and past C; the
// same chunk as ChunkPrefetch, loaded and stored in one pass.
template <int TILE>
__device__ void load_ln_chunk(const float* __restrict__ src,
                              const float* __restrict__ ln_w,
                              const float* __restrict__ ln_b, int C, int k0,
                              HaloBuffers<TILE>& sb) {
  using T = Tile<TILE>;
  for (int idx = threadIdx.x; idx < KC * T::SLOTS; idx += kThreads) {
    const int k = idx % KC, r = idx / KC, kk = k0 + k;
    float v = 0.f;
    const long long off = sb.off[r];
    if (off >= 0 && kk < C) {
      const float x = src[off + kk];
      v = ln_b ? (x - sb.mean[r]) * sb.inv[r] * ln_w[kk] + ln_b[kk]
               : x * sb.inv[r] * ln_w[kk];
    }
    sb.at[k * T::LDA + r] = v;
  }
}

// bw[k][n] = w[row(n)][k0 + k] for a weight stored (rows, K) row-major;
// row(n) < 0 marks a masked column.
template <typename RowOf>
__device__ void load_weight_chunk(const float* __restrict__ w, int K, int k0,
                                  RowOf row_of, float* bw) {
  for (int idx = threadIdx.x; idx < KC * NC; idx += kThreads) {
    const int k = idx % KC, n = idx / KC, kk = k0 + k;
    const int row = row_of(n);
    bw[k * LDB + n] = (row >= 0 && kk < K) ? w[(long long)row * K + kk] : 0.f;
  }
}

// acc[i] += sum_k at[k][row0 + i] * bw[k][lane] over one K chunk.
template <int RPW, int LDA>
__device__ __forceinline__ void mma_chunk(const float* at, const float* bw,
                                          int row0, float (&acc)[RPW]) {
  const int lane = threadIdx.x % 32;
#pragma unroll 4
  for (int k = 0; k < KC; ++k) {
    const float b = bw[k * LDB + lane];
    const float4* a4 = reinterpret_cast<const float4*>(at + k * LDA + row0);
#pragma unroll
    for (int i = 0; i < RPW / 4; ++i) {
      const float4 a = a4[i];
      acc[4 * i + 0] = fmaf(a.x, b, acc[4 * i + 0]);
      acc[4 * i + 1] = fmaf(a.y, b, acc[4 * i + 1]);
      acc[4 * i + 2] = fmaf(a.z, b, acc[4 * i + 2]);
      acc[4 * i + 3] = fmaf(a.w, b, acc[4 * i + 3]);
    }
  }
}

// h[r][n] = sum_k LN(src)[r][k] * w[row(n)][k] for every halo pixel r of
// the tile: the 1x1 product of one chunk of 32 output channels. PREFETCH
// fetches chunk k0 + KC before the FMAs of chunk k0; it pays where there
// are registers to spare (the 8x8 GDFN tile) and costs occupancy where the
// accumulators already fill them (the 16x16 head tile, 44 per thread).
template <int TILE, bool PREFETCH, typename RowOf>
__device__ void halo_product(const float* __restrict__ src,
                             const float* __restrict__ ln_w,
                             const float* __restrict__ ln_b,
                             const float* __restrict__ w, int C, RowOf row_of,
                             HaloBuffers<TILE>& sb) {
  using T = Tile<TILE>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * T::RPW;
  float acc[T::RPW];
#pragma unroll
  for (int i = 0; i < T::RPW; ++i) acc[i] = 0.f;
  __syncthreads();  // the halo offsets and statistics are written
  if constexpr (PREFETCH) {
    ChunkPrefetch<TILE> pf;
    pf.fetch(src, w, C, 0, row_of, sb);
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();  // the previous chunk's readers are done
      pf.store(ln_w, ln_b, C, k0, sb);
      __syncthreads();
      if (k0 + KC < C) pf.fetch(src, w, C, k0 + KC, row_of, sb);
      mma_chunk<T::RPW, T::LDA>(sb.at, sb.bw, row0, acc);
    }
  } else {
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();
      load_ln_chunk<TILE>(src, ln_w, ln_b, C, k0, sb);
      load_weight_chunk(w, C, k0, row_of, sb.bw);
      __syncthreads();
      mma_chunk<T::RPW, T::LDA>(sb.at, sb.bw, row0, acc);
    }
  }
#pragma unroll
  for (int i = 0; i < T::RPW; ++i) {
    const int r = row0 + i;
    if (r < T::NP) sb.h[r * LDH + lane] = acc[i];
  }
}

// 3x3 depthwise conv of the h tile at interior pixel q, channel `lane`.
template <int TILE>
__device__ __forceinline__ float dw3x3_at(const HaloBuffers<TILE>& sb, int q) {
  using T = Tile<TILE>;
  const int lane = threadIdx.x % 32;
  const int iy = q / TILE, ix = q % TILE;
  float s = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      s = fmaf(sb.h[((iy + dy) * T::HWD + ix + dx) * LDH + lane],
               sb.dw[(dy * 3 + dx) * NC + lane], s);
  return s;
}

// ------------------------------------------------------------------ head

template <int TILE>
__global__ void __launch_bounds__(kThreads)
head_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
            const float* __restrict__ ln_b, const float* __restrict__ w_qkv,
            const float* __restrict__ dwk, float* __restrict__ out, int H,
            int W, int C, int M, int tiles_x) {
  extern __shared__ float4 smem4[];
  HaloBuffers<TILE> sb;
  sb.carve(reinterpret_cast<float*>(smem4));
  const int b = blockIdx.z, m0 = blockIdx.y * NC;
  const int gy0 = (blockIdx.x / tiles_x) * TILE;
  const int gx0 = (blockIdx.x % tiles_x) * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  halo_stats<TILE>(x, b, H, W, C, gy0, gx0, sb);
  for (int idx = threadIdx.x; idx < 9 * NC; idx += kThreads) {
    const int n = idx % NC, tap = idx / NC, m = m0 + n;
    sb.dw[tap * NC + n] = m < M ? dwk[m * 9 + tap] : 0.f;
  }
  auto row_of = [=](int n) { return m0 + n < M ? m0 + n : -1; };
  halo_product<TILE, false>(x, ln_w, ln_b, w_qkv, C, row_of, sb);
  __syncthreads();

  const int m = m0 + lane;
  for (int q = warp; q < Tile<TILE>::NI; q += kWarps) {
    const int gy = gy0 + q / TILE, gx = gx0 + q % TILE;
    const float v = dw3x3_at<TILE>(sb, q);
    if (gy < H && gx < W && m < M)
      out[(((long long)b * H + gy) * W + gx) * M + m] = v;
  }
}

// ------------------------------------------------------------------ tail

// t = x + a @ W_proj^T for a run of 64 pixels and 32 output channels,
// written to t_out and y.
constexpr int kProjRows = 64;
constexpr int kProjRPW = kProjRows / kWarps;
constexpr int kProjLDA = kProjRows + 4;

__global__ void __launch_bounds__(kThreads)
tail_proj_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ w_proj, float* __restrict__ t_out,
                 float* __restrict__ y, long long n_pix, int C) {
  __shared__ __align__(16) float at[KC * kProjLDA];
  __shared__ float bw[KC * LDB];
  const long long p0 = (long long)blockIdx.x * kProjRows;
  const int c0 = blockIdx.y * NC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * kProjRPW;
  float acc[kProjRPW];
#pragma unroll
  for (int i = 0; i < kProjRPW; ++i) acc[i] = 0.f;
  auto row_of = [=](int n) { return c0 + n < C ? c0 + n : -1; };
  for (int k0 = 0; k0 < C; k0 += KC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < KC * kProjRows; idx += kThreads) {
      const int k = idx % KC, r = idx / KC, kk = k0 + k;
      const long long p = p0 + r;
      at[k * kProjLDA + r] = (p < n_pix && kk < C) ? a[p * C + kk] : 0.f;
    }
    load_weight_chunk(w_proj, C, k0, row_of, bw);
    __syncthreads();
    mma_chunk<kProjRPW, kProjLDA>(at, bw, row0, acc);
  }
  const int c = c0 + lane;
#pragma unroll
  for (int i = 0; i < kProjRPW; ++i) {
    const long long p = p0 + row0 + i;
    if (p < n_pix && c < C) {
      const float t = x[p * C + c] + acc[i];
      t_out[p * C + c] = t;
      y[p * C + c] = t;
    }
  }
}

// y += (gelu(c1) * c2) @ W_out^T over the gate chunks [g_begin, g_end) of
// one tile, with [c1 | c2] = dw3x3(LN2(t) @ W_in^T).
template <int TILE>
__global__ void __launch_bounds__(kThreads)
tail_gdfn_kernel(const float* __restrict__ t, const float* __restrict__ ln_w,
                 const float* __restrict__ ln_b, const float* __restrict__ w_in,
                 const float* __restrict__ dwk, const float* __restrict__ w_out,
                 float* __restrict__ y, int H, int W, int C, int hid,
                 int tiles_x, int chunks_per_split, int atomic) {
  using T = Tile<TILE>;
  extern __shared__ float4 smem4[];
  HaloBuffers<TILE> sb;
  float* s = sb.carve(reinterpret_cast<float*>(smem4));
  float* g = s;                  // [NI][GC + 1] gated values of the chunk
  s += T::NI * (GC + 1);
  float* wo = s;                 // [C][GC + 1]   W_out columns of the chunk
  s += C * (GC + 1);
  float* acc_out = s;            // [NI][C]       W_out product, all chunks

  const int b = blockIdx.z;
  const int gy0 = (blockIdx.x / tiles_x) * TILE;
  const int gx0 = (blockIdx.x % tiles_x) * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_chunks = (hid + GC - 1) / GC;
  const int g_begin = blockIdx.y * chunks_per_split;
  const int g_end = min(n_chunks, g_begin + chunks_per_split);

  halo_stats<TILE>(t, b, H, W, C, gy0, gx0, sb);
  for (int idx = threadIdx.x; idx < T::NI * C; idx += kThreads)
    acc_out[idx] = 0.f;

  for (int gc = g_begin; gc < g_end; ++gc) {
    const int j0 = gc * GC;
    // lane n < 16 carries gate channel j0 + n, lane n >= 16 its partner
    // j0 + n - 16 + hid
    auto row_of = [=](int n) {
      const int j = j0 + (n % GC);
      return j < hid ? j + (n < GC ? 0 : hid) : -1;
    };
    __syncthreads();  // the previous chunk's readers of dw, g and wo are done
    for (int idx = threadIdx.x; idx < 9 * NC; idx += kThreads) {
      const int n = idx % NC, tap = idx / NC, row = row_of(n);
      sb.dw[tap * NC + n] = row >= 0 ? dwk[row * 9 + tap] : 0.f;
    }
    for (int idx = threadIdx.x; idx < C * GC; idx += kThreads) {
      const int j = idx % GC, c = idx / GC;
      wo[c * (GC + 1) + j] =
          j0 + j < hid ? w_out[(long long)c * hid + j0 + j] : 0.f;
    }
    halo_product<TILE, true>(t, ln_w, ln_b, w_in, C, row_of, sb);
    __syncthreads();

    for (int q = warp; q < T::NI; q += kWarps) {
      const float v = dw3x3_at<TILE>(sb, q);
      const float partner = __shfl_down_sync(0xffffffffu, v, GC);
      if (lane < GC) g[q * (GC + 1) + lane] = gelu_erf(v) * partner;
    }
    __syncthreads();

    for (int c = lane; c < C; c += 32) {
      float wr[GC];
#pragma unroll
      for (int j = 0; j < GC; ++j) wr[j] = wo[c * (GC + 1) + j];
      for (int q = warp; q < T::NI; q += kWarps) {
        float sum = acc_out[q * C + c];
#pragma unroll
        for (int j = 0; j < GC; ++j) sum = fmaf(g[q * (GC + 1) + j], wr[j], sum);
        acc_out[q * C + c] = sum;
      }
    }
  }
  __syncthreads();

  for (int q = warp; q < T::NI; q += kWarps) {
    const int gy = gy0 + q / TILE, gx = gx0 + q % TILE;
    if (gy >= H || gx >= W) continue;
    float* yp = y + (((long long)b * H + gy) * W + gx) * C;
    for (int c = lane; c < C; c += 32) {
      const float v = acc_out[q * C + c];
      if (atomic)
        atomicAdd(yp + c, v);
      else
        yp[c] += v;
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int TILE>
int launch_head(const float* x, const float* ln_w, const float* ln_b,
                const float* w_qkv, const float* dwk, float* out, int B, int H,
                int W, int C, int M, cudaStream_t stream) {
  const size_t smem = host_halo_bytes<TILE>();
  cudaError_t err = allow_smem(head_kernel<TILE>, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  dim3 grid(tiles_x * tiles_y, (M + NC - 1) / NC, B);
  head_kernel<TILE><<<grid, kThreads, smem, stream>>>(
      x, ln_w, ln_b, w_qkv, dwk, out, H, W, C, M, tiles_x);
  return cudaGetLastError();
}

template <int TILE>
int launch_gdfn(const float* t, const float* ln_w, const float* ln_b,
                const float* w_in, const float* dwk, const float* w_out,
                float* y, int B, int H, int W, int C, int hid,
                cudaStream_t stream) {
  using T = Tile<TILE>;
  const size_t smem = host_halo_bytes<TILE>() +
                      sizeof(float) * (T::NI * (GC + 1) + C * (GC + 1) +
                                       (size_t)T::NI * C);
  cudaError_t err = allow_smem(tail_gdfn_kernel<TILE>, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  const int tiles = tiles_x * tiles_y * B;
  const int n_chunks = (hid + GC - 1) / GC;
  // split the gate chunks of a tile over blocks until about four blocks per SM
  int splits = (4 * sm_count() + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > n_chunks ? n_chunks : splits);
  const int per_split = (n_chunks + splits - 1) / splits;
  splits = (n_chunks + per_split - 1) / per_split;
  dim3 grid(tiles_x * tiles_y, splits, B);
  tail_gdfn_kernel<TILE><<<grid, kThreads, smem, stream>>>(
      t, ln_w, ln_b, w_in, dwk, w_out, y, H, W, C, hid, tiles_x, per_split,
      splits > 1 ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv = dw3x3(LN1(x) @ W_qkv^T). x (B,H,W,C); w_qkv (M,C); dwk (M,3,3);
// ln_b may be null (BiasFree); out (B,H,W,M).
int rcot_block_head(const float* x, const float* ln_w, const float* ln_b,
                    const float* w_qkv, const float* dwk, float* out, int B,
                    int H, int W, int C, int M, void* stream) {
  return launch_head<kHeadTile>(x, ln_w, ln_b, w_qkv, dwk, out, B, H, W, C, M,
                         (cudaStream_t)stream);
}

// y = t + GDFN(LN2(t)), t = x + a @ W_proj^T. x, a, y, t_scratch (B,H,W,C);
// w_proj (C,C); w_in (2h,C); dwk (2h,3,3); w_out (C,h); ln_b may be null.
int rcot_block_tail(const float* x, const float* a, const float* w_proj,
                    const float* ln_w, const float* ln_b, const float* w_in,
                    const float* dwk, const float* w_out, float* t_scratch,
                    float* y, int B, int H, int W, int C, int hid,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_pix = (long long)B * H * W;
  dim3 grid((unsigned)((n_pix + kProjRows - 1) / kProjRows), (C + NC - 1) / NC);
  tail_proj_kernel<<<grid, kThreads, 0, st>>>(x, a, w_proj, t_scratch, y,
                                              n_pix, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gdfn<kGdfnTile>(t_scratch, ln_w, ln_b, w_in, dwk, w_out, y, B,
                                H, W, C, hid, st);
}

}  // extern "C"
