// Fused [1x1 ->] depthwise 3x3 [-> gelu gate -> 1x1] for Hopper (sm_90a),
// forward and backward.
//
// Replaces the TPU kernels of rcot_tpu/ops/pallas_fused.py in the two
// configurations the model calls:
//
//   conv1x1_dw (conv1x1_dw_fused, pallas_fused.py:568; the MDTA qkv path):
//       qkv = dw3x3( x @ W_in^T )                       x (B,H,W,C) -> (B,H,W,M)
//   gdfn_fused (gdfn_fused, pallas_fused.py:549; the whole GDFN):
//       y = ( gelu(c1) * c2 ) @ W_out^T,  [c1 | c2] = dw3x3( x @ W_in^T )
//                                                       x (B,H,W,C) -> (B,H,W,C)
//
// forward: fused_dwconv_fwd (pallas_call at :274); backward: fused_dwconv_bwd
// (pallas_call at :456), which recomputes the forward from x and the weights.
// Weights are in the port's layouts, read in place: W_in (M, C), taps
// (M, 3, 3), W_out (C, h) with M = 2h in the GDFN.
//
// The depthwise conv zero-pads h = x @ W_in^T. There is no LayerNorm in
// front, so h outside the image is 0 @ W_in = 0 and the halo rule is simply
// "outside the image reads 0", for x in the forward and for every
// whole-tensor intermediate in the backward. The odd gate widths of the
// reference model (h = 127, 255, 510, 1021) are masked, not padded: the
// gate pairs channel j with j + h, and a chunk past h loads zero weights.
// gelu is the exact-erf form (erff); the TPU kernel's erf was the
// Abramowitz-Stegun 7.1.26 polynomial (|error| < 1.5e-7).
//
// This file shares no code with block_fwd.cu / block_bwd.cu: the tiles and
// GEMMs are copies without the LayerNorm, so neither file's halo rule can
// reach the other.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s).
// conv1x1_dw at train L1 (3 x 128^2, C = 48, M = 144): 2*C*M + 18*M flops
// per pixel (0.81 GFLOP, 12 us) against 4*(C + M) bytes (38 MB, 11 us), so
// it sits near both bounds and the M-wide output has to be written; the
// deeper levels (C up to 384, M = 3C) are bound by operations. gdfn_fused
// does 2*C*2h + 36h + 2h*C flops per pixel against 8*C bytes: bound by
// operations at every width.
//
// Design against that bound. Forward: each block owns a TILE x TILE tile of
// output pixels plus a one-pixel halo and recomputes the 1x1 product on the
// halo, so h (and, in the GDFN, conv and the gate) never reach device
// memory. The 1x1 product streams K in chunks of 16 through shared memory;
// each lane owns one of 32 output channels and each warp a run of halo
// pixels. conv1x1_dw writes its M-wide tile directly; gdfn_fused walks the
// gate in chunks of 16 pairs and adds each chunk's W_out product into a C-wide
// accumulator in shared memory, written once (or, when the tiles alone do
// not fill the card, the chunks of one tile are split over blocks that add
// into y with atomicAdd on a zeroed y). Backward: a chain of plain kernels
// on one stream over a workspace the caller allocates (h, conv, dconv, dh),
// as in block_bwd.cu: strided fp32 GEMMs for every 1x1 product (the pixel
// sums dW_in, dW_out split K over blocks and atomicAdd into outputs zeroed on
// the stream), whole-tensor stencils for dh (the rot180 correlation of dconv
// with the taps) and ddw. No tensor cores yet.

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
constexpr int GC = NC / 2;   // gate pairs per chunk
constexpr int kQkvTile = 16;   // conv1x1_dw: 16x16 output pixels per block
constexpr int kGdfnTile = 8;   // gdfn_fused: 8x8, so that several blocks fit an SM

template <int TILE>
struct Tile {
  static constexpr int HWD = TILE + 2;                  // halo width
  static constexpr int NP = HWD * HWD;                  // halo pixels
  static constexpr int RPW = (NP + kWarps * 4 - 1) / (kWarps * 4) * 4;
  static constexpr int SLOTS = RPW * kWarps;            // >= NP
  static constexpr int LDA = SLOTS + 4;                 // 16-byte rows
  static constexpr int NI = TILE * TILE;                // interior pixels
};

template <int TILE>
struct HaloBuffers {
  long long* off; // [SLOTS] element offset of the pixel's row, -1 outside
  float* at;      // [KC][LDA]  transposed x chunk
  float* bw;      // [KC][LDB]  weight chunk
  float* h;       // [NP][LDH]  1x1 product of the halo tile
  float* dw;      // [9][NC]    depthwise taps of the chunk

  // Lays the buffers out from s (16-byte aligned); returns the first float
  // past them. halo_bytes<TILE>() is their size.
  __device__ float* carve(float* s) {
    using T = Tile<TILE>;
    off = reinterpret_cast<long long*>(s);
    s += 2 * T::SLOTS;
    at = s;  // 16-byte aligned: SLOTS is a multiple of 4
    s += KC * T::LDA;
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
size_t halo_bytes() {
  using T = Tile<TILE>;
  return sizeof(float) * (KC * T::LDA + KC * LDB + T::NP * LDH + 9 * NC) +
         sizeof(long long) * T::SLOTS;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// Row offsets of the tile's halo pixels; -1 outside the image (h is zero).
template <int TILE>
__device__ void halo_offsets(int b, int H, int W, int C, int gy0, int gx0,
                             HaloBuffers<TILE>& sb) {
  using T = Tile<TILE>;
  for (int r = threadIdx.x; r < T::SLOTS; r += kThreads) {
    long long off = -1;
    if (r < T::NP) {
      const int gy = gy0 - 1 + r / T::HWD, gx = gx0 - 1 + r % T::HWD;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        off = (((long long)b * H + gy) * W + gx) * C;
    }
    sb.off[r] = off;
  }
}

// One K chunk of the halo product, staged through registers: fetch() starts
// the global loads of chunk k0 (x of the halo pixels, and the weight chunk),
// store() writes them to shared memory. Fetching chunk k0+KC before the FMAs
// of chunk k0 keeps those loads in flight under the FMAs.
template <int TILE>
struct ChunkPrefetch {
  using T = Tile<TILE>;
  static constexpr int EA = (KC * T::SLOTS + kThreads - 1) / kThreads;
  static constexpr int EB = (KC * NC + kThreads - 1) / kThreads;
  float a[EA];
  float b[EB];

  // a: x[r][k0 + k] (0 outside the image and past C);
  // b: w[row(n)][k0 + k], where row(n) < 0 marks a masked column
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

  __device__ __forceinline__ void store(HaloBuffers<TILE>& sb) const {
#pragma unroll
    for (int e = 0; e < EA; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int k = idx % KC, r = idx / KC;
      if (r < T::SLOTS) sb.at[k * T::LDA + r] = a[e];
    }
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int k = idx % KC, n = idx / KC;
      if (n < NC) sb.bw[k * LDB + n] = b[e];
    }
  }
};

// at[k][r] = x[r][k0 + k], zero outside the image and past C.
template <int TILE>
__device__ void load_x_chunk(const float* __restrict__ src, int C, int k0,
                             HaloBuffers<TILE>& sb) {
  using T = Tile<TILE>;
  for (int idx = threadIdx.x; idx < KC * T::SLOTS; idx += kThreads) {
    const int k = idx % KC, r = idx / KC, kk = k0 + k;
    const long long off = sb.off[r];
    sb.at[k * T::LDA + r] = (off >= 0 && kk < C) ? src[off + kk] : 0.f;
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

// h[r][n] = sum_k x[r][k] * w[row(n)][k] for every halo pixel r of the tile:
// the 1x1 product of one chunk of 32 output channels. PREFETCH fetches chunk
// k0 + KC before the FMAs of chunk k0; it pays where there are registers to
// spare (the 8x8 GDFN tile), not where the accumulators fill them (16x16).
template <int TILE, bool PREFETCH, typename RowOf>
__device__ void halo_product(const float* __restrict__ src,
                             const float* __restrict__ w, int C, RowOf row_of,
                             HaloBuffers<TILE>& sb) {
  using T = Tile<TILE>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * T::RPW;
  float acc[T::RPW];
#pragma unroll
  for (int i = 0; i < T::RPW; ++i) acc[i] = 0.f;
  __syncthreads();  // the halo offsets are written
  if constexpr (PREFETCH) {
    ChunkPrefetch<TILE> pf;
    pf.fetch(src, w, C, 0, row_of, sb);
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();  // the previous chunk's readers are done
      pf.store(sb);
      __syncthreads();
      if (k0 + KC < C) pf.fetch(src, w, C, k0 + KC, row_of, sb);
      mma_chunk<T::RPW, T::LDA>(sb.at, sb.bw, row0, acc);
    }
  } else {
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();
      load_x_chunk<TILE>(src, C, k0, sb);
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

// ------------------------------------------------------------ forward

// out = dw3x3(x @ W_in^T) for one tile and one chunk of 32 channels.
template <int TILE>
__global__ void __launch_bounds__(kThreads)
conv1x1_dw_kernel(const float* __restrict__ x, const float* __restrict__ w_in,
                  const float* __restrict__ dwk, float* __restrict__ out,
                  int H, int W, int C, int M, int tiles_x) {
  extern __shared__ float4 smem4[];
  HaloBuffers<TILE> sb;
  sb.carve(reinterpret_cast<float*>(smem4));
  const int b = blockIdx.z, m0 = blockIdx.y * NC;
  const int gy0 = (blockIdx.x / tiles_x) * TILE;
  const int gx0 = (blockIdx.x % tiles_x) * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  halo_offsets<TILE>(b, H, W, C, gy0, gx0, sb);
  for (int idx = threadIdx.x; idx < 9 * NC; idx += kThreads) {
    const int n = idx % NC, tap = idx / NC, m = m0 + n;
    sb.dw[tap * NC + n] = m < M ? dwk[m * 9 + tap] : 0.f;
  }
  auto row_of = [=](int n) { return m0 + n < M ? m0 + n : -1; };
  halo_product<TILE, false>(x, w_in, C, row_of, sb);
  __syncthreads();

  const int m = m0 + lane;
  for (int q = warp; q < Tile<TILE>::NI; q += kWarps) {
    const int gy = gy0 + q / TILE, gx = gx0 + q % TILE;
    const float v = dw3x3_at<TILE>(sb, q);
    if (gy < H && gx < W && m < M)
      out[(((long long)b * H + gy) * W + gx) * M + m] = v;
  }
}

// y (+)= (gelu(c1) * c2) @ W_out^T over the gate chunks [g_begin, g_end) of
// one tile, with [c1 | c2] = dw3x3(x @ W_in^T).
template <int TILE>
__global__ void __launch_bounds__(kThreads)
gdfn_kernel(const float* __restrict__ x, const float* __restrict__ w_in,
            const float* __restrict__ dwk, const float* __restrict__ w_out,
            float* __restrict__ y, int H, int W, int C, int hid, int tiles_x,
            int chunks_per_split, int atomic) {
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

  halo_offsets<TILE>(b, H, W, C, gy0, gx0, sb);
  for (int idx = threadIdx.x; idx < T::NI * C; idx += kThreads)
    acc_out[idx] = 0.f;

  for (int gc = g_begin; gc < g_end; ++gc) {
    const int j0 = gc * GC;
    // lane n < 16 carries gate channel j0 + n, lane n >= 16 its partner
    // j0 + n - 16 + hid; channels past hid are masked
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
    halo_product<TILE, true>(x, w_in, C, row_of, sb);
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
        yp[c] = v;
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

// ------------------------------------------------------------ backward

// C (M x N, row-major, ldc) op= A B with A(m, k) = A[m*sam + k*sak] and
// B(k, n) = B[k*sbk + n*sbn]. Block z covers K in [z*k_split, +k_split).
// Each thread owns a 4 x 4 micro-tile: rows 4*ty.., columns 4*tx...
constexpr int BM = 64, BN = 64, BK = 16;
constexpr int kStore = 0;   // C = A B
constexpr int kReduce = 1;  // C += A B by atomicAdd, K split over blocks

__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ A, long long sam, long long sak,
            const float* __restrict__ B, long long sbk, long long sbn,
            float* __restrict__ Cm, long long ldc, int M, int N, long long K,
            long long k_split, int mode) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long kb = (long long)blockIdx.z * k_split;
  const long long ke = kb + k_split < K ? kb + k_split : K;
  // stage each tile along the operand's unit stride, for coalesced loads
  const bool a_m_fast = sam == 1 && sak != 1;
  const bool b_n_fast = sbn == 1;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = kb; k0 < ke; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int m = a_m_fast ? e % BM : e / BK;
      const int k = a_m_fast ? e / BM : e % BK;
      const long long kk = k0 + k;
      const int mm = m0 + m;
      As[k][m] = (mm < M && kk < ke) ? A[mm * sam + kk * sak] : 0.f;
    }
    for (int e = tid; e < BN * BK; e += kThreads) {
      const int n = b_n_fast ? e % BN : e / BK;
      const int k = b_n_fast ? e / BN : e % BK;
      const long long kk = k0 + k;
      const int nn = n0 + n;
      Bs[k][n] = (nn < N && kk < ke) ? B[kk * sbk + nn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= N) continue;
      float* c = Cm + m * ldc + n;
      if (mode == kReduce)
        atomicAdd(c, acc[i][j]);
      else
        *c = acc[i][j];
    }
  }
}

// blocks for a grid-stride loop over `work` items: about eight per SM
unsigned grid_for(long long work) {
  const long long cap = 8LL * sm_count();
  const long long need = (work + kThreads - 1) / kThreads;
  return (unsigned)(need < 1 ? 1 : (need < cap ? need : cap));
}

cudaError_t gemm(const float* A, long long sam, long long sak, const float* B,
                 long long sbk, long long sbn, float* C, long long ldc, int M,
                 int N, long long K, int mode, cudaStream_t st) {
  const long long tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  long long k_split = K, splits = 1;
  if (mode == kReduce) {
    // split the pixel sum until the grid holds about four blocks per SM
    const long long k_tiles = (K + BK - 1) / BK;
    splits = (4LL * sm_count() + tiles_m * tiles_n - 1) / (tiles_m * tiles_n);
    splits = splits < 1 ? 1 : (splits > k_tiles ? k_tiles : splits);
    k_split = (k_tiles + splits - 1) / splits * BK;
    splits = (K + k_split - 1) / k_split;
  }
  if (splits < 1) splits = 1;
  dim3 grid((unsigned)tiles_m, (unsigned)tiles_n, (unsigned)splits);
  gemm_kernel<<<grid, kThreads, 0, st>>>(A, sam, sak, B, sbk, sbn, C, ldc, M,
                                         N, K, k_split, mode);
  return cudaGetLastError();
}

// out[b,y,x,m] = sum_{dy,dx} in[b, y + S*(dy-1), x + S*(dx-1), m] * w[m, dy, dx]
// with zero outside the image. S = +1 is the forward conv; S = -1 is the
// rot180 correlation that gives dh from dconv.
template <int S>
__global__ void __launch_bounds__(kThreads)
dw3x3_kernel(const float* __restrict__ in, const float* __restrict__ w,
             float* __restrict__ out, int B, int H, int W, int M) {
  const long long total = (long long)B * H * W * M;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const int m = (int)(idx % M);
    const long long pix = idx / M;
    const int x = (int)(pix % W);
    const long long row = pix / W;
    const int y = (int)(row % H);
    const long long b = row / H;
    float s = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = y + S * (dy - 1);
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int xx = x + S * (dx - 1);
        if (xx < 0 || xx >= W) continue;
        s = fmaf(in[((b * H + yy) * W + xx) * M + m], w[m * 9 + dy * 3 + dx], s);
      }
    }
    out[idx] = s;
  }
}

// ddw[m, dy, dx] += sum over pixels of dconv[b,y,x,m] * h[b, y+dy-1, x+dx-1, m]
// (h zero outside the image). Block (channel chunk of 32, pixel range):
// lane = channel, warps stride over the range, nine sums per thread, then
// the warps' sums meet in shared memory and one atomicAdd per (m, tap).
__global__ void __launch_bounds__(kThreads)
ddw_kernel(const float* __restrict__ dconv, const float* __restrict__ h,
           float* __restrict__ ddw, int B, int H, int W, int M,
           long long pix_per_block) {
  __shared__ float part[kWarps][9][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int m = blockIdx.x * 32 + lane;
  const long long n_pix = (long long)B * H * W;
  const long long p0 = blockIdx.y * pix_per_block;
  const long long p1 = p0 + pix_per_block < n_pix ? p0 + pix_per_block : n_pix;
  float acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0.f;
  if (m < M) {
    for (long long p = p0 + warp; p < p1; p += kWarps) {
      const int x = (int)(p % W);
      const long long row = p / W;
      const int y = (int)(row % H);
      const long long b = row / H;
      const float d = dconv[p * M + m];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = y + dy - 1;
        if (yy < 0 || yy >= H) continue;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int xx = x + dx - 1;
          if (xx < 0 || xx >= W) continue;
          acc[dy * 3 + dx] = fmaf(d, h[((b * H + yy) * W + xx) * M + m],
                                  acc[dy * 3 + dx]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  for (int e = threadIdx.x; e < 9 * 32; e += kThreads) {
    const int tap = e / 32, l = e % 32, mm = blockIdx.x * 32 + l;
    if (mm >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int wv = 0; wv < kWarps; ++wv) s += part[wv][tap][l];
    atomicAdd(ddw + mm * 9 + tap, s);
  }
}

cudaError_t launch_dw(const float* in, const float* w, float* out, int B, int H,
                      int W, int M, bool corr, cudaStream_t st) {
  const unsigned grid = grid_for((long long)B * H * W * M);
  if (corr)
    dw3x3_kernel<-1><<<grid, kThreads, 0, st>>>(in, w, out, B, H, W, M);
  else
    dw3x3_kernel<1><<<grid, kThreads, 0, st>>>(in, w, out, B, H, W, M);
  return cudaGetLastError();
}

cudaError_t launch_ddw(const float* dconv, const float* h, float* ddw, int B,
                       int H, int W, int M, cudaStream_t st) {
  const long long n_pix = (long long)B * H * W;
  const int chunks = (M + 31) / 32;
  // split the pixels until the grid holds about four blocks per SM
  long long splits = (4LL * sm_count() + chunks - 1) / chunks;
  if (splits > n_pix) splits = n_pix;
  if (splits < 1) splits = 1;
  const long long per = (n_pix + splits - 1) / splits;
  splits = (n_pix + per - 1) / per;
  dim3 grid(chunks, (unsigned)splits);
  ddw_kernel<<<grid, kThreads, 0, st>>>(dconv, h, ddw, B, H, W, M, per);
  return cudaGetLastError();
}

// conv = [c1 | c2] (N, 2h), dgate (N, h) ->
//   dconv = [dgate * c2 * gelu'(c1) | dgate * gelu(c1)],  gate = gelu(c1) * c2
__global__ void __launch_bounds__(kThreads)
gate_bwd_kernel(const float* __restrict__ conv, const float* __restrict__ dgate,
                float* __restrict__ dconv, float* __restrict__ gate,
                long long n_pix, int hid) {
  const long long total = n_pix * hid;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const long long p = idx / hid;
    const int j = (int)(idx % hid);
    const long long base = p * 2 * hid;
    const float x1 = conv[base + j], x2 = conv[base + hid + j];
    const float dg = dgate[idx];
    const float cdf = 0.5f * (1.0f + erff(x1 * 0.70710678118654752f));
    const float pdf = 0.39894228040143268f * expf(-0.5f * x1 * x1);
    const float gl = x1 * cdf;
    dconv[base + j] = dg * x2 * (cdf + x1 * pdf);
    dconv[base + hid + j] = dg * gl;
    gate[idx] = gl * x2;
  }
}

#define RCOT_TRY(expr)                       \
  do {                                       \
    cudaError_t err_ = (expr);               \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

}  // namespace

extern "C" {

// qkv = dw3x3(x @ W_in^T). x (B,H,W,C); w_in (M,C); dwk (M,3,3);
// out (B,H,W,M).
int rcot_conv1x1_dw(const float* x, const float* w_in, const float* dwk,
                    float* out, int B, int H, int W, int C, int M,
                    void* stream) {
  constexpr int TILE = kQkvTile;
  const size_t smem = halo_bytes<TILE>();
  RCOT_TRY(allow_smem(conv1x1_dw_kernel<TILE>, smem));
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  dim3 grid(tiles_x * tiles_y, (M + NC - 1) / NC, B);
  conv1x1_dw_kernel<TILE><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w_in, dwk, out, H, W, C, M, tiles_x);
  return cudaGetLastError();
}

// y = (gelu(c1) * c2) @ W_out^T, [c1 | c2] = dw3x3(x @ W_in^T). x, y
// (B,H,W,C); w_in (2h,C); dwk (2h,3,3); w_out (C,h).
int rcot_gdfn_fused(const float* x, const float* w_in, const float* dwk,
                    const float* w_out, float* y, int B, int H, int W, int C,
                    int hid, void* stream) {
  constexpr int TILE = kGdfnTile;
  using T = Tile<TILE>;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = halo_bytes<TILE>() +
                      sizeof(float) * (T::NI * (GC + 1) + C * (GC + 1) +
                                       (size_t)T::NI * C);
  RCOT_TRY(allow_smem(gdfn_kernel<TILE>, smem));
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  const int tiles = tiles_x * tiles_y * B;
  const int n_chunks = (hid + GC - 1) / GC;
  // split the gate chunks of a tile over blocks until about four blocks per SM
  int splits = (4 * sm_count() + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > n_chunks ? n_chunks : splits);
  const int per_split = (n_chunks + splits - 1) / splits;
  splits = (n_chunks + per_split - 1) / per_split;
  if (splits > 1)
    RCOT_TRY(cudaMemsetAsync(y, 0, sizeof(float) * (size_t)B * H * W * C, st));
  dim3 grid(tiles_x * tiles_y, splits, B);
  gdfn_kernel<TILE><<<grid, kThreads, smem, st>>>(
      x, w_in, dwk, w_out, y, H, W, C, hid, tiles_x, per_split,
      splits > 1 ? 1 : 0);
  return cudaGetLastError();
}

// Backward of rcot_conv1x1_dw for the cotangent g (B,H,W,M). Outputs dx
// (B,H,W,C), dw_in (M,C), ddw (M,3,3). Workspace: h (N,M), dh (N,M),
// N = B*H*W.
int rcot_conv1x1_dw_bwd(const float* x, const float* w_in, const float* dwk,
                        const float* g, float* dx, float* dw_in, float* ddw,
                        float* h, float* dh, int B, int H, int W, int C, int M,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  RCOT_TRY(cudaMemsetAsync(dw_in, 0, sizeof(float) * M * C, st));
  RCOT_TRY(cudaMemsetAsync(ddw, 0, sizeof(float) * M * 9, st));
  // recompute h = x @ W_in^T; with no gate and no W_out, dconv = g
  RCOT_TRY(gemm(x, C, 1, w_in, 1, C, h, M, (int)n, M, C, kStore, st));
  RCOT_TRY(launch_dw(g, dwk, dh, B, H, W, M, true, st));
  RCOT_TRY(launch_ddw(g, h, ddw, B, H, W, M, st));
  // dx = dh @ W_in, dW_in = dh^T x
  RCOT_TRY(gemm(dh, M, 1, w_in, C, 1, dx, C, (int)n, C, M, kStore, st));
  return gemm(dh, 1, M, x, C, 1, dw_in, C, M, C, n, kReduce, st);
}

// Backward of rcot_gdfn_fused for the cotangent g (B,H,W,C). Outputs dx
// (B,H,W,C), dw_in (2h,C), ddw (2h,3,3), dw_out (C,h). Workspace: h (N,2h),
// conv_dh (N,2h), dconv (N,2h), dgate (N,h), gate (N,h), N = B*H*W.
int rcot_gdfn_fused_bwd(const float* x, const float* w_in, const float* dwk,
                        const float* w_out, const float* g, float* dx,
                        float* dw_in, float* ddw, float* dw_out, float* h,
                        float* conv_dh, float* dconv, float* dgate, float* gate,
                        int B, int H, int W, int C, int hid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const int m2 = 2 * hid;
  RCOT_TRY(cudaMemsetAsync(dw_in, 0, sizeof(float) * m2 * C, st));
  RCOT_TRY(cudaMemsetAsync(ddw, 0, sizeof(float) * m2 * 9, st));
  RCOT_TRY(cudaMemsetAsync(dw_out, 0, sizeof(float) * C * hid, st));
  // recompute h = x @ W_in^T, conv = dw3x3(h)
  RCOT_TRY(gemm(x, C, 1, w_in, 1, C, h, m2, (int)n, m2, C, kStore, st));
  RCOT_TRY(launch_dw(h, dwk, conv_dh, B, H, W, m2, false, st));
  // W_out: dgate = g @ W_out, dW_out = g^T gate
  RCOT_TRY(gemm(g, C, 1, w_out, hid, 1, dgate, hid, (int)n, hid, C, kStore, st));
  gate_bwd_kernel<<<grid_for(n * hid), kThreads, 0, st>>>(conv_dh, dgate, dconv,
                                                          gate, n, hid);
  RCOT_TRY(cudaGetLastError());
  RCOT_TRY(gemm(g, 1, C, gate, hid, 1, dw_out, hid, C, hid, n, kReduce, st));
  // depthwise backward (conv is dead now: its buffer takes dh)
  RCOT_TRY(launch_dw(dconv, dwk, conv_dh, B, H, W, m2, true, st));
  RCOT_TRY(launch_ddw(dconv, h, ddw, B, H, W, m2, st));
  // W_in: dx = dh @ W_in, dW_in = dh^T x
  RCOT_TRY(gemm(conv_dh, m2, 1, w_in, C, 1, dx, C, (int)n, C, m2, kStore, st));
  return gemm(conv_dh, 1, m2, x, C, 1, dw_in, C, m2, C, n, kReduce, st);
}

}  // extern "C"
