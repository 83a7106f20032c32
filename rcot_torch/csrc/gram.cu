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
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s):
// the Gram reads 2C floats and does 2*C*ch + 4*C flops per pixel, so it is
// bound by bytes (at 256^2, C = 48: ~7.5 us of bytes, ~4.6 us of flops);
// the apply reads C floats, writes C floats and does 2*C*ch flops per
// pixel, nearly balanced (~7.5 us of bytes, ~4.5 us of flops). The Gram
// backward moves 4C floats and does 4*C*ch + 4*C flops per pixel, the
// apply backward moves 3C floats and does 4*C*ch flops: near the balance
// point at ch = 48, bound by operations at ch = 96.
//
// Forward design (rows 3-4 of the kernel table). Both are bound by bytes
// at the main path's shapes, so each streams its input once through a
// cp.async ring (16-byte copies where ch % 4 == 0 and the rows are 16-byte
// aligned, 4-byte copies otherwise) and does its products on the tensor
// cores as 3xTF32 (mma.sync m16n8k8: a b ~ ah bh + ah bl + al bh with
// x = xh + xl split into two tf32 values), accumulating in fp32 registers,
// with ch zero-padded to 16R in shared memory. The hot loops have no
// branch (padding adds zeros) and issue each of the three terms over all
// of a warp's tiles before the next, so no product waits on another.
//   - gram_fwd_kernel: the pixels of each (b, head) are split into ranges
//     by a plan made in Python (ops/gram.py gram_plan), one block each, so
//     that the blocks fill the card about once. A block's eight warps
//     split the G tiles and the pixels of each stage; the sums of squares
//     come from the same fragments. The warps' partials are added in shared
//     memory in a fixed order and written with plain stores: into G, nq, nk
//     when a (b, head) is one range, else into a workspace that
//     gram_reduce_kernel sums over the ranges in a fixed order. No memset,
//     no atomics: the sums are the same bitwise on every call.
//   - apply_fwd_kernel: a grid of one or two blocks an SM walks contiguous
//     runs of 128-pixel tiles; attn[b, h], whose row-major layout is the
//     column-major B operand of out = v attn^T, is staged once per (b, h) a
//     block meets, already split into its tf32 parts. Each warp owns 16
//     rows of a tile and all its columns (each v value is split once), and
//     writes its results straight from the accumulators, 32 contiguous
//     bytes per group of four lanes. The kernels' shared-memory limits are
//     raised once per device.
// Every launch plan of this file (blocks, and the pixels or tiles each
// takes) is made in Python (ops/gram.py) from the SM count it reads once.
//
// Backward design (rows 6-7), two kernel shapes on the CUDA cores:
//   - pixel_gram: dattn_bh(c, d) += sum_n g[n, h*ch + c] v[n, h*ch + d].
//     The pixels of each (b, head) are split over enough blocks to fill the
//     card (ops/gram.py dattn_plan); each block sums in registers (a 16 x 16 thread grid, thread
//     (ty, tx) owning rows ty + 16i and columns tx + 16j) from 32-pixel
//     tiles staged in shared memory, and adds its partial into the output
//     zeroed on the stream first, with atomicAdd (an order that changes
//     from run to run: about 1e-6 relative, not bitwise).
//   - rowmix: out[n, h*ch + c] = sum_d in[n, h*ch + d] Mat_bh(c, d), or
//     Mat_bh(d, c), plus 2 self[n, h*ch + c] vec_bh[c] where asked. One
//     head and a 64-pixel tile per block, the ch x ch matrix staged
//     transposed in shared memory (36 KB at ch = 96), each thread 4 pixels
//     x R channels: dq (in = k, Mat = dG, self q), dk (in = q, Mat = dG^T,
//     self k) and dv (in = g, Mat = attn^T), each written only into its
//     own third, as the TPU kernels do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGramTile = 32;  // pixels per shared-memory stage (pixel_gram)
constexpr int kRowTile = 64;   // pixels per block (rowmix)
constexpr int kMaxCh = 128;    // 16 * R with R <= 8

struct Rows {  // a head's slice of an NHWC tensor: base[n*stride + off + h*ch]
  const float* base;
  long long stride;
  int off;
};

// G_bh += X^T Y over this block's pixels (the apply backward's dattn).
template <int R>
__global__ void __launch_bounds__(kThreads)
pixel_gram_kernel(Rows X, Rows Y, float* __restrict__ gram, long long hw,
                  int heads, int ch, long long pix_per_block) {
  __shared__ float xs[kGramTile * kMaxCh];
  __shared__ float ys[kGramTile * kMaxCh];
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long begin = blockIdx.x * pix_per_block;
  const long long end = begin + pix_per_block < hw ? begin + pix_per_block : hw;
  const float* xb = X.base + (long long)b * hw * X.stride + X.off + h * ch;
  const float* yb = Y.base + (long long)b * hw * Y.stride + Y.off + h * ch;

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;

  for (long long p0 = begin; p0 < end; p0 += kGramTile) {
    __syncthreads();
    for (int idx = tid; idx < kGramTile * ch; idx += kThreads) {
      const int p = idx / ch, c = idx % ch;
      const long long pix = p0 + p;
      const bool in = pix < end;
      xs[p * ch + c] = in ? xb[pix * X.stride + c] : 0.f;
      ys[p * ch + c] = in ? yb[pix * Y.stride + c] : 0.f;
    }
    __syncthreads();
    for (int p = 0; p < kGramTile; ++p) {
      float a[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int c = ty + 16 * i;
        a[i] = c < ch ? xs[p * ch + c] : 0.f;
        const int d = tx + 16 * i;
        bv[i] = d < ch ? ys[p * ch + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }

  const long long bh = (long long)b * heads + h;
  float* g = gram + bh * ch * ch;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int d = tx + 16 * j;
      if (c < ch && d < ch) atomicAdd(g + c * ch + d, acc[i][j]);
    }
  }
}

// TRANS = false: out = in Mat^T (out[c] = sum_d in[d] Mat[c][d]);
// TRANS = true:  out = in Mat   (out[c] = sum_d in[d] Mat[d][c]);
// plus 2 self[c] vec[c] where self.base is not null.
template <int R, bool TRANS>
__global__ void __launch_bounds__(kThreads)
rowmix_kernel(Rows in, const float* __restrict__ mat, Rows self,
              const float* __restrict__ vec, float* __restrict__ out,
              long long out_stride, int out_off, long long hw, int heads,
              int ch) {
  extern __shared__ float smem[];
  float* mt = smem;                  // [ch][ch + 1]: mt[d][c] = Mat(c, d)
  float* xs = smem + ch * (ch + 1);  // [kRowTile][ch]
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long p0 = (long long)blockIdx.x * kRowTile;
  const long long bh = (long long)b * heads + h;
  const float* m = mat + bh * ch * ch;

  for (int idx = tid; idx < ch * ch; idx += kThreads) {
    const int r = idx / ch, s = idx % ch;  // m[r][s]
    if (TRANS)
      mt[r * (ch + 1) + s] = m[idx];  // mt[d = r][c = s]
    else
      mt[s * (ch + 1) + r] = m[idx];  // mt[d = s][c = r]
  }
  for (int idx = tid; idx < kRowTile * ch; idx += kThreads) {
    const int p = idx / ch, d = idx % ch;
    const long long pix = p0 + p;
    xs[idx] = pix < hw ? in.base[((long long)b * hw + pix) * in.stride +
                                 in.off + h * ch + d]
                       : 0.f;
  }
  __syncthreads();

  constexpr int PI = kRowTile / 16;
  float acc[PI][R];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < ch; ++d) {
    float v[PI], w[R];
#pragma unroll
    for (int i = 0; i < PI; ++i) v[i] = xs[(ty + 16 * i) * ch + d];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      w[j] = c < ch ? mt[d * (ch + 1) + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(v[i], w[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < PI; ++i) {
    const long long pix = p0 + ty + 16 * i;
    if (pix >= hw) continue;
    const long long row = (long long)b * hw + pix;
    float* o = out + row * out_stride + out_off + h * ch;
    const float* sp =
        self.base ? self.base + row * self.stride + self.off + h * ch : nullptr;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      if (c >= ch) continue;
      float r = acc[i][j];
      if (sp) r = fmaf(2.0f * sp[c], vec[bh * ch + c], r);
      o[c] = r;
    }
  }
}

// n_blocks blocks of `per` pixels per (b, h), as ops/gram.py dattn_plan
// gives them
template <int R>
cudaError_t launch_pixel_gram(Rows X, Rows Y, float* gram, int B, long long hw, int heads,
                              int ch, int n_blocks, long long per, cudaStream_t st) {
  dim3 grid((unsigned)n_blocks, heads, B);
  pixel_gram_kernel<R><<<grid, kThreads, 0, st>>>(X, Y, gram, hw, heads, ch,
                                                  per);
  return cudaGetLastError();
}

template <int R, bool TRANS>
cudaError_t launch_rowmix(Rows in, const float* mat, Rows self,
                          const float* vec, float* out, long long out_stride,
                          int out_off, int B, long long hw, int heads, int ch,
                          cudaStream_t st) {
  const size_t smem = sizeof(float) * (ch * (ch + 1) + kRowTile * ch);
  cudaError_t err = cudaFuncSetAttribute(
      rowmix_kernel<R, TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((hw + kRowTile - 1) / kRowTile), heads, B);
  rowmix_kernel<R, TRANS><<<grid, kThreads, smem, st>>>(
      in, mat, self, vec, out, out_stride, out_off, hw, heads, ch);
  return cudaGetLastError();
}

constexpr Rows kNone{nullptr, 0, 0};

// ------------------------------------------------- the forward kernels

constexpr int kGramStages = 3;   // depth of each kernel's cp.async ring
constexpr int kApplyStages = 3;
constexpr int kApplyTP = 128;    // pixels per apply tile: eight warps of 16 rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dst <- src (16 or 4 bytes), or zeros where !in (the source is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [p0, p0 + rows) of a head slice (row r at src + r * stride, ch
// floats) into a tile of pitch ld; rows at or past `end` are zero-filled.
// Thread t copies pieces t, t + kThreads, ... of the row-major tile.
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src,
                                           long long stride, long long p0,
                                           long long end, int rows, int ch) {
  const int w = VEC ? 4 : 1, per_row = ch / w;  // pieces of w floats per row
  const int dr = kThreads / per_row, dc = kThreads - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  while (r < rows) {
    const bool in = p0 + r < end;
    const float* from = src + (in ? (p0 + r) * stride : 0) + c * w;
    if (VEC)
      cp_async16(dst + r * ld + c * w, from, in);
    else
      cp_async4(dst + r * ld + c, from, in);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// x = hi + lo + O(2^-22 |x|), hi and lo tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d += a b on the tensor cores. Not volatile, so that the compiler may
// interleave independent products and hide each one's latency.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 over a warp's M x N tiles of one 8-deep step: acc[i][j] += a_i b_j
// as al bh + ah bl + ah bh (al bl, ~2^-22 of the product, dropped), each
// term over every tile before the next, so that no product waits on the
// one before it. Tiles outside the matrix (use_m, use_n false) are skipped.
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[M][N][4], uint32_t (&ah)[M][4],
                                           uint32_t (&al)[M][4], uint32_t (&bh)[N][2],
                                           uint32_t (&bl)[N][2], const bool (&use_m)[M],
                                           const bool (&use_n)[N]) {
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (use_m[i] && use_n[j])
          mma_tf32(acc[i][j], term == 0 ? al[i] : ah[i], term == 1 ? bl[j] : bh[j]);
}

// The Gram at head width ch <= 16R: G (16R x 16R, zero-padded) in 16 x 8
// mma tiles, R row tiles by 2R column tiles. The eight warps split the
// tiles (WTM x WTN) and the pixels of each stage (WK groups); each warp
// holds MW x NW tiles in registers.
template <int R>
struct GramCfg {
  static constexpr int CHP = 16 * R;
  static constexpr int LD = CHP + 8;  // pitch: fragment reads hit 32 banks
  static constexpr int MT = R, NT = 2 * R;
  static constexpr int WK = R <= 2 ? 8 : (R <= 4 ? 4 : 1);
  static constexpr int WTM = R <= 4 ? 1 : 2;
  static constexpr int WTN = R <= 2 ? 1 : (R <= 4 ? 2 : 4);
  static constexpr int MW = (MT + WTM - 1) / WTM, NW = (NT + WTN - 1) / WTN;
  static constexpr int TP = R <= 4 ? 64 : 32;   // pixels per stage
  static constexpr int KS = TP / (8 * WK);      // 8-pixel steps per warp and stage
  static constexpr int STAGE = 2 * TP * LD;     // q tile, k tile
  static constexpr int RP = CHP + 1;             // pitch of a partial G: stores spread over banks
  static constexpr int E = CHP * RP + 2 * CHP;   // one warp group's partial
  static constexpr int FLOATS =
      kGramStages * STAGE > WK * E ? kGramStages * STAGE : WK * E;
  static_assert(WK * WTM * WTN == kThreads / 32, "eight warps");
  static_assert(KS >= 1, "a stage feeds every warp group");
};

// Block (s, bh) sums G = q^T k, nq = sum q^2 and nk = sum k^2 over pixels
// [s * per, (s + 1) * per) of (b, h) and writes them with plain stores to
// g_out + (bh * splits + s) * g_stride (nq, nk likewise with n_stride): the
// outputs themselves when splits == 1, else the workspace that
// gram_reduce_kernel sums.
template <int R, bool VEC>
__global__ void __launch_bounds__(kThreads)
gram_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ g_out,
                float* __restrict__ nq_out, float* __restrict__ nk_out,
                long long g_stride, long long n_stride, long long hw, int heads,
                int ch, int splits, long long per) {
  using Cfg = GramCfg<R>;
  constexpr int LD = Cfg::LD, TP = Cfg::TP, CHP = Cfg::CHP, MW = Cfg::MW, NW = Cfg::NW;
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x, bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const long long C = (long long)heads * ch, stride = 3 * C;
  const long long begin = s * per;
  const long long end = begin + per < hw ? begin + per : hw;
  const float* q_rows = qkv + (long long)b * hw * stride + (long long)h * ch;
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

  // the copies never write columns [ch, LD): zero them once
  for (int i = tid; i < kGramStages * 2 * TP * (LD - ch); i += kThreads) {
    const int r = i / (LD - ch);
    smem[r * LD + ch + (i - r * (LD - ch))] = 0.f;
  }
  const int n_tiles = (int)((end - begin + TP - 1) / TP);
  auto load = [&](int t) {
    float* dst = smem + (t % kGramStages) * Cfg::STAGE;
    const long long p0 = begin + (long long)t * TP;
    stage_rows<VEC>(dst, LD, q_rows, stride, p0, end, TP, ch);
    stage_rows<VEC>(dst + TP * LD, LD, q_rows + C, stride, p0, end, TP, ch);
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
  float* go = g_out + unit * g_stride;
  for (int c = warp; c < ch; c += kThreads / 32)
    for (int d = lane; d < ch; d += 32) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < Cfg::WK; ++w) v += smem[w * Cfg::E + c * RP + d];
      go[c * ch + d] = v;
    }
  for (int e = tid; e < 2 * CHP; e += kThreads) {
    const int which = e / CHP, c = e - which * CHP;
    if (c >= ch) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < Cfg::WK; ++w) v += smem[w * Cfg::E + SQ + e];
    (which ? nk_out : nq_out)[unit * n_stride + c] = v;
  }
}

// out = sum over s of the workspace's partials in a fixed order (warp w
// of W adds s = w, w + W, ...; then the W warps' sums in order), so the
// result is the same bitwise on every call. Workspace (B*heads, splits,
// ch*ch + 2ch) -> G | nq | nk; block (x, bh) sums 32 entries of (b, h),
// with W = min(splits, kReduceWarps) warps.
constexpr int kReduceWarps = 16;

__global__ void __launch_bounds__(32 * kReduceWarps)
gram_reduce_kernel(const float* __restrict__ ws, float* __restrict__ gram,
                   float* __restrict__ nq, float* __restrict__ nk, int ch, int splits) {
  __shared__ float part[kReduceWarps][32];
  const int bh = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int n_g = ch * ch, E = n_g + 2 * ch;
  const int e = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (e < E) {
    const float* src = ws + (long long)bh * splits * E + e;
#pragma unroll 8
    for (int s = w; s < splits; s += W) v += src[(long long)s * E];
  }
  part[w][lane] = v;
  __syncthreads();
  if (w != 0 || e >= E) return;
  float t = 0.f;
  for (int i = 0; i < W; ++i) t += part[i][lane];
  if (e < n_g)
    gram[(long long)bh * n_g + e] = t;
  else if (e < n_g + ch)
    nq[(long long)bh * ch + e - n_g] = t;
  else
    nk[(long long)bh * ch + e - n_g - ch] = t;
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
// block k walks tiles [k * per_block, (k + 1) * per_block), restaging attn
// only where bh changes, with the v tiles streaming through the ring. The
// results leave straight from the accumulators: each group of four lanes
// writes 32 contiguous bytes of a row.
template <int R, bool VEC>
__global__ void __launch_bounds__(kThreads)
apply_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ attn,
                 float* __restrict__ out, long long hw, int heads, int ch,
                 long long tiles_per_bh, long long n_tiles_all, long long per_block) {
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
  const long long C = (long long)heads * ch, stride = 3 * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = warp * 16;
  const bool use_m[1] = {true};
  bool use_n[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) use_n[j] = true;  // no branch in the hot loop: padding adds zeros

  // the product runs over d < CHP: the v columns [ch, LD) stay zero
  for (int i = tid; i < STAGES * TP * (LD - ch); i += kThreads) {
    const int r = i / (LD - ch);
    ring[r * LD + ch + (i - r * (LD - ch))] = 0.f;
  }
  auto load = [&](int i) {
    const long long t = t0 + i, bh = t / tiles_per_bh, b = bh / heads;
    stage_rows<VEC>(ring + (i % STAGES) * TP * LD, LD,
                    qkv + b * hw * stride + (bh - b * heads) * ch + 2 * C, stride,
                    (t - bh * tiles_per_bh) * TP, hw, TP, ch);
  };
  auto stage_attn = [&](long long bh) {  // zero outside ch x ch
    const float* a = attn + bh * ch * ch;
    for (int idx = tid; idx < CHP * CHP; idx += kThreads) {
      const int c = idx / CHP, d = idx - c * CHP;
      const float x = c < ch && d < ch ? a[c * ch + d] : 0.f;
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
    float* ob = out + b * hw * C + (bh - b * heads) * ch;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * tig;
      if (c >= ch) continue;
      if (VEC) {  // ch is even: c + 1 < ch
        if (r0 < hw) *reinterpret_cast<float2*>(ob + r0 * C + c) = make_float2(acc[0][j][0], acc[0][j][1]);
        if (r1 < hw) *reinterpret_cast<float2*>(ob + r1 * C + c) = make_float2(acc[0][j][2], acc[0][j][3]);
      } else {
        const bool c1 = c + 1 < ch;
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

// Raise the dynamic shared-memory limit of a kernel's two variants to
// `floats`, once per device (the attribute is the device's): `done` is the
// caller's function-local flags. A failure is returned and tried again on
// the next call.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(bool (&done)[kMaxDevices], Kernel k1, Kernel k2, int floats) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  const Kernel ks[2] = {k1, k2};
  for (int i = 0; i < 2; ++i) {
    e = cudaFuncSetAttribute(ks[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(float) * floats);
    if (e != cudaSuccess) return e;
  }
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int R>
cudaError_t gram_fwd(const float* qkv, float* gram, float* nq, float* nk, float* ws,
                     int B, long long hw, int heads, int ch, int splits, long long per,
                     cudaStream_t st) {
  using Cfg = GramCfg<R>;
  static bool done[kMaxDevices];
  const cudaError_t attr =
      allow_smem(done, gram_fwd_kernel<R, true>, gram_fwd_kernel<R, false>, Cfg::FLOATS);
  if (attr != cudaSuccess) return attr;
  const bool vec = ch % 4 == 0 && aligned16(qkv);
  const dim3 grid((unsigned)splits, (unsigned)(B * heads));
  const size_t smem = sizeof(float) * Cfg::FLOATS;
  const long long E = (long long)ch * ch + 2 * ch;
  float* g_out = splits > 1 ? ws : gram;
  float* nq_out = splits > 1 ? ws + ch * ch : nq;
  float* nk_out = splits > 1 ? ws + ch * ch + ch : nk;
  const long long g_stride = splits > 1 ? E : (long long)ch * ch;
  const long long n_stride = splits > 1 ? E : ch;
  const auto kernel = vec ? gram_fwd_kernel<R, true> : gram_fwd_kernel<R, false>;
  kernel<<<grid, kThreads, smem, st>>>(qkv, g_out, nq_out, nk_out, g_stride, n_stride, hw,
                                       heads, ch, splits, per);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int warps = splits < kReduceWarps ? splits : kReduceWarps;
    gram_reduce_kernel<<<dim3((unsigned)((E + 31) / 32), (unsigned)(B * heads)), 32 * warps,
                         0, st>>>(ws, gram, nq, nk, ch, splits);
  }
  return cudaGetLastError();
}

// `blocks` blocks of `per_block` tiles, as ops/gram.py apply_plan gives them
template <int R>
cudaError_t apply_fwd(const float* qkv, const float* attn, float* out, int B, long long hw,
                      int heads, int ch, int blocks, long long per_block, cudaStream_t st) {
  using Cfg = ApplyCfg<R>;
  static bool done[kMaxDevices];
  const cudaError_t attr =
      allow_smem(done, apply_fwd_kernel<R, true>, apply_fwd_kernel<R, false>, Cfg::FLOATS);
  if (attr != cudaSuccess) return attr;
  const bool vec = ch % 4 == 0 && aligned16(qkv) && aligned16(attn) && aligned16(out);
  const long long tiles_per_bh = (hw + kApplyTP - 1) / kApplyTP;
  const long long n_tiles = tiles_per_bh * B * heads;
  const auto kernel = vec ? apply_fwd_kernel<R, true> : apply_fwd_kernel<R, false>;
  kernel<<<(unsigned)blocks, kThreads, sizeof(float) * Cfg::FLOATS, st>>>(
      qkv, attn, out, hw, heads, ch, tiles_per_bh, n_tiles, per_block);
  return cudaGetLastError();
}

template <int R>
cudaError_t gram_bwd(const float* qkv, const float* dgram, const float* dnq,
                     const float* dnk, float* dqdk, int B, long long hw,
                     int heads, int ch, cudaStream_t st) {
  const int C = heads * ch;
  const Rows q{qkv, 3LL * C, 0}, k{qkv, 3LL * C, C};
  // dq = k dG^T + 2 q dnq -> channels [0, C) of d[q|k]
  cudaError_t err = launch_rowmix<R, false>(k, dgram, q, dnq, dqdk, 2LL * C, 0,
                                            B, hw, heads, ch, st);
  if (err != cudaSuccess) return err;
  // dk = q dG + 2 k dnk -> channels [C, 2C)
  return launch_rowmix<R, true>(q, dgram, k, dnk, dqdk, 2LL * C, C, B, hw,
                                heads, ch, st);
}

template <int R>
cudaError_t apply_bwd(const float* qkv, const float* attn, const float* g,
                      float* dv, float* dattn, int B, long long hw, int heads,
                      int ch, int n_blocks, long long per, cudaStream_t st) {
  const int C = heads * ch;
  const Rows gr{g, C, 0};
  // dv = g attn
  cudaError_t err = launch_rowmix<R, true>(gr, attn, kNone, nullptr, dv, C, 0,
                                           B, hw, heads, ch, st);
  if (err != cudaSuccess) return err;
  // dattn = sum over pixels of g^T v
  err = cudaMemsetAsync(dattn, 0, sizeof(float) * B * heads * ch * ch, st);
  if (err != cudaSuccess) return err;
  return launch_pixel_gram<R>(gr, Rows{qkv, 3LL * C, 2 * C}, dattn, B, hw, heads,
                              ch, n_blocks, per, st);
}

}  // namespace

// ch <= 128 picks R = ceil(ch / 16) in 1..8; anything wider is refused.
#define RCOT_BY_WIDTH(ch, CALL)           \
  switch (((ch) + 15) / 16) {             \
    case 1: return CALL(1);               \
    case 2: return CALL(2);               \
    case 3: return CALL(3);               \
    case 4: return CALL(4);               \
    case 5: return CALL(5);               \
    case 6: return CALL(6);               \
    case 7: return CALL(7);               \
    case 8: return CALL(8);               \
    default: return cudaErrorInvalidValue; \
  }

extern "C" {

// qkv (B, hw, 3*heads*ch) -> gram (B,heads,ch,ch), nq and nk (B,heads,ch).
// The pixels of each (b, head) are split into `splits` ranges of `per`
// (ops/gram.py gram_plan); with splits > 1 the partials go to ws
// (B*heads*splits*(ch*ch + 2ch) floats) and a second launch sums them.
int rcot_mdta_gram(const float* qkv, float* gram, float* nq, float* nk, float* ws,
                   int B, long long hw, int heads, int ch, int splits, long long per,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) gram_fwd<R>(qkv, gram, nq, nk, ws, B, hw, heads, ch, splits, per, st)
  RCOT_BY_WIDTH(ch, RCOT_CALL)
#undef RCOT_CALL
}

// qkv (B, hw, 3*heads*ch), attn (B,heads,ch,ch) -> out (B, hw, heads*ch),
// on `blocks` blocks of `per_block` 128-pixel tiles (ops/gram.py apply_plan).
int rcot_attn_apply(const float* qkv, const float* attn, float* out, int B,
                    long long hw, int heads, int ch, int blocks, long long per_block,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) apply_fwd<R>(qkv, attn, out, B, hw, heads, ch, blocks, per_block, st)
  RCOT_BY_WIDTH(ch, RCOT_CALL)
#undef RCOT_CALL
}

// qkv (B, hw, 3*heads*ch), dgram (B,heads,ch,ch), dnq, dnk (B,heads,ch)
// -> dqdk (B, hw, 2*heads*ch) = [dq | dk].
int rcot_mdta_gram_bwd(const float* qkv, const float* dgram, const float* dnq,
                       const float* dnk, float* dqdk, int B, long long hw,
                       int heads, int ch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) gram_bwd<R>(qkv, dgram, dnq, dnk, dqdk, B, hw, heads, ch, st)
  RCOT_BY_WIDTH(ch, RCOT_CALL)
#undef RCOT_CALL
}

// qkv (B, hw, 3*heads*ch), attn (B,heads,ch,ch), g (B, hw, heads*ch)
// -> dv (B, hw, heads*ch), dattn (B,heads,ch,ch); dattn is zeroed here and
// summed by n_blocks blocks of `per` pixels per (b, head) (ops/gram.py
// dattn_plan).
int rcot_attn_apply_bwd(const float* qkv, const float* attn, const float* g,
                        float* dv, float* dattn, int B, long long hw,
                        int heads, int ch, int n_blocks, long long per, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) apply_bwd<R>(qkv, attn, g, dv, dattn, B, hw, heads, ch, n_blocks, per, st)
  RCOT_BY_WIDTH(ch, RCOT_CALL)
#undef RCOT_CALL
}

}  // extern "C"
