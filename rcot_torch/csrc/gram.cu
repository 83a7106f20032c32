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
// Design. The TPU kernels carried their pixel sums across a sequential
// grid of row bands; here blocks run in no order. Two kernel shapes cover
// all six products:
//   - pixel_gram: G_bh(c, d) += sum_n X[n, h*ch + c] Y[n, h*ch + d] (and,
//     for the forward Gram, the sums of squares). The pixels of each
//     (b, head) are split over enough blocks to fill the card; each block
//     sums in registers (a 16 x 16 thread grid, thread (ty, tx) owning rows
//     ty + 16i and columns tx + 16j) from 32-pixel tiles staged in shared
//     memory, and adds its partial into outputs zeroed on the stream first,
//     with atomicAdd. The order of those adds changes from run to run, so
//     the sums agree with a fixed-order sum to about 1e-6 relative, not
//     bitwise. Forward: X = q, Y = k. Backward: dattn with X = g, Y = v.
//   - rowmix: out[n, h*ch + c] = sum_d in[n, h*ch + d] Mat_bh(c, d), or
//     Mat_bh(d, c), plus 2 self[n, h*ch + c] vec_bh[c] where asked. One
//     head and a 64-pixel tile per block, the ch x ch matrix staged
//     transposed in shared memory (36 KB at ch = 96), each thread 4 pixels
//     x R channels. Forward: the apply (in = v, Mat = attn). Backward: dq
//     (in = k, Mat = dG, self q), dk (in = q, Mat = dG^T, self k) and dv
//     (in = g, Mat = attn^T), each written only into its own third, as the
//     TPU kernels do.

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

// G_bh += X^T Y over this block's pixels; with NORMS also nx += sum X^2 and
// ny += sum Y^2 per channel.
template <int R, bool NORMS>
__global__ void __launch_bounds__(kThreads)
pixel_gram_kernel(Rows X, Rows Y, float* __restrict__ gram,
                  float* __restrict__ nx, float* __restrict__ ny, long long hw,
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
  float sq = 0.f;  // NORMS: thread tid < ch sums x^2 of channel tid,
                   // ch <= tid < 2ch sums y^2 of channel tid - ch

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
    if (NORMS && tid < 2 * ch) {
      const float* src = tid < ch ? xs + tid : ys + (tid - ch);
      for (int p = 0; p < kGramTile; ++p) {
        const float v = src[p * ch];
        sq = fmaf(v, v, sq);
      }
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
  if (NORMS) {
    if (tid < ch)
      atomicAdd(nx + bh * ch + tid, sq);
    else if (tid < 2 * ch)
      atomicAdd(ny + bh * ch + tid - ch, sq);
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

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <int R, bool NORMS>
cudaError_t launch_pixel_gram(Rows X, Rows Y, float* gram, float* nx,
                              float* ny, int B, long long hw, int heads,
                              int ch, cudaStream_t st) {
  // about four blocks per SM over all (b, h), at least one stage each
  const long long stages = (hw + kGramTile - 1) / kGramTile;
  long long n_blocks = (4LL * sm_count() + (long long)B * heads - 1) /
                       ((long long)B * heads);
  if (n_blocks > stages) n_blocks = stages;
  if (n_blocks < 1) n_blocks = 1;
  const long long per = (stages + n_blocks - 1) / n_blocks * kGramTile;
  n_blocks = (hw + per - 1) / per;
  dim3 grid((unsigned)n_blocks, heads, B);
  pixel_gram_kernel<R, NORMS><<<grid, kThreads, 0, st>>>(X, Y, gram, nx, ny,
                                                         hw, heads, ch, per);
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

template <int R>
cudaError_t gram_fwd(const float* qkv, float* gram, float* nq, float* nk,
                     int B, long long hw, int heads, int ch, cudaStream_t st) {
  const int C = heads * ch;
  const size_t n_g = sizeof(float) * B * heads * ch * ch;
  const size_t n_n = sizeof(float) * B * heads * ch;
  cudaError_t err = cudaMemsetAsync(gram, 0, n_g, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(nq, 0, n_n, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(nk, 0, n_n, st);
  if (err != cudaSuccess) return err;
  return launch_pixel_gram<R, true>(Rows{qkv, 3LL * C, 0}, Rows{qkv, 3LL * C, C},
                                    gram, nq, nk, B, hw, heads, ch, st);
}

template <int R>
cudaError_t apply_fwd(const float* qkv, const float* attn, float* out, int B,
                      long long hw, int heads, int ch, cudaStream_t st) {
  const int C = heads * ch;
  return launch_rowmix<R, false>(Rows{qkv, 3LL * C, 2 * C}, attn, kNone,
                                 nullptr, out, C, 0, B, hw, heads, ch, st);
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
                      int ch, cudaStream_t st) {
  const int C = heads * ch;
  const Rows gr{g, C, 0};
  // dv = g attn
  cudaError_t err = launch_rowmix<R, true>(gr, attn, kNone, nullptr, dv, C, 0,
                                           B, hw, heads, ch, st);
  if (err != cudaSuccess) return err;
  // dattn = sum over pixels of g^T v
  err = cudaMemsetAsync(dattn, 0, sizeof(float) * B * heads * ch * ch, st);
  if (err != cudaSuccess) return err;
  return launch_pixel_gram<R, false>(gr, Rows{qkv, 3LL * C, 2 * C}, dattn,
                                     nullptr, nullptr, B, hw, heads, ch, st);
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

// qkv (B, hw, 3*heads*ch) -> gram (B,heads,ch,ch), nq and nk (B,heads,ch);
// the outputs are zeroed here, on the stream, before the kernel adds in.
int rcot_mdta_gram(const float* qkv, float* gram, float* nq, float* nk, int B,
                   long long hw, int heads, int ch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) gram_fwd<R>(qkv, gram, nq, nk, B, hw, heads, ch, st)
  RCOT_BY_WIDTH(ch, RCOT_CALL)
#undef RCOT_CALL
}

// qkv (B, hw, 3*heads*ch), attn (B,heads,ch,ch) -> out (B, hw, heads*ch).
int rcot_attn_apply(const float* qkv, const float* attn, float* out, int B,
                    long long hw, int heads, int ch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) apply_fwd<R>(qkv, attn, out, B, hw, heads, ch, st)
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
// -> dv (B, hw, heads*ch), dattn (B,heads,ch,ch); dattn is zeroed here.
int rcot_attn_apply_bwd(const float* qkv, const float* attn, const float* g,
                        float* dv, float* dattn, int B, long long hw,
                        int heads, int ch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) apply_bwd<R>(qkv, attn, g, dv, dattn, B, hw, heads, ch, st)
  RCOT_BY_WIDTH(ch, RCOT_CALL)
#undef RCOT_CALL
}

}  // extern "C"
