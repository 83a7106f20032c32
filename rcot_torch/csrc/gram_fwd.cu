// MDTA attention core kernels for Hopper (sm_90a), forward only.
//
// Replace the TPU kernels of rcot_tpu/ops/pallas_gram.py:
//
//   mdta_gram (mdta_gram_fwd, pallas_gram.py:99, pallas_call at :106):
//       per (b, head h):  G = q^T k,  nq = sum q^2,  nk = sum k^2
//       summed over every pixel of the packed NHWC qkv = [q | k | v];
//   attn_apply (attn_apply_fwd, pallas_gram.py:178, pallas_call at :185):
//       out[pixel, h*ch + c] = sum_d v[pixel, h*ch + d] * attn[b, h, c, d].
//
// Head h occupies channels [h*ch, (h+1)*ch) of each third of qkv.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s):
// the Gram reads 2C floats and does 2*C*ch + 4*C flops per pixel, so it is
// bound by bytes (at 256^2, C = 48: ~7.5 us of bytes, ~4.6 us of flops);
// the apply reads C floats, writes C floats and does 2*C*ch flops per
// pixel, nearly balanced (~7.5 us of bytes, ~4.5 us of flops).
//
// Design. The TPU kernel carried G, nq and nk across a sequential grid of
// row bands; here blocks run in no order, so the Gram splits the pixels of
// each (b, h) over enough blocks to fill the card, each block sums its
// share in registers (a 16 x 16 thread grid, thread (ty, tx) owning rows
// ty + 16i and columns tx + 16j of G) from 32-pixel tiles staged in shared
// memory, and adds its partial into outputs zeroed on the stream first,
// with atomicAdd. The order of those adds changes from run to run, so G,
// nq and nk agree with a fixed-order sum to about 1e-6 relative, not
// bitwise. The apply stages attn^T of one head (ch*ch floats, 36 KB at
// ch = 96) and a 64-pixel tile of v in shared memory, one head per block,
// and each thread computes 4 pixels x R channels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGramTile = 32;   // pixels per shared-memory stage (Gram)
constexpr int kApplyTile = 64;  // pixels per block (apply)
constexpr int kMaxCh = 128;     // 16 * R with R <= 8

template <int R>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ qkv, float* __restrict__ gram,
            float* __restrict__ nq, float* __restrict__ nk, long long hw,
            int C, int heads, int ch, long long pix_per_block) {
  __shared__ float qs[kGramTile * kMaxCh];
  __shared__ float ks[kGramTile * kMaxCh];
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long begin = blockIdx.x * pix_per_block;
  const long long end = begin + pix_per_block < hw ? begin + pix_per_block : hw;
  const float* base = qkv + (long long)b * hw * 3 * C + h * ch;

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  float sq = 0.f;  // thread tid < ch: sum q^2 of channel tid;
                   // ch <= tid < 2ch: sum k^2 of channel tid - ch

  for (long long p0 = begin; p0 < end; p0 += kGramTile) {
    __syncthreads();
    for (int idx = tid; idx < kGramTile * ch; idx += kThreads) {
      const int p = idx / ch, c = idx % ch;
      const long long pix = p0 + p;
      float qv = 0.f, kv = 0.f;
      if (pix < end) {
        const float* row = base + pix * 3 * C;
        qv = row[c];
        kv = row[C + c];
      }
      qs[p * ch + c] = qv;
      ks[p * ch + c] = kv;
    }
    __syncthreads();
    for (int p = 0; p < kGramTile; ++p) {
      float a[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int c = ty + 16 * i;
        a[i] = c < ch ? qs[p * ch + c] : 0.f;
        const int d = tx + 16 * i;
        bv[i] = d < ch ? ks[p * ch + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (tid < 2 * ch) {
      const float* src = tid < ch ? qs + tid : ks + (tid - ch);
      for (int p = 0; p < kGramTile; ++p) {
        const float v = src[p * ch];
        sq = fmaf(v, v, sq);
      }
    }
  }

  const long long bh = (long long)b * heads + h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int d = tx + 16 * j;
      if (c < ch && d < ch) atomicAdd(gram + (bh * ch + c) * ch + d, acc[i][j]);
    }
  }
  if (tid < ch)
    atomicAdd(nq + bh * ch + tid, sq);
  else if (tid < 2 * ch)
    atomicAdd(nk + bh * ch + tid - ch, sq);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ qkv, const float* __restrict__ attn,
             float* __restrict__ out, long long hw, int C, int heads, int ch) {
  extern __shared__ float smem[];
  float* at = smem;                  // [ch][ch + 1]: at[d][c] = attn[c][d]
  float* vs = smem + ch * (ch + 1);  // [kApplyTile][ch]
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long p0 = (long long)blockIdx.x * kApplyTile;
  const float* a = attn + ((long long)b * heads + h) * ch * ch;

  for (int idx = tid; idx < ch * ch; idx += kThreads) {
    const int c = idx / ch, d = idx % ch;
    at[d * (ch + 1) + c] = a[idx];
  }
  for (int idx = tid; idx < kApplyTile * ch; idx += kThreads) {
    const int p = idx / ch, d = idx % ch;
    const long long pix = p0 + p;
    vs[idx] = pix < hw ? qkv[((long long)b * hw + pix) * 3 * C + 2 * C +
                             h * ch + d]
                       : 0.f;
  }
  __syncthreads();

  constexpr int PI = kApplyTile / 16;
  float acc[PI][R];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < ch; ++d) {
    float v[PI], w[R];
#pragma unroll
    for (int i = 0; i < PI; ++i) v[i] = vs[(ty + 16 * i) * ch + d];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      w[j] = c < ch ? at[d * (ch + 1) + c] : 0.f;
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
    float* o = out + ((long long)b * hw + pix) * C + h * ch;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      if (c < ch) o[c] = acc[i][j];
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <int R>
int launch_gram(const float* qkv, float* gram, float* nq, float* nk, int B,
                long long hw, int heads, int ch, cudaStream_t st) {
  const int C = heads * ch;
  // about four blocks per SM over all (b, h), at least one 32-pixel stage each
  const long long stages = (hw + kGramTile - 1) / kGramTile;
  long long n_blocks = (4LL * sm_count() + (long long)B * heads - 1) /
                       ((long long)B * heads);
  if (n_blocks > stages) n_blocks = stages;
  if (n_blocks < 1) n_blocks = 1;
  const long long per = (stages + n_blocks - 1) / n_blocks * kGramTile;
  n_blocks = (hw + per - 1) / per;
  dim3 grid((unsigned)n_blocks, heads, B);
  gram_kernel<R><<<grid, kThreads, 0, st>>>(qkv, gram, nq, nk, hw, C, heads,
                                            ch, per);
  return cudaGetLastError();
}

template <int R>
int launch_apply(const float* qkv, const float* attn, float* out, int B,
                 long long hw, int heads, int ch, cudaStream_t st) {
  const size_t smem = sizeof(float) * (ch * (ch + 1) + kApplyTile * ch);
  cudaError_t err = cudaFuncSetAttribute(
      apply_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((hw + kApplyTile - 1) / kApplyTile), heads, B);
  apply_kernel<R><<<grid, kThreads, smem, st>>>(qkv, attn, out, hw,
                                                heads * ch, heads, ch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (B, hw, 3*heads*ch) -> gram (B,heads,ch,ch), nq and nk (B,heads,ch);
// the outputs are zeroed here, on the stream, before the kernel adds in.
int rcot_mdta_gram(const float* qkv, float* gram, float* nq, float* nk, int B,
                   long long hw, int heads, int ch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n_g = sizeof(float) * B * heads * ch * ch;
  const size_t n_n = sizeof(float) * B * heads * ch;
  cudaError_t err = cudaMemsetAsync(gram, 0, n_g, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(nq, 0, n_n, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(nk, 0, n_n, st);
  if (err != cudaSuccess) return err;
  switch ((ch + 15) / 16) {
    case 1: return launch_gram<1>(qkv, gram, nq, nk, B, hw, heads, ch, st);
    case 2: return launch_gram<2>(qkv, gram, nq, nk, B, hw, heads, ch, st);
    case 3: return launch_gram<3>(qkv, gram, nq, nk, B, hw, heads, ch, st);
    case 4: return launch_gram<4>(qkv, gram, nq, nk, B, hw, heads, ch, st);
    case 5: return launch_gram<5>(qkv, gram, nq, nk, B, hw, heads, ch, st);
    case 6: return launch_gram<6>(qkv, gram, nq, nk, B, hw, heads, ch, st);
    case 7: return launch_gram<7>(qkv, gram, nq, nk, B, hw, heads, ch, st);
    case 8: return launch_gram<8>(qkv, gram, nq, nk, B, hw, heads, ch, st);
    default: return cudaErrorInvalidValue;
  }
}

// qkv (B, hw, 3*heads*ch), attn (B,heads,ch,ch) -> out (B, hw, heads*ch).
int rcot_attn_apply(const float* qkv, const float* attn, float* out, int B,
                    long long hw, int heads, int ch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch ((ch + 15) / 16) {
    case 1: return launch_apply<1>(qkv, attn, out, B, hw, heads, ch, st);
    case 2: return launch_apply<2>(qkv, attn, out, B, hw, heads, ch, st);
    case 3: return launch_apply<3>(qkv, attn, out, B, hw, heads, ch, st);
    case 4: return launch_apply<4>(qkv, attn, out, B, hw, heads, ch, st);
    case 5: return launch_apply<5>(qkv, attn, out, B, hw, heads, ch, st);
    case 6: return launch_apply<6>(qkv, attn, out, B, hw, heads, ch, st);
    case 7: return launch_apply<7>(qkv, attn, out, B, hw, heads, ch, st);
    case 8: return launch_apply<8>(qkv, attn, out, B, hw, heads, ch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
