// The MDTA Gram core's backward kernels on a bf16 qkv, for Hopper
// (sm_90a): the attention core of bf16 training (cli.train --dtype
// bfloat16).
//
// Replace the TPU kernels of rcot_tpu/ops/pallas_gram.py as the JAX
// package runs them on a bf16 qkv:
//
//   mdta_gram_bwd_bf16 (mdta_gram_bwd, :141, pallas_call at :149, body
//   :120-138): qkv widened to fp32; dq = k dG^T + 2 q dnq and
//   dk = q dG + 2 k dnk in fp32 (dG, dnq, dnk fp32); d[q|k] written in bf16;
//   attn_apply_bwd_bf16 (attn_apply_bwd, :219, pallas_call at :227, body
//   :195-216): v and g widened to fp32; dv = g attn with the fp32 attn (not
//   the bf16-rounded attn the forward applied, :171), written in bf16;
//   dattn = sum over pixels of g^T v, fp32.
//
// Neither has a rounding point inside: each is the fp32 computation on the
// widened inputs, rounded at its bf16 outputs. Bound on an H100 SXM by
// their bytes (gram.cu's header; bf16 halves them): the Gram backward
// reads 4C and writes 4C bytes a pixel, the apply backward reads 4C and
// writes 2C.
//
// Design. One launch widens the q and k thirds (or the v third and g) into
// fp32 workspaces of qkv's layout (cast.cuh); then gram.cu's fp32 kernels
// (rcot_mdta_gram_bwd, rcot_attn_apply_bwd: 3xTF32 mma.sync, cp.async
// rings reading each input once, the channel blocks of heads wider than
// 128, every pixel sum in a fixed order) run on them with the fp32 plans
// (ops/gram.py gram_bwd_plan, gram_pairs_plan); one last launch rounds
// d[q|k] (or dv) to bf16. No atomics and no memsets: two calls on the same
// inputs give the same bits. With `ops16` (RCOT_BWD_BF16's "gram" tier)
// the fp32 kernels are their bf16-operand forms (gram_bwd_b16ops.cu,
// apply_bwd_b16ops.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cast.cuh"

// the fp32 backward kernels (gram_bwd.cu, apply_bwd.cu, where their
// arguments are documented) and their bf16-operand forms (*_b16ops.cu)
extern "C" {
int rcot_mdta_gram_bwd(const float* qkv, const float* dgram, const float* dnq, const float* dnk,
                       float* dqdk, float* ws, int B, long long hw, int heads, int ch, int cb,
                       int blocks, long long per_block, void* stream);
int rcot_mdta_gram_bwd_b16ops(const float* qkv, const float* dgram, const float* dnq,
                              const float* dnk, float* dqdk, float* ws, int B, long long hw,
                              int heads, int ch, int cb, int blocks, long long per_block,
                              void* stream);
int rcot_attn_apply_bwd(const float* qkv, const float* attn, const float* g, float* dv,
                        float* dattn, float* ws, int B, long long hw, int heads, int ch, int cb,
                        int splits, long long per, void* stream);
int rcot_attn_apply_bwd_b16ops(const float* qkv, const float* attn, const float* g, float* dv,
                               float* dattn, float* ws, int B, long long hw, int heads, int ch,
                               int cb, int splits, long long per, void* stream);
}

extern "C" {

// qkv (B, hw, 3*heads*ch) bf16, dgram (B,heads,ch,ch), dnq, dnk
// (B,heads,ch) fp32 -> dqdk (B, hw, 2*heads*ch) = [dq | dk] bf16.
// Workspace (fp32): qkv32 (B*hw, 3*heads*ch; its q and k thirds are
// written and read), dqdk32 (B*hw, 2*heads*ch) and ws (rcot_mdta_gram_bwd's).
// blocks, per_block: ops/gram.py gram_bwd_plan. ops16: 1 takes the
// bf16-operand form.
int rcot_mdta_gram_bwd_bf16(const bf16* qkv, const float* dgram, const float* dnq,
                            const float* dnk, bf16* dqdk, float* qkv32, float* dqdk32, float* ws,
                            int B, long long hw, int heads, int ch, int cb, int blocks,
                            long long per_block, int ops16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * hw;
  const int C = heads * ch;
  Widen up;
  up.add(qkv, 3LL * C, qkv32, 3LL * C, n, 2 * C);
  cudaError_t err = up.run(st);
  if (err == cudaSuccess)
    err = (cudaError_t)(ops16 ? rcot_mdta_gram_bwd_b16ops : rcot_mdta_gram_bwd)(
        qkv32, dgram, dnq, dnk, dqdk32, ws, B, hw, heads, ch, cb, blocks, per_block, stream);
  if (err != cudaSuccess) return err;
  Narrow down;
  down.add(dqdk32, 2LL * C, dqdk, 2LL * C, n, 2 * C);
  return down.run(st);
}

// qkv (B, hw, 3*heads*ch) bf16, attn (B,heads,ch,ch) fp32, g (B, hw,
// heads*ch) bf16 -> dv (B, hw, heads*ch) bf16, dattn (B,heads,ch,ch) fp32.
// Workspace (fp32): qkv32 (B*hw, 3*heads*ch; its v third is written and
// read), g32 and dv32 (B*hw, heads*ch), and ws (rcot_attn_apply_bwd's).
// splits, per: ops/gram.py gram_pairs_plan. ops16: 1 takes the
// bf16-operand form.
int rcot_attn_apply_bwd_bf16(const bf16* qkv, const float* attn, const bf16* g, bf16* dv,
                             float* dattn, float* qkv32, float* g32, float* dv32, float* ws,
                             int B, long long hw, int heads, int ch, int cb, int splits,
                             long long per, int ops16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * hw;
  const int C = heads * ch;
  Widen up;
  up.add(qkv + 2LL * C, 3LL * C, qkv32 + 2LL * C, 3LL * C, n, C);
  up.add(g, C, g32, C, n, C);
  cudaError_t err = up.run(st);
  if (err == cudaSuccess)
    err = (cudaError_t)(ops16 ? rcot_attn_apply_bwd_b16ops : rcot_attn_apply_bwd)(
        qkv32, attn, g32, dv32, dattn, ws, B, hw, heads, ch, cb, splits, per, stream);
  if (err != cudaSuccess) return err;
  Narrow down;
  down.add(dv32, C, dv, C, n, C);
  return down.run(st);
}

}  // extern "C"
