// The apply's backward with bf16 operands, for Hopper (sm_90a): row 7
// under the JAX package's RCOT_BWD_BF16 "gram" tier (cli.train --bwd-bf16
// gram or all) in fp32 training (bf16 training's form is
// apply_bwd_bf16_b16ops.cu's).
//
// Replaces the TPU kernel attn_apply_bwd (rcot_tpu/ops/pallas_gram.py:219,
// pallas_call at :227) as the JAX package runs it with that tier on:
// dv = g attn and dattn = sum over pixels of g^T v with g, attn and v
// rounded to bf16 (_bwd_dot at :211-212); fp32 sums throughout.
//
// Bound on an H100 SXM by its bytes, as gram.cu's forms (its header).
//
// Design: apply_bwd.cu's kernel (gram_bwd.cuh) with each operand rounded
// as it enters its fragment and one tf32 mma.sync in place of 3xTF32's
// three, compiled in a source of its own so that it builds in parallel
// with the others.

#include <cuda_runtime.h>

#include "gram.cuh"
#include "gram_bwd.cuh"

extern "C" {

// rcot_attn_apply_bwd's arguments and outputs (apply_bwd.cu), bf16 operands.
int rcot_attn_apply_bwd_b16ops(const float* qkv, const float* attn, const float* g, float* dv,
                               float* dattn, float* ws, int B, long long hw, int heads, int ch,
                               int cb, int splits, long long per, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) \
  apply_bwd<R, true>(qkv, attn, g, dv, dattn, ws, B, hw, heads, ch, cb, splits, per, st)
  RCOT_BY_WIDTH(ch, cb, RCOT_CALL)
#undef RCOT_CALL
}

}  // extern "C"
