// The Gram backward with bf16 operands, for Hopper (sm_90a): row 6 under
// the JAX package's RCOT_BWD_BF16 "gram" tier (cli.train --bwd-bf16 gram or
// all) in fp32 training (bf16 training's form is gram_bwd_bf16_b16ops.cu's).
//
// Replaces the TPU kernel mdta_gram_bwd (rcot_tpu/ops/pallas_gram.py:141,
// pallas_call at :149) as the JAX package runs it with that tier on:
// dq = k dG^T + 2 q dnq and dk = q dG + 2 k dnk with k, q and dG rounded to
// bf16 for the two products (_bwd_dot at :129-130) and the norm terms on
// the fp32 q and k; fp32 sums throughout. Row 7's form is in
// apply_bwd_b16ops.cu.
//
// Bound on an H100 SXM by their bytes, as gram.cu's forms (its header): the
// products' flops at 989 TFLOP/s on bf16 operands are far below the bytes'
// time at the main path's widths.
//
// Design: gram_bwd.cu's kernel (gram_bwd.cuh), the same launches, plans,
// rings and fixed-order sums, with each operand rounded as it enters its
// fragment and one tf32 mma.sync in place of 3xTF32's three. Compiled in a
// source of its own so that it builds in parallel with the others.

#include <cuda_runtime.h>

#include "gram.cuh"
#include "gram_bwd.cuh"

extern "C" {

// rcot_mdta_gram_bwd's arguments and outputs (gram_bwd.cu), bf16 operands.
int rcot_mdta_gram_bwd_b16ops(const float* qkv, const float* dgram, const float* dnq,
                              const float* dnk, float* dqdk, float* ws, int B, long long hw,
                              int heads, int ch, int cb, int blocks, long long per_block,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) \
  gram_bwd<R, true>(qkv, dgram, dnq, dnk, dqdk, ws, B, hw, heads, ch, cb, blocks, per_block, st)
  RCOT_BY_WIDTH(ch, cb, RCOT_CALL)
#undef RCOT_CALL
}

}  // extern "C"
