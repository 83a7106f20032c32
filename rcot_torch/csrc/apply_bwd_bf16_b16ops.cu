// The apply's backward on a bf16 qkv and cotangent with bf16 operands in
// its products, for Hopper (sm_90a): row 7 in bf16 training under the JAX
// package's RCOT_BWD_BF16 "gram" tier (cli.train --dtype bfloat16
// --bwd-bf16 gram or all).
//
// Replaces the TPU kernel attn_apply_bwd (rcot_tpu/ops/pallas_gram.py:219,
// pallas_call at :227) as the JAX package runs it on a bf16 qkv with that
// tier on: dv = g attn and dattn = sum over pixels of g^T v with g, attn and
// v rounded to bf16 (_bwd_dot at :211-212), fp32 sums, dv written in bf16.
//
// Bound on an H100 SXM by its bytes (apply_bwd_bf16.cu's header). Design:
// apply_bwd_bf16.cu's (gram_bwd.cuh's apply backward on bf16 tiles), the
// ops16 policy's one tf32 mma.sync a step in both products; attn is rounded
// as it is staged, and a bf16 value needs no rounding. Compiled in a source
// of its own so that it builds in parallel with the 3xTF32 policy's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gram.cuh"
#include "gram_bwd.cuh"

namespace {
constexpr bool kAbbOps16 = true;  // the bf16-operand policy
}  // namespace

extern "C" {

// rcot_attn_apply_bwd_bf16's arguments and outputs (apply_bwd_bf16.cu), and
// its blocks an SM, with bf16 operands.
RCOT_APPLY_BWD_BF16_ENTRIES(rcot_attn_apply_bwd_bf16_b16ops)

}  // extern "C"
