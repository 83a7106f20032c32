// The Gram backward on a bf16 qkv with bf16 operands in its products, for
// Hopper (sm_90a): row 6 in bf16 training under the JAX package's
// RCOT_BWD_BF16 "gram" tier (cli.train --dtype bfloat16 --bwd-bf16 gram or
// all).
//
// Replaces the TPU kernel mdta_gram_bwd (rcot_tpu/ops/pallas_gram.py:141,
// pallas_call at :149) as the JAX package runs it on a bf16 qkv with that
// tier on: dq = k dG^T + 2 q dnq and dk = q dG + 2 k dnk with k, q and dG
// rounded to bf16 for the products (_bwd_dot at :129-130), fp32 sums,
// d[q|k] written in bf16.
//
// Bound on an H100 SXM by its bytes (gram_bwd_bf16.cu's header). Design:
// gram_bwd_bf16.cu's (gram_bwd.cuh on bf16 tiles, one launch a call), the
// ops16 policy's one tf32 mma.sync a step; dG is rounded as it is staged,
// and a bf16 value needs no rounding. Compiled in a source of its own so
// that it builds in parallel with the 3xTF32 policy's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gram.cuh"
#include "gram_bwd.cuh"

namespace {
constexpr bool kGbbOps16 = true;  // the bf16-operand policy
}  // namespace

extern "C" {

// rcot_mdta_gram_bwd_bf16's arguments and outputs (gram_bwd_bf16.cu), and
// its blocks an SM, with bf16 operands.
RCOT_GRAM_BWD_BF16_ENTRIES(rcot_mdta_gram_bwd_bf16_b16ops)

}  // extern "C"
