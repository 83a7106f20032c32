// The Gram backward in 3xTF32, for Hopper (sm_90a): row 6, replacing
// mdta_gram_bwd (rcot_tpu/ops/pallas_gram.py:141, pallas_call at :149) as
// the JAX package runs it with RCOT_BWD_BF16 unset.
//
// The kernel is gram_bwd.cuh's (gram.cu's header describes the design).
// Each of the MDTA core's backward kernels is compiled in a source of its
// own, for each operand policy (gram_bwd.cu, apply_bwd.cu and their
// _b16ops forms), so that nvcc builds them in parallel.

#include <cuda_runtime.h>

#include "gram.cuh"
#include "gram_bwd.cuh"

extern "C" {

// qkv (B, hw, 3*heads*ch), dgram (B,heads,ch,ch), dnq, dnk (B,heads,ch)
// -> dqdk (B, hw, 2*heads*ch) = [dq | dk], in channel blocks of cb, on
// `blocks` blocks of `per_block` 64-pixel tiles for each block pair
// (ops/gram.py gram_bwd_plan); ws holds nb slots of dqdk where nb > 1
// (ops/gram.py gram_bwd_workspace_numel).
int rcot_mdta_gram_bwd(const float* qkv, const float* dgram, const float* dnq,
                       const float* dnk, float* dqdk, float* ws, int B, long long hw,
                       int heads, int ch, int cb, int blocks, long long per_block,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) \
  gram_bwd<R, false>(qkv, dgram, dnq, dnk, dqdk, ws, B, hw, heads, ch, cb, blocks, per_block, st)
  RCOT_BY_WIDTH(ch, cb, RCOT_CALL)
#undef RCOT_CALL
}

}  // extern "C"
