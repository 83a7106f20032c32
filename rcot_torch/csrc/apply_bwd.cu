// The apply's backward in 3xTF32, for Hopper (sm_90a): row 7, replacing
// attn_apply_bwd (rcot_tpu/ops/pallas_gram.py:219, pallas_call at :227) as
// the JAX package runs it with RCOT_BWD_BF16 unset.
//
// The kernel is gram_bwd.cuh's (gram.cu's header describes the design),
// compiled here in a source of its own so that it builds in parallel with
// row 6's (gram_bwd.cu).

#include <cuda_runtime.h>

#include "gram.cuh"
#include "gram_bwd.cuh"

extern "C" {

// qkv (B, hw, 3*heads*ch), attn (B,heads,ch,ch), g (B, hw, heads*ch)
// -> dv (B, hw, heads*ch), dattn (B,heads,ch,ch), in channel blocks of cb.
// The pixels of each (b, head) are split into `splits` ranges of `per`
// (ops/gram.py gram_plan); ws holds the dattn partials where splits > 1
// (B*heads*splits*ch*ch floats), then nb slots of dv where nb > 1, each
// summed by a launch of its own.
int rcot_attn_apply_bwd(const float* qkv, const float* attn, const float* g, float* dv,
                        float* dattn, float* ws, int B, long long hw, int heads, int ch,
                        int cb, int splits, long long per, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define RCOT_CALL(R) \
  apply_bwd<R, false>(qkv, attn, g, dv, dattn, ws, B, hw, heads, ch, cb, splits, per, st)
  RCOT_BY_WIDTH(ch, cb, RCOT_CALL)
#undef RCOT_CALL
}

}  // extern "C"
