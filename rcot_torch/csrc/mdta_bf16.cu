// The fused MDTA attend in bf16 for Hopper (sm_90a): row 10's bf16 form,
// replacing mdta_attend_fused (rcot_tpu/ops/pallas_mdta.py:88, pallas_call
// at :116) on bf16 q, k and v. The kernels are mdta.cuh's (mdta.cu's
// header describes the design and its bf16 form); this source compiles
// them on bf16 tiles, beside mdta.cu's fp32 form, so that the two build in
// parallel.

#include "mdta.cuh"

extern "C" {

// The same on bf16 q, k, v -> bf16 out, the temperature and ws fp32; copies
// of `vec` bf16 (8 where N % 8 == 0 and the rows are 16-byte aligned, else 1).
int rcot_mdta_attend_bf16(const bf16* q, const bf16* k, const bf16* v, const float* temp,
                          bf16* out, float* ws, int BH, int heads, int c, long long n,
                          int splits, int per, int cb, int apply_blocks, int apply_per,
                          int warps, int vec, void* stream) {
  return attend_call(q, k, v, temp, out, ws, BH, heads, c, n, splits, per, cb, apply_blocks,
                     apply_per, warps, vec, stream);
}

}  // extern "C"
