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
//   its bf16-operand form (RCOT_BWD_BF16's "gram" tier, _bwd_dot(...,
//   tier="gram") at :129-130: k, q and dG rounded to bf16 for the two
//   products) is gram_bwd_bf16_b16ops.cu's;
//   attn_apply_bwd_bf16 (attn_apply_bwd, :219, pallas_call at :227, body
//   :195-216): v and g widened to fp32; dv = g attn with the fp32 attn (not
//   the bf16-rounded attn the forward applied, :171), written in bf16;
//   dattn = sum over pixels of g^T v, fp32.
//
// Neither has a rounding point inside: each is the fp32 computation on the
// widened inputs, rounded at its bf16 outputs. Bound on an H100 SXM by
// their bytes (3.35 TB/s): the Gram backward reads 4C and writes 4C bytes a
// pixel against 4 C ch flops on the tensor cores; the apply backward reads
// 4C and writes 2C.
//
// The Gram backward: gram_bwd.cuh's kernel on bf16 tiles, one launch a
// call where the head is one channel block. Its q and k rows are staged as
// bf16 by cp.async (16-byte copies where bf16_copy_width allows), half the
// fp32 kernel's shared memory and bytes; each value is widened as it enters
// its tf32 fragment, so the 3xTF32 policy takes two mma.sync a step (the
// term of the zero low part left out) and the ops16 policy one; 2 q dnq and
// 2 k dnk read the same tiles; d[q|k] is rounded in the epilogue, staged in
// place of the warp's own tile rows and written in 16-byte stores, a warp's
// lanes along a row. The plan (ops/gram.py gram_bwd_bf16_plan) gives a
// block as many tiles as the card's SMs times the blocks an SM holds (its
// shared memory and the registers its launch bounds allow) leave it, and
// the ring keeps three of them in flight. The sums are the fp32 kernel's on
// the widened values, in its order: the same bits as the widening design it
// replaces. No workspace but the slots of a head cut into channel blocks.
// Its bf16-operand policy is compiled in gram_bwd_bf16_b16ops.cu, so that
// the two build in parallel.
//
// The apply backward keeps its widening design: one launch widens the v
// third and g into fp32 workspaces of their layout (cast.cuh), then
// apply_bwd.cu's fp32 kernel (rcot_attn_apply_bwd: 3xTF32 mma.sync, a
// cp.async ring, dattn summed in a fixed order) runs on them with its plan
// (ops/gram.py gram_pairs_plan), and one last launch rounds dv to bf16.
// With ops16 the fp32 kernel is its bf16-operand form (apply_bwd_b16ops.cu).
//
// No atomics and no memsets: two calls on the same inputs give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cast.cuh"
#include "gram.cuh"
#include "gram_bwd.cuh"

// the fp32 apply backward (apply_bwd.cu, where its arguments are
// documented) and its bf16-operand form (apply_bwd_b16ops.cu)
extern "C" {
int rcot_attn_apply_bwd(const float* qkv, const float* attn, const float* g, float* dv,
                        float* dattn, float* ws, int B, long long hw, int heads, int ch, int cb,
                        int splits, long long per, void* stream);
int rcot_attn_apply_bwd_b16ops(const float* qkv, const float* attn, const float* g, float* dv,
                               float* dattn, float* ws, int B, long long hw, int heads, int ch,
                               int cb, int splits, long long per, void* stream);
}

namespace {
constexpr bool kGbbOps16 = false;  // the 3xTF32 policy
}  // namespace

extern "C" {

// qkv (B, hw, 3*heads*ch) bf16, dgram (B,heads,ch,ch), dnq, dnk
// (B,heads,ch) fp32 -> dqdk (B, hw, 2*heads*ch) = [dq | dk] bf16. ws (fp32)
// holds nb slots of d[q|k] where the head is cut into nb > 1 channel
// blocks of cb (ops/gram.py slots_numel), else null. blocks, per_block:
// ops/gram.py gram_bwd_bf16_plan; vec: bf16 a copy (bf16_copy_width, of
// qkv and dqdk). rcot_mdta_gram_bwd_bf16_blocks_per_sm(ch, cb, &blocks,
// &bytes, &min_blocks): the blocks of its kernel one SM holds (ops/gram.py
// gram_bwd_bf16_per_sm states it), its shared memory and the blocks its
// registers are held to (gram_bwd_bf16_smem, _gram_bwd_bf16_reg_blocks). The bf16-operand policy's pair is gram_bwd_bf16_b16ops.cu's.
RCOT_GRAM_BWD_BF16_ENTRIES(rcot_mdta_gram_bwd_bf16)

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
