// The MDTA Gram backward on a bf16 qkv, for Hopper (sm_90a): row 6 of
// bf16 training (cli.train --dtype bfloat16).
//
// Replaces the TPU kernel mdta_gram_bwd (rcot_tpu/ops/pallas_gram.py:141,
// pallas_call at :149, body :120-138) as the JAX package runs it on a bf16
// qkv: qkv widened to fp32; dq = k dG^T + 2 q dnq and dk = q dG + 2 k dnk in
// fp32 (dG, dnq, dnk fp32); d[q|k] written in bf16. Its bf16-operand form
// (RCOT_BWD_BF16's "gram" tier, _bwd_dot(..., tier="gram") at :129-130: k,
// q and dG rounded to bf16 for the two products) is
// gram_bwd_bf16_b16ops.cu's. Row 7 on bf16 is apply_bwd_bf16.cu's.
//
// It has no rounding point inside: the fp32 computation on the widened
// inputs, rounded at its bf16 output. Bound on an H100 SXM by its bytes
// (3.35 TB/s): it reads 4C and writes 4C bytes a pixel against 4 C ch flops
// on the tensor cores.
//
// Design: gram_bwd.cuh's kernel on bf16 tiles, one launch a call where the
// head is one channel block. Its q and k rows are staged as bf16 by
// cp.async (16-byte copies where bf16_copy_width allows), half the fp32
// kernel's shared memory and bytes; each value is widened as it enters its
// tf32 fragment, so the 3xTF32 policy takes two mma.sync a step (the term
// of the zero low part left out) and the ops16 policy one; 2 q dnq and
// 2 k dnk read the same tiles; d[q|k] is rounded in the epilogue, staged in
// place of the warp's own tile rows and written in 16-byte stores, a warp's
// lanes along a row. The plan (ops/gram.py gram_bwd_bf16_plan) gives a
// block as many tiles as the card's SMs times the blocks an SM holds (its
// shared memory and the registers its launch bounds allow) leave it, and
// the ring keeps three of them in flight. The sums are the fp32 kernel's on
// the widened values, in its order: the same bits as the widening design it
// replaced. No workspace but the slots of a head cut into channel blocks.
// Its bf16-operand policy is compiled in gram_bwd_bf16_b16ops.cu, so that
// the two build in parallel.
//
// No atomics and no memsets: two calls on the same inputs give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gram.cuh"
#include "gram_bwd.cuh"

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

}  // extern "C"
