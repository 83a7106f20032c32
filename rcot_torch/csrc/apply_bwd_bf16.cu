// The apply's backward on a bf16 qkv and cotangent, for Hopper (sm_90a):
// row 7 of bf16 training (cli.train --dtype bfloat16).
//
// Replaces the TPU kernel attn_apply_bwd (rcot_tpu/ops/pallas_gram.py:219,
// pallas_call at :227, body :195-216) as the JAX package runs it on a bf16
// qkv and cotangent g: v and g widened to fp32; dv = g attn with the fp32
// attn (not the bf16-rounded attn the forward applied, :171), written in
// bf16; dattn = sum over pixels of g^T v, fp32. Its bf16-operand form
// (RCOT_BWD_BF16's "gram" tier, _bwd_dot(..., tier="gram") at :211-212: g,
// attn and v rounded to bf16 for both products) is
// apply_bwd_bf16_b16ops.cu's.
//
// It has no rounding point inside: the fp32 computation on the widened
// inputs, rounded at its bf16 output. Bound on an H100 SXM by its bytes
// (3.35 TB/s): it reads 4C and writes 2C bytes a pixel against 4 C ch flops
// on the tensor cores (dv's at the TF32 rate, two terms a step; dattn's
// one).
//
// Design: gram_bwd.cuh's apply_bwd_kernel on bf16 tiles, over the fp32
// kernel's pixel ranges (ops/gram.py gram_pairs_plan), so that dattn's sums
// and their order are its own. The g and v rows are staged as bf16 by
// cp.async (16-byte copies where bf16_copy_width allows) in a ring of four
// stages up to 64 channels (three above), half the fp32 kernel's bytes a
// stage; each value is widened as it enters its tf32 fragment, so dv's
// 3xTF32 takes two mma.sync a step (the term of g's zero low part left out)
// and dattn one (both of its operands are exact), and the ops16 policy one
// in both; attn is staged split into its tf32 parts (rounded to bf16 in
// ops16) as the fp32 kernel stages it. The products are held by their
// fragment reads from shared memory (PERF.md, PR 20), so each read serves
// more: up to R = 3 a warp holds its attn fragments in registers for the
// block, at even R it takes two row tiles of dv (each attn fragment read
// serving both), and dattn's g fragments take two channels a 4-byte read
// (the mma's rows ordered so; a row's sums do not depend on its place).
// dv is rounded in the epilogue, staged in the warp's own rows and columns
// of a tile of its own and written in 16-byte stores along a row. One
// launch where a (b, head) is
// one range and one channel block; else the fixed-order reduce of dattn's
// range partials (gram.cuh) and, for a head cut into channel blocks, the
// fixed-order sum of dv's fp32 slots, rounded once (tc.cuh sum_slots). No
// fp32 copy of qkv, g or dv: the same bits as the widening design it
// replaced (the dropped terms added exact zeros; the rest keep their
// order). The bf16-operand policy compiles in apply_bwd_bf16_b16ops.cu, so
// that the two build in parallel.
//
// No atomics and no memsets: two calls on the same inputs give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gram.cuh"
#include "gram_bwd.cuh"

namespace {
constexpr bool kAbbOps16 = false;  // the 3xTF32 policy
}  // namespace

extern "C" {

// qkv (B, hw, 3*heads*ch) bf16, attn (B,heads,ch,ch) fp32, g (B, hw,
// heads*ch) bf16 -> dv (B, hw, heads*ch) bf16, dattn (B,heads,ch,ch) fp32.
// ws (fp32): the dattn partials where splits > 1 (ops/gram.py
// apply_bwd_workspace_numel), then nb slots of dv where the head is cut
// into nb > 1 channel blocks of cb (slots_numel), else null. splits, per:
// ops/gram.py gram_pairs_plan; vec: bf16 a copy (bf16_copy_width, of qkv, g
// and dv). rcot_attn_apply_bwd_bf16_blocks_per_sm(ch, cb, &blocks, &bytes,
// &min_blocks): the blocks of its kernel one SM holds (ops/gram.py
// apply_bwd_bf16_per_sm states it), its shared memory and the blocks its
// registers are held to (apply_bwd_bf16_smem, _apply_bwd_bf16_reg_blocks).
// The bf16-operand policy's pair is apply_bwd_bf16_b16ops.cu's.
RCOT_APPLY_BWD_BF16_ENTRIES(rcot_attn_apply_bwd_bf16)

}  // extern "C"
