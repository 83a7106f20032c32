// Fused MDTA transposed attention for Hopper (sm_90a), forward.
//
// Replaces the TPU kernel of rcot_tpu/ops/pallas_mdta.py, `_kernel`
// (:41-76) launched by mdta_attend_fused (pallas_call at :116). Per
// (b, head), on q, k and v of shape (c, N), channels by pixels (the layout
// the caller's transposes give, as rcot_tpu/ops/attention.py:75-76 does):
//
//   P   = softmax_d( (q_hat k_hat^T)[i, d] * temperature[head] ),
//   q_hat = q / max(|q_i|, 1e-12) along N (k_hat likewise),
//   out = P v,
//
// through the identity q_hat k_hat^T = (q k^T) / (max(|q_i|, eps)
// max(|k_d|, eps)): the Gram and the two sums of squares are pixel sums of
// the raw inputs, and the normalisation touches only the c x c matrix.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores, 495
// TF32 on the tensor cores): q, k and v are read and out written once, 16
// bytes per element of (c, N), against 4c + 4 flops per element; at c = 48
// and 96 the bytes bound it (about 15 us at serve L1, 1 x 48 x 65536). Even
// as 3xTF32 the products stay below the bytes on the tensor cores.
//
// Design: three launches, every sum in a fixed order (no atomics, no
// memset: two calls give the same bits), the launch plan from Python
// (ops/mdta.py mdta_plan, the SM count read once per device), each
// kernel's shared-memory limit raised once per device, and one workspace:
// [slots of out (c > 128) | Gram partials | P].
//   1. mdta_gram_kernel: one block per (pixel range of at most 512 pixels,
//      bh, channel-block pair). q and k rows (channels) stream through a
//      cp.async ring of 64-pixel stages, four deep up to 64 channels and
//      three above (16-byte copies where N % 4 == 0 and the rows are
//      aligned, 4-byte ones otherwise, as at N = 80,250, a 250x321 image
//      unpadded), staged [channel][pixel] as they lie, so that
//      q is the row-major A operand and k the column-major B operand of
//      G = q k^T on mma.sync m16n8k8 with no transpose. Products are
//      3xTF32, each value split into its tf32 halves by integer ops
//      (tc.cuh split_fast: two cvt.rna.tf32 a value made the conversions
//      the limit); every chain is one 32-deep step (four k-steps) that starts
//      from zero and joins the range's total in fp32, since a long chain of
//      mma.sync accumulations drifts toward zero (PERF.md, PR 9). The sums
//      of squares come from the same staged fragments, in fp32 on the CUDA
//      cores. The eight warps split G's tiles and each stage's pixels
//      (gram.cu's layout); their partials are added in shared memory in a
//      fixed order and written with plain stores, one record G | nq | nk of
//      the range.
//   2. mdta_softmax_kernel: one block per (row i, bh), of W <= 32 warps
//      (the plan's): warp w sums the ranges w, w + W, ... of row i of G, of
//      nk and of nq[i] in order, a few each with their loads in flight
//      together, the W sums are added in order, then warp 0
//      normalises by max(sqrt(nq), eps) * max(sqrt(nk), eps), scales by
//      temperature[head] and takes the row softmax (any c: 32 columns at a
//      time, the row in shared memory up to 8,192 columns), writing row i
//      of P (BH, c, c) once.
//   3. mdta_apply_kernel: out = P v over 128-pixel tiles. Blocks walk runs
//      of (bh, tile); P_bh is staged once per bh a block meets, already
//      split into its tf32 parts, as the row-major A operand; v tiles
//      ([channel][pixel], the column-major B operand) come through a ring.
//      Warp w owns pixels [16 w, 16 w + 16) of a tile and every row, so
//      each v value is split once; chains are 32 deep, as above; the output
//      leaves straight from the accumulators, four lanes writing 32
//      contiguous bytes of a row.
// Heads wider than 128 channels are cut into channel blocks (ops/gram.py
// channel_blocks) and every launch runs over block pairs (i, j), as
// gram.cu does: G_ij = q_i k_j^T and the squares from (i, 0) and (0, j)
// into the records at row i cb, column j cb; out_i's part P_ij v_j into
// slot j of the workspace, and tc.cuh's sum_slots adds the slots in order.
//
// bf16 (row 10's bf16 form, rcot_mdta_attend_bf16): the kernels are
// templated on the element type T of q, k, v and out. The JAX kernel
// widens q, k and v to fp32 (pallas_mdta.py:56-57, :73), keeps G, the
// norms and P in fp32 and writes out in v's dtype (:76, :126). Here bf16
// tiles are staged as they lie (16-byte copies of 8 bf16 where N % 8 == 0
// and the rows are aligned, else a load a value) and widened as they
// become fragments. A bf16 value is exact in tf32, so its low tf32 part is
// zero: the Gram's products take the one term ah bh (a product of two
// tf32 values is exact in fp32, fp32 sums as in fp32), the apply's the two
// al bh + ah bh (P is fp32); the sums of squares, the reduce and the
// softmax are the fp32 kernels'. out is rounded to bf16 once, from the
// accumulators, or by sum_slots for a head cut into channel blocks.
//
// The kernels live in mdta.cuh, templated on the element type; this source
// compiles the fp32 form and mdta_bf16.cu the bf16 form, so that nvcc
// builds the two in parallel.

#include "mdta.cuh"

extern "C" {

// q, k, v (BH, c, N) with bh = b * heads + head, temp (heads,) -> out
// (BH, c, N), on the plan of ops/mdta.py mdta_plan: `splits` ranges of
// `per` pixels, channel blocks of cb, the apply on `apply_blocks` blocks of
// `apply_per` 128-pixel tiles for each block pair, the softmax's `warps`,
// copies of `vec` floats. ws holds mdta_workspace_numel floats. The block
// width cb picks R = ceil(cb / 16) in 1..8.
int rcot_mdta_attend(const float* q, const float* k, const float* v, const float* temp,
                     float* out, float* ws, int BH, int heads, int c, long long n, int splits,
                     int per, int cb, int apply_blocks, int apply_per, int warps, int vec,
                     void* stream) {
  return attend_call(q, k, v, temp, out, ws, BH, heads, c, n, splits, per, cb, apply_blocks,
                     apply_per, warps, vec, stream);
}

}  // extern "C"
