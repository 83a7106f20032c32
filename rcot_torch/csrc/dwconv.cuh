// The depthwise 3x3 kernels of dwconv.cu (row 11), for other kernels'
// launchers: block_bwd.cu runs its three depthwise stages through them,
// block_fwd_bf16.cu and fused_dwconv_bf16.cu their bf16 forwards (the head's
// and the qkv's conv_bf16 where C passes the product-depthwise of pw_dw.cuh,
// the tail's and the GDFN's gated depthwise,
// conv_gate_bf16), and the bf16 backward forms of block_bwd_bf16.cu and
// fused_dwconv_bf16.cu theirs on bf16 tiles.
// The plan (vec, cv, tc, rows) is ops/dwconv.py's dwconv_plan, made in
// Python and passed in; both launch on `st` and return the launch's error.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rcot_dwconv {

// x (B, H, W, C), taps (C, 3, 3) -> out (B, H, W, C), zeros outside the
// image; rot rotates the taps by 180 degrees (the backward's dx). out must
// not alias x; x and out 4 * vec-byte aligned.
cudaError_t conv(const float* x, const float* taps, float* out, int B, int H, int W, int C,
                 int vec, int cv, int tc, int rows, bool rot, cudaStream_t st);

// conv on bf16 x and taps (vec = 8, 4 or 2 bf16 a copy), fp32 sums,
// into out: bf16 where out_bf16, else fp32.
cudaError_t conv_bf16(const __nv_bfloat16* x, const __nv_bfloat16* taps, void* out,
                      bool out_bf16, int B, int H, int W, int C, int vec, int cv, int tc,
                      int rows, cudaStream_t st);

// The gated depthwise of the bf16 forwards: [c1 | c2] = conv_bf16 of a bf16
// x (B, H, W, 2 hid) on bf16 taps (2 hid, 3, 3), each sum in conv_bf16's
// order, then gate = bf16(gelu(c1) c2) (B, H, W, ld_gate), zeros past hid;
// the fp32 conv stays in the SM. The plan (vec = 2, cv, tc, rows) is over
// ld_gate channels (ops/dwconv.py conv_gate_plan); ld_gate a multiple of 8,
// x 4-byte and gate 16-byte aligned; gate must not alias x.
cudaError_t conv_gate_bf16(const __nv_bfloat16* x, const __nv_bfloat16* taps,
                           __nv_bfloat16* gate, int B, int H, int W, int hid, int ld_gate,
                           int vec, int cv, int tc, int rows, cudaStream_t st);

// conv of an fp32 x on bf16 taps (vec = 4, 2 or 1 floats a copy), into fp32
// out: the bf16 tail backward's dh (rot).
cudaError_t conv_taps16(const float* x, const __nv_bfloat16* taps, float* out, int B, int H,
                        int W, int C, int vec, int cv, int tc, int rows, bool rot,
                        cudaStream_t st);

// the rotated conv of a bf16 x on bf16 taps (vec = 8, 4, 2 or 1 bf16 a
// copy), into fp32 out: the bf16 qkv backward's dh.
cudaError_t conv_bf16_rot(const __nv_bfloat16* x, const __nv_bfloat16* taps, float* out, int B,
                          int H, int W, int C, int vec, int cv, int tc, int rows,
                          cudaStream_t st);

// dtaps of a bf16 x and a g of fp32 (vec = 4, 2 or 1) or bf16 (g_bf16; vec
// = 8, 4, 2 or 1), summed as dtaps sums and rounded once into bf16 dtaps;
// its bits follow (tc, rows), so a caller that must match the fp32 dtaps
// gives the fp32 plan's.
cudaError_t dtaps_16(const __nv_bfloat16* x, const void* g, bool g_bf16, float* ws,
                     __nv_bfloat16* dtaps, int B, int H, int W, int C, int vec, int cv, int tc,
                     int rows, cudaStream_t st);

// dtaps[c, i, j] = sum over pixels of g[b, y, x, c] x[b, y + i - 1, x + j - 1, c],
// through the workspace ws of ops/dwconv.py dtaps_workspace_numel floats,
// summed in a fixed order (bitwise repeatable); B * H * W > 0.
cudaError_t dtaps(const float* x, const float* g, float* ws, float* dtaps, int B, int H, int W,
                  int C, int vec, int cv, int tc, int rows, cudaStream_t st);

}  // namespace rcot_dwconv
