// Depthwise 3x3 SAME convolution for Hopper (sm_90a), bias-free, NHWC.
//
// Replaces the TPU kernel of rcot_tpu/ops/pallas_dwconv.py, `_kernel`
// (:28-54) launched by dwconv3x3_fwd (pallas_call at :87):
//
//   out[b, y, x, c] = sum_{i, j in 0..2} taps[c, i, j] x[b, y + i - 1, x + j - 1, c]
//
// with zeros outside the image; taps are (C, 3, 3), the port's layout of a
// (C, 1, 3, 3) depthwise weight. The backward's dx is this kernel on the
// cotangent with the taps rotated by 180 degrees (pallas_dwconv.py:118-120);
// the wrapper rotates them.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
// 18 flops per output against 8 bytes (x read once, out written once), so
// bytes bound it: about 30 us at 3 x 128^2 x 254 channels.
//
// Design. No TPU workaround is carried over: no 128-lane channel padding,
// no W % 8 condition, no row-tile search; any B, H, W and C, odd C too.
// One image row is W*C contiguous floats, so a block's threads walk the
// flattened (x, c) index of a row: neighbouring threads read neighbouring
// addresses whatever C is, and the left and right taps sit at the same
// index -+ C (masked at the image's edges). Each thread owns one (x, c) and
// a strip of kStrip output rows. It reads the kStrip + 2 input rows of its
// column once each, at x - 1, x and x + 1, and adds each value into the up
// to three outputs it feeds, so device memory sees x about
// (kStrip + 2) / kStrip times (the side reads are the neighbouring
// threads' centre reads and hit L1) and out once. The zero halo is the
// masked read, inside the kernel; nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 8;  // output rows per thread

__global__ void __launch_bounds__(kThreads)
dwconv3x3_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                 float* __restrict__ out, int H, int W, int C) {
  const long long row = (long long)W * C;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= row) return;
  const int c = (int)(idx % C);
  const int col = (int)(idx / C);
  const bool left = col > 0, right = col + 1 < W;
  float w[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) w[t] = __ldg(taps + 9LL * c + t);

  const int y0 = blockIdx.y * kStrip;
  const long long img = (long long)blockIdx.z * H * row;
  const float* xb = x + img + idx;
  float* ob = out + img + idx;
  float acc[kStrip];
#pragma unroll
  for (int s = 0; s < kStrip; ++s) acc[s] = 0.f;

  // input row y0 - 1 + r feeds output row y0 + s through tap row i = r - s
#pragma unroll
  for (int r = 0; r < kStrip + 2; ++r) {
    const int yi = y0 - 1 + r;
    if (yi < 0 || yi >= H) continue;
    const float* p = xb + yi * row;
    const float l = left ? __ldg(p - C) : 0.f;
    const float m = __ldg(p);
    const float rt = right ? __ldg(p + C) : 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int s = r - i;
      if (s >= 0 && s < kStrip)
        acc[s] = fmaf(w[3 * i], l,
                      fmaf(w[3 * i + 1], m, fmaf(w[3 * i + 2], rt, acc[s])));
    }
  }
#pragma unroll
  for (int s = 0; s < kStrip; ++s)
    if (y0 + s < H) ob[(y0 + s) * row] = acc[s];
}

}  // namespace

extern "C" {

// x (B, H, W, C), taps (C, 3, 3) -> out (B, H, W, C); out must not alias x.
int rcot_dwconv3x3(const float* x, const float* taps, float* out, int B,
                   int H, int W, int C, void* stream) {
  if ((long long)B * H * W * C == 0) return cudaSuccess;
  const long long row = (long long)W * C;
  dim3 grid((unsigned)((row + kThreads - 1) / kThreads),
            (unsigned)((H + kStrip - 1) / kStrip), (unsigned)B);
  dwconv3x3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, taps, out,
                                                                H, W, C);
  return cudaGetLastError();
}

}  // extern "C"
