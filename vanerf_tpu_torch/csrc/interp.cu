// Kernel D — bilinear sample (border padding, align_corners=True) of a
// small channels-last map at N normalized points.
//
// Replaces the TPU kernel vanerf_tpu/ops/interp_mxu.py::mxu_grid_sample
// (body `_kernel`), which contracts per-tile hat weights against the
// VMEM-resident table on the MXU because TPU gathers are row-count bound.
//
// Bound on the H100: memory.  The 32x32x64 table is 256 KB and stays in
// L1/L2; per output value the kernel reads 2 coordinates (shared by the C
// channel threads of a point) and 4 table values, writes 4 bytes, and does
// ~15 flops — 262,144 x 64 outputs write 67 MB, which at 3.35 TB/s is
// ~20 us.  Design: one thread per (point, channel), consecutive threads on
// consecutive channels so table reads and output writes coalesce; table
// and coordinates are read through the read-only cache (__ldg).
//
// Numerics: the coordinates are clipped exactly as interp_mxu.py:116-119,
// (u + 1) * 0.5 * (W - 1) then clip to [0, W - 1]; after the clip the hat
// weight max(0, 1 - |x - j|) of the two bracketing columns is the bilinear
// weight.  The four corner products are summed in f32 in the fixed order
// w00 f00 + w01 f01 + w10 f10 + w11 f11.  A corner outside the map (only
// at x == W - 1 or y == H - 1) has hat weight exactly 0 and reads the
// clamped edge value instead.

#include "common.cuh"

#define IP_THREADS 256

__global__ void interp_kernel(const float* __restrict__ feat, int H, int W,
                              int C, const float* __restrict__ uv, int N,
                              float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(N) * C) return;
  const int n = static_cast<int>(t / C);
  const int c = static_cast<int>(t % C);
  const float u = __ldg(uv + 2 * n);
  const float v = __ldg(uv + 2 * n + 1);
  const float wm1 = static_cast<float>(W - 1);
  const float hm1 = static_cast<float>(H - 1);
  const float x = fminf(fmaxf((u + 1.0f) * 0.5f * wm1, 0.0f), wm1);
  const float y = fminf(fmaxf((v + 1.0f) * 0.5f * hm1, 0.0f), hm1);
  const float x0 = floorf(x), y0 = floorf(y);
  const float hx0 = fmaxf(0.0f, 1.0f - fabsf(x - x0));
  const float hx1 = fmaxf(0.0f, 1.0f - fabsf(x - (x0 + 1.0f)));
  const float hy0 = fmaxf(0.0f, 1.0f - fabsf(y - y0));
  const float hy1 = fmaxf(0.0f, 1.0f - fabsf(y - (y0 + 1.0f)));
  const int ix0 = static_cast<int>(x0), iy0 = static_cast<int>(y0);
  const int ix1 = min(ix0 + 1, W - 1), iy1 = min(iy0 + 1, H - 1);
  const float f00 = __ldg(feat + (static_cast<long long>(iy0) * W + ix0) * C + c);
  const float f01 = __ldg(feat + (static_cast<long long>(iy0) * W + ix1) * C + c);
  const float f10 = __ldg(feat + (static_cast<long long>(iy1) * W + ix0) * C + c);
  const float f11 = __ldg(feat + (static_cast<long long>(iy1) * W + ix1) * C + c);
  out[t] = (hx0 * hy0) * f00 + (hx1 * hy0) * f01 + (hx0 * hy1) * f10 +
           (hx1 * hy1) * f11;
}

VT_EXPORT int vt_interp(const float* feat, int H, int W, int C,
                        const float* uv, int N, float* out, void* stream) {
  const long long total = static_cast<long long>(N) * C;
  if (total <= 0) return 0;
  interp_kernel<<<vt_blocks(total, IP_THREADS), IP_THREADS, 0,
                  vt_stream(stream)>>>(feat, H, W, C, uv, N, out);
  return static_cast<int>(cudaGetLastError());
}
