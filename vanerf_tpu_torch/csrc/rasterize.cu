// Kernel C — z-buffer rasterizer: per pixel, the z-argmin over the faces
// whose edge functions cover it (pix_to_face, zbuf).
//
// Replaces the TPU kernel vanerf_tpu/ops/rasterize_pallas.py::
// rasterize_zbuffer_pallas (body `_kernel`), a (256-pixel x 512-face) VMEM
// sweep.  The winner's barycentrics are recomputed outside, in torch, as
// the TPU path does in XLA.
//
// Bound on the H100: arithmetic — every pixel tests every face (65,536
// pixels x 2,560 faces = 1.7e8 pairs at ~25 flops and 3 divides each);
// memory traffic is tiny.  Design: one thread per pixel; faces are staged
// through shared memory in chunks of 256 x 9 floats (9 KB) and read as
// warp broadcasts.  The edge-function arithmetic is the TPU kernel's
// (rasterize_pallas.py:48-66): the area epsilon 1e-12, three divides and
// `inside` on all three barycentrics >= 0.  The z test keeps a running
// minimum with strict `<` in ascending face order — no atomics, and ties go
// to the lowest face index, the tie-break of jnp.argmin.

#include "common.cuh"

#define RC_THREADS 256
#define RC_CHUNK 256

__global__ void raster_kernel(const float* __restrict__ tri, int F, int H,
                              int W, int* __restrict__ face,
                              float* __restrict__ zbuf) {
  __shared__ float st[RC_CHUNK * 9];
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = pix < H * W;
  const float px = static_cast<float>(pix % W);
  const float py = static_cast<float>(pix / W);
  float zb = INFINITY;
  int fb = -1;
  for (int f0 = 0; f0 < F; f0 += RC_CHUNK) {
    const int nf = min(RC_CHUNK, F - f0);
    __syncthreads();
    for (int k = threadIdx.x; k < 9 * nf; k += blockDim.x)
      st[k] = tri[9 * f0 + k];
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nf; ++j) {
      const float* t = st + 9 * j;
      const float ax = t[0], ay = t[1], az = t[2];
      const float bx = t[3], by = t[4], bz = t[5];
      const float cx = t[6], cy = t[7], cz = t[8];
      const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      const float w0 = (cx - bx) * (py - by) - (cy - by) * (px - bx);
      const float w1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx);
      const float w2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax);
      const bool ok = fabsf(area) >= 1e-12f;
      const float den = ok ? area : 1.0f;
      const float b0 = w0 / den;
      const float b1 = w1 / den;
      const float b2 = w2 / den;
      if (ok && b0 >= 0.0f && b1 >= 0.0f && b2 >= 0.0f) {
        const float zi = b0 * az + b1 * bz + b2 * cz;
        if (zi < zb) {
          zb = zi;
          fb = f0 + j;
        }
      }
    }
  }
  if (valid) {
    face[pix] = fb;
    zbuf[pix] = zb;
  }
}

VT_EXPORT int vt_raster(const float* tri, int F, int H, int W, int* face,
                        float* zbuf, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  raster_kernel<<<vt_blocks(static_cast<long long>(H) * W, RC_THREADS),
                  RC_THREADS, 0, vt_stream(stream)>>>(tri, F, H, W, face,
                                                      zbuf);
  return static_cast<int>(cudaGetLastError());
}
