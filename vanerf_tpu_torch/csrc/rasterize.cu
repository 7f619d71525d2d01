// Kernel C — z-buffer rasterizer: per pixel, the z-argmin over the faces
// whose edge functions cover it (pix_to_face, zbuf).
//
// Replaces the TPU kernel vanerf_tpu/ops/rasterize_pallas.py::
// rasterize_zbuffer_pallas (body `_kernel`), a (256-pixel x 512-face) VMEM
// sweep.  The winner's barycentrics are recomputed outside, in torch, as
// the TPU path does in XLA.
//
// Bound on the H100: a sweep of every (pixel, face) pair is arithmetic
// (65,536 pixels x 2,560 faces = 1.7e8 pairs, ~25 operations and three
// IEEE divisions each), but a face of the main path's meshes covers a few
// tens of pixels of a 256^2 raster: almost every pair is a face whose box
// lies far from the pixel.  Design: one block a 16x16 tile of pixels, one
// thread a pixel, one launch.  The block walks the faces in chunks of 256,
// one face a thread: each thread tests its face against the tile's pixel
// rectangle (`rc_skip`, certified below), the kept faces are compacted in
// ascending face order into shared memory (warp ballot, popcount, a block
// prefix over the 8 warps' counts), and then every thread walks only that
// list with the TPU kernel's per-pair arithmetic (rasterize_pallas.py:
// 48-66): the area epsilon 1e-12, three divisions and `inside` on all
// three barycentrics >= 0.  The z test keeps a running minimum with strict
// `<` in ascending face order, so a skipped face, which can win no pixel of
// the tile, changes nothing and ties go to the lowest face index, the
// tie-break of jnp.argmin: face and zbuf equal ops/rasterize.py::
// raster_plain, the sweep over every face, bit for bit.  Shared memory
// holds one chunk whatever F and wherever the faces fall.  What is left is
// the (tile, face) tests (F a block) and the walk of the densest tile,
// which bounds the launch.
//
// The skip certificate (`rc_skip`; its mirror, evaluated in the same
// order, is ops/rasterize.py::tile_face_keep).  u = 2^-24.  A face is
// skipped for a tile only when
//   (a) !(|area~| >= 1e-12), area~ its area rounded exactly as the walk
//       rounds it (NaN included): the walk's `ok` is then false at every
//       pixel; or
//   (b) its six x, y coordinates are finite with |.| <= 2^60, its area is
//       no sliver, Aerr < A / 2 with A = |area~| and Aerr = g (|P1| + |P2|)
//       + e (P1, P2 the area's two exact products, g = 2^-21, e = 2^-100),
//       and the tile lies beside the face's box in x, by d = xmin - x1 or
//       x0 - xmax > 0 (x0, x1 the tile's first and last pixel centres),
//       with d A > 4 Wx (g Tmax + k A + e) (1 + 2^-20), Wx = xmax - xmin > 0,
//       k = 2^-100; or the same in y.
// Tmax bounds, over the tile's pixels p and the three edge functions
// w_i = ex_i (py - vy_i) - ey_i (px - vx_i), the exact |T1| + |T2| =
// |ex_i| |py - vy_i| + |ey_i| |px - vx_i| (convex in p: its largest value is
// at a corner of the tile's rectangle).  All of (b) is evaluated in double,
// whose relative errors (< 2^-48 over these few operations) the factor
// 1 + 2^-20 and the slack of g over 3u cover.
// Why no pixel of the tile can pass the walk's test.  The walk rounds each
// difference, product and sum once (-fmad=false), so (bounds ~3u, 1 + u
// per rounding, an absolute 2^-149 per underflowing product)
//   |w~_i - w_i| <= 3.00001 u (|T1| + |T2|) + 2^-148 <= g T + e,
// and likewise |area~ - area| <= Aerr < A / 2: the exact area has the sign
// s of area~ and |area| > A / 2.  With coordinates below 2^60 and pixels
// below 2^24 no difference or product overflows.  The exact barycentrics
// u_i = w_i / area sum to 1 and px = sum u_i vx_i, so for px <= xmin - d
//   px - xmin = sum u_i (vx_i - xmin) >= Wx sum_{u_i < 0} u_i,
// the negative u_i sum to at most -d / Wx, and at most two are negative:
// some s w_i <= -(d / (2 Wx)) |area| < -d A / (4 Wx) < -(g T + k A + e).
// Then s w~_i < -k A: w~_i has the sign -s, and w~_i / area~ lies below
// -2^-100, far from rounding to -0.0 (which would pass `>= 0`): b_i < 0 at
// every pixel of the tile.  The right side (px >= xmax + d) and y are the
// same.  Faces the argument does not cover (non-finite or very large
// coordinates, slivers, a tile within its margin) are kept.

#include "common.cuh"

#define RC_TILE 16                      // a block's tile is 16 x 16 pixels
#define RC_THREADS (RC_TILE * RC_TILE)  // one thread a pixel
#define RC_CHUNK RC_THREADS             // faces tested a round, one a thread
#define RC_WARPS (RC_THREADS / 32)

// The rounded area, as the walk computes it.
__device__ __forceinline__ float rc_area(const float* t) {
  return (t[3] - t[0]) * (t[7] - t[1]) - (t[4] - t[1]) * (t[6] - t[0]);
}

// |ex| max|py - vy| + |ey| max|px - vx| over the tile's corners, for the
// edge function ex (py - vy) - ey (px - vx).
__device__ __forceinline__ double rc_edge_t(double ex, double ey, double vx,
                                            double vy, const double (&r)[4]) {
  return fabs(ex) * fmax(fabs(r[2] - vy), fabs(r[3] - vy)) +
         fabs(ey) * fmax(fabs(r[0] - vx), fabs(r[1] - vx));
}

// True when the face t (9 floats) can cover no pixel centre of the tile
// [x0, x1] x [y0, y1] (r: the same four in double): the certificate at the
// top of this file.
__device__ __forceinline__ bool rc_skip(const float* t, float x0, float x1,
                                        float y0, float y1,
                                        const double (&r)[4]) {
  const float area = rc_area(t);
  if (!(fabsf(area) >= 1e-12f)) return true;                    // (a)
  const float fx0 = fminf(fminf(t[0], t[3]), t[6]);
  const float fx1 = fmaxf(fmaxf(t[0], t[3]), t[6]);
  const float fy0 = fminf(fminf(t[1], t[4]), t[7]);
  const float fy1 = fmaxf(fmaxf(t[1], t[4]), t[7]);
  // the tile meets the face's box (or a coordinate is NaN): keep
  if (!(x1 < fx0 || x0 > fx1 || y1 < fy0 || y0 > fy1)) return false;
  const int xyk[6] = {0, 1, 3, 4, 6, 7};
  for (int k = 0; k < 6; ++k)            // non-finite or too large: keep
    if (!(fabsf(t[xyk[k]]) <= 0x1p60f)) return false;
  const double G = 0x1p-21, E = 0x1p-100, K = 0x1p-100;
  const double ax = t[0], ay = t[1], bx = t[3], by = t[4], cx = t[6],
               cy = t[7];
  const double A = fabsf(area);
  const double aerr = G * (fabs((bx - ax) * (cy - ay)) +
                           fabs((by - ay) * (cx - ax))) + E;
  if (!(aerr < 0.5 * A)) return false;                          // a sliver
  const double tmax = fmax(fmax(rc_edge_t(cx - bx, cy - by, bx, by, r),
                                rc_edge_t(ax - cx, ay - cy, cx, cy, r)),
                           rc_edge_t(bx - ax, by - ay, ax, ay, r));
  const double margin = (G * tmax + K * A + E) * (1.0 + 0x1p-20);
  const double wx = (double)fx1 - (double)fx0;
  const double wy = (double)fy1 - (double)fy0;
  const double dx = fmax((double)fx0 - r[1], r[0] - (double)fx1);
  const double dy = fmax((double)fy0 - r[3], r[2] - (double)fy1);
  return (wx > 0.0 && dx > 0.0 && dx * A > 4.0 * wx * margin) ||
         (wy > 0.0 && dy > 0.0 && dy * A > 4.0 * wy * margin);
}

__global__ void __launch_bounds__(RC_THREADS)
raster_kernel(const float* __restrict__ tri, int F, int H, int W,
              int* __restrict__ face, float* __restrict__ zbuf) {
  __shared__ float st[RC_CHUNK * 9];  // the chunk's kept faces, ascending
  __shared__ int sid[RC_CHUNK];       // and their indices
  __shared__ int wcount[RC_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = blockIdx.x * RC_TILE, ty = blockIdx.y * RC_TILE;
  const int x = tx + (threadIdx.x % RC_TILE);
  const int y = ty + (threadIdx.x / RC_TILE);
  const bool valid = x < W && y < H;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  // the pixel centres of the tile (a ragged tile ends at the raster's edge)
  const float x0 = static_cast<float>(tx);
  const float x1 = static_cast<float>(min(tx + RC_TILE, W) - 1);
  const float y0 = static_cast<float>(ty);
  const float y1 = static_cast<float>(min(ty + RC_TILE, H) - 1);
  const double r[4] = {x0, x1, y0, y1};
  float zb = INFINITY;
  int fb = -1;
  for (int f0 = 0; f0 < F; f0 += RC_CHUNK) {
    const int f = f0 + threadIdx.x;
    float t[9];
    bool keep = false;
    if (f < F) {
#pragma unroll
      for (int k = 0; k < 9; ++k) t[k] = __ldg(tri + 9LL * f + k);
      keep = !rc_skip(t, x0, x1, y0, y1, r);
    }
    // compact the kept faces in ascending order
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();  // the counts are written; the last walk is done
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < RC_WARPS; ++w) {
      const int c = wcount[w];
      base += w < warp ? c : 0;
      total += c;
    }
    if (keep) {
      const int slot = base + __popc(bal & ((1u << lane) - 1u));
#pragma unroll
      for (int k = 0; k < 9; ++k) st[9 * slot + k] = t[k];
      sid[slot] = f;
    }
    __syncthreads();
    if (valid) {
      for (int j = 0; j < total; ++j) {
        const float* s = st + 9 * j;
        const float ax = s[0], ay = s[1], az = s[2];
        const float bx = s[3], by = s[4], bz = s[5];
        const float cx = s[6], cy = s[7], cz = s[8];
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
            fb = sid[j];
          }
        }
      }
    }
    __syncthreads();  // the list is read before the next chunk's replaces it
  }
  if (valid) {
    face[y * W + x] = fb;
    zbuf[y * W + x] = zb;
  }
}

VT_EXPORT int vt_raster(const float* tri, int F, int H, int W, int* face,
                        float* zbuf, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const dim3 grid((W + RC_TILE - 1) / RC_TILE, (H + RC_TILE - 1) / RC_TILE);
  raster_kernel<<<grid, RC_THREADS, 0, vt_stream(stream)>>>(tri, F, H, W,
                                                            face, zbuf);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel, one block of one thread: the floor a launch costs on the
// card, which chip_smoke.py times beside kernel C.
__global__ void empty_kernel() {}

VT_EXPORT int vt_empty(void* stream) {
  empty_kernel<<<1, 1, 0, vt_stream(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
