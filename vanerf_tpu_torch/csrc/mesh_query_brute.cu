// Kernels 5 and 6 — the exact, unculled point -> mesh query: per point, the
// minimum squared distance over EVERY face, the argmin face, a winding
// number, and (kernel 6) the vertex visibility interpolated on the argmin
// face.  No certified bound, no far tier: this is the reference-faithful
// mesh prior behind point_mesh_query / point_mesh_sdf / cal_vis_sdf /
// cal_vis_sdf_fast.
//
// 5 replaces the TPU kernel vanerf_tpu/ops/mesh_query_pallas.py::
// point_mesh_query_pallas (bodies `_kernel_ray` and `_kernel`, distance
// chunk `_distance_chunk`); 6 replaces point_mesh_query_vis_pallas (bodies
// `_kernel_vis_ray` and `_kernel_vis`, chunk `_distance_chunk_vis`).  The
// TPU wrappers pad the points to tiles of 128 and the faces to chunks of
// 512 with far-away degenerate triangles; here N and F are any size and
// the ragged edges are masked.
//
// Bound on the H100: arithmetic.  262,144 points x 2,560 faces are 6.7e8
// pairs; a pair costs ~65 operations for the distance plus ~37 for the
// unfolded crossing test, or ~63 plus three square roots and an atan2 for
// the solid angle; the bytes are a few MB.  Design: one thread per point,
// one templated body over (VIS, winding method); the per-face rows (22
// floats: 9 corner coordinates, 3 corner visibilities, pv = d x e2, e1, e2,
// det = e1 . pv) are staged through shared memory 128 faces at a time and
// read as warp broadcasts.
//
// Numerics, those of the plain versions in ops/mesh_query.py:
//   * distance: the difference-form Ericson region method (tri_dist.cuh),
//     running minimum with strict `<` over ascending faces, so ties go to
//     the lowest face index;
//   * visibility (kernel 6): Ericson's plane barycentrics of the face that
//     wins the running minimum, v = vb/denom, w = vc/denom (denom == 0 ->
//     1), qv = (1 - v - w) vis_a + v vis_b + w vis_c, unclamped — what the
//     TPU kernel carries with its minimum (`_distance_chunk_vis`), and not
//     kernel A's projection after the sweep.  It is evaluated only when a
//     face becomes the new best;
//   * ray winding: SIGNED crossings of the ray p + t d, d = _RAY_D, by
//     Moller-Trumbore with the UNFOLDED per-face constants pv, e1, e2, det
//     (`_ray_constants`): v = d . (q x e1), t = e2 . (q x e1).  Kernel A's
//     table holds the folded ones (w2 = e1 x d, n = e1 x e2), which save a
//     cross product per pair; the two round differently in v and t, and the
//     crossing counts agree except where a ray grazes an edge to within
//     rounding;
//   * solid-angle winding: Van Oosterom-Strackee per face with atan2f,
//     summed in face order and divided by 4 pi once.  The TPU kernel's
//     polynomial atan2 is a workaround for Mosaic and is not carried over.
//     sqrtf and atan2f need not round as torch's do and the sum's order
//     differs, so this mode agrees with its plain version to ~1e-6, where
//     the ray and no-winding modes are bit-equal (-fmad=false).

#include "common.cuh"
#include "tri_dist.cuh"

#define MQB_THREADS 128
#define MQB_CHUNK 128
#define MQB_STRIDE 22  // a(3) b(3) c(3) | vis_a vis_b vis_c | pv(3) e1(3) e2(3) det

#define WIND_NONE 0
#define WIND_RAY 1
#define WIND_SOLID 2

#define RAY_DX 0.5773502691896258f
#define RAY_DY 0.7071067811865476f
#define RAY_DZ 0.40824829046386296f
#define FOUR_PI 12.566370614359172f

__device__ __forceinline__ float crossing_unfolded(float px, float py,
                                                   float pz, const float* t) {
  const float qx = px - t[0], qy = py - t[1], qz = pz - t[2];
  const float u = qx * t[12] + qy * t[13] + qz * t[14];
  const float e1x = t[15], e1y = t[16], e1z = t[17];
  const float qvx = qy * e1z - qz * e1y;
  const float qvy = qz * e1x - qx * e1z;
  const float qvz = qx * e1y - qy * e1x;
  const float v = RAY_DX * qvx + RAY_DY * qvy + RAY_DZ * qvz;
  const float w = t[18] * qvx + t[19] * qvy + t[20] * qvz;
  const float det = t[21];
  const bool hit = (u * det >= 0.0f) && (v * det >= 0.0f) &&
                   ((u + v - det) * det <= 0.0f) && (w * det > 0.0f);
  return hit ? (det > 0.0f ? -1.0f : 1.0f) : 0.0f;
}

__device__ __forceinline__ float solid_angle(float px, float py, float pz,
                                             const float* t) {
  const float r1x = t[0] - px, r1y = t[1] - py, r1z = t[2] - pz;
  const float r2x = t[3] - px, r2y = t[4] - py, r2z = t[5] - pz;
  const float r3x = t[6] - px, r3y = t[7] - py, r3z = t[8] - pz;
  const float n1 = sqrtf(r1x * r1x + r1y * r1y + r1z * r1z);
  const float n2 = sqrtf(r2x * r2x + r2y * r2y + r2z * r2z);
  const float n3 = sqrtf(r3x * r3x + r3y * r3y + r3z * r3z);
  const float crx = r2y * r3z - r2z * r3y;
  const float cry = r2z * r3x - r2x * r3z;
  const float crz = r2x * r3y - r2y * r3x;
  const float num = r1x * crx + r1y * cry + r1z * crz;
  const float den = n1 * n2 * n3 +
                    (r1x * r2x + r1y * r2y + r1z * r2z) * n3 +
                    (r1x * r3x + r1y * r3y + r1z * r3z) * n2 +
                    (r2x * r3x + r2y * r3y + r2z * r3z) * n1;
  return 2.0f * atan2f(num, den);
}

template <bool VIS, int WIND>
__global__ void mesh_query_brute_kernel(const float* __restrict__ pts, int N,
                                        const float* __restrict__ faces,
                                        int F, float* __restrict__ d2o,
                                        int* __restrict__ idxo,
                                        float* __restrict__ windo,
                                        float* __restrict__ qviso) {
  __shared__ float sf[MQB_CHUNK * MQB_STRIDE];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < N;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (valid) {
    px = pts[3 * i];
    py = pts[3 * i + 1];
    pz = pts[3 * i + 2];
  }
  float best = INFINITY;
  int bidx = 0;
  float qvis = 0.0f;
  float wind = 0.0f;
  for (int f0 = 0; f0 < F; f0 += MQB_CHUNK) {
    const int nf = min(MQB_CHUNK, F - f0);
    __syncthreads();
    for (int k = threadIdx.x; k < MQB_STRIDE * nf; k += blockDim.x)
      sf[k] = faces[(size_t)MQB_STRIDE * f0 + k];
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nf; ++j) {
      const float* t = sf + MQB_STRIDE * j;
      float va, vb, vc;
      const float d = tri_sq_dist(px, py, pz, t, va, vb, vc);
      if (d < best) {
        best = d;
        bidx = f0 + j;
        if (VIS) {
          const float denom = va + vb + vc;
          const float den = denom == 0.0f ? 1.0f : denom;
          const float v = vb / den;
          const float w = vc / den;
          qvis = (1.0f - v - w) * t[9] + v * t[10] + w * t[11];
        }
      }
      if (WIND == WIND_RAY) wind += crossing_unfolded(px, py, pz, t);
      if (WIND == WIND_SOLID) wind += solid_angle(px, py, pz, t);
    }
  }
  if (!valid) return;
  d2o[i] = best;
  idxo[i] = bidx;
  windo[i] = WIND == WIND_SOLID ? wind / FOUR_PI : wind;
  if (VIS) qviso[i] = qvis;
}

template <bool VIS>
static int brute_launch(const float* pts, int N, const float* faces, int F,
                        int wind_mode, float* d2, int* idx, float* wind,
                        float* qvis, void* stream) {
  if (N <= 0) return 0;
  const int blocks = vt_blocks(N, MQB_THREADS);
  cudaStream_t s = vt_stream(stream);
  switch (wind_mode) {
    case WIND_NONE:
      mesh_query_brute_kernel<VIS, WIND_NONE><<<blocks, MQB_THREADS, 0, s>>>(
          pts, N, faces, F, d2, idx, wind, qvis);
      break;
    case WIND_RAY:
      mesh_query_brute_kernel<VIS, WIND_RAY><<<blocks, MQB_THREADS, 0, s>>>(
          pts, N, faces, F, d2, idx, wind, qvis);
      break;
    case WIND_SOLID:
      mesh_query_brute_kernel<VIS, WIND_SOLID><<<blocks, MQB_THREADS, 0, s>>>(
          pts, N, faces, F, d2, idx, wind, qvis);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 5.  pts (N, 3), faces (F, 22); wind_mode 0 none (wind := 0),
// 1 signed ray crossings, 2 solid angles.
VT_EXPORT int vt_mesh_query_brute(const float* pts, int N, const float* faces,
                                  int F, int wind_mode, float* d2, int* idx,
                                  float* wind, void* stream) {
  return brute_launch<false>(pts, N, faces, F, wind_mode, d2, idx, wind,
                             nullptr, stream);
}

// Kernel 6: kernel 5 plus the argmin face's interpolated visibility.
VT_EXPORT int vt_mesh_query_vis_brute(const float* pts, int N,
                                      const float* faces, int F,
                                      int wind_mode, float* d2, int* idx,
                                      float* wind, float* qvis,
                                      void* stream) {
  return brute_launch<true>(pts, N, faces, F, wind_mode, d2, idx, wind, qvis,
                            stream);
}
