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
// pairs; a pair costs ~65 operations for the distance plus ~38 for the
// unfolded crossing test, or ~67 plus three square roots and an atan2 for
// the solid angle; the bytes are a few MB.  Under -fmad=false every add
// and multiply issues on its own.  Design (one templated body over (VIS,
// winding method)):
//   * a thread owns MQB_PPT = 4 points: thread t of block b the points
//     512 b + t + 128 q, q = 0..3, so the 32 points of a warp's slot q are
//     consecutive and every face row a thread reads serves 4 points (with
//     2 points a thread, twice the warps, the ray mode took ~10% longer on
//     the H100 and the solid angles ~2% less);
//   * the face rows (brute_face_table, 28 floats = 7 float4s: corners 9,
//     corner visibility 3, pv = d x e2, e1, e2, det, two zeros, the face's
//     sphere 4) arrive by 1-D bulk copies (TMA) of MQB_CHUNK faces into two
//     staging buffers on mbarriers: chunk k + 1 arrives while chunk k is
//     searched, and one block barrier a chunk frees a buffer for chunk
//     k + 2.  A row is 112 bytes, so every copy is a multiple of 16 bytes
//     whatever F is, and every row starts on a 16-byte boundary: the rows
//     are read as float4 broadcasts (every lane of a warp reads the same
//     address);
//   * a certified per-face skip of the distance (below): after a point's
//     first faces most faces cannot beat its running minimum, and a pair
//     then costs the 11 operations of a sphere test in place of the ~65 of
//     Ericson's regions;
//   * the winding (crossing test or solid angle) runs for every pair,
//     unchanged: no reject comes in front of it.
//
// The per-face skip.  brute_face_table appends to each row the sphere of
// ops/mesh_query.py::face_spheres: c_f the centroid and r'_f = r_f (1 +
// 1e-4) + 1e-5 R, with r_f the largest corner distance from c_f and R the
// largest corner norm of the faces as given; a sliver (twice its area
// below 1e-2 of its longest edge squared) has r'_f = inf and is never
// skipped.  A point whose best squared distance so far is `best`, with
// sb = sqrtf(best) * 1.0001 (+inf while best is), skips face f when
//     |p - c_f|^2 > (r'_f + sb)^2,
// written as ops/mesh_query.py::sphere_skip evaluates it.  This is kernel
// A's test; csrc/mesh_query.cu holds the argument that a skipped face's
// computed distance d^ satisfies sqrt(d^) > sqrt(best), for A's centred
// points.  It holds for this kernel's inputs too:
//   * uncentred points and faces.  Every rounding the argument counts is
//     either of a difference of two coordinates (p - c_f, p - a, p - q^),
//     which IEEE rounds to within u = 2^-24 of the difference itself
//     however large the two coordinates are, or of a computed point q^ of
//     the face (a + t ab, a + v ab + w ac, ...), whose coordinates are at
//     most ~R in size and round to within a few u R.  The region tests'
//     dot products round to a few u |ab| |ap| with |ap| <= d_f + 2 r_f, so
//     a misjudged region moves q^ by a few u (d_f + R).  The point's own
//     magnitude enters none of these, and R is computed from the corners
//     the kernel reads, in the coordinates it computes in: a mesh far from
//     the origin widens every r'_f by 1e-5 R, so the test skips less; it
//     does not break.  The margins 1e-4 sb and 1e-5 R still exceed these
//     terms by two orders of magnitude;
//   * the running minimum starts at +inf.  Then sb = +inf, the right side
//     is +inf, and no point skips a face before its first evaluated one;
//     from then on `best` is a distance the kernel computed, as in A.  No
//     seeded minimum is taken: `best` is only ever a computed face
//     distance.
// So a skipped face has d^ >= best, and under strict `<` it could not have
// replaced the running minimum: d2 and idx, and qvis, a function of the
// point and the winning face alone, do not change.  A warp evaluates a
// face's distance for slot q when any of its lanes keeps it for that slot
// (the 32 points are neighbours in the caller's order and mostly agree); a
// lane that could have skipped it computes a distance that cannot win.
// tests/test_torch_mesh_api.py plays this walk face by face against the
// plain version (centred meshes, meshes 1e2 and 1e3 from the origin,
// slivers, points on shared edges and vertices) and holds sphere_skip
// against point_triangle_sq_dist on single faces far from the origin;
// ops/mesh_query.py::brute_work counts the evaluations.
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
//   * solid-angle winding: Van Oosterom-Strackee per face with sqrtf and
//     atan2f, summed in face order and divided by 4 pi once.  The TPU
//     kernel's polynomial atan2 is a workaround for Mosaic and is not
//     carried over.  sqrtf and atan2f need not round as torch's do and the
//     sum's order differs, so this mode agrees with its plain version to
//     ~1e-6, where the ray and no-winding modes are bit-equal
//     (-fmad=false).

#include "common.cuh"
#include "tma.cuh"
#include "tri_dist.cuh"

#define MQB_THREADS 128
#define MQB_PPT 4       // points a thread
#define MQB_CHUNK 128   // faces a staging buffer
#define MQB_ROW4 7      // float4s a face row (ops/mesh_query.py BRUTE_STRIDE)

#define WIND_NONE 0
#define WIND_RAY 1
#define WIND_SOLID 2

#define RAY_DX 0.5773502691896258f
#define RAY_DY 0.7071067811865476f
#define RAY_DZ 0.40824829046386296f
#define FOUR_PI 12.566370614359172f

// The row's float4s: r0 = a.x a.y a.z b.x, r1 = b.y b.z c.x c.y,
// r2 = c.z vis_a vis_b vis_c, r3 = pv.x pv.y pv.z e1.x,
// r4 = e1.y e1.z e2.x e2.y, r5 = e2.z det 0 0, r6 = the sphere.
__device__ __forceinline__ float crossing_unfolded(float px, float py,
                                                   float pz, float4 r0,
                                                   float4 r3, float4 r4,
                                                   float4 r5) {
  const float qx = px - r0.x, qy = py - r0.y, qz = pz - r0.z;
  const float u = qx * r3.x + qy * r3.y + qz * r3.z;
  const float e1x = r3.w, e1y = r4.x, e1z = r4.y;
  const float qvx = qy * e1z - qz * e1y;
  const float qvy = qz * e1x - qx * e1z;
  const float qvz = qx * e1y - qy * e1x;
  const float v = RAY_DX * qvx + RAY_DY * qvy + RAY_DZ * qvz;
  const float w = r4.z * qvx + r4.w * qvy + r5.x * qvz;
  const float det = r5.y;
  const bool hit = (u * det >= 0.0f) && (v * det >= 0.0f) &&
                   ((u + v - det) * det <= 0.0f) && (w * det > 0.0f);
  return hit ? (det > 0.0f ? -1.0f : 1.0f) : 0.0f;
}

__device__ __forceinline__ float solid_angle(float px, float py, float pz,
                                             float4 r0, float4 r1,
                                             float4 r2) {
  const float r1x = r0.x - px, r1y = r0.y - py, r1z = r0.z - pz;
  const float r2x = r0.w - px, r2y = r1.x - py, r2z = r1.y - pz;
  const float r3x = r1.z - px, r3y = r1.w - py, r3z = r2.x - pz;
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
__global__ void __launch_bounds__(MQB_THREADS) mesh_query_brute_kernel(
    const float* __restrict__ pts, int N, const float4* __restrict__ faces,
    int F, float* __restrict__ d2o, int* __restrict__ idxo,
    float* __restrict__ windo, float* __restrict__ qviso) {
  __shared__ __align__(128) float4 sf[2][MQB_CHUNK * MQB_ROW4];
  __shared__ __align__(8) unsigned long long bar[2];
  const int i0 = blockIdx.x * (MQB_THREADS * MQB_PPT) + threadIdx.x;
  float px[MQB_PPT], py[MQB_PPT], pz[MQB_PPT], best[MQB_PPT], sb[MQB_PPT];
  float wind[MQB_PPT], qvis[MQB_PPT];
  int bidx[MQB_PPT];
#pragma unroll
  for (int q = 0; q < MQB_PPT; ++q) {
    // a ragged last block repeats the last point (it writes nothing)
    const int i = min(i0 + q * MQB_THREADS, N - 1);
    px[q] = pts[3 * i];
    py[q] = pts[3 * i + 1];
    pz[q] = pts[3 * i + 2];
    best[q] = INFINITY;
    sb[q] = INFINITY;
    wind[q] = 0.0f;
    qvis[q] = 0.0f;
    bidx[q] = 0;
  }
  if (threadIdx.x == 0) {
    bar_init(&bar[0]);
    bar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_chunks = (F + MQB_CHUNK - 1) / MQB_CHUNK;
  // chunk k sits in buffer k & 1, the (k >> 1)-th fill of that buffer
  auto issue = [&](int k) {
    const int f0 = k * MQB_CHUNK;
    const unsigned bytes =
        static_cast<unsigned>(min(MQB_CHUNK, F - f0) * MQB_ROW4 * 16);
    bar_expect(&bar[k & 1], bytes);
    bulk_load(sf[k & 1], faces + (size_t)f0 * MQB_ROW4, bytes, &bar[k & 1]);
  };
  if (threadIdx.x == 0) {
    if (n_chunks > 0) issue(0);
    if (n_chunks > 1) issue(1);
  }
  for (int k = 0; k < n_chunks; ++k) {
    bar_wait(&bar[k & 1], (k >> 1) & 1);
    const float4* buf = sf[k & 1];
    const int f0 = k * MQB_CHUNK;
    const int nf = min(MQB_CHUNK, F - f0);
    for (int j = 0; j < nf; ++j) {
      const float4* row = buf + MQB_ROW4 * j;
      const float4 s = row[6];
      unsigned ev = 0u;  // the slots whose warp evaluates the distance
#pragma unroll
      for (int q = 0; q < MQB_PPT; ++q) {
        const float dx = px[q] - s.x, dy = py[q] - s.y, dz = pz[q] - s.z;
        const float e = dx * dx + dy * dy + dz * dz;
        const float t = s.w + sb[q];
        if (__any_sync(0xffffffffu, !(e > t * t))) ev |= 1u << q;
      }
      if (ev != 0u) {
        const float4 r0 = row[0], r1 = row[1], r2 = row[2];
#pragma unroll
        for (int q = 0; q < MQB_PPT; ++q) {
          if (!((ev >> q) & 1u)) continue;
          float va, vb, vc;
          const float d = tri_sq_dist(px[q], py[q], pz[q], r0.x, r0.y, r0.z,
                                      r0.w, r1.x, r1.y, r1.z, r1.w, r2.x,
                                      va, vb, vc);
          if (d < best[q]) {
            best[q] = d;
            sb[q] = sqrtf(d) * 1.0001f;
            bidx[q] = f0 + j;
            if (VIS) {
              const float denom = va + vb + vc;
              const float den = denom == 0.0f ? 1.0f : denom;
              const float v = vb / den;
              const float w = vc / den;
              qvis[q] = (1.0f - v - w) * r2.y + v * r2.z + w * r2.w;
            }
          }
        }
      }
      if (WIND == WIND_RAY) {
        const float4 r0 = row[0], r3 = row[3], r4 = row[4], r5 = row[5];
#pragma unroll
        for (int q = 0; q < MQB_PPT; ++q)
          wind[q] += crossing_unfolded(px[q], py[q], pz[q], r0, r3, r4, r5);
      }
      if (WIND == WIND_SOLID) {
        const float4 r0 = row[0], r1 = row[1], r2 = row[2];
#pragma unroll
        for (int q = 0; q < MQB_PPT; ++q)
          wind[q] += solid_angle(px[q], py[q], pz[q], r0, r1, r2);
      }
    }
    // every thread has left buffer k & 1: refill it with chunk k + 2
    __syncthreads();
    if (threadIdx.x == 0 && k + 2 < n_chunks) issue(k + 2);
  }
#pragma unroll
  for (int q = 0; q < MQB_PPT; ++q) {
    const int i = i0 + q * MQB_THREADS;
    if (i < N) {
      d2o[i] = best[q];
      idxo[i] = bidx[q];
      windo[i] = WIND == WIND_SOLID ? wind[q] / FOUR_PI : wind[q];
      if (VIS) qviso[i] = qvis[q];
    }
  }
}

template <bool VIS>
static int brute_launch(const float* pts, int N, const float* faces, int F,
                        int wind_mode, float* d2, int* idx, float* wind,
                        float* qvis, void* stream) {
  if (reinterpret_cast<size_t>(faces) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  const int blocks = vt_blocks(N, MQB_THREADS * MQB_PPT);
  const float4* rows = reinterpret_cast<const float4*>(faces);
  cudaStream_t s = vt_stream(stream);
  switch (wind_mode) {
    case WIND_NONE:
      mesh_query_brute_kernel<VIS, WIND_NONE><<<blocks, MQB_THREADS, 0, s>>>(
          pts, N, rows, F, d2, idx, wind, qvis);
      break;
    case WIND_RAY:
      mesh_query_brute_kernel<VIS, WIND_RAY><<<blocks, MQB_THREADS, 0, s>>>(
          pts, N, rows, F, d2, idx, wind, qvis);
      break;
    case WIND_SOLID:
      mesh_query_brute_kernel<VIS, WIND_SOLID><<<blocks, MQB_THREADS, 0, s>>>(
          pts, N, rows, F, d2, idx, wind, qvis);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 5.  pts (N, 3), faces (F, 28) rows of brute_face_table, 16-byte
// aligned; wind_mode 0 none (wind := 0), 1 signed ray crossings, 2 solid
// angles.
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
