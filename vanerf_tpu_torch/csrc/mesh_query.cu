// Kernel A — point -> mesh query: per point, the exact minimum squared
// distance to the mesh, the argmin face, the signed ray-crossing winding
// number along a fixed direction, and the barycentric vertex visibility of
// the winning face.
//
// Replaces the TPU kernel vanerf_tpu/ops/mesh_query_pallas.py::
// point_mesh_query_vis_culled (body `_kernel_vis_ray_culled`, distance
// chunk `_distance_chunk_vis_fast`, host prep `prepare_mesh_ray`,
// `_cull_masks`, `_cull_lists`).
//
// Bound on the H100: arithmetic.  Brute force visits every (point, face)
// pair: 262,144 points x 2,560 faces = 6.7e8 pairs per pass at ~80 flops
// (difference-form Ericson distance) + ~25 flops (crossing test) each, i.e.
// ~70 GFLOP; the bytes are a few MB.  Design: one thread per point; faces
// are staged through shared memory in chunks of 128 faces x 22 floats
// (11 KB: 9 corner coordinates, 3 corner visibilities, 10 folded crossing
// constants) and read as warp broadcasts.  The TPU kernel's AABB culling
// changes no result except argmin ties, so this first kernel visits every
// face; culling is later work.
//
// Numerics, chosen to match the plain-PyTorch twin in ops/mesh_query.py:
//   * distance: the difference-form Ericson region method of
//     vanerf_tpu/ops/mesh_query.py::point_triangle_sq_dist (the TPU
//     kernel's |p|^2 - 2p.a + |a|^2 form trades accuracy for VPU ops);
//   * running minimum with strict `<` in ascending face order: ties go to
//     the lowest face index, as with jnp.argmin / torch.argmin;
//   * winding: SIGNED crossings of the ray p + t*d, t > 0, with
//     d = _RAY_D for every point (a point inside both hands reads 2).  The
//     sign comes from det = -d.(e1 x e2) (mesh_query_pallas.py:863-868);
//   * far points (flag set by the caller) skip the distance search: their
//     d2 is the caller's certified upper bound, qvis is 0, and the winding
//     stays exact;
//   * visibility: barycentrics of the point's projection onto the winning
//     face's plane (Heidrich, mesh_query.py::barycentric_of_projection),
//     computed once per point after the sweep.

#include "common.cuh"

#define MQ_THREADS 128
#define MQ_CHUNK 128
#define MQ_STRIDE 22  // ax ay az bx by bz cx cy cz | va vb vc | pv(3) w2(3) n(3) det

__device__ __forceinline__ float tri_sq_dist(float px, float py, float pz,
                                             const float* t) {
  const float ax = t[0], ay = t[1], az = t[2];
  const float bx = t[3], by = t[4], bz = t[5];
  const float cx = t[6], cy = t[7], cz = t[8];
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  const float apx = px - ax, apy = py - ay, apz = pz - az;
  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;
  const float bpx = px - bx, bpy = py - by, bpz = pz - bz;
  const float d3 = abx * bpx + aby * bpy + abz * bpz;
  const float d4 = acx * bpx + acy * bpy + acz * bpz;
  const float cpx = px - cx, cpy = py - cy, cpz = pz - cz;
  const float d5 = abx * cpx + aby * cpy + abz * cpz;
  const float d6 = acx * cpx + acy * cpy + acz * cpz;
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  float qx, qy, qz;
  // region precedence of point_triangle_sq_dist's `where` chain: the last
  // `where` applied (vertex a) wins, so test in reverse order
  if (d1 <= 0.0f && d2 <= 0.0f) {
    qx = ax; qy = ay; qz = az;
  } else if (d3 >= 0.0f && d4 <= d3) {
    qx = bx; qy = by; qz = bz;
  } else if (d6 >= 0.0f && d5 <= d6) {
    qx = cx; qy = cy; qz = cz;
  } else if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {
    const float tt = d1 / fmaxf(d1 - d3, 1e-20f);
    qx = ax + tt * abx; qy = ay + tt * aby; qz = az + tt * abz;
  } else if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {
    const float tt = d2 / fmaxf(d2 - d6, 1e-20f);
    qx = ax + tt * acx; qy = ay + tt * acy; qz = az + tt * acz;
  } else if (va <= 0.0f && (d4 - d3) >= 0.0f && (d5 - d6) >= 0.0f) {
    const float tt = (d4 - d3) / fmaxf((d4 - d3) + (d5 - d6), 1e-20f);
    qx = bx + tt * (cx - bx); qy = by + tt * (cy - by); qz = bz + tt * (cz - bz);
  } else {
    const float denom = va + vb + vc;
    const float den = denom == 0.0f ? 1.0f : denom;
    const float v = vb / den;
    const float w = vc / den;
    qx = ax + v * abx + w * acx;
    qy = ay + v * aby + w * acy;
    qz = az + v * abz + w * acz;
  }
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  return dx * dx + dy * dy + dz * dz;
}

__device__ __forceinline__ float crossing(float px, float py, float pz,
                                          const float* t) {
  const float qx = px - t[0], qy = py - t[1], qz = pz - t[2];
  const float u = qx * t[12] + qy * t[13] + qz * t[14];
  const float v = qx * t[15] + qy * t[16] + qz * t[17];
  const float w = qx * t[18] + qy * t[19] + qz * t[20];
  const float det = t[21];
  const bool hit = (u * det >= 0.0f) && (v * det >= 0.0f) &&
                   ((u + v - det) * det <= 0.0f) && (w * det > 0.0f);
  return hit ? (det > 0.0f ? -1.0f : 1.0f) : 0.0f;
}

__device__ __forceinline__ float face_vis(float px, float py, float pz,
                                          const float* t) {
  const float ux = t[3] - t[0], uy = t[4] - t[1], uz = t[5] - t[2];
  const float vx = t[6] - t[0], vy = t[7] - t[1], vz = t[8] - t[2];
  const float nx = uy * vz - uz * vy;
  const float ny = uz * vx - ux * vz;
  const float nz = ux * vy - uy * vx;
  float s = nx * nx + ny * ny + nz * nz;
  s = s == 0.0f ? 1e-6f : s;
  const float wx = px - t[0], wy = py - t[1], wz = pz - t[2];
  const float c2x = uy * wz - uz * wy;  // u x w
  const float c2y = uz * wx - ux * wz;
  const float c2z = ux * wy - uy * wx;
  const float c1x = wy * vz - wz * vy;  // w x v
  const float c1y = wz * vx - wx * vz;
  const float c1z = wx * vy - wy * vx;
  const float b2 = (c2x * nx + c2y * ny + c2z * nz) / s;
  const float b1 = (c1x * nx + c1y * ny + c1z * nz) / s;
  const float b0 = 1.0f - b1 - b2;
  return t[9] * b0 + t[10] * b1 + t[11] * b2;
}

__global__ void mesh_query_kernel(const float* __restrict__ pts, int N,
                                  const float* __restrict__ faces, int F,
                                  const float* __restrict__ ub,
                                  const unsigned char* __restrict__ far,
                                  float* __restrict__ d2o,
                                  int* __restrict__ idxo,
                                  float* __restrict__ windo,
                                  float* __restrict__ qviso) {
  __shared__ float sf[MQ_CHUNK * MQ_STRIDE];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < N;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  bool is_far = false;
  if (valid) {
    px = pts[3 * i];
    py = pts[3 * i + 1];
    pz = pts[3 * i + 2];
    is_far = far != nullptr && far[i] != 0;
  }
  float best = INFINITY;
  int bidx = 0;
  float wind = 0.0f;
  for (int f0 = 0; f0 < F; f0 += MQ_CHUNK) {
    const int nf = min(MQ_CHUNK, F - f0);
    __syncthreads();
    for (int k = threadIdx.x; k < MQ_STRIDE * nf; k += blockDim.x)
      sf[k] = faces[MQ_STRIDE * f0 + k];
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nf; ++j) {
      const float* t = sf + MQ_STRIDE * j;
      if (!is_far) {
        const float d = tri_sq_dist(px, py, pz, t);
        if (d < best) {
          best = d;
          bidx = f0 + j;
        }
      }
      wind += crossing(px, py, pz, t);
    }
  }
  if (!valid) return;
  windo[i] = wind;
  idxo[i] = bidx;
  if (is_far) {
    d2o[i] = ub[i];
    qviso[i] = 0.0f;
  } else {
    d2o[i] = best;
    qviso[i] = F > 0 ? face_vis(px, py, pz, faces + MQ_STRIDE * bidx) : 0.0f;
  }
}

VT_EXPORT int vt_mesh_query(const float* pts, int N, const float* faces,
                            int F, const float* ub, const unsigned char* far,
                            float* d2, int* idx, float* wind, float* qvis,
                            void* stream) {
  if (N <= 0) return 0;
  mesh_query_kernel<<<vt_blocks(N, MQ_THREADS), MQ_THREADS, 0,
                      vt_stream(stream)>>>(pts, N, faces, F, ub, far, d2, idx,
                                           wind, qvis);
  return static_cast<int>(cudaGetLastError());
}
