// Exact squared point-triangle distance, shared by the mesh-query kernels
// (mesh_query.cu: kernels A and 7; mesh_query_brute.cu: kernels 5 and 6).
//
// The difference-form Ericson region method (Real-Time Collision Detection
// 5.1.5) of vanerf_tpu/ops/mesh_query.py::point_triangle_sq_dist, in the
// order of the plain version ops/mesh_query.py::point_triangle_sq_dist.
// `va`, `vb`, `vc` are Ericson's unnormalised plane barycentrics of the
// point's projection; kernel 6 interpolates the vertex visibility with
// them, the other kernels ignore them (the compiler drops the stores).
#pragma once

// The corners as values (kernels 5 and 6 hold them in registers from
// 16-byte loads); the form below reads them from a table row (A, 7).
__device__ __forceinline__ float tri_sq_dist(float px, float py, float pz,
                                             float ax, float ay, float az,
                                             float bx, float by, float bz,
                                             float cx, float cy, float cz,
                                             float& va_o, float& vb_o,
                                             float& vc_o) {
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
  va_o = va;
  vb_o = vb;
  vc_o = vc;
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

__device__ __forceinline__ float tri_sq_dist(float px, float py, float pz,
                                             const float* t) {
  float va, vb, vc;
  return tri_sq_dist(px, py, pz, t[0], t[1], t[2], t[3], t[4], t[5], t[6],
                     t[7], t[8], va, vb, vc);
}
