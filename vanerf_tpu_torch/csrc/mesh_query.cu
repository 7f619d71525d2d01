// Kernels A and 7 — point -> mesh query: per point, the exact minimum squared
// distance to the mesh, the argmin face, the signed ray-crossing winding
// number along a fixed direction, and the barycentric vertex visibility of
// the winning face.
//
// A replaces the TPU kernel vanerf_tpu/ops/mesh_query_pallas.py::
// point_mesh_query_vis_culled (body `_kernel_vis_ray_culled`, distance
// chunk `_distance_chunk_vis_fast`, host prep `prepare_mesh_ray`,
// `_cull_masks`, `_cull_lists`).  7 replaces point_mesh_query_vis_culled_T
// (body `_kernel_vis_ray_culled_T`): the same function on coordinate-major
// (3, N) points.  On the TPU that layout avoids padding a 3-wide minor
// dimension to 128 lanes; here it turns a thread's three loads of stride 3
// into three loads that a warp coalesces.  Both are one kernel body with
// the point loads as a template parameter, so 7 equals A bit for bit on the
// transposed input; the outputs are packed (N,) arrays in both.
//
// Bound on the H100: arithmetic, ~65 operations a (point, face) pair for the
// difference-form Ericson distance and ~29 for the crossing test, over the
// pairs the culling keeps; the bytes are a few MB.  Built with -fmad=false,
// every add and multiply takes its own issue slot, so the reachable rate is
// half the f32 peak.
//
// Design of the culled query (`mesh_query_culled_kernel`).  The TPU version
// relayouts the points into blocked order, builds per-tile boxes, masks and
// compacted chunk lists on the host, and ships the lists through scalar
// memory.  Here A BLOCK IS A TILE of TP points of the blocked order (TP =
// VANERF_MESH_TILE_P, 64 / 128 / 256, a template parameter; 128 = 16 rays
// x 8 samples, or the 2-D pixel blocks of VANERF_BLOCK_2D): thread t of
// block b finds its ray-major point by index arithmetic from the tile
// geometry, so no relayouted copy of points, bounds or outputs exists and
// no list goes through device memory.  Chunks hold CH = VANERF_CULL_CHUNK
// faces (64 / 128, a template parameter).  The block
//   1. reduces its points' box, the largest and the least bound with warp
//      shuffles (a ragged last tile repeats its last real point);
//   2. decides the far tier for the whole tile: every bound above far2
//      means no distance search at all, so a far block runs the winding
//      loop only (per-point far flags saved the unculled sweep nothing,
//      because every warp also held near points);
//   3. lets its first C threads (C <= 64 chunks of 128 Morton-sorted faces)
//      each test one chunk box from the (C, 6) table the wrapper made once
//      per mesh: the distance test `gap^2 <= ub_t (1 + 1e-5) + 1e-12`, and
//      the conservative separating-axis test of the tile box swept along
//      +d and along -d (per-axis half spaces, the ray axis, the three axes
//      d x e_k); ballots publish three 64-bit masks in shared memory, and
//      the tile takes the ray direction that keeps fewer chunks
//      (crossings along -d are the `t det < 0` half-line of the same
//      arithmetic, the sign taking the tile's s = -1);
//   4. walks the set bits of (distance | winding) in ascending order and
//      stages only those chunks of CH x 22 floats and their CH face
//      spheres, once each; a chunk in both sets runs both tests from one
//      staging (the TPU kernel has two loops; the winding sum is a sum of
//      +-1 and does not depend on the order, so one loop gives the same
//      result).  Two staging buffers, each filled by 1-D bulk copies (TMA)
//      that complete on an mbarrier: chunk q+1 arrives while chunk q is
//      searched, and one block barrier a chunk frees a buffer for chunk
//      q+2;
//   5. inside a distance chunk, skips (a warp at a time) every face whose
//      bounding sphere certifies that it cannot beat a point's best
//      distance so far (the proof is at `mesh_query_culled_kernel`): most
//      pairs of a visited chunk then cost 11 operations, not 65.
// Under VANERF_CULL_EARLY the distance chunks come first, in ascending
// order of their box lower bound (ranked in shared memory), and the walk
// stops at the first whose bound exceeds the tile's largest best d2 so far
// (a block max after each chunk); the winding chunks it did not stage
// follow in ascending order.  d2 and the winding are the default walk's;
// on exact ties another face may win (the JAX docstring's argmin-tie
// freedom).
// The tolerance keeps the chunk of every face that reaches the minimum, and
// the order is ascending in the sorted table, so d2, idx and qvis equal the
// sweep over every face of the same table bit for bit, and the winding
// equals it on every tile that keeps +d (along -d a ray that grazes an edge
// may count differently).  The mask expressions are those of
// ops/mesh_query.py::cull_masks in their written order.
// `mesh_query_kernel`, the sweep over every face with per-point far flags,
// stays for comparisons; no render path launches it.
// The culled kernel takes a batch (the JAX package's vmap over the batch,
// as a grid dimension): element e of B (blockIdx.y) reads its own points,
// bounds and outputs and mesh e % Bm of a stack of prepared meshes (the
// G tiles of one frame in a tile group share the frame's mesh): face
// tables `fstride` floats apart (a multiple of 4, so every mesh's rows
// start on the 16-byte boundary the bulk copies need, with room for the
// padding row), spheres F and chunk boxes C apart.  The tile geometry and
// the far tier are the same for every element (they depend on N, the
// samples and far2 only), and an element's arithmetic does not depend on
// the batch, so each equals its own launch at B = 1 bit for bit.  The
// offsets are 64-bit.
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
//   * far points (a whole tile in the culled query, flags set by the caller
//     in the sweep) skip the distance search: their d2 is the caller's
//     certified upper bound, qvis is 0, and the winding stays exact;
//   * visibility: barycentrics of the point's projection onto the winning
//     face's plane (Heidrich, mesh_query.py::barycentric_of_projection),
//     computed once per point after the sweep.

#include "common.cuh"
#include "tma.cuh"
#include "tri_dist.cuh"

#define MQ_THREADS 128
#define MQ_CHUNK 128
#define MQ_STRIDE 22  // ax ay az bx by bz cx cy cz | va vb vc | pv(3) w2(3) n(3) det

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

// The same test along s * d for s = +-1: flipping d negates u, v and det,
// which leaves every product with det unchanged except t * det and the
// crossing's sign (mesh_query_pallas.py:836-866).  s = 1 is `crossing`.
__device__ __forceinline__ float crossing_s(float px, float py, float pz,
                                            const float* t, float s) {
  const float qx = px - t[0], qy = py - t[1], qz = pz - t[2];
  const float u = qx * t[12] + qy * t[13] + qz * t[14];
  const float v = qx * t[15] + qy * t[16] + qz * t[17];
  const float w = qx * t[18] + qy * t[19] + qz * t[20];
  const float det = t[21];
  const bool hit = (u * det >= 0.0f) && (v * det >= 0.0f) &&
                   ((u + v - det) * det <= 0.0f) && (s * (w * det) > 0.0f);
  return hit ? (det > 0.0f ? -s : s) : 0.0f;
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

template <bool SOA>
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
    px = SOA ? pts[i] : pts[3 * i];
    py = SOA ? pts[(size_t)N + i] : pts[3 * i + 1];
    pz = SOA ? pts[2 * (size_t)N + i] : pts[3 * i + 2];
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
  mesh_query_kernel<false><<<vt_blocks(N, MQ_THREADS), MQ_THREADS, 0,
                             vt_stream(stream)>>>(pts, N, faces, F, ub, far,
                                                  d2, idx, wind, qvis);
  return static_cast<int>(cudaGetLastError());
}

// The sweep over every face on (3, N) contiguous `pts`.
VT_EXPORT int vt_mesh_query_T(const float* pts, int N, const float* faces,
                              int F, const float* ub,
                              const unsigned char* far, float* d2, int* idx,
                              float* wind, float* qvis, void* stream) {
  if (N <= 0) return 0;
  mesh_query_kernel<true><<<vt_blocks(N, MQ_THREADS), MQ_THREADS, 0,
                            vt_stream(stream)>>>(pts, N, faces, F, ub, far,
                                                 d2, idx, wind, qvis);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the culled query
// ---------------------------------------------------------------------------

#define MQ_MAX_CHUNKS 64

// How tiles are cut from the ray-major order: (H x W) rays x S samples in
// blocks of (bh x bw) rays x sb samples; sb == 0 means consecutive points.
struct TileGeom {
  int H, W, S, bh, bw, sb;
};

// The ray-major index of position j of the blocked order
// (ops/mesh_query.py::_to_blocked2d_ax1).
__device__ __forceinline__ int tile_point(int j, const TileGeom& g) {
  if (g.sb == 0) return j;
  const int s = j % g.sb; j /= g.sb;
  const int x = j % g.bw; j /= g.bw;
  const int y = j % g.bh; j /= g.bh;
  const int n_sk = g.S / g.sb, n_wb = g.W / g.bw;
  const int sk = j % n_sk; j /= n_sk;
  const int wb = j % n_wb;
  const int hb = j / n_wb;
  return ((hb * g.bh + y) * g.W + wb * g.bw + x) * g.S + sk * g.sb + s;
}

// The per-face rejection (ops/mesh_query.py::face_spheres / sphere_skip).
// Each face has a sphere (c_f, r'_f): c_f its centroid and r'_f its largest
// corner distance r_f widened to r_f (1 + 1e-4) + 1e-5 R (R the prepared
// mesh's largest corner norm; a sliver face has r'_f = inf).  A point whose
// best squared distance so far is `best` skips face f when
//     |p - c_f|^2 > (r'_f + sqrt(best) (1 + 1e-4))^2.
// Why a skipped face cannot change d2, idx or qvis: every point of the
// triangle lies within r_f of c_f, so its true distance is
// d_f >= |p - c_f| - r_f.  The test's three roundings (the differences,
// the squares and sums of non-negative terms, the square of t) are each a
// few units in the last place u of the quantity, so the test implies
// |p - c_f| > (r'_f + sb)(1 - 8u) and d_f > sb + 1e-4 r_f + 1e-5 R - 8u
// (r'_f + sb).  The distance the sweep would compute for face f,
// tri_sq_dist, is that of a computed point q^ which lies on the triangle,
// or on a line or plane through its feature on the side where the true
// closest point is the foot of the perpendicular, up to the rounding of
// its coordinates, a few u R for a face whose area is not below 1e-2 of
// its longest edge squared (the region tests can misjudge only points
// within rounding of a region's border, where the two regions' points
// meet); so sqrt(d^) >= d_f (1 - 4u) - 8u R.  With u = 2^-24 the margins
// 1e-4 sqrt(best) and 1e-5 R exceed these terms by two orders, hence
// sqrt(d^) > sqrt(best) and d^ >= best: under strict `<` the face would
// not have replaced the running minimum.  tests/test_torch_cull.py holds
// the test's plain mirror against tri_sq_dist's on random and degenerate
// faces (hypothesis), and chip_smoke.py holds this kernel bit-equal to
// the sweep over every face, which has no rejection.
//
// A warp evaluates a face's distance when any of its lanes keeps it (the
// 32 points of a warp are neighbours in a tile and mostly agree); a lane
// that could have skipped it computes a distance that cannot win.

// EARLY (VANERF_CULL_EARLY) is a template parameter: the default walk's
// instantiation carries none of the early walk's code (with both in one
// body, selected at run time, the default walk ran ~20% slower on the
// H100).
template <bool SOA, int TP, int CH, bool EARLY>
__global__ void __launch_bounds__(TP) mesh_query_culled_kernel(
    const float* __restrict__ pts, int N, const float* __restrict__ faces,
    const float4* __restrict__ sph, int F, int Bm, long long fstride,
    const float* __restrict__ cbox, int C, const float* __restrict__ ub,
    float far2, TileGeom geom, float* __restrict__ d2o,
    int* __restrict__ idxo, float* __restrict__ windo,
    float* __restrict__ qviso, unsigned char* __restrict__ faro,
    int* __restrict__ visits) {
  constexpr int WARPS = TP / 32;
  // the batch element: its points, bounds and outputs, and its mesh (every
  // element, 0 included: skipping element 0 behind a branch cost this
  // kernel 13% at B = 1 on the H100, where the remainder costs nothing
  // beside a tile's search)
  {
    const size_t e = blockIdx.y, n = static_cast<size_t>(N);
    const size_t m = e % static_cast<size_t>(Bm);
    pts += e * 3 * n;
    ub += e * n;
    d2o += e * n;
    idxo += e * n;
    windo += e * n;
    qviso += e * n;
    if (faro != nullptr) faro += e * n;
    if (visits != nullptr) visits += e * 2 * gridDim.x;
    faces += m * static_cast<size_t>(fstride);
    sph += m * static_cast<size_t>(F);
    cbox += m * 6 * static_cast<size_t>(C);
  }
  // two staging buffers of a chunk's rows and spheres, each filled by one
  // pair of bulk copies on its own mbarrier while the other is searched
  __shared__ __align__(128) float sf[2][CH * MQ_STRIDE];
  __shared__ __align__(16) float4 ssph[2][CH];
  __shared__ __align__(8) unsigned long long bar[2];
  __shared__ float red[WARPS][8];
  __shared__ unsigned ballots[2][3];
  __shared__ float slb[MQ_MAX_CHUNKS];
  __shared__ int sorder[MQ_MAX_CHUNKS];
  __shared__ float wmax[2][WARPS];
  const int j = blockIdx.x * TP + threadIdx.x;
  const bool valid = j < N;
  // a ragged last tile repeats its last real point: the box, the bounds and
  // the early walk's largest best d2 are those of the real points
  const int i = tile_point(min(j, N - 1), geom);
  const float px = SOA ? pts[i] : pts[3 * i];
  const float py = SOA ? pts[(size_t)N + i] : pts[3 * i + 1];
  const float pz = SOA ? pts[2 * (size_t)N + i] : pts[3 * i + 2];
  const float ubi = ub[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    bar_init(&bar[0]);
    bar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // 1. the tile's box, largest and least bound
  float r[8] = {px, py, pz, px, py, pz, ubi, ubi};
  for (int o = 16; o > 0; o >>= 1) {
    for (int k = 0; k < 3; ++k) {
      r[k] = fminf(r[k], __shfl_xor_sync(0xffffffffu, r[k], o));
      r[3 + k] = fmaxf(r[3 + k], __shfl_xor_sync(0xffffffffu, r[3 + k], o));
    }
    r[6] = fmaxf(r[6], __shfl_xor_sync(0xffffffffu, r[6], o));
    r[7] = fminf(r[7], __shfl_xor_sync(0xffffffffu, r[7], o));
  }
  if (lane == 0)
    for (int k = 0; k < 8; ++k) red[warp][k] = r[k];
  __syncthreads();
  float tmin[3], tmax[3];
  for (int k = 0; k < 3; ++k) {
    tmin[k] = red[0][k];
    tmax[k] = red[0][3 + k];
  }
  float ub_t = red[0][6], ub_lo = red[0][7];
  for (int w = 1; w < WARPS; ++w) {
    for (int k = 0; k < 3; ++k) {
      tmin[k] = fminf(tmin[k], red[w][k]);
      tmax[k] = fmaxf(tmax[k], red[w][3 + k]);
    }
    ub_t = fmaxf(ub_t, red[w][6]);
    ub_lo = fminf(ub_lo, red[w][7]);
  }
  // 2. the far tier, for the whole tile
  const bool is_far = far2 >= 0.0f && ub_lo > far2;

  // 3. one chunk box a thread: distance need, winding need along +d and -d
  if (threadIdx.x < MQ_MAX_CHUNKS) {
    const int c = threadIdx.x;
    bool nd = false, wp = false, wn = false;
    if (c < C) {
      const float* b = cbox + 6 * c;
      const float d0 = 0.5773502691896258f, d1 = 0.7071067811865476f,
                  d2 = 0.40824829046386296f;
      float gap[3], tcen[3], text[3], ccen[3], cext[3];
      bool half_p = true, half_n = true;
      for (int k = 0; k < 3; ++k) {
        gap[k] = fmaxf(fmaxf(b[k] - tmax[k], tmin[k] - b[3 + k]), 0.0f);
        tcen[k] = 0.5f * (tmin[k] + tmax[k]);
        text[k] = 0.5f * (tmax[k] - tmin[k]);
        ccen[k] = 0.5f * (b[k] + b[3 + k]);
        cext[k] = 0.5f * (b[3 + k] - b[k]);
        half_p = half_p && b[3 + k] >= tmin[k];
        half_n = half_n && b[k] <= tmax[k];
      }
      const float lb = gap[0] * gap[0] + gap[1] * gap[1] + gap[2] * gap[2];
      nd = !is_far &&
           lb <= ub_t * static_cast<float>(1.0 + 1e-5) + 1e-12f;
      slb[c] = lb;
      // the three axes d x e_k: (0, d2, -d1), (-d2, 0, d0), (d1, -d0, 0)
      const float tp0 = tcen[1] * d2 - tcen[2] * d1;
      const float tp1 = tcen[2] * d0 - tcen[0] * d2;
      const float tp2 = tcen[0] * d1 - tcen[1] * d0;
      const float cp0 = ccen[1] * d2 - ccen[2] * d1;
      const float cp1 = ccen[2] * d0 - ccen[0] * d2;
      const float cp2 = ccen[0] * d1 - ccen[1] * d0;
      const float tr0 = text[1] * d2 + text[2] * d1;
      const float tr1 = text[2] * d0 + text[0] * d2;
      const float tr2 = text[0] * d1 + text[1] * d0;
      const float cr0 = cext[1] * d2 + cext[2] * d1;
      const float cr1 = cext[2] * d0 + cext[0] * d2;
      const float cr2 = cext[0] * d1 + cext[1] * d0;
      const bool cross_ok = fabsf(tp0 - cp0) <= tr0 + cr0 + 1e-7f &&
                            fabsf(tp1 - cp1) <= tr1 + cr1 + 1e-7f &&
                            fabsf(tp2 - cp2) <= tr2 + cr2 + 1e-7f;
      const float t_al = tcen[0] * d0 + tcen[1] * d1 + tcen[2] * d2;
      const float c_al = ccen[0] * d0 + ccen[1] * d1 + ccen[2] * d2;
      const float t_ex = text[0] * d0 + text[1] * d1 + text[2] * d2;
      const float c_ex = cext[0] * d0 + cext[1] * d1 + cext[2] * d2;
      wp = half_p && (c_al + c_ex >= t_al - t_ex) && cross_ok;
      wn = half_n && (-c_al + c_ex >= -t_al - t_ex) && cross_ok;
    }
    const unsigned bd = __ballot_sync(0xffffffffu, nd);
    const unsigned bp = __ballot_sync(0xffffffffu, wp);
    const unsigned bn = __ballot_sync(0xffffffffu, wn);
    if (lane == 0) {
      ballots[warp][0] = bd;
      ballots[warp][1] = bp;
      ballots[warp][2] = bn;
    }
  }
  __syncthreads();
  typedef unsigned long long u64;
  const u64 md = (u64)ballots[0][0] | ((u64)ballots[1][0] << 32);
  const u64 mp = (u64)ballots[0][1] | ((u64)ballots[1][1] << 32);
  const u64 mn = (u64)ballots[0][2] | ((u64)ballots[1][2] << 32);
  const bool use_neg = __popcll(mn) < __popcll(mp);
  const u64 mw = use_neg ? mn : mp;
  const float s = use_neg ? -1.0f : 1.0f;
  const int nd = __popcll(md);
  if (threadIdx.x == 0 && visits != nullptr) {
    visits[2 * blockIdx.x] = nd;
    visits[2 * blockIdx.x + 1] = __popcll(mw);
  }
  // the early walk's order: the distance chunks ranked by (lb, id), the
  // stable ascending sort of ops/mesh_query.py::early_walk_lists
  if (EARLY) {
    const int c = threadIdx.x;
    if (c < C && ((md >> c) & 1ull)) {
      const float lc = slb[c];
      int rank = 0;
      for (int k = 0; k < C; ++k)
        rank += ((md >> k) & 1ull) && (slb[k] < lc || (slb[k] == lc && k < c));
      sorder[rank] = c;
    }
    __syncthreads();
  }

  // 4. the walk: chunk q of the walk sits in buffer q & 1, the (q >> 1)-th
  // fill of that buffer; thread 0 issues fill q + 2 once every thread has
  // left chunk q (the barrier at the end of a chunk)
  float best = INFINITY, sb = INFINITY;
  int bidx = 0;
  float wind = 0.0f;
  auto issue = [&](int q, int c) {
    const int f0 = c * CH;
    const int nf = min(CH, F - f0);
    // an odd count's last row ends 8 bytes before a 16-byte boundary: the
    // copy takes the padding row behind the table with it
    const unsigned fb = (static_cast<unsigned>(nf * MQ_STRIDE * 4) + 15u) & ~15u;
    const unsigned sbytes = static_cast<unsigned>(nf) * 16u;
    bar_expect(&bar[q & 1], fb + sbytes);
    bulk_load(sf[q & 1], faces + (size_t)f0 * MQ_STRIDE, fb, &bar[q & 1]);
    bulk_load(ssph[q & 1], sph + f0, sbytes, &bar[q & 1]);
  };
  auto search = [&](int q, int c, bool dist, bool cross) {
    bar_wait(&bar[q & 1], (q >> 1) & 1);
    const float* buf = sf[q & 1];
    const float4* sp = ssph[q & 1];
    const int f0 = c * CH;
    const int nf = min(CH, F - f0);
    if (dist) {
      for (int jf = 0; jf < nf; ++jf) {
        const float4 sfc = sp[jf];
        const float dx = px - sfc.x, dy = py - sfc.y, dz = pz - sfc.z;
        const float e = dx * dx + dy * dy + dz * dz;
        const float t = sfc.w + sb;
        if (__any_sync(0xffffffffu, !(e > t * t))) {
          const float d = tri_sq_dist(px, py, pz, buf + MQ_STRIDE * jf);
          if (d < best) {
            best = d;
            bidx = f0 + jf;
            sb = sqrtf(best) * 1.0001f;
          }
        }
      }
    }
    if (cross) {
      for (int jf = 0; jf < nf; ++jf)
        wind += crossing_s(px, py, pz, buf + MQ_STRIDE * jf, s);
    }
  };
  // One loop, one search: while `walking` (the early walk) the chunks come
  // from `sorder` while lb <= the tile's largest best d2 so far (no
  // tolerance, _kernel_vis_ray_culled's while loop), a chunk that is also
  // a winding chunk counted from the same staging; then (or by default
  // from the start) the unsearched chunks of md | mw in ascending order.
  // Every flag below is the same in all threads of the block.
  int q = 0, issued = 0, k = 0;
  bool walking = EARLY && nd > 0;
  float ub_run = INFINITY;
  u64 rest = md | mw;  // chunks not searched yet
  u64 pre = 0ull;      // chunks of `rest` not issued yet (ascending part)
  auto refill = [&]() {
    if (walking) {
      if (issued < nd) {
        if (threadIdx.x == 0) issue(issued, sorder[issued]);
        ++issued;
      }
    } else if (pre != 0ull) {
      if (threadIdx.x == 0)
        issue(issued, __ffsll(static_cast<long long>(pre)) - 1);
      pre &= pre - 1ull;
      ++issued;
    }
  };
  if (!walking) pre = rest;
  refill();
  refill();
  while (true) {
    int c;
    if (walking) {
      if (k == nd || !(slb[sorder[k]] <= ub_run)) {
        // the walk stopped: wait out the fills already issued, then the
        // winding chunks it did not stage
        for (; q < issued; ++q) bar_wait(&bar[q & 1], (q >> 1) & 1);
        __syncthreads();
        walking = false;
        rest &= mw;
        pre = rest;
        refill();
        refill();
        continue;
      }
      c = sorder[k];
    } else {
      if (rest == 0ull) break;
      c = __ffsll(static_cast<long long>(rest)) - 1;
    }
    rest &= ~(1ull << c);
    // by default a chunk of md | mw runs the distance and winding tests
    // from one staging (the winding sum, a sum of +-1, does not depend on
    // the order in which the chunks come)
    search(q, c, walking || (!EARLY && ((md >> c) & 1ull)),
           (mw >> c) & 1ull);
    if (walking) {
      float m = best;
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) wmax[k & 1][warp] = m;
    }
    __syncthreads();
    ++q;
    refill();
    if (walking) {
      ub_run = wmax[k & 1][0];
      for (int w = 1; w < WARPS; ++w) ub_run = fmaxf(ub_run, wmax[k & 1][w]);
      ++k;
    }
  }
  if (!valid) return;
  windo[i] = wind;
  if (faro != nullptr) faro[i] = is_far ? 1 : 0;
  if (is_far) {
    d2o[i] = ubi;
    idxo[i] = 0;
    qviso[i] = 0.0f;
  } else {
    d2o[i] = best;
    idxo[i] = bidx;
    qviso[i] =
        best < INFINITY ? face_vis(px, py, pz, faces + MQ_STRIDE * bidx) : 0.0f;
  }
}

// The arguments of one launch of the culled kernel.
struct CulledArgs {
  const float* pts;
  int N;
  int B;
  const float* faces;
  const float4* sph;
  int F;
  int Bm;
  long long fstride;
  const float* cbox;
  int C;
  const float* ub;
  float far2;
  TileGeom g;
  float* d2;
  int* idx;
  float* wind;
  float* qvis;
  unsigned char* far;
  int* visits;
};

template <bool SOA, int TP, int CH, bool EARLY>
static void culled_launch(const CulledArgs& a, cudaStream_t st) {
  const dim3 grid(vt_blocks(a.N, TP), a.B);
  mesh_query_culled_kernel<SOA, TP, CH, EARLY><<<grid, TP, 0, st>>>(
      a.pts, a.N, a.faces, a.sph, a.F, a.Bm, a.fstride, a.cbox, a.C, a.ub,
      a.far2, a.g, a.d2, a.idx, a.wind, a.qvis, a.far, a.visits);
}

template <bool SOA>
static int mesh_query_culled_launch(const float* pts, int N, int B,
                                    const float* faces, const float* sph,
                                    int F, int Bm, long long fstride,
                                    const float* cbox, int C,
                                    const float* ub, float far2,
                                    const int* geom, int tile_p, int chunk,
                                    int early, float* d2, int* idx,
                                    float* wind, float* qvis,
                                    unsigned char* far, int* visits,
                                    void* stream) {
  // the instantiations: tile 64 / 128 / 256 x chunk 64 / 128 x the walk
  typedef void (*Launch)(const CulledArgs&, cudaStream_t);
#define MQ_WALKS(TP, CH) \
  { culled_launch<SOA, TP, CH, false>, culled_launch<SOA, TP, CH, true> }
  static const Launch launches[3][2][2] = {
      {MQ_WALKS(64, 64), MQ_WALKS(64, 128)},
      {MQ_WALKS(128, 64), MQ_WALKS(128, 128)},
      {MQ_WALKS(256, 64), MQ_WALKS(256, 128)}};
#undef MQ_WALKS
  const int ti = tile_p == 64 ? 0 : tile_p == 128 ? 1 : tile_p == 256 ? 2 : -1;
  const int ci = chunk == 64 ? 0 : chunk == 128 ? 1 : -1;
  if (ti < 0 || ci < 0 || C > MQ_MAX_CHUNKS ||
      C != (F + chunk - 1) / chunk || B <= 0 || B > 65535 || Bm <= 0 ||
      fstride % 4 != 0 || fstride < static_cast<long long>(F) * MQ_STRIDE ||
      (reinterpret_cast<size_t>(faces) | reinterpret_cast<size_t>(sph)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  const TileGeom g = {geom[0], geom[1], geom[2], geom[3], geom[4], geom[5]};
  if (g.sb != 0 &&
      (g.bh <= 0 || g.bw <= 0 || g.sb < 0 || g.H % g.bh || g.W % g.bw ||
       g.S % g.sb || (long long)g.H * g.W * g.S != N))
    return static_cast<int>(cudaErrorInvalidValue);
  const CulledArgs a = {pts, N, B, faces,
                        reinterpret_cast<const float4*>(sph), F, Bm, fstride,
                        cbox, C, ub, far2, g, d2, idx, wind, qvis, far,
                        visits};
  launches[ti][ci][early != 0](a, vt_stream(stream));
  return static_cast<int>(cudaGetLastError());
}

// Kernel A, culled: `pts` (B, N, 3) centred and ray-major; `faces` Bm
// tables of (F, 22) rows, `fstride` floats apart (a multiple of 4),
// Morton-sorted, 16-byte aligned, each with a padding row behind it when the
// last chunk holds an odd number of faces; `sph` (Bm, F, 4) face spheres,
// 16-byte aligned; `cbox` (Bm, C, 6) chunk boxes of `chunk` (64 or 128)
// faces; element e reads mesh e % Bm; `ub` and the outputs (B, N); `far2` < 0
// switches the far tier off; `geom` six host ints (H, W, S, bh, bw, sb), sb
// = 0 for consecutive tiles; `tile_p` points a tile (64, 128 or 256);
// `early` != 0 walks the distance chunks by ascending lower bound and stops
// early; `far` (B, N) and `visits` (B, T, 2) may be null.
VT_EXPORT int vt_mesh_query_culled(const float* pts, int N, int B,
                                   const float* faces, const float* sph,
                                   int F, int Bm, long long fstride,
                                   const float* cbox, int C,
                                   const float* ub, float far2,
                                   const int* geom, int tile_p, int chunk,
                                   int early, float* d2, int* idx,
                                   float* wind, float* qvis,
                                   unsigned char* far, int* visits,
                                   void* stream) {
  return mesh_query_culled_launch<false>(pts, N, B, faces, sph, F, Bm,
                                         fstride, cbox, C, ub, far2, geom,
                                         tile_p, chunk, early, d2, idx, wind,
                                         qvis, far, visits, stream);
}

// Kernel 7, culled: `pts` is (B, 3, N) contiguous.
VT_EXPORT int vt_mesh_query_culled_T(const float* pts, int N, int B,
                                     const float* faces, const float* sph,
                                     int F, int Bm, long long fstride,
                                     const float* cbox, int C,
                                     const float* ub, float far2,
                                     const int* geom, int tile_p, int chunk,
                                     int early, float* d2, int* idx,
                                     float* wind, float* qvis,
                                     unsigned char* far, int* visits,
                                     void* stream) {
  return mesh_query_culled_launch<true>(pts, N, B, faces, sph, F, Bm,
                                        fstride, cbox, C, ub, far2, geom,
                                        tile_p, chunk, early, d2, idx, wind,
                                        qvis, far, visits, stream);
}
