// Kernels B, 8 and 9 — exact nearest vertex per query point (index + squared
// distance): the sweep over every vertex (B, 8) and the landmark-culled
// search (9, at the end of this file).
//
// B replaces the TPU kernel vanerf_tpu/ops/knn_pallas.py::nearest_vertex_d2_pallas
// (body `_kernel`), which sweeps a (256-point x all-vertex) tile in VMEM.
// 8 replaces nearest_vertex_d2_pallas_T (body `_kernel_T`): the same search
// on coordinate-major (3, N) queries.  One kernel body, the point loads a
// template parameter: 8 equals B bit for bit on the transposed input, and a
// warp's three loads are coalesced instead of strided by 3.
//
// Bound on the H100: arithmetic.  Per (point, vertex) pair it does 3 subs,
// 3 muls, 2 adds and a compare: 262,144 points x 1,284 vertices is ~3.4e8
// pairs, ~3 GFLOP; the bytes (3.1 MB of points in, 2 MB out) are
// negligible.  Under -fmad=false each of those is its own instruction, and
// the running minimum adds a select for the index, so the issue rate, not
// the f32 peak, is the ceiling.
// Design: the whole vertex table (V x 3 f32, 15 KB for the two-hand
// fixture, 48 KB at KNN_MAX_VERTS, the dynamic shared memory a block gets
// without cudaFuncSetAttribute) is staged once per block into shared
// memory in its packed 12-byte layout.  A thread owns KNN_PPT points
// (consecutive threads, consecutive points: the loads coalesce), and every
// vertex it reads serves all of them; four vertices arrive in three
// 16-byte broadcast loads (every lane of a warp reads the same address),
// and the index of the running minimum is kept per group of 8 vertices
// (see the loop).
// The running minimum uses strict `<` in ascending vertex order, so ties
// go to the lowest index like jnp.argmin / torch.argmin.  The squared
// distance is dx*dx + dy*dy + dz*dz in that order: it is the exact
// distance to a mesh vertex, hence a certified upper bound on the
// point-to-mesh distance (kernel A's far rule relies on that), and it
// equals the plain version's bit for bit.

#include "common.cuh"

#define KNN_THREADS 128
#define KNN_PPT 4       // points a thread
#define KNN_MAX_VERTS 4096  // 48 KB: the dynamic shared memory a block gets
                            // without cudaFuncSetAttribute

template <bool SOA>
__global__ void __launch_bounds__(KNN_THREADS) knn_kernel(
    const float* __restrict__ pts, int N, const float* __restrict__ verts,
    int V, int* __restrict__ idx, float* __restrict__ d2) {
  extern __shared__ __align__(16) float sv[];
  for (int k = threadIdx.x; k < 3 * V; k += KNN_THREADS) sv[k] = verts[k];
  __syncthreads();
  const int i0 = blockIdx.x * (KNN_THREADS * KNN_PPT) + threadIdx.x;
  float px[KNN_PPT], py[KNN_PPT], pz[KNN_PPT], best[KNN_PPT];
  int bi[KNN_PPT];
#pragma unroll
  for (int q = 0; q < KNN_PPT; ++q) {
    const int i = min(i0 + q * KNN_THREADS, N - 1);
    px[q] = SOA ? pts[i] : pts[3 * i];
    py[q] = SOA ? pts[(size_t)N + i] : pts[3 * i + 1];
    pz[q] = SOA ? pts[2 * (size_t)N + i] : pts[3 * i + 2];
    best[q] = INFINITY;
    bi[q] = 0;
  }
  // Groups of 8 vertices, 24 floats in six float4 loads (group g starts
  // 96g bytes into the table, so the loads are aligned).  A point keeps the
  // smallest distance and the first group that reached it: per group 7
  // minima, a compare and two selects for 8 pairs, in place of a compare
  // and two selects a pair.  The minimum of a group replaces the best only
  // when strictly smaller, so the group is the first holding the overall
  // minimum; the index inside it is found at the end from the same
  // expressions (the first of the 8 equal to the minimum), which is what
  // a strict `<` walk in ascending order picks.
  const float4* s4 = reinterpret_cast<const float4*>(sv);
  const int G = V / 8;
  int bg[KNN_PPT];
#pragma unroll
  for (int q = 0; q < KNN_PPT; ++q) bg[q] = -1;
#pragma unroll 2
  for (int g = 0; g < G; ++g, s4 += 6) {
    float vx[8], vy[8], vz[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = s4[3 * h], b = s4[3 * h + 1], e = s4[3 * h + 2];
      vx[4 * h] = a.x; vy[4 * h] = a.y; vz[4 * h] = a.z;
      vx[4 * h + 1] = a.w; vy[4 * h + 1] = b.x; vz[4 * h + 1] = b.y;
      vx[4 * h + 2] = b.z; vy[4 * h + 2] = b.w; vz[4 * h + 2] = e.x;
      vx[4 * h + 3] = e.y; vy[4 * h + 3] = e.z; vz[4 * h + 3] = e.w;
    }
#pragma unroll
    for (int q = 0; q < KNN_PPT; ++q) {
      float d[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float dx = px[q] - vx[u];
        const float dy = py[q] - vy[u];
        const float dz = pz[q] - vz[u];
        d[u] = dx * dx + dy * dy + dz * dz;
      }
      const float m = fminf(fminf(fminf(d[0], d[1]), fminf(d[2], d[3])),
                            fminf(fminf(d[4], d[5]), fminf(d[6], d[7])));
      if (m < best[q]) {
        best[q] = m;
        bg[q] = g;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < KNN_PPT; ++q) {
    if (bg[q] < 0) continue;
    const float* t = sv + 24 * bg[q];
    int u = 0;
    for (; u < 7; ++u) {
      const float dx = px[q] - t[3 * u];
      const float dy = py[q] - t[3 * u + 1];
      const float dz = pz[q] - t[3 * u + 2];
      if (dx * dx + dy * dy + dz * dz == best[q]) break;
    }
    bi[q] = 8 * bg[q] + u;
  }
  for (int j = 8 * G; j < V; ++j) {
    const float x = sv[3 * j], y = sv[3 * j + 1], z = sv[3 * j + 2];
#pragma unroll
    for (int q = 0; q < KNN_PPT; ++q) {
      const float dx = px[q] - x;
      const float dy = py[q] - y;
      const float dz = pz[q] - z;
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < best[q]) {
        best[q] = d;
        bi[q] = j;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < KNN_PPT; ++q) {
    const int i = i0 + q * KNN_THREADS;
    if (i < N) {
      idx[i] = bi[q];
      d2[i] = best[q];
    }
  }
}

template <bool SOA>
static int knn_launch(const float* pts, int N, const float* verts, int V,
                      int* idx, float* d2, void* stream) {
  if (V <= 0 || V > KNN_MAX_VERTS) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(V);
  knn_kernel<SOA><<<vt_blocks(N, KNN_THREADS * KNN_PPT), KNN_THREADS, smem,
                    vt_stream(stream)>>>(pts, N, verts, V, idx, d2);
  return static_cast<int>(cudaGetLastError());
}

VT_EXPORT int vt_knn(const float* pts, int N, const float* verts, int V,
                     int* idx, float* d2, void* stream) {
  return knn_launch<false>(pts, N, verts, V, idx, d2, stream);
}

// Kernel 8: `pts` is (3, N) contiguous.
VT_EXPORT int vt_knn_T(const float* pts, int N, const float* verts, int V,
                       int* idx, float* d2, void* stream) {
  return knn_launch<true>(pts, N, verts, V, idx, d2, stream);
}

// ---------------------------------------------------------------------------
// Kernel 9 — the landmark-culled search.
//
// Replaces vanerf_tpu/ops/knn_pallas.py::_culled_common (body
// `_kernel_culled`, host lists `_knn_cull_lists`), behind
// nearest_vertex_d2_pallas_culled and nearest_vertex_d2_pallas_T_culled.  The
// TPU version builds compacted per-tile chunk lists on the host and ships
// them through scalar memory; here a block IS a tile and decides for itself.
//
// A block of 256 threads owns 256 consecutive points.  It stages the vertex
// table as B does, reduces the tile's box with warp shuffles (a ragged last
// tile takes its last real point for the missing ones, which leaves the box
// unchanged), and the first C lanes of warp 0 (C <= 32 chunks of 128
// vertices at the 4,096-vertex limit) each test one chunk box, (C, 10) rows
// [min | max | centre | half diagonal] that a small kernel in front of the
// search makes once per call:
//   ub_t = (min_c |farthest tile-box corner - centre_c| + radius_c)^2 bounds
//          every tile point's nearest-vertex distance from above,
//   lb_c = the box-to-box gap bounds the distance to chunk c from below,
// and chunk c is visited when lb_c <= ub_t * (1 + 1e-5) + 1e-12.  A ballot
// publishes the visited set as one 32-bit mask in shared memory, and every
// thread walks its set bits in ascending order with B's arithmetic and
// strict `<`, so idx and d2 equal B's bit for bit: the tolerance keeps every
// chunk that can hold the minimum or tie with it.  No list goes through
// device memory and the host never waits.  The expressions of the test are
// those of ops/knn.py::knn_cull_lists in their written order (sqrtf rounds
// to nearest, -fmad=false), so the mask equals the plain version's.
//
// Bound: arithmetic, as B, over the visited pairs only.  How many pairs are
// skipped depends on the caller's tiles: 256 consecutive ray-major points
// are 4 rays x 64 samples, long thin boxes that cull little; tiles compact
// in all three dimensions cull more.

#define KNC_TILE 256
#define KNC_CHUNK 128
#define KNC_WARPS (KNC_TILE / 32)

// (at most 32 registers a thread: 8 blocks then fit an SM, as with B, and the
// 1,024 blocks of a 262,144-point pass are resident at once)
template <bool SOA>
__global__ void __launch_bounds__(KNC_TILE, 8) knn_culled_kernel(const float* __restrict__ pts, int N,
                                  const float* __restrict__ verts, int V,
                                  const float* __restrict__ boxes, int C,
                                  int* __restrict__ idx,
                                  float* __restrict__ d2,
                                  int* __restrict__ visits) {
  extern __shared__ __align__(16) float svc[];
  __shared__ float red[KNC_WARPS][6];
  __shared__ unsigned smask;
  for (int k = threadIdx.x; k < 3 * V; k += blockDim.x) svc[k] = verts[k];
  const int i = blockIdx.x * KNC_TILE + threadIdx.x;
  const int ic = min(i, N - 1);
  const float px = SOA ? pts[ic] : pts[3 * ic];
  const float py = SOA ? pts[(size_t)N + ic] : pts[3 * ic + 1];
  const float pz = SOA ? pts[2 * (size_t)N + ic] : pts[3 * ic + 2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float lo_x = px, lo_y = py, lo_z = pz, hi_x = px, hi_y = py, hi_z = pz;
  for (int o = 16; o > 0; o >>= 1) {
    lo_x = fminf(lo_x, __shfl_xor_sync(0xffffffffu, lo_x, o));
    lo_y = fminf(lo_y, __shfl_xor_sync(0xffffffffu, lo_y, o));
    lo_z = fminf(lo_z, __shfl_xor_sync(0xffffffffu, lo_z, o));
    hi_x = fmaxf(hi_x, __shfl_xor_sync(0xffffffffu, hi_x, o));
    hi_y = fmaxf(hi_y, __shfl_xor_sync(0xffffffffu, hi_y, o));
    hi_z = fmaxf(hi_z, __shfl_xor_sync(0xffffffffu, hi_z, o));
  }
  if (lane == 0) {
    red[warp][0] = lo_x; red[warp][1] = lo_y; red[warp][2] = lo_z;
    red[warp][3] = hi_x; red[warp][4] = hi_y; red[warp][5] = hi_z;
  }
  __syncthreads();
  if (warp == 0) {
    float tmin[3], tmax[3];
    for (int k = 0; k < 3; ++k) {
      tmin[k] = red[0][k];
      tmax[k] = red[0][3 + k];
      for (int w = 1; w < KNC_WARPS; ++w) {
        tmin[k] = fminf(tmin[k], red[w][k]);
        tmax[k] = fmaxf(tmax[k], red[w][3 + k]);
      }
    }
    float fard = INFINITY, lb = INFINITY;
    if (lane < C) {
      const float* b = boxes + 10 * lane;
      const float fx = fmaxf(fabsf(b[6] - tmin[0]), fabsf(b[6] - tmax[0]));
      const float fy = fmaxf(fabsf(b[7] - tmin[1]), fabsf(b[7] - tmax[1]));
      const float fz = fmaxf(fabsf(b[8] - tmin[2]), fabsf(b[8] - tmax[2]));
      fard = sqrtf(fx * fx + fy * fy + fz * fz) + b[9];
      const float gx = fmaxf(fmaxf(b[0] - tmax[0], tmin[0] - b[3]), 0.0f);
      const float gy = fmaxf(fmaxf(b[1] - tmax[1], tmin[1] - b[4]), 0.0f);
      const float gz = fmaxf(fmaxf(b[2] - tmax[2], tmin[2] - b[5]), 0.0f);
      lb = gx * gx + gy * gy + gz * gz;
    }
    float m = fard;
    for (int o = 16; o > 0; o >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float ub = m * m;
    const bool need =
        lane < C && lb <= ub * static_cast<float>(1.0 + 1e-5) + 1e-12f;
    const unsigned mask = __ballot_sync(0xffffffffu, need);
    if (lane == 0) {
      smask = mask;
      if (visits != nullptr) visits[blockIdx.x] = __popc(mask);
    }
  }
  __syncthreads();
  if (i >= N) return;
  unsigned mask = smask;
  float best = INFINITY;
  int bi = 0;
  while (mask != 0u) {
    const int c = __ffs(mask) - 1;
    mask &= mask - 1u;
    const int j0 = c * KNC_CHUNK;
    if (V - j0 >= KNC_CHUNK) {
      // a whole chunk: 128 vertices are 96 float4s, four vertices in three
      // 16-byte loads (a chunk starts 1,536 bytes into the table, so the
      // loads are aligned; through a float pointer nvcc cannot tell)
      const float4* s4 = reinterpret_cast<const float4*>(svc) + 96 * c;
#pragma unroll 4
      for (int k = 0; k < KNC_CHUNK / 4; ++k) {
        const float4 a = s4[3 * k], b = s4[3 * k + 1], e = s4[3 * k + 2];
        const float vx[4] = {a.x, a.w, b.z, e.y};
        const float vy[4] = {a.y, b.x, b.w, e.z};
        const float vz[4] = {a.z, b.y, e.x, e.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float dx = px - vx[u];
          const float dy = py - vy[u];
          const float dz = pz - vz[u];
          const float d = dx * dx + dy * dy + dz * dz;
          if (d < best) {
            best = d;
            bi = j0 + 4 * k + u;
          }
        }
      }
    } else {
      for (int j = j0; j < V; ++j) {
        const float dx = px - svc[3 * j];
        const float dy = py - svc[3 * j + 1];
        const float dz = pz - svc[3 * j + 2];
        const float d = dx * dx + dy * dy + dz * dz;
        if (d < best) {
          best = d;
          bi = j;
        }
      }
    }
  }
  idx[i] = bi;
  d2[i] = best;
}

// Per chunk of 128 vertices the row [min | max | centre | half diagonal] of
// its box (ops/knn.py::vertex_chunk_boxes, the same expressions): one block
// a chunk, a short last chunk repeating its last vertex.  One launch in
// front of the search instead of a dozen small tensor ops on the host.
__global__ void knn_chunk_boxes_kernel(const float* __restrict__ verts, int V,
                                       float* __restrict__ boxes) {
  __shared__ float red[KNC_CHUNK / 32][6];
  const int j = min(blockIdx.x * KNC_CHUNK + threadIdx.x, V - 1);
  float r[6] = {verts[3 * j],     verts[3 * j + 1], verts[3 * j + 2],
                verts[3 * j],     verts[3 * j + 1], verts[3 * j + 2]};
  for (int o = 16; o > 0; o >>= 1)
    for (int k = 0; k < 3; ++k) {
      r[k] = fminf(r[k], __shfl_xor_sync(0xffffffffu, r[k], o));
      r[3 + k] = fmaxf(r[3 + k], __shfl_xor_sync(0xffffffffu, r[3 + k], o));
    }
  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < 6; ++k) red[threadIdx.x >> 5][k] = r[k];
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < KNC_CHUNK / 32; ++w)
    for (int k = 0; k < 3; ++k) {
      r[k] = fminf(r[k], red[w][k]);
      r[3 + k] = fmaxf(r[3 + k], red[w][3 + k]);
    }
  float* b = boxes + 10 * blockIdx.x;
  for (int k = 0; k < 3; ++k) {
    b[k] = r[k];
    b[3 + k] = r[3 + k];
    b[6 + k] = 0.5f * (r[k] + r[3 + k]);
  }
  const float ex = r[3] - r[0], ey = r[4] - r[1], ez = r[5] - r[2];
  b[9] = 0.5f * sqrtf(ex * ex + ey * ey + ez * ez);
}

template <bool SOA>
static int knn_culled_launch(const float* pts, int N, const float* verts,
                             int V, float* boxes, int C, int* idx,
                             float* d2, int* visits, void* stream) {
  if (V <= 0 || V > KNN_MAX_VERTS || C != (V + KNC_CHUNK - 1) / KNC_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  knn_chunk_boxes_kernel<<<C, KNC_CHUNK, 0, vt_stream(stream)>>>(verts, V,
                                                                 boxes);
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(V);
  // the table's 48 KB at KNN_MAX_VERTS and the kernel's own shared arrays
  // exceed the 48 KB a block gets by default; the limit is the current
  // device's, so it is raised on every launch
  const cudaError_t raised = cudaFuncSetAttribute(
      knn_culled_kernel<SOA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * 3 * KNN_MAX_VERTS));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  knn_culled_kernel<SOA><<<vt_blocks(N, KNC_TILE), KNC_TILE, smem,
                           vt_stream(stream)>>>(pts, N, verts, V, boxes, C,
                                                idx, d2, visits);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 9: `pts` is (N, 3); `boxes` (C, 10) scratch that the entry point
// fills with the chunk boxes; `visits` (ceil(N / 256),) or null.
VT_EXPORT int vt_knn_culled(const float* pts, int N, const float* verts,
                            int V, float* boxes, int C, int* idx,
                            float* d2, int* visits, void* stream) {
  return knn_culled_launch<false>(pts, N, verts, V, boxes, C, idx, d2, visits,
                                  stream);
}

// Kernel 9 on (3, N) contiguous `pts`.
VT_EXPORT int vt_knn_T_culled(const float* pts, int N, const float* verts,
                              int V, float* boxes, int C, int* idx,
                              float* d2, int* visits, void* stream) {
  return knn_culled_launch<true>(pts, N, verts, V, boxes, C, idx, d2, visits,
                                 stream);
}
