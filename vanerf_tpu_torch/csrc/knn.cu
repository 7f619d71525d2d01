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
// (`load_group8` / `group8_min`, the step kernel 9 shares).
// The running minimum uses strict `<` in ascending vertex order, so ties
// go to the lowest index like jnp.argmin / torch.argmin.  The squared
// distance is dx*dx + dy*dy + dz*dz in that order: it is the exact
// distance to a mesh vertex, hence a certified upper bound on the
// point-to-mesh distance (kernel A's far rule relies on that), and it
// equals the plain version's bit for bit.
// A launch takes a batch: element e of B (blockIdx.y) searches its own
// (N, 3) or (3, N) points against vertex set e % Bv of a (Bv, V, 3) stack,
// the JAX package's vmap over the batch written as a grid dimension (the
// G tiles of one frame in a tile group share the frame's vertices).  An
// element's arithmetic does not depend on the batch, so each equals its
// own launch at B = 1 bit for bit; the offsets are 64-bit.

#include "common.cuh"

#define KNN_THREADS 128
#define KNN_PPT 4       // points a thread
#define KNN_MAX_VERTS 4096  // 48 KB: the dynamic shared memory a block gets
                            // without cudaFuncSetAttribute

// The search's inner step, shared by B / 8 and 9: vertices 8g .. 8g+7 of a
// table staged in shared memory in its packed 12-byte layout arrive in six
// 16-byte broadcast loads (every lane of a warp reads the same address;
// group g starts 96g bytes in, so the loads are aligned), and a point takes
// the least of their eight squared distances.  A point keeps the smallest
// distance and the first group that reached it: per group 7 minima, a
// compare and two selects for 8 pairs, in place of a compare and two
// selects a pair.  The minimum of a group replaces the best only when
// strictly smaller, so the group is the first holding the overall minimum;
// the index inside it is found at the end from the same expressions (the
// first of the 8 equal to the minimum), which is what a strict `<` walk in
// ascending order picks.
__device__ __forceinline__ void load_group8(const float4* s4, int g,
                                            float* vx, float* vy, float* vz) {
  s4 += 6 * g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 a = s4[3 * h], b = s4[3 * h + 1], e = s4[3 * h + 2];
    vx[4 * h] = a.x; vy[4 * h] = a.y; vz[4 * h] = a.z;
    vx[4 * h + 1] = a.w; vy[4 * h + 1] = b.x; vz[4 * h + 1] = b.y;
    vx[4 * h + 2] = b.z; vy[4 * h + 2] = b.w; vz[4 * h + 2] = e.x;
    vx[4 * h + 3] = e.y; vy[4 * h + 3] = e.z; vz[4 * h + 3] = e.w;
  }
}

__device__ __forceinline__ float group8_min(float px, float py, float pz,
                                            const float* vx, const float* vy,
                                            const float* vz) {
  float d[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const float dx = px - vx[u];
    const float dy = py - vy[u];
    const float dz = pz - vz[u];
    d[u] = dx * dx + dy * dy + dz * dz;
  }
  return fminf(fminf(fminf(d[0], d[1]), fminf(d[2], d[3])),
               fminf(fminf(d[4], d[5]), fminf(d[6], d[7])));
}

// The index of the first vertex of group g whose distance equals `best`.
__device__ __forceinline__ int group8_first(float px, float py, float pz,
                                            const float* sv, int g,
                                            float best) {
  const float* t = sv + 24 * g;
  int u = 0;
  for (; u < 7; ++u) {
    const float dx = px - t[3 * u];
    const float dy = py - t[3 * u + 1];
    const float dz = pz - t[3 * u + 2];
    if (dx * dx + dy * dy + dz * dz == best) break;
  }
  return 8 * g + u;
}

// Vertex j against a point's running minimum (strict `<`).
__device__ __forceinline__ void vertex_step(float px, float py, float pz,
                                            const float* sv, int j,
                                            float& best, int& bi) {
  const float dx = px - sv[3 * j];
  const float dy = py - sv[3 * j + 1];
  const float dz = pz - sv[3 * j + 2];
  const float d = dx * dx + dy * dy + dz * dz;
  if (d < best) {
    best = d;
    bi = j;
  }
}

template <bool SOA>
__global__ void __launch_bounds__(KNN_THREADS) knn_kernel(
    const float* __restrict__ pts, int N, const float* __restrict__ verts,
    int V, int Bv, int* __restrict__ idx, float* __restrict__ d2) {
  extern __shared__ __align__(16) float sv[];
  // the batch element and its vertex set (element 0: no offset; a 32-bit
  // remainder for the others)
  if (blockIdx.y != 0) {
    const unsigned e = blockIdx.y, m = e % static_cast<unsigned>(Bv);
    pts += static_cast<size_t>(e) * 3 * N;
    verts += static_cast<size_t>(m) * 3 * V;
    idx += static_cast<size_t>(e) * N;
    d2 += static_cast<size_t>(e) * N;
  }
  for (int k = threadIdx.x; k < 3 * V; k += KNN_THREADS) sv[k] = verts[k];
  __syncthreads();
  const int i0 = blockIdx.x * (KNN_THREADS * KNN_PPT) + threadIdx.x;
  float px[KNN_PPT], py[KNN_PPT], pz[KNN_PPT], best[KNN_PPT];
  int bi[KNN_PPT], bg[KNN_PPT];
#pragma unroll
  for (int q = 0; q < KNN_PPT; ++q) {
    const int i = min(i0 + q * KNN_THREADS, N - 1);
    px[q] = SOA ? pts[i] : pts[3 * i];
    py[q] = SOA ? pts[(size_t)N + i] : pts[3 * i + 1];
    pz[q] = SOA ? pts[2 * (size_t)N + i] : pts[3 * i + 2];
    best[q] = INFINITY;
    bi[q] = 0;
    bg[q] = -1;
  }
  const float4* s4 = reinterpret_cast<const float4*>(sv);
  const int G = V / 8;
#pragma unroll 2
  for (int g = 0; g < G; ++g) {
    float vx[8], vy[8], vz[8];
    load_group8(s4, g, vx, vy, vz);
#pragma unroll
    for (int q = 0; q < KNN_PPT; ++q) {
      const float m = group8_min(px[q], py[q], pz[q], vx, vy, vz);
      if (m < best[q]) {
        best[q] = m;
        bg[q] = g;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < KNN_PPT; ++q)
    if (bg[q] >= 0) bi[q] = group8_first(px[q], py[q], pz[q], sv, bg[q],
                                         best[q]);
  for (int j = 8 * G; j < V; ++j) {
#pragma unroll
    for (int q = 0; q < KNN_PPT; ++q)
      vertex_step(px[q], py[q], pz[q], sv, j, best[q], bi[q]);
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
static int knn_launch(const float* pts, int N, int B, const float* verts,
                      int V, int Bv, int* idx, float* d2, void* stream) {
  if (V <= 0 || V > KNN_MAX_VERTS || B <= 0 || B > 65535 || Bv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(V);
  const dim3 grid(vt_blocks(N, KNN_THREADS * KNN_PPT), B);
  knn_kernel<SOA><<<grid, KNN_THREADS, smem, vt_stream(stream)>>>(
      pts, N, verts, V, Bv, idx, d2);
  return static_cast<int>(cudaGetLastError());
}

// Kernel B: `pts` (B, N, 3), `verts` (Bv, V, 3), `idx` / `d2` (B, N).
VT_EXPORT int vt_knn(const float* pts, int N, int B, const float* verts,
                     int V, int Bv, int* idx, float* d2, void* stream) {
  return knn_launch<false>(pts, N, B, verts, V, Bv, idx, d2, stream);
}

// Kernel 8: `pts` is (B, 3, N) contiguous.
VT_EXPORT int vt_knn_T(const float* pts, int N, int B, const float* verts,
                       int V, int Bv, int* idx, float* d2, void* stream) {
  return knn_launch<true>(pts, N, B, verts, V, Bv, idx, d2, stream);
}

// ---------------------------------------------------------------------------
// Kernel 9 — the landmark-culled search.
//
// Replaces vanerf_tpu/ops/knn_pallas.py::_culled_common (body
// `_kernel_culled`, host lists `_knn_cull_lists`), behind
// nearest_vertex_d2_pallas_culled and nearest_vertex_d2_pallas_T_culled.  The
// TPU version builds compacted per-tile chunk lists on the host and ships
// them through scalar memory; here each tile decides for itself.
//
// The cull decision is made per tile of KNC_TILE = 256 consecutive points
// (JAX's TILE_P) over chunks of KNC_CHUNK = 128 vertices (VERT_CHUNK).  The
// first C lanes of a warp (C <= 32 chunks at the 4,096-vertex limit) each
// test one chunk box, (C, 10) rows [min | max | centre | half diagonal]
// that knn_chunk_boxes_kernel makes in front of the search on every call
// (as the JAX package builds them every call):
//   ub_t = (min_c |farthest tile-box corner - centre_c| + radius_c)^2 bounds
//          every tile point's nearest-vertex distance from above,
//   lb_c = the box-to-box gap bounds the distance to chunk c from below,
// and chunk c is visited when lb_c <= ub_t * (1 + 1e-5) + 1e-12; a ballot
// publishes the visited set as one 32-bit mask in shared memory.  The
// expressions are those of ops/knn.py::knn_cull_lists in their written
// order (sqrtf rounds to nearest, -fmad=false), so the mask equals the
// plain version's.
//
// Thread-to-point map: a tile is KNC_TT = 64 threads (two warps), and
// thread t of tile T owns the KNC_PPT = 4 points 256 T + t + 64 q,
// q = 0..3; a block holds KNC_TILES = 4 tiles (256 threads, 1,024
// points; 2 tiles a block, kernel B's 128 threads, measured ~2% slower on
// the H100).  All of a thread's points lie in its tile, so one
// chunk mask serves every point it owns and no warp diverges on the walk.
// A ragged last tile takes its last real point for the missing ones,
// which leaves its box unchanged; a tile past the end (where N ends before
// a block's last tile) writes nothing and stops after the barrier.  The
// tile's box is reduced from registers: each thread over its 4 points,
// warp shuffles, then one shared-memory step joining the tile's two warps;
// warp w then tests tile w's chunks.
//
// The walk is kernel B's: the set bits of the mask in ascending order,
// each chunk's 16 groups of 8 vertices read in six 16-byte broadcast loads
// that serve all 4 points, the group of the running minimum kept, the
// index found once at the end; the table's last V % 8 vertices (in the
// last chunk) follow one by one when that chunk is visited.  With strict
// `<` in ascending vertex order and dx*dx + dy*dy + dz*dz, idx and d2
// equal B's bit for bit: the tolerance keeps every chunk that can hold the
// minimum or tie with it.
//
// Staging: the whole vertex table (15 KB for the two-hand fixture, 48 KB
// at the limit), as B stages it, not only the visited chunks: on the main
// path's ray-major tiles every chunk is visited (visit share 1.000), so a
// copy of the visited chunks alone would copy the same bytes after the
// mask is known, one barrier later, where the whole copy overlaps the
// box reduction.
//
// Bound: arithmetic, as B, over the visited pairs only.  How many pairs are
// skipped depends on the caller's tiles: 256 consecutive ray-major points
// are 4 rays x 64 samples, long thin boxes that cull little; tiles compact
// in all three dimensions cull more.

#define KNC_TILE 256
#define KNC_CHUNK 128
#define KNC_TT 64
#define KNC_PPT (KNC_TILE / KNC_TT)
#define KNC_TILES 4
#define KNC_THREADS (KNC_TT * KNC_TILES)

template <bool SOA>
__global__ void __launch_bounds__(KNC_THREADS) knn_culled_kernel(
    const float* __restrict__ pts, int N, const float* __restrict__ verts,
    int V, const float* __restrict__ boxes, int C, int* __restrict__ idx,
    float* __restrict__ d2, int* __restrict__ visits) {
  extern __shared__ __align__(16) float svc[];
  __shared__ float red[KNC_THREADS / 32][6];
  __shared__ unsigned smask[KNC_TILES];
  for (int k = threadIdx.x; k < 3 * V; k += KNC_THREADS) svc[k] = verts[k];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tl = threadIdx.x / KNC_TT;
  const int tile = blockIdx.x * KNC_TILES + tl;
  const int i0 = tile * KNC_TILE + threadIdx.x % KNC_TT;
  float px[KNC_PPT], py[KNC_PPT], pz[KNC_PPT], best[KNC_PPT];
  int bi[KNC_PPT], bg[KNC_PPT];
#pragma unroll
  for (int q = 0; q < KNC_PPT; ++q) {
    const int i = min(i0 + q * KNC_TT, N - 1);
    px[q] = SOA ? pts[i] : pts[3 * i];
    py[q] = SOA ? pts[(size_t)N + i] : pts[3 * i + 1];
    pz[q] = SOA ? pts[2 * (size_t)N + i] : pts[3 * i + 2];
    best[q] = INFINITY;
    bi[q] = 0;
    bg[q] = -1;
  }
  float r[6] = {px[0], py[0], pz[0], px[0], py[0], pz[0]};
#pragma unroll
  for (int q = 1; q < KNC_PPT; ++q) {
    r[0] = fminf(r[0], px[q]); r[1] = fminf(r[1], py[q]);
    r[2] = fminf(r[2], pz[q]);
    r[3] = fmaxf(r[3], px[q]); r[4] = fmaxf(r[4], py[q]);
    r[5] = fmaxf(r[5], pz[q]);
  }
  for (int o = 16; o > 0; o >>= 1)
    for (int k = 0; k < 3; ++k) {
      r[k] = fminf(r[k], __shfl_xor_sync(0xffffffffu, r[k], o));
      r[3 + k] = fmaxf(r[3 + k], __shfl_xor_sync(0xffffffffu, r[3 + k], o));
    }
  if (lane == 0)
    for (int k = 0; k < 6; ++k) red[warp][k] = r[k];
  __syncthreads();
  if (warp < KNC_TILES) {
    // warp w tests the chunks of tile w, whose warps are 2w and 2w + 1
    const int tw = blockIdx.x * KNC_TILES + warp;
    float tmin[3], tmax[3];
    for (int k = 0; k < 3; ++k) {
      tmin[k] = fminf(red[2 * warp][k], red[2 * warp + 1][k]);
      tmax[k] = fmaxf(red[2 * warp][3 + k], red[2 * warp + 1][3 + k]);
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
      smask[warp] = mask;
      if (visits != nullptr && tw * KNC_TILE < N) visits[tw] = __popc(mask);
    }
  }
  __syncthreads();
  if (tile * KNC_TILE >= N) return;
  const unsigned mask0 = smask[tl];
  const float4* s4 = reinterpret_cast<const float4*>(svc);
  const int G = V / 8;
  for (unsigned mask = mask0; mask != 0u; mask &= mask - 1u) {
    const int g0 = (__ffs(mask) - 1) * (KNC_CHUNK / 8);
    const int g1 = min(g0 + KNC_CHUNK / 8, G);
#pragma unroll 2
    for (int g = g0; g < g1; ++g) {
      float vx[8], vy[8], vz[8];
      load_group8(s4, g, vx, vy, vz);
#pragma unroll
      for (int q = 0; q < KNC_PPT; ++q) {
        const float m = group8_min(px[q], py[q], pz[q], vx, vy, vz);
        if (m < best[q]) {
          best[q] = m;
          bg[q] = g;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < KNC_PPT; ++q)
    if (bg[q] >= 0) bi[q] = group8_first(px[q], py[q], pz[q], svc, bg[q],
                                         best[q]);
  if ((mask0 >> (C - 1)) & 1u) {
    for (int j = 8 * G; j < V; ++j) {
#pragma unroll
      for (int q = 0; q < KNC_PPT; ++q)
        vertex_step(px[q], py[q], pz[q], svc, j, best[q], bi[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < KNC_PPT; ++q) {
    const int i = i0 + q * KNC_TT;
    if (i < N) {
      idx[i] = bi[q];
      d2[i] = best[q];
    }
  }
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

static int chunk_boxes_launch(const float* verts, int V, float* boxes,
                              int C, cudaStream_t st) {
  if (V <= 0 || V > KNN_MAX_VERTS || C != (V + KNC_CHUNK - 1) / KNC_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  knn_chunk_boxes_kernel<<<C, KNC_CHUNK, 0, st>>>(verts, V, boxes);
  return static_cast<int>(cudaGetLastError());
}

template <bool SOA>
static int knn_culled_launch(const float* pts, int N, const float* verts,
                             int V, float* boxes, int C, int* idx,
                             float* d2, int* visits, void* stream) {
  cudaStream_t st = vt_stream(stream);
  if (V <= 0 || V > KNN_MAX_VERTS || C != (V + KNC_CHUNK - 1) / KNC_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  const int rc = chunk_boxes_launch(verts, V, boxes, C, st);
  if (rc != 0) return rc;
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(V);
  // the table's 48 KB at KNN_MAX_VERTS and the kernel's own shared arrays
  // exceed the 48 KB a block gets by default; the limit is the current
  // device's, so it is raised on every launch
  const cudaError_t raised = cudaFuncSetAttribute(
      knn_culled_kernel<SOA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * 3 * KNN_MAX_VERTS));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  knn_culled_kernel<SOA><<<vt_blocks(N, KNC_TILE * KNC_TILES), KNC_THREADS,
                           smem, st>>>(pts, N, verts, V, boxes, C, idx, d2,
                                       visits);
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

// Kernel 9's chunk boxes alone (the launch vt_knn_culled makes in front of
// the search), so that its time can be read apart from the search's.
VT_EXPORT int vt_knn_chunk_boxes(const float* verts, int V, float* boxes,
                                 int C, void* stream) {
  return chunk_boxes_launch(verts, V, boxes, C, vt_stream(stream));
}
