// Kernels B and 8 — exact nearest vertex per query point (index + squared
// distance).
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
// pairs, ~3 GFLOP — the card's fp32 rate makes that a fraction of a
// millisecond; the bytes (3.1 MB of points in, 2 MB out) are negligible.
// Design: one thread per point; the whole vertex table (V x 3 f32, 15 KB
// for the two-hand fixture) is staged once per block into shared memory
// and read as a broadcast (every thread of a warp reads the same vertex).
// The running minimum uses strict `<` in ascending vertex order, so ties
// go to the lowest index like jnp.argmin / torch.argmin.  The squared
// distance is dx*dx + dy*dy + dz*dz in that order: it is the exact
// distance to a mesh vertex, hence a certified upper bound on the
// point-to-mesh distance (kernel A's far rule relies on that).

#include "common.cuh"

#define KNN_THREADS 256
#define KNN_MAX_VERTS 4096  // 48 KB: the dynamic shared memory a block gets
                            // without cudaFuncSetAttribute

template <bool SOA>
__global__ void knn_kernel(const float* __restrict__ pts, int N,
                           const float* __restrict__ verts, int V,
                           int* __restrict__ idx, float* __restrict__ d2) {
  extern __shared__ float sv[];
  for (int k = threadIdx.x; k < 3 * V; k += blockDim.x) sv[k] = verts[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float px = SOA ? pts[i] : pts[3 * i];
  const float py = SOA ? pts[(size_t)N + i] : pts[3 * i + 1];
  const float pz = SOA ? pts[2 * (size_t)N + i] : pts[3 * i + 2];
  float best = INFINITY;
  int bi = 0;
  for (int j = 0; j < V; ++j) {
    const float dx = px - sv[3 * j];
    const float dy = py - sv[3 * j + 1];
    const float dz = pz - sv[3 * j + 2];
    const float d = dx * dx + dy * dy + dz * dz;
    if (d < best) {
      best = d;
      bi = j;
    }
  }
  idx[i] = bi;
  d2[i] = best;
}

template <bool SOA>
static int knn_launch(const float* pts, int N, const float* verts, int V,
                      int* idx, float* d2, void* stream) {
  if (V <= 0 || V > KNN_MAX_VERTS) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(V);
  knn_kernel<SOA><<<vt_blocks(N, KNN_THREADS), KNN_THREADS, smem,
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
