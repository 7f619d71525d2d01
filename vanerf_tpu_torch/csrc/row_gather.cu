// Kernel 10 — row gather out[n] = table[idx[n]], bit for bit.
//
// Replaces the TPU kernel vanerf_tpu/ops/interp_mxu.py::mxu_row_gather
// (body `_rg_kernel`), which builds an exact one-hot matrix per 256-point
// tile and contracts it against the VMEM-resident table on the MXU because
// TPU gathers are row-count bound.  The one-hot product is the TPU's way
// to the result; the result is a copy of table rows.
//
// Bound on the H100: memory.  The 1,284 x 204 f32 vertex table (1 MB)
// stays in L2; 262,144 output rows of 816 bytes are 214 MB written once,
// ~64 us at 3.35 TB/s.  Design: one warp per output row; the row index is
// read once per warp and the row moves as 16-byte vectors when the row
// width and both base addresses allow it (C % 4 == 0, 16-byte aligned),
// else as scalars.  Nothing is computed, so the copy equals table[idx]
// exactly.  Indices are in range by the caller's contract (nearest-vertex
// ids); an index outside [0, V) is clamped instead of read out of bounds.

#include "common.cuh"

#include <cstdint>

#define RG_THREADS 256

template <bool VEC4>
__global__ void row_gather_kernel(const float* __restrict__ table, int V,
                                  int C, const int* __restrict__ idx, int N,
                                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x) >> 5;
  if (row >= N) return;
  int src = __ldg(idx + row);
  src = min(max(src, 0), V - 1);
  const float* in = table + static_cast<long long>(src) * C;
  float* dst = out + row * C;
  if (VEC4) {
    const float4* in4 = reinterpret_cast<const float4*>(in);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < (C >> 2); c += 32) dst4[c] = __ldg(in4 + c);
  } else {
    for (int c = lane; c < C; c += 32) dst[c] = __ldg(in + c);
  }
}

VT_EXPORT int vt_row_gather(const float* table, int V, int C, const int* idx,
                            int N, float* out, void* stream) {
  if (V <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  const long long threads = static_cast<long long>(N) * 32;
  const bool vec4 = (C % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec4) {
    row_gather_kernel<true><<<vt_blocks(threads, RG_THREADS), RG_THREADS, 0,
                              vt_stream(stream)>>>(table, V, C, idx, N, out);
  } else {
    row_gather_kernel<false><<<vt_blocks(threads, RG_THREADS), RG_THREADS, 0,
                               vt_stream(stream)>>>(table, V, C, idx, N, out);
  }
  return static_cast<int>(cudaGetLastError());
}
