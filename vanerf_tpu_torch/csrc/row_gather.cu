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
// read once per warp and the row moves as units of the widest of 16, 8, 4
// or 2 bytes that divides the row's bytes and both base addresses.  The
// copy knows no dtype, so one body serves both entry points:
// vt_row_gather (float32) and vt_row_gather_bf16 (bfloat16, replacing the
// same TPU kernel on a bfloat16 table, whose one-hot product is exact in
// any dtype).  Nothing is computed, so the copy equals table[idx] exactly.
// Indices are in range by the caller's contract (nearest-vertex ids); an
// index outside [0, V) is clamped instead of read out of bounds.
//
// The bf16 main path's 1,284 x 204 table has 408-byte rows, 8-byte aligned
// but not 16: each lane moves 8-byte units, 51 a row; 262,144 rows out are
// 107 MB, ~32 us at 3.35 TB/s.

//
// A launch takes a batch (the JAX package's vmap, as a grid dimension):
// element e of B (blockIdx.y) copies its own N rows from table e % Bm of a
// (Bm, V, C) stack, so the caller says by Bm whether an element reads its
// frame's table (Bm the frames, the G tiles of a frame sharing it) or its
// own (Bm = B).  Tables and outputs of an element start on multiples of
// the row's bytes, so the unit is the one its own launch would take, and
// its rows equal that launch's.  A tile group's output passes 2^31 bytes
// (16 x 262,144 rows of 816 bytes is 3.4 GB): the offsets are 64-bit.

#include "common.cuh"

#include <cstdint>

#define RG_THREADS 256

// One warp a row, `units` units of type U a row.  Only the BATCHED
// instantiation takes the element offsets (a B = 1 launch runs the
// unbatched body: even a 32-bit remainder behind a branch cost the
// bfloat16 rows ~2% on the H100).
template <typename U, bool BATCHED>
__global__ void row_gather_kernel(const U* __restrict__ table, int V,
                                  int units, int Bm,
                                  const int* __restrict__ idx, int N,
                                  U* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x) >> 5;
  if (row >= N) return;
  // element blockIdx.y's table (e % Bm), indices and rows; element 0 takes
  // no offset arithmetic, the others a 32-bit remainder (a 64-bit one is a
  // library call on the card)
  if (BATCHED && blockIdx.y != 0) {
    const unsigned e = blockIdx.y, m = e % static_cast<unsigned>(Bm);
    table += static_cast<long long>(m) * V * units;
    idx += static_cast<long long>(e) * N;
    out += static_cast<long long>(e) * N * units;
  }
  int src = __ldg(idx + row);
  src = min(max(src, 0), V - 1);
  const U* in = table + static_cast<long long>(src) * units;
  U* dst = out + row * units;
  for (int c = lane; c < units; c += 32) dst[c] = __ldg(in + c);
}

template <typename U>
static int row_gather_units(const void* table, int V, int row_bytes, int Bm,
                            const int* idx, int N, int B, void* out,
                            void* stream) {
  const long long threads = static_cast<long long>(N) * 32;
  const dim3 grid(vt_blocks(threads, RG_THREADS), B);
  (B > 1 ? row_gather_kernel<U, true> : row_gather_kernel<U, false>)
      <<<grid, RG_THREADS, 0, vt_stream(stream)>>>(
          static_cast<const U*>(table), V,
          row_bytes / static_cast<int>(sizeof(U)), Bm, idx, N,
          static_cast<U*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Rows of `row_bytes` bytes (a multiple of 2), in the widest unit allowed:
// `table` (Bm, V, row), `idx` (B, N), `out` (B, N, row).
static int row_gather_bytes(const void* table, int V, int row_bytes, int Bm,
                            const int* idx, int N, int B, void* out,
                            void* stream) {
  if (V <= 0 || row_bytes <= 0 || Bm <= 0 || B <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    return row_gather_units<uint4>(table, V, row_bytes, Bm, idx, N, B, out,
                                   stream);
  if (align % 8 == 0)
    return row_gather_units<uint2>(table, V, row_bytes, Bm, idx, N, B, out,
                                   stream);
  if (align % 4 == 0)
    return row_gather_units<unsigned>(table, V, row_bytes, Bm, idx, N, B,
                                      out, stream);
  return row_gather_units<unsigned short>(table, V, row_bytes, Bm, idx, N, B,
                                          out, stream);
}

VT_EXPORT int vt_row_gather(const float* table, int V, int C, int Bm,
                            const int* idx, int N, int B, float* out,
                            void* stream) {
  return row_gather_bytes(table, V, 4 * C, Bm, idx, N, B, out, stream);
}

VT_EXPORT int vt_row_gather_bf16(const void* table, int V, int C, int Bm,
                                 const int* idx, int N, int B, void* out,
                                 void* stream) {
  return row_gather_bytes(table, V, 2 * C, Bm, idx, N, B, out, stream);
}
