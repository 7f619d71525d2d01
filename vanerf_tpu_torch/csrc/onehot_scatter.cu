// Kernel 13 — the table gradient of a small-table row gather (the VJP of
// take_rows):  d_table[t, c] = sum_n [idx[n] == t] * g[n, c], f32 in and out.
//
// Replaces the TPU kernel vanerf_tpu/ops/onehot_gather.py::_take_rows_fn
// (body `_take_scatter_kernel`), which builds a one-hot (T, 1024) block in
// VMEM, contracts it with the point block on the MXU and carries the
// (T, C) sum in its output block across the sequential grid.  None of that
// carries over: Hopper blocks run in no order, a (T x C) f32 table (1.3 MB
// at T = 1,284, C = 204) does not fit one block's shared memory, and a
// one-hot product would spend 2*T*N*C flops (~1.4e11) on what is a sum.
//
// Bound on the H100: bytes.  The sum reads g once: N x C x 4 bytes, 214 MB
// for the KNN table (262,144 rows x 204) and 268 MB for the 32^2 geometry
// map (x 256) — ~65-80 us at 3.35 TB/s.  Everything else (the indices,
// the sort, the partial sums) is a few MB.
//
// Design: a stable counting sort of the points by row, then a sum in point
// order, in six launches on the caller's stream; no float atomics, so two
// runs give bit-equal tables (as the TPU kernel does):
//   1. os_rank    — one warp per chunk of OS_CHUNK points ranks each point
//                   among the earlier points of its chunk with the same
//                   row (__match_any_sync + a running count in shared
//                   memory), writes the chunk's row histogram (row-major)
//                   and adds it to the row totals (integer atomics: the
//                   totals do not depend on their order);
//   2. os_scan    — one block: the exclusive scan of the row totals gives
//                   each row's first slot in a row-sorted order; each
//                   row's segment is cut into pieces of at most OS_SEG
//                   points, so a row that holds a large share of the
//                   points (rays cluster around a few vertices and texels)
//                   is spread over many blocks;
//   3. os_rowscan — one warp per row: the exclusive scan of its chunk
//                   histogram, offset by the row's first slot;
//   4. os_place   — perm[slot] = point, stable: within a row, in point
//                   order;
//   5. os_partial — one block per piece, threads over channels, sums its
//                   <= OS_SEG rows of g in point order (each row a
//                   contiguous, coalesced read);
//   6. os_final   — each table row sums its pieces in order.
// The order of every float sum is fixed by the data alone.  Indices
// outside [0, T) go to a dump row that is never summed (the forward gather
// has already refused them).

#include "common.cuh"

#define OS_CHUNK 2048       // points ranked by one warp (stage 1)
#define OS_SEG 128          // points summed by one block (stage 4)
#define OS_MAX_T 8192       // rows: the stage-1 counts live in shared memory
#define OS_SCAN_THREADS 1024
#define OS_SUM_THREADS 256

__global__ void os_rank(const int* __restrict__ idx, int N, int T,
                        int nchunks, int* __restrict__ rank,
                        int* __restrict__ counts, int* __restrict__ total) {
  extern __shared__ int cnt[];            // T + 1 running counts
  const int k = blockIdx.x;
  const int lane = threadIdx.x;           // one warp per block
  for (int t = lane; t <= T; t += 32) cnt[t] = 0;
  __syncwarp();
  const int n0 = k * OS_CHUNK;
  const unsigned below = (1u << lane) - 1u;
  int bins[OS_CHUNK / 32];
#pragma unroll
  for (int i = 0; i < OS_CHUNK / 32; ++i) {
    const int n = n0 + i * 32 + lane;
    int b = -1;                           // -1: past the end of the input
    if (n < N) {
      b = idx[n];
      if (b < 0 || b >= T) b = T;         // dump row
    }
    bins[i] = b;
  }
#pragma unroll
  for (int i = 0; i < OS_CHUNK / 32; ++i) {
    const int b = bins[i];
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int r = (b >= 0) ? cnt[b] + __popc(peers & below) : 0;
    __syncwarp();
    if (b >= 0 && (peers & below) == 0) cnt[b] += __popc(peers);
    __syncwarp();
    if (b >= 0) rank[n0 + i * 32 + lane] = r;
  }
  for (int t = lane; t <= T; t += 32) {
    const int c = cnt[t];
    counts[t * nchunks + k] = c;
    if (c) atomicAdd(total + t, c);
  }
}

// Exclusive scan of one value per thread across a block of
// OS_SCAN_THREADS threads; returns the thread's exclusive prefix.
__device__ int os_block_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;                  // inclusive over warps
  }
  __syncthreads();
  const int before = (warp > 0) ? warp_sums[warp - 1] : 0;
  __syncthreads();                        // warp_sums is reused by the caller
  return before + x - v;
}

// Row totals -> seg[t] = first sorted slot of row t (t <= T); sub[t] =
// first piece of row t, sub[T] = the number of pieces.
__global__ void os_scan(const int* __restrict__ total, int T,
                        int* __restrict__ seg, int* __restrict__ sub) {
  __shared__ int warp_sums[32];
  const int per = (T + 1 + OS_SCAN_THREADS - 1) / OS_SCAN_THREADS;
  const int lo = min(static_cast<int>(threadIdx.x) * per, T + 1);
  const int hi = min(lo + per, T + 1);
  int s = 0;
  for (int t = lo; t < hi; ++t) s += total[t];
  int run = os_block_scan(s, warp_sums);
  for (int t = lo; t < hi; ++t) {
    seg[t] = run;
    run += total[t];
  }
  __syncthreads();
  // pieces per row, then their exclusive scan (rows < T; the dump row T
  // is never summed)
  const int r0 = min(lo, T);
  const int r1 = min(hi, T);
  int np = 0;
  for (int t = r0; t < r1; ++t) np += (total[t] + OS_SEG - 1) / OS_SEG;
  int p = os_block_scan(np, warp_sums);
  for (int t = r0; t < r1; ++t) {
    sub[t] = p;
    p += (total[t] + OS_SEG - 1) / OS_SEG;
  }
  if (threadIdx.x == OS_SCAN_THREADS - 1) sub[T] = p;
}

// counts[t][k] -> seg[t] + (points of row t in chunks < k), in place; one
// warp per row.
__global__ void os_rowscan(int* __restrict__ counts, int nchunks, int T,
                           const int* __restrict__ seg) {
  const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t > T) return;
  int* row = counts + static_cast<long long>(t) * nchunks;
  int carry = seg[t];
  for (int k0 = 0; k0 < nchunks; k0 += 32) {
    const int k = k0 + lane;
    const int v = (k < nchunks) ? row[k] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (k < nchunks) row[k] = carry + x - v;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
}

__global__ void os_place(const int* __restrict__ idx, int N, int T,
                         int nchunks, const int* __restrict__ rank,
                         const int* __restrict__ offsets,
                         int* __restrict__ perm) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int b = idx[n];
  if (b < 0 || b >= T) b = T;
  perm[offsets[b * nchunks + n / OS_CHUNK] + rank[n]] = n;
}

__global__ void os_partial(const float* __restrict__ g, int C, int T,
                           const int* __restrict__ perm,
                           const int* __restrict__ seg,
                           const int* __restrict__ sub,
                           float* __restrict__ partial) {
  __shared__ int rows[OS_SEG];
  __shared__ int span[2];
  const int s = blockIdx.x;
  if (s >= sub[T]) return;                // the grid is an upper bound
  if (threadIdx.x == 0) {
    int lo = 0, hi = T - 1;               // last row t with sub[t] <= s
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (sub[mid] <= s) lo = mid; else hi = mid - 1;
    }
    const int j0 = seg[lo] + (s - sub[lo]) * OS_SEG;
    span[0] = j0;
    span[1] = min(j0 + OS_SEG, seg[lo + 1]);
  }
  __syncthreads();
  const int j0 = span[0];
  const int len = span[1] - j0;
  for (int q = threadIdx.x; q < len; q += blockDim.x) rows[q] = perm[j0 + q];
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.0f;
#pragma unroll 8
    for (int q = 0; q < len; ++q)
      acc += g[static_cast<long long>(rows[q]) * C + c];
    partial[static_cast<long long>(s) * C + c] = acc;
  }
}

__global__ void os_final(const float* __restrict__ partial, int C,
                         const int* __restrict__ sub,
                         float* __restrict__ out) {
  const int t = blockIdx.x;
  const int s0 = sub[t], s1 = sub[t + 1];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.0f;
    for (int s = s0; s < s1; ++s)
      acc += partial[static_cast<long long>(s) * C + c];
    out[static_cast<long long>(t) * C + c] = acc;
  }
}

// Workspace: ints  rank[N] | perm[N] | counts[(T+1)*nchunks] | total[T+1]
//                  | seg[T+1] | sub[T+1];
//            floats partial[(ceil(N/OS_SEG) + T) * C].
VT_EXPORT int vt_onehot_scatter(const float* g, const int* idx, int N,
                                int C, int T, float* out, int* iws,
                                long long n_iws, float* fws,
                                long long n_fws, void* stream) {
  if (T <= 0 || T > OS_MAX_T || C <= 0 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = vt_stream(stream);
  if (N == 0) {
    cudaMemsetAsync(out, 0, sizeof(float) * static_cast<size_t>(T) * C, st);
    return static_cast<int>(cudaGetLastError());
  }
  const int nchunks = (N + OS_CHUNK - 1) / OS_CHUNK;
  const int max_pieces = (N + OS_SEG - 1) / OS_SEG + T;
  const long long need_i = 2LL * N + static_cast<long long>(T + 1) * nchunks
                           + 3LL * (T + 1);
  const long long need_f = static_cast<long long>(max_pieces) * C;
  if (n_iws < need_i || n_fws < need_f)
    return static_cast<int>(cudaErrorInvalidValue);
  int* rank = iws;
  int* perm = rank + N;
  int* counts = perm + N;
  int* total = counts + static_cast<long long>(T + 1) * nchunks;
  int* seg = total + (T + 1);
  int* sub = seg + (T + 1);

  cudaMemsetAsync(total, 0, sizeof(int) * (T + 1), st);
  os_rank<<<nchunks, 32, sizeof(int) * (T + 1), st>>>(idx, N, T, nchunks,
                                                       rank, counts, total);
  os_scan<<<1, OS_SCAN_THREADS, 0, st>>>(total, T, seg, sub);
  os_rowscan<<<vt_blocks(T + 1, 8), 256, 0, st>>>(counts, nchunks, T, seg);
  os_place<<<vt_blocks(N, 256), 256, 0, st>>>(idx, N, T, nchunks, rank,
                                               counts, perm);
  os_partial<<<max_pieces, OS_SUM_THREADS, 0, st>>>(g, C, T, perm, seg, sub,
                                                    fws);
  os_final<<<T, OS_SUM_THREADS, 0, st>>>(fws, C, sub, out);
  return static_cast<int>(cudaGetLastError());
}
