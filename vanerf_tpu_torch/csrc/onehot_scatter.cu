// Kernel 13 — the table gradient of a small-table row gather (the VJP of
// take_rows):  d_table[t, c] = sum_n [idx[n] == t] * g[n, c], in two
// forms: vt_onehot_scatter (g and the table float32) and
// vt_onehot_scatter_bf16 (g and the table bfloat16, as the TPU kernel runs
// on a bfloat16 table: its one-hot in bfloat16, the sum in float32 through
// preferred_element_type, one rounding at `d_p[:t].astype(dtype)`).
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
// map (x 256) — ~65-80 us at 3.35 TB/s; 1.3 MB (~0.4 us) for the 1,284
// projected vertices into the 32^2 map, where one launch is the cost.
//
// No float atomics: every sum runs in an order fixed by the data alone, so
// two runs give bit-equal tables (as the TPU kernel does).  Two paths:
//
// Small N (N <= OS_SMALL_N), one launch, no workspace: `os_small`.  A
// block owns OS_SMALL_ROWS consecutive table rows (two, so that several
// blocks share an SM and their rows' load latencies overlap) and loads all
// of idx into shared memory.  It counts its rows' points, then lists them grouped
// by row, in ascending point order within a row (a ballot per row and a
// prefix over the warps, 256 points at a time).  Each row is then summed as
// a piece of the large path is (os_block_sum below: channel vectors x
// point lanes and a fixed tree), so a row that holds many points is spread
// over the block's point lanes.  Each block writes its rows, zeros included.
//
// Large N, four launches, no memset: a stable counting sort of the points
// by row, then ordered sums.
//   1. os_rank  — a block ranks OS_CHUNK points, each warp its own
//                 OS_WARP_CHUNK of them (__match_any_sync and a running
//                 16-bit count per row in shared memory); the warps'
//                 counts are scanned per row, so a point's rank is its
//                 place among the block's earlier points of its row, and
//                 the block writes its row histogram;
//   2. os_scan  — a block owns 32 rows and scans their histograms over the
//                 blocks of step 1 (8 lanes of blocks a row).  The last
//                 block to finish (an integer ticket after __threadfence,
//                 zeroed by step 1) scans the row totals into each row's
//                 first slot, and the rows' pieces: a row is cut into
//                 pieces of at most OS_SEG points (rays cluster around a
//                 few vertices and texels), an empty row is one empty
//                 piece;
//   3. os_place — perm[slot] = point (stable: within a row in point
//                 order); it also zeroes the rows' fold tickets and writes
//                 each piece's row;
//   4. os_sum   — one block per piece, threads as (channel vector x point
//                 lane), so a 32-channel row keeps all 256 threads busy.
//                 Point lane p sums the piece's points p, p + PL, ... in
//                 order, a fixed shared-memory tree combines the lanes.  A
//                 row of one piece writes its table row; otherwise the
//                 piece goes to the partial buffer and the last piece of
//                 the row to finish (integer ticket) sums the row's pieces
//                 in piece order, the same way.
// Indices outside [0, T) go to a dump row that is never summed (the
// forward gather has already refused them).
//
// The bfloat16 form differs only where g is read and the table written.  A
// lane loads 4 bfloat16 channels in 8 bytes (or 1 in 2) and widens them to
// float32 in registers, which is exact; the sort, the summation tree, the
// float32 partial rows and every sum are the float32 form's, so its sums
// equal, bit for bit, those of vt_onehot_scatter on g widened to float32.
// Each table element is rounded to bfloat16 once, in the store (to
// nearest, ties to even, as torch's cast): the TPU kernel's one rounding.
// The bytes read halve: N x C x 2.

#include "bf16.cuh"
#include "common.cuh"

#include <cstdint>

#define OS_THREADS 256
#define OS_WARPS (OS_THREADS / 32)
#define OS_SMALL_N 4096                        // one launch up to here
#define OS_SMALL_ROWS 2                        // rows of a block, small path
#define OS_WARP_CHUNK 256                      // points ranked by one warp
#define OS_CHUNK (OS_WARPS * OS_WARP_CHUNK)    // points ranked by one block
#define OS_SCAN_ROWS 32                        // rows of an os_scan block
#define OS_SEG 128                             // points of one piece
#define OS_MAX_T 8192                          // rows

// A lane's vector: 4 channels (float4) or 1; g's element type is float or
// bfloat16 held as its 16 bits (unsigned short), widened at the load; the
// table's the same two, rounded at the store; the partial rows are float.
template <bool VEC>
struct OsVec;

template <>
struct OsVec<true> {
  typedef float4 T;
  static __device__ __forceinline__ float4 ld(const float* p, int i) {
    return __ldg(reinterpret_cast<const float4*>(p) + i);
  }
  static __device__ __forceinline__ float4 ld(const unsigned short* p,
                                              int i) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p) + i);
    return make_float4(vt_bf16_lo(w.x), vt_bf16_hi(w.x), vt_bf16_lo(w.y),
                       vt_bf16_hi(w.y));
  }
  // partial rows written by other blocks of the same launch: past L1
  static __device__ __forceinline__ float4 ldcg(const float* p, int i) {
    return __ldcg(reinterpret_cast<const float4*>(p) + i);
  }
  static __device__ __forceinline__ void st(float* p, int i, float4 v) {
    reinterpret_cast<float4*>(p)[i] = v;
  }
  static __device__ __forceinline__ void st(unsigned short* p, int i,
                                            float4 v) {
    reinterpret_cast<uint2*>(p)[i] =
        make_uint2(vt_bf16_pack(v.x, v.y), vt_bf16_pack(v.z, v.w));
  }
};

template <>
struct OsVec<false> {
  typedef float T;
  static __device__ __forceinline__ float ld(const float* p, int i) {
    return __ldg(p + i);
  }
  static __device__ __forceinline__ float ld(const unsigned short* p, int i) {
    return vt_bf16_float(__ldg(p + i));
  }
  static __device__ __forceinline__ float ldcg(const float* p, int i) {
    return __ldcg(p + i);
  }
  static __device__ __forceinline__ void st(float* p, int i, float v) {
    p[i] = v;
  }
  static __device__ __forceinline__ void st(unsigned short* p, int i,
                                            float v) {
    p[i] = vt_bf16_bits(v);
  }
};

__device__ __forceinline__ float4 os_add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float os_add(float a, float b) { return a + b; }
__device__ __forceinline__ void os_zero(float4& a) {
  a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void os_zero(float& a) { a = 0.0f; }

// ---------------------------------------------------------------------------
// large N: counting sort, then ordered sums
// ---------------------------------------------------------------------------

// Exclusive scan of one value per thread across a 1-D block; returns the
// thread's exclusive prefix.
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
    int w = (lane < static_cast<int>(blockDim.x >> 5)) ? warp_sums[lane] : 0;
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

__device__ __forceinline__ int os_pieces(int count) {
  return max(1, (count + OS_SEG - 1) / OS_SEG);
}

// counts: nchunks x (T + 1), block-major, the block's count of each row
// (the dump row T last).
__global__ void __launch_bounds__(OS_THREADS)
os_rank(const int* __restrict__ idx, int N, int T, int* __restrict__ rank,
        int* __restrict__ counts, unsigned* __restrict__ ticket) {
  extern __shared__ unsigned short cnt[];       // OS_WARPS x stride
  const int T1 = T + 1;
  const int stride = (T1 + 1) & ~1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x;
  if (k == 0 && threadIdx.x == 0) *ticket = 0u;   // os_scan's
  unsigned* cnt2 = reinterpret_cast<unsigned*>(cnt);
  for (int i = threadIdx.x; i < OS_WARPS * stride / 2; i += blockDim.x)
    cnt2[i] = 0u;
  __syncthreads();
  unsigned short* my = cnt + warp * stride;
  const int n0 = k * OS_CHUNK + warp * OS_WARP_CHUNK;
  const unsigned below = (1u << lane) - 1u;
  // per point: (row + 1) << 12 | its rank among the warp's earlier points
  // of that row (< OS_WARP_CHUNK); row -1: past the end of the input
  int packed[OS_WARP_CHUNK / 32];
#pragma unroll
  for (int i = 0; i < OS_WARP_CHUNK / 32; ++i) {
    const int n = n0 + i * 32 + lane;
    int b = -1;
    if (n < N) {
      b = __ldg(idx + n);
      if (b < 0 || b >= T) b = T;               // dump row
    }
    packed[i] = b;
  }
#pragma unroll
  for (int i = 0; i < OS_WARP_CHUNK / 32; ++i) {
    const int b = packed[i];
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int r = (b >= 0) ? my[b] + __popc(peers & below) : 0;
    __syncwarp();
    if (b >= 0 && (peers & below) == 0)
      my[b] = static_cast<unsigned short>(my[b] + __popc(peers));
    __syncwarp();
    packed[i] = ((b + 1) << 12) | r;
  }
  __syncthreads();
  // per row: the warps' counts -> their exclusive prefix, in place; the
  // block's count -> its histogram
  for (int t = threadIdx.x; t < T1; t += blockDim.x) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < OS_WARPS; ++w) {
      const int c = cnt[w * stride + t];
      cnt[w * stride + t] = static_cast<unsigned short>(run);
      run += c;
    }
    counts[k * T1 + t] = run;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < OS_WARP_CHUNK / 32; ++i) {
    const int b = (packed[i] >> 12) - 1;
    if (b >= 0) rank[n0 + i * 32 + lane] = my[b] + (packed[i] & 0xfff);
  }
}

// counts -> each block's exclusive prefix of each row over the blocks, in
// place; the last block: seg (T + 2 first slots, seg[T + 1] = N) and sub
// (T + 1 first pieces, sub[T] = pieces) from the row totals, which wait in
// seg until then.
__global__ void __launch_bounds__(OS_THREADS)
os_scan(int* __restrict__ counts, int nchunks, int T, int* __restrict__ seg,
        int* __restrict__ sub, unsigned* __restrict__ ticket) {
  __shared__ int part[OS_WARPS][OS_SCAN_ROWS + 1];
  __shared__ int tot[OS_MAX_T + 1];             // the last block's row totals
  __shared__ int warp_sums[32];
  __shared__ bool last;
  const int T1 = T + 1;
  const int x = threadIdx.x & (OS_SCAN_ROWS - 1);   // row of the block
  const int y = threadIdx.x / OS_SCAN_ROWS;         // lane of blocks
  const int t = blockIdx.x * OS_SCAN_ROWS + x;
  const int per = (nchunks + OS_WARPS - 1) / OS_WARPS;
  const int k0 = min(y * per, nchunks), k1 = min(k0 + per, nchunks);
  int s = 0;
  if (t < T1) {
#pragma unroll 8
    for (int k = k0; k < k1; ++k) s += counts[k * T1 + t];
  }
  part[y][x] = s;
  __syncthreads();
  if (y == 0) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < OS_WARPS; ++w) {
      const int c = part[w][x];
      part[w][x] = run;
      run += c;
    }
    if (t < T1) seg[t] = run;                   // the row's total, for now
  }
  __syncthreads();
  if (t < T1) {
    int run = part[y][x];
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const int c = counts[k * T1 + t];
      counts[k * T1 + t] = run;
      run += c;
    }
  }

  // the last block: the rows' first slots and first pieces
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(gridDim.x - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll 8
  for (int r = threadIdx.x; r < T1; r += blockDim.x) tot[r] = __ldcg(seg + r);
  __syncthreads();
  const int span = (T1 + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * span, T1);
  const int hi = min(lo + span, T1);
  int sum = 0, np = 0;
  for (int r = lo; r < hi; ++r) {
    sum += tot[r];
    if (r < T) np += os_pieces(tot[r]);
  }
  int run = os_block_scan(sum, warp_sums);
  int p = os_block_scan(np, warp_sums);
  for (int r = lo; r < hi; ++r) {
    const int c = tot[r];
    seg[r] = run;
    run += c;
    if (r < T) {
      sub[r] = p;
      p += os_pieces(c);
    }
  }
  if (threadIdx.x == blockDim.x - 1) {
    seg[T1] = run;
    sub[T] = p;
  }
}

__global__ void __launch_bounds__(OS_THREADS)
os_place(const int* __restrict__ idx, int N, int T,
         const int* __restrict__ rank, const int* __restrict__ counts,
         const int* __restrict__ seg, const int* __restrict__ sub,
         int* __restrict__ perm, int* __restrict__ piece_row,
         unsigned* __restrict__ rowticket) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < N) {
    int b = __ldg(idx + n);
    if (b < 0 || b >= T) b = T;
    perm[seg[b] + counts[(n / OS_CHUNK) * (T + 1) + b] + rank[n]] = n;
  }
  for (int t = n; t < T; t += gridDim.x * blockDim.x) {
    rowticket[t] = 0u;
    for (int q = sub[t]; q < sub[t + 1]; ++q) piece_row[q] = t;
  }
}

// The block's sum of `len` rows of nv vectors, row q at src + off(q) * nv
// vectors (off(q) = rows[q], in global or shared memory, or q): point lane
// p (threadIdx.y) sums rows p, p + PL, ... in order, then a fixed tree over
// the lanes; thread (x, 0) stores vector v0 + x of the row at dst.  PERM
// reads g (float or bfloat16), else the float partial rows.
template <bool VEC, bool PERM, typename In, typename Out>
__device__ __forceinline__ void os_block_sum(
    const In* __restrict__ src, const int* __restrict__ rows, int len, int nv,
    Out* __restrict__ dst, typename OsVec<VEC>::T* red) {
  typedef OsVec<VEC> L;
  typedef typename L::T V;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int v0 = 0; v0 < nv; v0 += blockDim.x) {
    const int v = v0 + threadIdx.x;
    V acc;
    os_zero(acc);
    if (v < nv) {
#pragma unroll 4
      for (int q = threadIdx.y; q < len; q += blockDim.y) {
        if constexpr (PERM)
          acc = os_add(acc, L::ld(src, rows[q] * nv + v));
        else
          acc = os_add(acc, L::ldcg(src, q * nv + v));
      }
    }
    red[tid] = acc;
    __syncthreads();
    for (int h = blockDim.y >> 1; h > 0; h >>= 1) {
      if (threadIdx.y < h)
        red[tid] = os_add(red[tid], red[tid + h * blockDim.x]);
      __syncthreads();
    }
    if (threadIdx.y == 0 && v < nv) L::st(dst, v, red[threadIdx.x]);
    __syncthreads();
  }
}

template <bool VEC, typename In, typename Out>
__global__ void __launch_bounds__(OS_THREADS)
os_sum(const In* __restrict__ g, int C, int T, const int* __restrict__ perm,
       const int* __restrict__ seg, const int* __restrict__ sub,
       const int* __restrict__ piece_row, float* __restrict__ partial,
       unsigned* __restrict__ rowticket, Out* __restrict__ out) {
  typedef typename OsVec<VEC>::T V;
  __shared__ V red[OS_THREADS];
  __shared__ bool last;
  const int s = blockIdx.x;
  if (s >= sub[T]) return;                      // the grid is an upper bound
  const int t = piece_row[s];
  const int p0 = sub[t], np = sub[t + 1] - p0;
  const int j0 = seg[t] + (s - p0) * OS_SEG;
  const int len = min(OS_SEG, seg[t + 1] - j0);
  const int nv = VEC ? C >> 2 : C;
  if (np == 1) {                                // the row is this piece
    os_block_sum<VEC, true>(g, perm + j0, len, nv, out + t * C, red);
    return;
  }
  os_block_sum<VEC, true>(g, perm + j0, len, nv, partial + s * C, red);
  // the last piece of the row to finish sums the row's pieces in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0)
    last = atomicAdd(rowticket + t, 1u) == static_cast<unsigned>(np - 1);
  __syncthreads();
  if (!last) return;
  os_block_sum<VEC, false>(static_cast<const float*>(partial + p0 * C),
                           nullptr, np, nv, out + t * C, red);
}

// ---------------------------------------------------------------------------
// small N: one launch
// ---------------------------------------------------------------------------

template <bool VEC, typename In, typename Out>
__global__ void __launch_bounds__(OS_THREADS)
os_small(const In* __restrict__ g, const int* __restrict__ idx, int N,
         int C, int T, Out* __restrict__ out) {
  typedef typename OsVec<VEC>::T V;
  extern __shared__ int sm[];                   // row[N] | list[N]
  int* srow = sm;                               // the block's row of a point, or -1
  int* list = sm + N;                           // its points, by row
  __shared__ V red[OS_THREADS];
  __shared__ int wcnt[OS_WARPS][OS_SMALL_ROWS];
  __shared__ int start[OS_SMALL_ROWS + 1];      // the rows' first entries
  __shared__ int cursor[OS_SMALL_ROWS];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int r0 = blockIdx.x * OS_SMALL_ROWS;
  const int R = min(OS_SMALL_ROWS, T - r0);
  if (tid <= OS_SMALL_ROWS) start[tid] = 0;
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < N; i += OS_THREADS) {
    const unsigned r = static_cast<unsigned>(__ldg(idx + i)) -
                       static_cast<unsigned>(r0);
    srow[i] = (r < static_cast<unsigned>(R)) ? static_cast<int>(r) : -1;
  }
  __syncthreads();
  for (int i = tid; i < N; i += OS_THREADS)     // the rows' counts
    if (srow[i] >= 0) atomicAdd(start + srow[i] + 1, 1);
  __syncthreads();
  if (tid == 0)
    for (int r = 0; r < R; ++r) start[r + 1] += start[r];
  __syncthreads();
  if (tid < R) cursor[tid] = start[tid];
  // the list, 256 points at a time: a point's entry is its row's cursor, its
  // row's points in the earlier warps, and those of the earlier lanes
  for (int base = 0; base < N; base += OS_THREADS) {
    const int n = base + tid;
    const int r = (n < N) ? srow[n] : -1;
    if (!__syncthreads_or(r >= 0)) continue;
    unsigned mine = 0;
    for (int q = 0; q < R; ++q) {
      const unsigned m = __ballot_sync(0xffffffffu, r == q);
      if (lane == 0) wcnt[warp][q] = __popc(m);
      if (r == q) mine = m;
    }
    __syncthreads();
    if (r >= 0) {
      int pos = cursor[r] + __popc(mine & below);
      for (int w = 0; w < warp; ++w) pos += wcnt[w][r];
      list[pos] = n;
    }
    __syncthreads();
    if (tid < R) {
      int add = 0;
#pragma unroll
      for (int w = 0; w < OS_WARPS; ++w) add += wcnt[w][tid];
      cursor[tid] += add;
    }
  }
  __syncthreads();
  const int nv = VEC ? C >> 2 : C;
  for (int r = 0; r < R; ++r) {
    Out* dst = out + (r0 + r) * C;
    const int len = start[r + 1] - start[r];
    if (len == 0) {
      V z;
      os_zero(z);
      for (int v = tid; v < nv; v += OS_THREADS) OsVec<VEC>::st(dst, v, z);
    } else {
      os_block_sum<VEC, true>(g, list + start[r], len, nv, dst, red);
    }
  }
}

// Workspace (large N only; see ops/onehot_gather.py::scatter_workspace):
//   ints   rank[N] | perm[N] | counts[nchunks (T+1)] | seg[T+2] | sub[T+1]
//          | piece_row[P] | rowticket[T] | ticket[1],
//          P = ceil(N / OS_SEG) + T;
//   floats partial[P C].
// Takes the 4-channel instantiation where C % 4 == 0 and g and out start on
// a 4-channel boundary (16 bytes in float32, 8 in bfloat16) and (above
// OS_SMALL_N points) fws on 16 bytes, else the scalar-lane one; the two
// forms choose alike on buffers that torch allocates, so their sums match.
template <typename In, typename Out>
static int os_launch(const In* g, const int* idx, int N, int C, int T,
                     Out* out, int* iws, long long n_iws, float* fws,
                     long long n_fws, void* stream) {
  if (T <= 0 || T > OS_MAX_T || C <= 0 || N < 0 ||
      static_cast<long long>(N) * C >= (1LL << 31) ||
      static_cast<long long>(T) * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 =
      C % 4 == 0 && reinterpret_cast<uintptr_t>(g) % (4 * sizeof(In)) == 0 &&
      reinterpret_cast<uintptr_t>(out) % (4 * sizeof(Out)) == 0 &&
      (N <= OS_SMALL_N || reinterpret_cast<uintptr_t>(fws) % 16 == 0);
  cudaStream_t st = vt_stream(stream);
  const int nv = vec4 ? C / 4 : C;
  int lanes = 1;                                // channel vectors, then points
  while (lanes < nv && lanes < OS_THREADS) lanes <<= 1;
  const dim3 block(lanes, OS_THREADS / lanes);
  if (N <= OS_SMALL_N) {
    const int grid = vt_blocks(T, OS_SMALL_ROWS);
    const size_t smem = 2 * sizeof(int) * static_cast<size_t>(N);
    if (vec4)
      os_small<true, In, Out><<<grid, block, smem, st>>>(g, idx, N, C, T, out);
    else
      os_small<false, In, Out><<<grid, block, smem, st>>>(g, idx, N, C, T, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int T1 = T + 1;
  const int nchunks = (N + OS_CHUNK - 1) / OS_CHUNK;
  const long long pieces = (N + OS_SEG - 1) / OS_SEG + static_cast<long long>(T);
  const long long need_i = 2LL * N + static_cast<long long>(T1) * nchunks
                           + (T + 2) + T1 + pieces + T + 1;
  const long long need_f = pieces * C;
  if (iws == nullptr || fws == nullptr || n_iws < need_i || n_fws < need_f ||
      need_i >= (1LL << 31) || need_f >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int* rank = iws;
  int* perm = rank + N;
  int* counts = perm + N;
  int* seg = counts + static_cast<long long>(T1) * nchunks;
  int* sub = seg + (T + 2);
  int* piece_row = sub + T1;
  unsigned* rowticket = reinterpret_cast<unsigned*>(piece_row + pieces);
  unsigned* ticket = rowticket + T;

  const int stride = (T1 + 1) & ~1;
  const int smem = static_cast<int>(sizeof(unsigned short)) * OS_WARPS * stride;
  if (smem > 48 * 1024) {                       // T > 3,070: opt in
    const cudaError_t e = cudaFuncSetAttribute(
        os_rank, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  os_rank<<<nchunks, OS_THREADS, smem, st>>>(idx, N, T, rank, counts, ticket);
  os_scan<<<vt_blocks(T1, OS_SCAN_ROWS), OS_THREADS, 0, st>>>(
      counts, nchunks, T, seg, sub, ticket);
  os_place<<<vt_blocks(N, OS_THREADS), OS_THREADS, 0, st>>>(
      idx, N, T, rank, counts, seg, sub, perm, piece_row, rowticket);
  if (vec4)
    os_sum<true, In, Out><<<static_cast<int>(pieces), block, 0, st>>>(
        g, C, T, perm, seg, sub, piece_row, fws, rowticket, out);
  else
    os_sum<false, In, Out><<<static_cast<int>(pieces), block, 0, st>>>(
        g, C, T, perm, seg, sub, piece_row, fws, rowticket, out);
  return static_cast<int>(cudaGetLastError());
}

VT_EXPORT int vt_onehot_scatter(const float* g, const int* idx, int N,
                                int C, int T, float* out, int* iws,
                                long long n_iws, float* fws,
                                long long n_fws, void* stream) {
  return os_launch(g, idx, N, C, T, out, iws, n_iws, fws, n_fws, stream);
}

// g and out bfloat16 (their 16 bits); the workspace as vt_onehot_scatter's
VT_EXPORT int vt_onehot_scatter_bf16(const void* g, const int* idx, int N,
                                     int C, int T, void* out, int* iws,
                                     long long n_iws, float* fws,
                                     long long n_fws, void* stream) {
  return os_launch(static_cast<const unsigned short*>(g), idx, N, C, T,
                   static_cast<unsigned short*>(out), iws, n_iws, fws, n_fws,
                   stream);
}
