// Kernel 14 — feat_sample_nhwc in one pass: the bilinear sample (border
// padding, align_corners=True) of a channels-last map at N normalized
// points, equal to the bit to the plain version's gather and lerp.
//
// Replaces no TPU kernel: the JAX package leaves this op to XLA's gather
// (vanerf_tpu/ops/grid_sample.py::feat_sample_nhwc).  It was added because
// on the H100 the plain version (about a dozen elementwise launches for the
// coordinates and int64 indices, four native row gathers, eight lerp
// launches over (B, N, C)) took 36 ms of a 256^2 one-view frame and 147 ms
// of a two-view one for 20 output channels a point, on the three maps the
// query samples without kernel D (the 256^2 x 4 mask + image, the 128^2 x 8
// fine geometry map, the 64^2 x 8 texture map).
//
// Bound on the H100: memory.  Per point the kernel reads one (u, v) pair and
// writes C values, 8 + 4 C bytes in float32: the one-view frame's three maps
// at 8.4 M points a pass are ~0.9 GB a frame, ~0.26 ms at 3.35 TB/s.  The
// corners come from a map of at most 1 MB an element (256^2 x 4 f32), which
// stays in L2.  Design, as kernel D's: a group of L lanes per point, each
// lane owning VEC consecutive channels; corners read through the read-only
// path in 16-byte units where C % VEC == 0 and every base is aligned (f32:
// VEC 4; bfloat16: VEC 8, or VEC 4 in 8-byte units), else one channel a
// lane; one streaming store a unit.  The block is 2-D, (L, 256 / L), so no
// index is divided by a runtime channel count; index math is 32-bit (the
// entry point refuses N C >= 2^31 or H W C >= 2^31) but for the batch
// offsets, which are 64-bit.
//
// Numerics: every operation of feat_sample_nhwc, in its order and rounding
// (built with -fmad=false, so each product and sum rounds on its own):
//   x = clamp((u + 1) * 0.5 * (W - 1), 0, W - 1), likewise y;
//   x0 = clamp(floor(x), 0, W - 1); wx = x - x0 (rounded to the map's
//   dtype); the corners (x0, y0), (min(x0 + 1, W - 1), y0), ...;
//   top = f00 (1 - wx) + f01 wx, bot = f10 (1 - wx) + f11 wx,
//   out = top (1 - wy) + bot wy.
// A clamp keeps a NaN as torch.clamp does, so a NaN coordinate gives a NaN
// row (its corner index converts to 0, as the plain version's int64 cast
// does on the card).  On a bfloat16 map each of those values rounds to
// bfloat16 where torch's bfloat16 elementwise ops round: wx and wy, 1 - w,
// every product and every sum (each computed in f32 from bfloat16 inputs).
//
// A launch takes a batch as kernel D does: element e of B (blockIdx.y)
// samples map e % Bm of a (Bm, H, W, C) stack at its own (N, 2) points
// into its own (N, C) rows.

#include "bf16.cuh"
#include "common.cuh"

#include <cstdint>

#define BL_THREADS 256
#define BL_MAX_LANES 32

// torch.clamp: a NaN stays NaN
__device__ __forceinline__ float bl_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

struct BlCell {
  int o00, o01, o10, o11;              // element offsets of the corner rows
  float wx, wy;                        // x - x0, y - y0 in float32
};

__device__ __forceinline__ BlCell bl_cell(float u, float v, int H, int W,
                                          int C) {
  const float wm1 = static_cast<float>(W - 1);
  const float hm1 = static_cast<float>(H - 1);
  const float x = bl_clamp((u + 1.0f) * 0.5f * wm1, 0.0f, wm1);
  const float y = bl_clamp((v + 1.0f) * 0.5f * hm1, 0.0f, hm1);
  const float x0 = bl_clamp(floorf(x), 0.0f, wm1);
  const float y0 = bl_clamp(floorf(y), 0.0f, hm1);
  // NaN converts to 0 (cvt.rzi); the clamps keep any read inside the map
  const int ix0 = min(max(__float2int_rz(x0), 0), W - 1);
  const int iy0 = min(max(__float2int_rz(y0), 0), H - 1);
  const int ix1 = min(ix0 + 1, W - 1), iy1 = min(iy0 + 1, H - 1);
  BlCell k;
  k.o00 = (iy0 * W + ix0) * C;
  k.o01 = (iy0 * W + ix1) * C;
  k.o10 = (iy1 * W + ix0) * C;
  k.o11 = (iy1 * W + ix1) * C;
  k.wx = x - x0;
  k.wy = y - y0;
  return k;
}

// The storage type's widening, rounding and narrowing: float32 rounds in
// every operation already; bfloat16 (its bits in an unsigned short) rounds
// each value to bfloat16 as a torch elementwise op does.
template <typename T>
struct BlNum;

template <>
struct BlNum<float> {
  static __device__ __forceinline__ float wide(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float narrow(float x) { return x; }
};

template <>
struct BlNum<unsigned short> {
  static __device__ __forceinline__ float wide(unsigned short b) {
    return vt_bf16_float(b);
  }
  static __device__ __forceinline__ float round(float x) {
    return vt_bf16_round(x);
  }
  static __device__ __forceinline__ unsigned short narrow(float x) {
    return vt_bf16_bits(x);
  }
};

// the load / store unit of VEC values of T
template <int BYTES>
struct BlRaw;
template <>
struct BlRaw<16> { typedef uint4 type; };
template <>
struct BlRaw<8> { typedef uint2 type; };
template <>
struct BlRaw<4> { typedef unsigned type; };
template <>
struct BlRaw<2> { typedef unsigned short type; };

template <typename T, int VEC>
union BlUnit {
  typename BlRaw<sizeof(T) * VEC>::type raw;
  T v[VEC];
};

// The weights as the lerp multiplies them: wx, wy and 1 - w in the map's
// dtype.
struct BlW {
  float wx, wy, omx, omy;
};

template <typename T>
__device__ __forceinline__ BlW bl_weights(const BlCell& k) {
  typedef BlNum<T> N;
  BlW w;
  w.wx = N::round(k.wx);
  w.wy = N::round(k.wy);
  w.omx = N::round(1.0f - w.wx);
  w.omy = N::round(1.0f - w.wy);
  return w;
}

template <typename T>
__device__ __forceinline__ T bl_mix(const BlW& w, T a, T b, T d, T e) {
  typedef BlNum<T> N;
  const float top = N::round(N::round(N::wide(a) * w.omx)
                             + N::round(N::wide(b) * w.wx));
  const float bot = N::round(N::round(N::wide(d) * w.omx)
                             + N::round(N::wide(e) * w.wx));
  return N::narrow(N::round(top * w.omy) + N::round(bot * w.wy));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(BL_THREADS)
bilinear_kernel(const T* __restrict__ feat, int H, int W, int C, int Bm,
                const float* __restrict__ uv, int N, T* __restrict__ out) {
  typedef typename BlRaw<sizeof(T) * VEC>::type U;
  // element blockIdx.y's map (e % Bm), points and rows; element 0 takes no
  // offset arithmetic, the others a 32-bit remainder
  if (blockIdx.y != 0) {
    const unsigned e = blockIdx.y, m = e % static_cast<unsigned>(Bm);
    feat += static_cast<size_t>(m) * (static_cast<size_t>(H) * W * C);
    uv += static_cast<size_t>(e) * (2 * static_cast<size_t>(N));
    out += static_cast<size_t>(e) * (static_cast<size_t>(N) * C);
  }
  const int n = blockIdx.x * blockDim.y + threadIdx.y;
  if (n >= N) return;
  float u, v;
  if (VEC > 1) {
    const float2 p = __ldg(reinterpret_cast<const float2*>(uv) + n);
    u = p.x;
    v = p.y;
  } else {
    u = __ldg(uv + 2 * n);
    v = __ldg(uv + 2 * n + 1);
  }
  const BlCell k = bl_cell(u, v, H, W, C);
  const BlW w = bl_weights<T>(k);
  const int nv = C / VEC;
  const U* f00 = reinterpret_cast<const U*>(feat + k.o00);
  const U* f01 = reinterpret_cast<const U*>(feat + k.o01);
  const U* f10 = reinterpret_cast<const U*>(feat + k.o10);
  const U* f11 = reinterpret_cast<const U*>(feat + k.o11);
  U* dst = reinterpret_cast<U*>(out) + n * nv;
  for (int c = threadIdx.x; c < nv; c += blockDim.x) {
    BlUnit<T, VEC> a, b, d, e, r;
    a.raw = __ldg(f00 + c);
    b.raw = __ldg(f01 + c);
    d.raw = __ldg(f10 + c);
    e.raw = __ldg(f11 + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      r.v[i] = bl_mix<T>(w, a.v[i], b.v[i], d.v[i], e.v[i]);
    __stcs(dst + c, r.raw);
  }
}

template <typename T, int VEC>
static void bl_launch(const T* feat, int H, int W, int C, int Bm,
                      const float* uv, int N, int B, T* out, void* stream) {
  // lanes per point: the channel units, rounded up to a power of two (at
  // most BL_MAX_LANES); the rest of the block's threads are points
  const int nv = C / VEC;
  int lanes = 1;
  while (lanes < nv && lanes < BL_MAX_LANES) lanes <<= 1;
  const dim3 block(lanes, BL_THREADS / lanes);
  const dim3 grid(vt_blocks(N, static_cast<int>(block.y)), B);
  bilinear_kernel<T, VEC><<<grid, block, 0, vt_stream(stream)>>>(
      feat, H, W, C, Bm, uv, N, out);
}

static bool bl_args_ok(int H, int W, int C, int Bm, int N, int B) {
  return H > 0 && W > 0 && C > 0 && N >= 0 && Bm > 0 && B > 0 &&
         B <= 65535 && static_cast<long long>(N) * C < (1LL << 31) &&
         static_cast<long long>(H) * W * C < (1LL << 31);
}

// every base a multiple of `bytes` (uv of 8: one float2 a point)
static bool bl_aligned(const void* feat, const float* uv, const void* out,
                       int bytes) {
  return reinterpret_cast<uintptr_t>(feat) % bytes == 0 &&
         reinterpret_cast<uintptr_t>(out) % bytes == 0 &&
         reinterpret_cast<uintptr_t>(uv) % 8 == 0;
}

// `feat` (Bm, H, W, C), `uv` (B, N, 2), `out` (B, N, C), all float32: the
// float4 instantiation where C % 4 == 0 and the bases allow it, else the
// scalar-lane one.
VT_EXPORT int vt_bilinear(const float* feat, int H, int W, int C, int Bm,
                          const float* uv, int N, int B, float* out,
                          void* stream) {
  if (!bl_args_ok(H, W, C, Bm, N, B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  if (C % 4 == 0 && bl_aligned(feat, uv, out, 16))
    bl_launch<float, 4>(feat, H, W, C, Bm, uv, N, B, out, stream);
  else
    bl_launch<float, 1>(feat, H, W, C, Bm, uv, N, B, out, stream);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 map and output (their bits), float32 points: 8 channels in
// 16 bytes where C % 8 == 0, 4 in 8 bytes where C % 4 == 0, else one a
// lane.
VT_EXPORT int vt_bilinear_bf16(const unsigned short* feat, int H, int W,
                               int C, int Bm, const float* uv, int N, int B,
                               unsigned short* out, void* stream) {
  if (!bl_args_ok(H, W, C, Bm, N, B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  if (C % 8 == 0 && bl_aligned(feat, uv, out, 16))
    bl_launch<unsigned short, 8>(feat, H, W, C, Bm, uv, N, B, out, stream);
  else if (C % 4 == 0 && bl_aligned(feat, uv, out, 8))
    bl_launch<unsigned short, 4>(feat, H, W, C, Bm, uv, N, B, out, stream);
  else
    bl_launch<unsigned short, 1>(feat, H, W, C, Bm, uv, N, B, out, stream);
  return static_cast<int>(cudaGetLastError());
}
