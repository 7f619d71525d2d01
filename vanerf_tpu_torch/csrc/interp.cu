// Kernel D — bilinear sample (border padding, align_corners=True) of a
// small channels-last map at N normalized points.
//
// Replaces the TPU kernel vanerf_tpu/ops/interp_mxu.py::mxu_grid_sample
// (body `_kernel`), which contracts per-tile hat weights against the
// VMEM-resident table on the MXU because TPU gathers are row-count bound.
//
// Bound on the H100: memory.  The map (32x32x64 f32 = 256 KB at most; it
// does not fit a block's 227 KB of shared memory) stays in L1/L2; per point
// the kernel reads one (u, v) pair and writes C values: 262,144 x 64 outputs
// are 67 MB, ~20 us at 3.35 TB/s.  Design: a group of L lanes per point,
// each lane owning VEC consecutive channels (VEC = 4: float4 corner loads
// through the read-only cache and one float4 streaming store; VEC = 1 for a
// channel count that is not a multiple of 4 or a base address that is not
// 16-byte aligned).  The block is 2-D, (L, 256 / L): threadIdx.x is the
// lane and threadIdx.y the point within the block, so no index is divided
// by a runtime channel count, and all index arithmetic is 32-bit (the
// entry point refuses N x C >= 2^31).  Each lane computes the point's
// weights once from one float2 load; a lane owning more than VEC channels
// (C > 4 L) strides over them.
//
// Numerics: the coordinates are clipped exactly as interp_mxu.py:116-119,
// (u + 1) * 0.5 * (W - 1) then clip to [0, W - 1]; after the clip the hat
// weight max(0, 1 - |x - j|) of the two bracketing columns is the bilinear
// weight.  The four corner products are summed in f32 in the fixed order
// w00 f00 + w01 f01 + w10 f10 + w11 f11 (built with -fmad=false, so each
// product and sum rounds on its own, as in the plain version).  A corner
// outside the map (only at x == W - 1 or y == H - 1) has hat weight
// exactly 0 and reads the clamped edge value instead.
//
// The bfloat16 body (vt_interp_bf16, the map and the output bfloat16,
// replacing the same TPU kernel on a bfloat16 table): each hat weight
// hx hy is made in f32 as above and rounded to bfloat16 before it
// multiplies its corner (interp_mxu.py:81 rounds the weights to the
// table's dtype); bfloat16 x bfloat16 is exact in f32, the four products
// are summed in f32 in the order above, and the sum is rounded to
// bfloat16 once (the MXU's f32 accumulator, then `.astype`).  So the
// kernel equals its plain twin bit for bit.  Half the bytes a channel:
// lanes own 8 channels, one 16-byte load a corner and one 16-byte store
// (C % 8 == 0, 16-byte aligned map and output, 8-byte aligned uv), else
// one channel each.  The main path's map is the 32^2 x 64 geometry
// coarse map: 262,144 x 64 bfloat16 outputs are 34 MB, ~10 us at 3.35
// TB/s.

// A launch takes a batch (the JAX package's vmap, as a grid dimension):
// element e of B (blockIdx.y) samples map e % Bm of a (Bm, H, W, C) stack
// at its own (N, 2) points into its own (N, C) rows, so the G tiles of one
// frame in a tile group read the frame's map.  Maps, points and outputs of
// an element start on the boundaries of the element's own launch (H W C
// and N C are multiples of the lane width where the vector lanes are
// taken), and its arithmetic does not depend on the batch: each element
// equals its launch at B = 1 bit for bit.  The batch offsets are 64-bit.

#include "bf16.cuh"
#include "common.cuh"

#include <cstdint>

#define IP_THREADS 256
#define IP_MAX_LANES 32

struct Corners {
  int o00, o01, o10, o11;              // element offsets of the corner rows
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Corners ip_corners(float u, float v, int H, int W,
                                              int C) {
  const float wm1 = static_cast<float>(W - 1);
  const float hm1 = static_cast<float>(H - 1);
  const float x = fminf(fmaxf((u + 1.0f) * 0.5f * wm1, 0.0f), wm1);
  const float y = fminf(fmaxf((v + 1.0f) * 0.5f * hm1, 0.0f), hm1);
  const float x0 = floorf(x), y0 = floorf(y);
  const float hx0 = fmaxf(0.0f, 1.0f - fabsf(x - x0));
  const float hx1 = fmaxf(0.0f, 1.0f - fabsf(x - (x0 + 1.0f)));
  const float hy0 = fmaxf(0.0f, 1.0f - fabsf(y - y0));
  const float hy1 = fmaxf(0.0f, 1.0f - fabsf(y - (y0 + 1.0f)));
  const int ix0 = static_cast<int>(x0), iy0 = static_cast<int>(y0);
  const int ix1 = min(ix0 + 1, W - 1), iy1 = min(iy0 + 1, H - 1);
  Corners k;
  k.o00 = (iy0 * W + ix0) * C;
  k.o01 = (iy0 * W + ix1) * C;
  k.o10 = (iy1 * W + ix0) * C;
  k.o11 = (iy1 * W + ix1) * C;
  k.w00 = hx0 * hy0;
  k.w01 = hx1 * hy0;
  k.w10 = hx0 * hy1;
  k.w11 = hx1 * hy1;
  return k;
}

// The element offsets of element blockIdx.y, in elements of the map (map
// e % Bm), the points and the outputs.  Only the BATCHED instantiations
// take them (element 0 none), so a B = 1 launch runs the unbatched body: a
// 64-bit remainder a thread cost it ~40% of its time on the H100, the
// 32-bit one behind a branch ~2%.
struct ElemOff {
  size_t feat, uv, out;
};

__device__ __forceinline__ ElemOff ip_element(int H, int W, int C, int Bm,
                                              int N) {
  const unsigned e = blockIdx.y, m = e % static_cast<unsigned>(Bm);
  ElemOff o;
  o.feat = static_cast<size_t>(m) * (static_cast<size_t>(H) * W * C);
  o.uv = static_cast<size_t>(e) * (2 * static_cast<size_t>(N));
  o.out = static_cast<size_t>(e) * (static_cast<size_t>(N) * C);
  return o;
}

__device__ __forceinline__ float ip_mix(const Corners& k, float f00,
                                        float f01, float f10, float f11) {
  return k.w00 * f00 + k.w01 * f01 + k.w10 * f10 + k.w11 * f11;
}

template <bool VEC4, bool BATCHED>
__global__ void __launch_bounds__(IP_THREADS)
interp_kernel(const float* __restrict__ feat, int H, int W, int C, int Bm,
              const float* __restrict__ uv, int N, float* __restrict__ out) {
  if (BATCHED && blockIdx.y != 0) {
    const ElemOff o = ip_element(H, W, C, Bm, N);
    feat += o.feat;
    uv += o.uv;
    out += o.out;
  }
  const int n = blockIdx.x * blockDim.y + threadIdx.y;
  if (n >= N) return;
  float u, v;
  if (VEC4) {
    const float2 p = __ldg(reinterpret_cast<const float2*>(uv) + n);
    u = p.x;
    v = p.y;
  } else {
    u = __ldg(uv + 2 * n);
    v = __ldg(uv + 2 * n + 1);
  }
  const Corners k = ip_corners(u, v, H, W, C);
  if (VEC4) {
    const int nv = C >> 2;
    const float4* f00 = reinterpret_cast<const float4*>(feat + k.o00);
    const float4* f01 = reinterpret_cast<const float4*>(feat + k.o01);
    const float4* f10 = reinterpret_cast<const float4*>(feat + k.o10);
    const float4* f11 = reinterpret_cast<const float4*>(feat + k.o11);
    float4* dst = reinterpret_cast<float4*>(out) + n * nv;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      const float4 a = __ldg(f00 + c), b = __ldg(f01 + c);
      const float4 d = __ldg(f10 + c), e = __ldg(f11 + c);
      float4 r;
      r.x = ip_mix(k, a.x, b.x, d.x, e.x);
      r.y = ip_mix(k, a.y, b.y, d.y, e.y);
      r.z = ip_mix(k, a.z, b.z, d.z, e.z);
      r.w = ip_mix(k, a.w, b.w, d.w, e.w);
      __stcs(dst + c, r);
    }
  } else {
    float* dst = out + n * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      __stcs(dst + c, ip_mix(k, __ldg(feat + k.o00 + c),
                             __ldg(feat + k.o01 + c),
                             __ldg(feat + k.o10 + c),
                             __ldg(feat + k.o11 + c)));
  }
}

// the weights as the bfloat16 body multiplies them: rounded to bfloat16
__device__ __forceinline__ void ip_round_weights(Corners& k) {
  k.w00 = vt_bf16_round(k.w00);
  k.w01 = vt_bf16_round(k.w01);
  k.w10 = vt_bf16_round(k.w10);
  k.w11 = vt_bf16_round(k.w11);
}

// two channels (a 32-bit word of two bfloat16 from each corner)
__device__ __forceinline__ unsigned ip_mix2(const Corners& k, unsigned a,
                                            unsigned b, unsigned d,
                                            unsigned e) {
  return vt_bf16_pack(
      ip_mix(k, vt_bf16_lo(a), vt_bf16_lo(b), vt_bf16_lo(d), vt_bf16_lo(e)),
      ip_mix(k, vt_bf16_hi(a), vt_bf16_hi(b), vt_bf16_hi(d), vt_bf16_hi(e)));
}

template <bool VEC8, bool BATCHED>
__global__ void __launch_bounds__(IP_THREADS)
interp_bf16_kernel(const unsigned short* __restrict__ feat, int H, int W,
                   int C, int Bm, const float* __restrict__ uv, int N,
                   unsigned short* __restrict__ out) {
  if (BATCHED && blockIdx.y != 0) {
    const ElemOff o = ip_element(H, W, C, Bm, N);
    feat += o.feat;
    uv += o.uv;
    out += o.out;
  }
  const int n = blockIdx.x * blockDim.y + threadIdx.y;
  if (n >= N) return;
  float u, v;
  if (VEC8) {
    const float2 p = __ldg(reinterpret_cast<const float2*>(uv) + n);
    u = p.x;
    v = p.y;
  } else {
    u = __ldg(uv + 2 * n);
    v = __ldg(uv + 2 * n + 1);
  }
  Corners k = ip_corners(u, v, H, W, C);
  ip_round_weights(k);
  if (VEC8) {
    const int nv = C >> 3;
    const uint4* f00 = reinterpret_cast<const uint4*>(feat + k.o00);
    const uint4* f01 = reinterpret_cast<const uint4*>(feat + k.o01);
    const uint4* f10 = reinterpret_cast<const uint4*>(feat + k.o10);
    const uint4* f11 = reinterpret_cast<const uint4*>(feat + k.o11);
    uint4* dst = reinterpret_cast<uint4*>(out) + n * nv;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      const uint4 a = __ldg(f00 + c), b = __ldg(f01 + c);
      const uint4 d = __ldg(f10 + c), e = __ldg(f11 + c);
      uint4 r;
      r.x = ip_mix2(k, a.x, b.x, d.x, e.x);
      r.y = ip_mix2(k, a.y, b.y, d.y, e.y);
      r.z = ip_mix2(k, a.z, b.z, d.z, e.z);
      r.w = ip_mix2(k, a.w, b.w, d.w, e.w);
      __stcs(dst + c, r);
    }
  } else {
    unsigned short* dst = out + n * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      dst[c] = vt_bf16_bits(ip_mix(k, vt_bf16_float(__ldg(feat + k.o00 + c)),
                                   vt_bf16_float(__ldg(feat + k.o01 + c)),
                                   vt_bf16_float(__ldg(feat + k.o10 + c)),
                                   vt_bf16_float(__ldg(feat + k.o11 + c))));
  }
}

// Takes the float4 instantiation where C % 4 == 0, feat and out are 16-byte
// and uv 8-byte aligned (a slice of a batch may start anywhere), else the
// scalar-lane one.  `feat` (Bm, H, W, C), `uv` (B, N, 2), `out` (B, N, C).
VT_EXPORT int vt_interp(const float* feat, int H, int W, int C, int Bm,
                        const float* uv, int N, int B, float* out,
                        void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || N < 0 || Bm <= 0 || B <= 0 ||
      B > 65535 ||
      static_cast<long long>(N) * C >= (1LL << 31) ||
      static_cast<long long>(H) * W * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(uv) % 8 == 0;
  if (N == 0) return 0;
  // lanes per point: the channel vectors, rounded up to a power of two
  // (at most IP_MAX_LANES); the rest of the block's threads are points
  const int nv = vec4 ? C / 4 : C;
  int lanes = 1;
  while (lanes < nv && lanes < IP_MAX_LANES) lanes <<= 1;
  const dim3 block(lanes, IP_THREADS / lanes);
  const dim3 grid(vt_blocks(N, static_cast<int>(block.y)), B);
  typedef void (*Kernel)(const float*, int, int, int, int, const float*, int,
                         float*);
  const Kernel k = vec4 ? (B > 1 ? interp_kernel<true, true>
                                 : interp_kernel<true, false>)
                        : (B > 1 ? interp_kernel<false, true>
                                 : interp_kernel<false, false>);
  k<<<grid, block, 0, vt_stream(stream)>>>(feat, H, W, C, Bm, uv, N, out);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 body: the 8-channel instantiation where C % 8 == 0, feat
// and out are 16-byte and uv 8-byte aligned, else the scalar-lane one.
VT_EXPORT int vt_interp_bf16(const unsigned short* feat, int H, int W, int C,
                             int Bm, const float* uv, int N, int B,
                             unsigned short* out, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || N < 0 || Bm <= 0 || B <= 0 ||
      B > 65535 ||
      static_cast<long long>(N) * C >= (1LL << 31) ||
      static_cast<long long>(H) * W * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec8 = C % 8 == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(uv) % 8 == 0;
  if (N == 0) return 0;
  const int nv = vec8 ? C / 8 : C;
  int lanes = 1;
  while (lanes < nv && lanes < IP_MAX_LANES) lanes <<= 1;
  const dim3 block(lanes, IP_THREADS / lanes);
  const dim3 grid(vt_blocks(N, static_cast<int>(block.y)), B);
  typedef void (*Kernel)(const unsigned short*, int, int, int, int,
                         const float*, int, unsigned short*);
  const Kernel k = vec8 ? (B > 1 ? interp_bf16_kernel<true, true>
                                 : interp_bf16_kernel<true, false>)
                        : (B > 1 ? interp_bf16_kernel<false, true>
                                 : interp_bf16_kernel<false, false>);
  k<<<grid, block, 0, vt_stream(stream)>>>(feat, H, W, C, Bm, uv, N, out);
  return static_cast<int>(cudaGetLastError());
}
