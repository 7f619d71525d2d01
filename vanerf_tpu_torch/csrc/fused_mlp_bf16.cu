// Kernels 12 and 11 in bfloat16 — the per-point query network in one
// launch a pass, redesigned for Hopper's warpgroup products.
//
//   vt_fused_geo_mlp_bf16   (12) replaces vanerf_tpu/ops/fused_mlp.py::
//     fused_geo_mlp (body `_kernel`) with cdt = bfloat16: the rel_z_decay
//     encoding, MLPUNetFusion at one source view and the gcompress latent.
//   vt_fused_query_mlp_bf16 (11) replaces ::fused_query_mlp (body
//     `_kernel_full`) with cdt = bfloat16: kernel 12's body between
//     GeoVisFusion's two gate / fuse scales and TexVisFusion's gate / fuse
//     with the V=1 rgb columns, reading the raw KNN gather rows.
//   vt_fm_act_bf16_all evaluates the body's softplus or sigmoid on all
//     65,536 bfloat16 inputs (chip_smoke.py holds it to the plain version,
//     bit for bit).
//
// Bound on the H100: operations.  ~140k (11) / ~102k (12) multiply-adds a
// point on the tensor cores at 989 TFLOP/s dense bfloat16, the epilogue
// (bias, two roundings and an activation per element, ~965 / ~640 elements
// a point) on the CUDA cores; bytes are ~0.05 / ~0.02 ms.
//
// Numerics: those of the plain version (ops/fused_mlp.py).  The 16-row
// k-steps of a layer sum on the tensor cores from zero (f32 accumulation),
// the bias is added after, and each value is rounded to bfloat16 where the
// JAX kernel rounds (vanerf_tpu/ops/fused_mlp.py:88-119, :199-222): the
// encoding (f32 math, rounded), each layer's sum with its bias, the
// activation's result, the gate scaling, the pooled mean and variance;
// `out` (sdf residual, radiance) is the f32 sum, not rounded.
//
// Design (PERF.md section 6 has the breakdown it answers).
//  * Products: wgmma.mma_async m64nNk16 .f32.bf16.bf16, N the layer's width
//    rounded up to a multiple of 8 (128, 120, 96, 64, 24, 16, 8).  A
//    consumer warpgroup owns 64 points; its warp w owns points 16w..16w+15
//    of them, as rows of A and of the accumulator, so each warp still reads
//    and writes only its own points' columns of shared memory.
//  * B from the TMA ring through a shared-memory descriptor: the packed
//    stream holds each 16-row k-step of a layer as K-major core matrices
//    without swizzle, [n8 group j][k half h][8 columns][8 rows] (128 bytes a
//    core matrix; leading byte offset 128 between the k halves, stride byte
//    offset 256 between the n8 groups).  A producer warp copies items of
//    whole k-steps (at most one 16 KB slot) into a ring of four on `full`
//    mbarriers; each consumer warp releases an item on its `empty`
//    mbarrier once its products that read it have completed
//    (wgmma.wait_group: each warp's tensor core reads B for its own 16
//    rows).  The order is fm_schedule's (host side, below; ops/
//    fused_mlp.py::_pack lays the stream out in it), checked on the host
//    against the stream's size; a wait that times out traps.
//  * A from registers.  An m64nNk16 accumulator's n8 tiles 2j and 2j + 1,
//    after the epilogue, are the register A fragment of k-step j of the
//    next product (as FlashAttention-3's P V), so every chain stays in
//    registers: the gate hidden -> gate and fuse hidden -> fuse layers,
//    layers1 0 -> 1 -> 2 -> 3, the pooled [mean | var] -> layers2 and the
//    latent, layers2 4 -> 5 -> 6.  The virtual concats in shared memory
//    (the encoding chunks, fused0 / fused1, the gate-scaled inputs) are
//    read as `[channel][point]` rows by ldmatrix.x4.trans into the same
//    fragments (one 16-byte row a lane; the row stride, 400 bytes = 4 mod
//    32 words, puts a matrix's 8 rows on 32 banks): that reads the rows as
//    they stand, which a descriptor could not (its core matrices are 128
//    contiguous bytes), at the same bytes per product.  wgmma reads its A
//    registers after issue, so those of the k-step in flight are not
//    written until the wait that completes it (two alternating sets).
//  * Softplus and sigmoid exact and fast.  The activation's input is a
//    bfloat16 value v (the rounded sum), its result is rounded: softplus
//    takes the intrinsics (__expf, __logf) for v in [-0.01, 0.2], a table
//    of the plain formula's results below (1,024 bfloat16 inputs in (-2,
//    -2^-7], 0 from -2 down), and v itself above; the sigmoid the
//    intrinsics for |v| <= 8.  A fast result whose f32 bits lie within
//    FW_NEAR units of the last place of a bfloat16 rounding boundary (or
//    an input outside those ranges) is recomputed by the plain version's
//    formula, so the bfloat16 result is the plain version's on every input
//    (chip_smoke.py phase 2b checks all 65,536).
//  * Occupancy: one block an SM, three consumer warpgroups (192 points,
//    three consumer warps a scheduler, against the float32 body's two) and
//    the producer warp, 416 threads (ptxas holds them to 128 registers;
//    kernel 11 spills 44 bytes), ~165 KB of shared memory.  Two blocks an
//    SM of two warpgroups each (the other way to more warps a scheduler)
//    were slower on the card: with the producer warp a block is 9 warps,
//    allocated as 10, which leaves 96 registers a thread, and ptxas spills
//    and serialises the products (C7512); PERF.md section 6 has the times.
//  * The epilogue packs: two neighbouring columns are rounded by one
//    cvt.rn.bf16x2.f32, relu is max.bf16x2, a layer's biases are read tile
//    by tile; the inputs are read 16 loads a lane in flight.

#include <type_traits>

#include "bf16.cuh"
#include "common.cuh"
#include "tma.cuh"

#define FW_WG 3                    // consumer warpgroups, 64 points each
#define FW_TP (64 * FW_WG)         // points a block
#define FW_CW (4 * FW_WG)          // consumer warps
#define FW_NT ((FW_CW + 1) * 32)   // + the producer warp
#define FW_TPS (FW_TP + 8)         // shared row stride, elements
#define FW_R 4                     // ring slots
#define FW_SLOT 16384              // bytes a slot
#define FW_XA_ROWS 196             // bfloat16 rows (kernel 11's first input)
#define FW_F32_ROWS 24             // S, G, O
#define FW_TAB 1024                // softplus table entries
#define FW_TAB0 0xBC00u            // its first bfloat16 input, -2^-7
#define FW_NEAR 64                 // the boundary test's width, f32 units
                                   // of the last place
// the widths the body is built for (configs/vanerf.json)
#define FW_D1 128
#define FW_D2 128
#define FW_D3 120
#define FW_E1 64
#define FW_E2 64
#define FW_LAT 24
// arena rows, reused phase by phase as in the float32 body
#define FW_R_F0 0      // fused0 (kernel 11: written over its input)
#define FW_R_X1 64     // kernel 11: the second gate / fuse input, 28 rows
#define FW_R_F1 64     // fused1 (written over it)
#define FW_R_PE 72     // the encoding, a chunk of keypoints
#define FW_R_TX 100    // kernel 11: the texture input, 96 rows (the latent
                       // at its rows 69-92)
#define FW_R_LAT 0     // kernel 12: the latent

#define FM_MAX_ITEMS 1024         // items a launch
#define FM_F0 64         // fused0 / x_view width
#define FM_F1 8          // fused1 width
#define FM_PE_ROWS 120   // rows a chunk of the encoding may fill (a multiple
                         // of 8)
#define FM_TRIES (1u << 22)       // polls of a ring barrier before a trap
#define FM_MAX_BIAS 840  // the geometry biases at the widest (5 x 128 + 64
                         // + 2 + 96 = 802) and the 31 words past them that
                         // the last layer's padding columns read

struct FmGeo {
  const float* cxyz;   // (N, 3) camera-frame points
  const float* kpt_T;  // (3, K) camera-frame keypoints
  const float* b;      // biases b0..b7
  int N, K, L;
  float scale, inv_two_sig2;
  int d1, d2, d3;      // layers1 widths (the last is FM_F0)
  int e1, e2;          // layers2 hidden widths (the last is 2)
  int lat;             // gcompress width
};

// The items of the weight stream in the order the consumers take them:
// runs of consecutive k-tiles of at most one ring slot, each item's size
// in tiles (a tile: one k-tile of one n8 column group).
struct FmSched {
  int n;
  unsigned char tiles[FM_MAX_ITEMS];
};

__host__ __device__ __forceinline__ int fm_pe_per(int P) {
  return FM_PE_ROWS / P;  // keypoints a chunk of the encoding
}

enum { FW_NONE = 0, FW_SOFTPLUS, FW_RELU, FW_SIGMOID, FW_OUT };

// ---------------------------------------------------------------------------
// the activations on bfloat16 inputs, rounded to bfloat16
// ---------------------------------------------------------------------------

// The plain version's formulas on the card (torch's logaddexp and sigmoid:
// the accurate expf / log1pf and an IEEE division).
__device__ __noinline__ float fw_softplus_acc(float v) {
  const float xb = v * 100.0f;
  return xb > 20.0f ? v
                    : (fmaxf(xb, 0.0f) + log1pf(expf(-fabsf(xb)))) * 0.01f;
}

__device__ __noinline__ float fw_sigmoid_acc(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// r lies within FW_NEAR units of its last place of a point halfway between
// two bfloat16 values, where an error that size could move its rounding.
// The fast forms below err by at most ~40 units against the plain version
// (the intrinsics' documented bounds plus the accurate functions' 2 ulp).
__device__ __forceinline__ bool fw_near(float r) {
  return ((__float_as_uint(r) + (FW_NEAR - 0x8000u)) & 0xFFFFu) <=
         2u * FW_NEAR;
}

// softplus (beta 100, threshold 20) of a bfloat16 value v: an f32 value
// whose rounding to bfloat16 is the plain version's
__device__ __forceinline__ float fw_softplus(float v,
                                             const unsigned short* tab) {
  const float x = v * 100.0f;  // exact: 8 + 7 significant bits
  const float r =
      (fmaxf(x, 0.0f) + __logf(1.0f + __expf(-fabsf(x)))) * 0.01f;
  const unsigned i = (__float_as_uint(v) >> 16) - FW_TAB0;
  const float t = i < FW_TAB ? vt_bf16_float(tab[i < FW_TAB ? i : 0u]) : 0.0f;
  const bool mid = !(x > 20.0f) && !(x < -1.0f);  // NaN included
  float out = x > 20.0f ? v : (x < -1.0f ? t : r);
  if (__builtin_expect(mid && (fw_near(r) || !(x == x)), 0))
    out = fw_softplus_acc(v);
  return out;
}

// the sigmoid of a bfloat16 value v, likewise
__device__ __forceinline__ float fw_sigmoid(float v) {
  const float r = __frcp_rn(1.0f + __expf(-v));
  if (__builtin_expect(!(fabsf(v) <= 8.0f) || fw_near(r), 0))
    return fw_sigmoid_acc(v);
  return r;
}

// two f32 values rounded to bfloat16 (to nearest, ties to even) and
// packed, lo in the low half: one instruction
__device__ __forceinline__ unsigned fw_pack(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// softplus of the bfloat16 inputs (-2, -2^-7], by the plain formula
__device__ __forceinline__ void fw_fill_table(unsigned short* tab) {
  for (int i = threadIdx.x; i < FW_TAB; i += blockDim.x)
    tab[i] = vt_bf16_bits(fw_softplus_acc(vt_bf16_float(FW_TAB0 + i)));
}

__global__ void fw_act_all_kernel(int act, unsigned short* out) {
  __shared__ unsigned short tab[FW_TAB];
  fw_fill_table(tab);
  __syncthreads();
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const float v = vt_bf16_float(static_cast<unsigned short>(i));
  out[i] = vt_bf16_bits(act == FW_SOFTPLUS ? fw_softplus(v, tab)
                                           : fw_sigmoid(v));  // rounded
}

// ---------------------------------------------------------------------------
// warpgroup products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fw_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void fw_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void fw_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// Registers an in-flight product reads or writes are kept from the
// compiler until its wait: they stay allocated, and are read after it.
template <int R>
__device__ __forceinline__ void fw_keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fw_keep(unsigned (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// the descriptor of a k-step's B (the layout of the source note)
__device__ __forceinline__ unsigned long long fw_desc(const void* p) {
  return static_cast<unsigned long long>((smem_addr(p) & 0x3FFFFu) >> 4) |
         (static_cast<unsigned long long>(128 >> 4) << 16) |
         (static_cast<unsigned long long>(256 >> 4) << 32);
}

// d (+)= A (registers, m64k16) x B (descriptor, k16 x N); acc 0: d = A B
template <int N>
__device__ __forceinline__ void fw_mma(float (&d)[N / 2],
                                       const unsigned (&a)[4],
                                       unsigned long long b, int acc);

// the widths the body takes (the accumulator's N / 2 registers listed)
template <>
__device__ __forceinline__ void fw_mma<8>(float (&d)[4],
                                            const unsigned (&a)[4],
                                            unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void fw_mma<16>(float (&d)[8],
                                            const unsigned (&a)[4],
                                            unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void fw_mma<24>(float (&d)[12],
                                            const unsigned (&a)[4],
                                            unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void fw_mma<64>(float (&d)[32],
                                            const unsigned (&a)[4],
                                            unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void fw_mma<96>(float (&d)[48],
                                            const unsigned (&a)[4],
                                            unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void fw_mma<120>(float (&d)[60],
                                            const unsigned (&a)[4],
                                            unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59}, "
      "{%60, %61, %62, %63}, %64, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void fw_mma<128>(float (&d)[64],
                                            const unsigned (&a)[4],
                                            unsigned long long b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---------------------------------------------------------------------------
// shared memory: the ring, the bfloat16 arena, the f32 rows (S: cx cy cz
// w_v q_sdf q_vis vis_th vis_toh; G: gates; O: outputs), the softplus
// table, the biases, the keypoints, then the FW_R `full` and the FW_R
// `empty` barriers
// ---------------------------------------------------------------------------

#define FW_XA_OFF (FW_R * FW_SLOT)
#define FW_F32_OFF (FW_XA_OFF + 2 * FW_XA_ROWS * FW_TPS)
#define FW_TAB_OFF (FW_F32_OFF + 4 * FW_F32_ROWS * FW_TPS)
#define FW_BIAS_OFF (FW_TAB_OFF + 2 * FW_TAB)
#define FW_KP_OFF (FW_BIAS_OFF + 4 * FM_MAX_BIAS)

__host__ __device__ __forceinline__ int fw_bar_offset(int K) {
  return FW_KP_OFF + 4 * ((3 * K + 3) & ~3);
}

extern __shared__ __align__(128) unsigned char fw_sm[];

__device__ __forceinline__ unsigned char* fw_at(int bytes) {
  return fw_sm + bytes;
}

struct FwSmem {
  unsigned short* XA;
  float* S;
  float* G;
  float* O;
  const unsigned short* tab;
  const float* bias;
  const float* kp;
  unsigned long long* full;  // FW_R full, then FW_R empty barriers
};

__device__ __forceinline__ FwSmem fw_carve(int K) {
  FwSmem s;
  s.XA = reinterpret_cast<unsigned short*>(fw_at(FW_XA_OFF));
  s.S = reinterpret_cast<float*>(fw_at(FW_F32_OFF));
  s.G = s.S + 8 * FW_TPS;
  s.O = s.G + 8 * FW_TPS;
  s.tab = reinterpret_cast<const unsigned short*>(fw_at(FW_TAB_OFF));
  s.bias = reinterpret_cast<const float*>(fw_at(FW_BIAS_OFF));
  s.kp = reinterpret_cast<const float*>(fw_at(FW_KP_OFF));
  s.full = reinterpret_cast<unsigned long long*>(fw_at(fw_bar_offset(K)));
  return s;
}

// the warp's first point column within the block's rows
__device__ __forceinline__ int fw_wp() { return (threadIdx.x >> 5) * 16; }

// ---------------------------------------------------------------------------
// the ring
// ---------------------------------------------------------------------------

// A consumer warp's place in the stream: pos in bytes (an item a slot:
// item pos / FW_SLOT, pos % FW_SLOT bytes of it taken) and the item to
// release once the products that read it have completed (-1: none).
struct FwRing {
  int pos, pend;
  unsigned long long* full;
};

// The next k-step of an N-wide layer (N 32 bytes): a k-step that does not
// fit in what is left of the item starts the next one, as fm_push groups
// them; at the start of an item the one before becomes pending and this
// one's copy is waited for.
__device__ __forceinline__ const unsigned char* fw_next(FwRing& r, int N) {
  const int need = 32 * N;
  int off = r.pos % FW_SLOT;
  if (off != 0 && off + need > FW_SLOT) {
    r.pos += FW_SLOT - off;
    off = 0;
  }
  const int item = r.pos / FW_SLOT, s = item % FW_R;
  if (off == 0) {
    if (item > 0) r.pend = item - 1;
    if (!bar_wait_bounded(r.full + s, (item / FW_R) & 1, FM_TRIES))
      __trap();
  }
  r.pos += need;
  // the lanes go on together (after the poll, or the branches of an
  // epilogue): wgmma and ldmatrix are .aligned, whole-warp instructions
  __syncwarp();
  return fw_at(s * FW_SLOT + off);
}

// After a wait: the pending item's products have completed, as far as
// they are this warp's (one arrival a warp on the slot's `empty` barrier:
// each warp's tensor core reads B for its own 16 rows, and its wait
// covers those alone).
__device__ __forceinline__ void fw_release(FwRing& r) {
  if (r.pend >= 0) {
    if ((threadIdx.x & 31) == 0) bar_arrive(r.full + FW_R + r.pend % FW_R);
    r.pend = -1;
    __syncwarp();
  }
}

// The producer warp: item i into slot i % FW_R once the consumer warps
// are done with the item FW_R before it.
__device__ __forceinline__ void fw_produce(const FmSched& sc,
                                           const void* __restrict__ w,
                                           unsigned long long* full) {
  if ((threadIdx.x & 31) != 0) return;
  unsigned long long* empty = full + FW_R;
  const char* src = static_cast<const char*>(w);
  for (int i = 0; i < sc.n; ++i) {
    const int s = i % FW_R;
    if (i >= FW_R &&
        !bar_wait_bounded(empty + s, (i / FW_R - 1) & 1, FM_TRIES))
      __trap();
    const unsigned bytes = 256u * sc.tiles[i];
    bar_expect(full + s, bytes);
    bulk_load(fw_at(s * FW_SLOT), src, bytes, full + s);
    src += bytes;
  }
}

// ---------------------------------------------------------------------------
// layers
// ---------------------------------------------------------------------------

// The A fragment of k-step [k0, k0 + 16) of `[channel][point]` rows X at
// the warp's 16 points (ldmatrix.x4.trans: matrices k 0-7 / 8-15 x points
// 0-7 / 8-15); rows at or past k0 + kr read as 0.
__device__ __forceinline__ void fw_lda(unsigned (&a)[4],
                                       const unsigned short* X, int k0,
                                       int kr) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  const unsigned short* p =
      X + (k0 + (lane & 7) + ((lane >> 4) << 3)) * FW_TPS + fw_wp() +
      (((lane >> 3) & 1) << 3);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
  if (kr < 16) {
    const int t2 = 2 * (lane & 3);
    const unsigned m0 =
        (t2 < kr ? 0xFFFFu : 0u) | (t2 + 1 < kr ? 0xFFFF0000u : 0u);
    const unsigned m1 =
        (t2 + 8 < kr ? 0xFFFFu : 0u) | (t2 + 9 < kr ? 0xFFFF0000u : 0u);
    a[0] &= m0;
    a[1] &= m0;
    a[2] &= m1;
    a[3] &= m1;
  }
}

// One k-step of fw_acc_rows: A from rows [k0, k0 + 16) of X into `cur`,
// its product issued; after the wait that completes the k-step before
// (whose A is `prev`), that one's registers may be written again.
template <int N>
__device__ __forceinline__ void fw_ks_rows(FwRing& r, float (&d)[N / 2],
                                           int& acc, const unsigned short* X,
                                           int k0, int K, unsigned (&cur)[4],
                                           unsigned (&prev)[4]) {
  fw_lda(cur, X, k0, K - k0);
  const unsigned char* b = fw_next(r, N);
  fw_fence();
  fw_mma<N>(d, cur, fw_desc(b), acc);
  fw_commit();
  acc = 1;
  fw_wait<1>();
  fw_keep(prev);
  fw_release(r);
}

// d (+)= X (K rows of shared memory) x the next ceil(K / 16) k-steps
// (acc: 0 before the layer's first product, 1 after).  One product in
// flight behind the one issued: the A registers alternate between two
// sets, so that a product's A is not written again before the wait that
// completes it (wgmma reads A asynchronously), and its item is released
// after that wait.
template <int N>
__device__ __forceinline__ void fw_acc_rows(FwRing& r, float (&d)[N / 2],
                                            int& acc,
                                            const unsigned short* X, int K) {
  unsigned a[2][4] = {};
  for (int k0 = 0; k0 < K; k0 += 32) {
    fw_ks_rows<N>(r, d, acc, X, k0, K, a[0], a[1]);
    if (k0 + 16 < K) fw_ks_rows<N>(r, d, acc, X, k0 + 16, K, a[1], a[0]);
  }
  fw_wait<0>();
  fw_keep(a[0]);
  fw_keep(a[1]);
  fw_keep(d);
  fw_release(r);
}

// d (+)= the KS register k-steps f x the next KS k-steps of the stream
template <int N, int KS>
__device__ __forceinline__ void fw_acc_frag(FwRing& r, float (&d)[N / 2],
                                            int& acc, unsigned (&f)[KS][4]) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const unsigned char* b = fw_next(r, N);
    fw_fence();
    fw_mma<N>(d, f[s], fw_desc(b), acc);
    fw_commit();
    acc = 1;
    fw_wait<1>();
    if (s > 0) fw_keep(f[s - 1]);
    fw_release(r);
  }
  fw_wait<0>();
  fw_keep(f[KS - 1]);
  fw_keep(d);
  fw_release(r);
}

// The layer's value at accumulator element v (bias added): rounded to
// bfloat16, the activation, rounded again (FW_OUT: the f32 sum as it is).
template <int ACT>
__device__ __forceinline__ float fw_act(float v, const unsigned short* tab) {
  if (ACT == FW_OUT) return v;
  v = vt_bf16_round(v);
  if (ACT == FW_SOFTPLUS) return vt_bf16_round(fw_softplus(v, tab));
  if (ACT == FW_SIGMOID) return vt_bf16_round(fw_sigmoid(v));
  if (ACT == FW_RELU) return fmaxf(v, 0.0f);
  return v;
}

// fw_act on two neighbouring columns a, b, packed as an A fragment
// register: the roundings by cvt.rn.bf16x2, relu by max.bf16x2 (exact)
template <int ACT>
__device__ __forceinline__ unsigned fw_act2(float a, float b,
                                            const unsigned short* tab) {
  const unsigned x = fw_pack(a, b);
  if (ACT == FW_RELU) {
    unsigned r;
    asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(x), "r"(0u));
    return r;
  }
  if (ACT == FW_SOFTPLUS)
    return fw_pack(fw_softplus(vt_bf16_lo(x), tab),
                   fw_softplus(vt_bf16_hi(x), tab));
  if (ACT == FW_SIGMOID)
    return fw_pack(fw_sigmoid(vt_bf16_lo(x)), fw_sigmoid(vt_bf16_hi(x)));
  return x;
}

// Accumulator element 4 j + e is point g + 8 (e >> 1), channel 8 j + 2 t +
// (e & 1) (lane 4 g + t of the warp's 16 points).  The biases of n8 tile
// j's columns 2 t, 2 t + 1 (those past the layer's width read the shared
// words after it), or none: read tile by tile, so that a wide layer's
// biases do not all hold registers beside its accumulator.
__device__ __forceinline__ float2 fw_bias(const float* bias, int j) {
  if (!bias) return make_float2(0.0f, 0.0f);
  return *reinterpret_cast<const float2*>(bias + 8 * j +
                                          2 * (threadIdx.x & 3));
}

// act(d + bias) as the A fragments of the next product: n8 tiles 2 s and
// 2 s + 1 are k-step s (a padding half k-step is 0)
template <int N, int ACT>
__device__ __forceinline__ void fw_epi_frag(float (&d)[N / 2],
                                            const float* bias,
                                            unsigned (&f)[(N + 15) / 16][4],
                                            const unsigned short* tab) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = fw_bias(bias, j);
    f[j >> 1][2 * (j & 1)] =
        fw_act2<ACT>(d[4 * j] + b.x, d[4 * j + 1] + b.y, tab);
    f[j >> 1][2 * (j & 1) + 1] =
        fw_act2<ACT>(d[4 * j + 2] + b.x, d[4 * j + 3] + b.y, tab);
  }
  if ((N / 8) & 1) {
    f[N / 16][2] = 0u;
    f[N / 16][3] = 0u;
  }
}

__device__ __forceinline__ void fw_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void fw_st(unsigned short* p, float v) {
  *p = vt_bf16_bits(v);
}

// act(d + bias), columns [0, M), into shared rows [channel][point]
template <int N, int ACT, typename T>
__device__ __forceinline__ void fw_epi_rows(float (&d)[N / 2],
                                            const float* bias, int M, T* dst,
                                            const unsigned short* tab) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  T* col = dst + fw_wp() + (lane >> 2);
  __syncwarp();  // the warp has read its inputs (dst may alias them)
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = fw_bias(bias, j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 8 * j + 2 * t + (e & 1);
      const float v = fw_act<ACT>(d[4 * j + e] + (e & 1 ? b.y : b.x), tab);
      if (m < M) fw_st(col + m * FW_TPS + 8 * (e >> 1), v);
    }
  }
  __syncwarp();  // the outputs are written before the warp reads them
}

// The V=1 pooling of x_view = round(d + bias) with weight w per point:
// mean = round(w x), var = round(w (x - w x)^2), as the A fragments of
// [mean | var] (k-steps 0-3 and 4-7).
__device__ __forceinline__ void fw_epi_pool(float (&d)[32], const float* bias,
                                            const float* wv,
                                            unsigned (&mv)[8][4]) {
  const int p = fw_wp() + ((threadIdx.x & 31) >> 2);
  const float w[2] = {wv[p], wv[p + 8]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = fw_bias(bias, j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g, g + 8
      const unsigned xr = fw_pack(d[4 * j + 2 * h] + b.x,
                                  d[4 * j + 2 * h + 1] + b.y);
      const float x0 = vt_bf16_lo(xr), x1 = vt_bf16_hi(xr);
      const float m0 = w[h] * x0, m1 = w[h] * x1;
      const float e0 = x0 - m0, e1 = x1 - m1;
      mv[j >> 1][2 * (j & 1) + h] = fw_pack(m0, m1);
      mv[4 + (j >> 1)][2 * (j & 1) + h] =
          fw_pack(w[h] * (e0 * e0), w[h] * (e1 * e1));
    }
  }
}

// ---------------------------------------------------------------------------
// per-warp data movement (each warp its own 16 points)
// ---------------------------------------------------------------------------

// Columns [col0, col0 + ncols) of a row-major (N, stride) array for the
// warp's points -> shared rows [c][p] (points past N read 0); a warp reads
// 4 points x 8 columns an instruction.  f32 sources by 4-byte asynchronous
// copies, landed by fw_load_wait; bfloat16 sources by plain loads, 16 a
// lane in flight before their stores, into bfloat16 rows or widened into
// f32 rows.
template <typename S, typename D>
__device__ __forceinline__ void fw_load_cols(const S* __restrict__ src,
                                             int stride, int col0, int ncols,
                                             int N, D* dst) {
  constexpr int B = 16;
  const int wp = fw_wp();
  const int gp0 = blockIdx.x * FW_TP + wp;
  const int total = ((ncols + 7) >> 3) * 8 * 16;
  for (int e0 = threadIdx.x & 31; e0 < total; e0 += 32 * B) {
    S v[B];
    int at[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int e = e0 + 32 * u;
      const int c = ((e >> 7) << 3) + (e & 7);
      const int p = (e >> 3) & 15;
      const int gp = gp0 + p;
      const bool ok = e < total && c < ncols;
      at[u] = ok ? c * FW_TPS + wp + p : -1;
      const S* from =
          src + static_cast<long long>(min(gp, N - 1)) * stride + col0 + c;
      if constexpr (std::is_same<S, float>::value) {
        if (ok)
          asm volatile(
              "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                  smem_addr(dst + at[u])),
              "l"(from), "r"(gp < N ? 4 : 0)
              : "memory");
      } else {
        v[u] = ok && gp < N ? __ldg(from) : S(0);
      }
    }
    if constexpr (!std::is_same<S, float>::value) {
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (at[u] < 0) continue;
        if constexpr (std::is_same<D, float>::value)
          dst[at[u]] = vt_bf16_float(v[u]);
        else
          dst[at[u]] = v[u];
      }
    }
  }
}

__device__ __forceinline__ void fw_load_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Ask L2 for the warp's rows of a row-major (N, stride) array, one request
// per 128-byte line, so that the column loads find them there.
template <typename S>
__device__ __forceinline__ void fw_prefetch_rows(const S* __restrict__ src,
                                                 int stride, int N) {
  const int gp0 = blockIdx.x * FW_TP + fw_wp();
  const int rows = min(16, N - gp0);
  if (rows <= 0) return;
  const char* base = reinterpret_cast<const char*>(
      src + static_cast<long long>(gp0) * stride);
  const long long bytes =
      static_cast<long long>(rows) * stride * static_cast<long long>(sizeof(S));
  for (long long o = (threadIdx.x & 31) * 128LL; o < bytes; o += 32 * 128LL)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + o));
}

// rows [0, nrows) of X *= the per-point f32 row `scale` (rounded)
__device__ __forceinline__ void fw_scale_rows(unsigned short* X, int nrows,
                                              const float* scale) {
  const int wp = fw_wp();
  for (int e = threadIdx.x & 31; e < nrows * 16; e += 32) {
    const int p = wp + (e & 15);
    unsigned short* x = X + (e >> 4) * FW_TPS + p;
    *x = vt_bf16_bits(vt_bf16_float(*x) * scale[p]);
  }
  __syncwarp();
}

__device__ __forceinline__ void fw_copy_row(unsigned short* dst,
                                            const float* src) {
  const int lane = threadIdx.x & 31;
  if (lane < 16) dst[fw_wp() + lane] = vt_bf16_bits(src[fw_wp() + lane]);
  __syncwarp();
}

// shared rows [c][p] -> row-major (N, ncols) device memory, the warp's
// points
template <typename T>
__device__ __forceinline__ void fw_write_out(const T* rows, int ncols, int N,
                                             T* __restrict__ out) {
  const int wp = fw_wp();
  const int gp0 = blockIdx.x * FW_TP + wp;
  for (int e = threadIdx.x & 31; e < ncols * 16; e += 32) {
    const int p = e / ncols, c = e - p * ncols;
    if (gp0 + p < N)
      out[static_cast<long long>(gp0 + p) * ncols + c] =
          rows[c * FW_TPS + wp + p];
  }
}

// rel_z_decay encoding of keypoints [j0, j0 + nj) -> bfloat16 rows
// [jl * P + part] (keypoint-major, as ops/fused_mlp.py packs the first
// layer's rows): dz, then sin / cos(pi dz) and their octaves by the
// double-angle recurrence, each times the Gaussian keypoint weight (f32,
// rounded as stored).
__device__ __forceinline__ void fw_pe(const FmGeo& g, const FwSmem& s,
                                      unsigned short* dst, int j0, int nj) {
  const int K = g.K;
  const int P = 1 + 2 * g.L;
  const int wp = fw_wp();
  for (int e = threadIdx.x & 31; e < nj * 16; e += 32) {
    const int p = wp + (e & 15);
    const int jl = e >> 4;
    const int j = j0 + jl;
    const float dxx = s.S[p] - s.kp[j];
    const float dyy = s.S[FW_TPS + p] - s.kp[K + j];
    const float dzz = s.S[2 * FW_TPS + p] - s.kp[2 * K + j];
    const float dz = g.scale * dzz;
    const float wgt =
        expf(-(dxx * dxx + dyy * dyy + dzz * dzz) * g.inv_two_sig2);
    float sn, cs;
    sincosf(3.14159274101257324f * dz, &sn, &cs);
    unsigned short* col = dst + jl * P * FW_TPS + p;
    col[0] = vt_bf16_bits(dz * wgt);
    for (int l = 0; l < g.L; ++l) {
      col[(1 + 2 * l) * FW_TPS] = vt_bf16_bits(sn * wgt);
      col[(2 + 2 * l) * FW_TPS] = vt_bf16_bits(cs * wgt);
      const float s2 = 2.0f * sn * cs;
      cs = 1.0f - 2.0f * sn * sn;
      sn = s2;
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// the networks
// ---------------------------------------------------------------------------

// PE + MLPUNetFusion (V=1) + gcompress.  Needs S rows 0-3 and the F0 / F1
// rows loaded.  Writes (sdf residual, radiance) to O rows 0-1 and the
// latent to `lat` rows.
__device__ __forceinline__ void fw_geo_body(const FmGeo& g, const FwSmem& s,
                                            FwRing& r, unsigned short* lat) {
  const float* B = s.bias;
  const unsigned short* F0 = s.XA + FW_R_F0 * FW_TPS;
  const unsigned short* F1 = s.XA + FW_R_F1 * FW_TPS;
  unsigned short* pe = s.XA + FW_R_PE * FW_TPS;
  const int P = 1 + 2 * g.L, per = fm_pe_per(P);
  int acc = 0;
  // layer 0: the encoding a chunk of keypoints at a time, then fused0
  float d0[FW_D1 / 2] = {};
  for (int j0 = 0; j0 < g.K; j0 += per) {
    const int nj = min(per, g.K - j0);
    fw_pe(g, s, pe, j0, nj);
    fw_acc_rows<FW_D1>(r, d0, acc, pe, nj * P);
    __syncwarp();  // the chunk is read before the next one replaces it
  }
  fw_acc_rows<FW_D1>(r, d0, acc, F0, FM_F0);
  unsigned h[8][4];
  fw_epi_frag<FW_D1, FW_SOFTPLUS>(d0, B, h, s.tab);
  B += FW_D1;
  // layer 1
  acc = 0;
  fw_acc_frag<FW_D2, 8>(r, d0, acc, h);
  fw_epi_frag<FW_D2, FW_SOFTPLUS>(d0, B, h, s.tab);
  B += FW_D2;
  // layer 2: [h | fused1]
  float d2[FW_D3 / 2] = {};
  acc = 0;
  fw_acc_frag<FW_D3, 8>(r, d2, acc, h);
  fw_acc_rows<FW_D3>(r, d2, acc, F1, FM_F1);
  fw_epi_frag<FW_D3, FW_SOFTPLUS>(d2, B, h, s.tab);
  B += FW_D3;
  // layer 3 and the pooling
  float d3[FM_F0 / 2] = {};
  acc = 0;
  fw_acc_frag<FM_F0, 8>(r, d3, acc, h);
  unsigned mv[8][4];
  fw_epi_pool(d3, B, s.S + 3 * FW_TPS, mv);
  B += FM_F0;
  // layers 4-6
  acc = 0;
  fw_acc_frag<FW_E1, 8>(r, d3, acc, mv);
  unsigned h4[4][4];
  fw_epi_frag<FW_E1, FW_SOFTPLUS>(d3, B, h4, s.tab);
  B += FW_E1;
  acc = 0;
  fw_acc_frag<FW_E2, 4>(r, d3, acc, h4);
  fw_epi_frag<FW_E2, FW_SOFTPLUS>(d3, B, h4, s.tab);
  B += FW_E2;
  float d6[4] = {};
  acc = 0;
  fw_acc_frag<8, 4>(r, d6, acc, h4);
  fw_epi_rows<8, FW_OUT>(d6, B, 2, s.O, s.tab);
  B += 2;
  // the latent from [mean | var]
  float d7[FW_LAT / 2] = {};
  acc = 0;
  fw_acc_frag<FW_LAT, 8>(r, d7, acc, mv);
  fw_epi_rows<FW_LAT, FW_NONE>(d7, B, FW_LAT, lat, s.tab);
}

// GateMLP + FuseMLP over the X rows (Kin of them): gate hidden (HG wide,
// relu) -> ng sigmoid gates (G rows); the first `np` row groups of widths
// w re-scaled by their gate; fuse hidden (HF wide, relu) -> nout rows at
// dst.  HG, NG, HF, NO: the widths rounded up to multiples of 8.
template <int HG, int NG, int HF, int NO, typename D>
__device__ __forceinline__ void fw_gate_fuse(FwRing& r, const FwSmem& s,
                                             unsigned short* X, int Kin,
                                             int np, const int* w, int ng,
                                             int nout, D* dst) {
  int acc = 0;
  float dg[HG / 2] = {};
  fw_acc_rows<HG>(r, dg, acc, X, Kin);
  unsigned fg[(HG + 15) / 16][4];
  fw_epi_frag<HG, FW_RELU>(dg, nullptr, fg, s.tab);
  float dn[NG / 2] = {};
  acc = 0;
  fw_acc_frag<NG, (HG + 15) / 16>(r, dn, acc, fg);
  fw_epi_rows<NG, FW_SIGMOID>(dn, nullptr, ng, s.G, s.tab);
  int row = 0;
  for (int i = 0; i < np; ++i) {
    fw_scale_rows(X + row * FW_TPS, w[i], s.G + i * FW_TPS);
    row += w[i];
  }
  float dh[HF / 2] = {};
  acc = 0;
  fw_acc_rows<HF>(r, dh, acc, X, Kin);
  unsigned fh[(HF + 15) / 16][4];
  fw_epi_frag<HF, FW_RELU>(dh, nullptr, fh, s.tab);
  float dout[NO / 2] = {};
  acc = 0;
  fw_acc_frag<NO, (HF + 15) / 16>(r, dout, acc, fh);
  fw_epi_rows<NO, FW_NONE>(dout, nullptr, nout, dst, s.tab);
}

// Barriers, keypoints, biases, the softplus table; then the producer warp
// leaves for its loop and the consumers go on (no block barrier after).
__device__ __forceinline__ bool fw_start(const FmGeo& g, const FmSched& sc,
                                         const void* __restrict__ w,
                                         const FwSmem& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < FW_R; ++i) {
      bar_init(s.full + i, 1);
      bar_init(s.full + FW_R + i, FW_CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* kp = reinterpret_cast<float*>(fw_at(FW_KP_OFF));
  for (int k = threadIdx.x; k < 3 * g.K; k += FW_NT) kp[k] = __ldg(g.kpt_T + k);
  float* bias = reinterpret_cast<float*>(fw_at(FW_BIAS_OFF));
  const int nb = g.d1 + g.d2 + g.d3 + FM_F0 + g.e1 + g.e2 + 2 + g.lat;
  for (int k = threadIdx.x; k < nb; k += FW_NT) bias[k] = __ldg(g.b + k);
  fw_fill_table(reinterpret_cast<unsigned short*>(fw_at(FW_TAB_OFF)));
  __syncthreads();
  if ((threadIdx.x >> 5) == FW_CW) {
    fw_produce(sc, w, s.full);
    return false;
  }
  return true;
}

// aux (N, 74): [fused0 64 | fused1 8 | out_mask | pix_weight]
__global__ void __launch_bounds__(FW_NT, 1)
fw_geo_kernel(FmGeo g, const __grid_constant__ FmSched sc,
              const void* __restrict__ w,
              const unsigned short* __restrict__ aux, float* __restrict__ out,
              unsigned short* __restrict__ lat) {
  const FwSmem s = fw_carve(g.K);
  if (!fw_start(g, sc, w, s)) return;
  FwRing r{0, -1, s.full};
  fw_load_cols(g.cxyz, 3, 0, 3, g.N, s.S);
  fw_load_cols(aux, 74, 0, FM_F0, g.N, s.XA + FW_R_F0 * FW_TPS);
  fw_load_cols(aux, 74, FM_F0, FM_F1, g.N, s.XA + FW_R_F1 * FW_TPS);
  fw_load_cols(aux, 74, 73, 1, g.N, s.S + 3 * FW_TPS);
  fw_load_wait();
  unsigned short* L = s.XA + FW_R_LAT * FW_TPS;
  fw_geo_body(g, s, r, L);
  fw_write_out(s.O, 2, g.N, out);
  fw_write_out(L, FW_LAT, g.N, lat);
}

// feats (N, 87): [feat_s0 64 | feat_s1 8 | img_xy 3 | ft_xy 8 | q_sdf |
//   q_vis | out_mask | pix_weight]; g2 (N, 204): the raw KNN rows
//   [geo64 | geo8 | tex 11 | tex_global 18 | vis] x {this, other hand}.
__global__ void __launch_bounds__(FW_NT, 1)
fw_query_kernel(FmGeo g, const __grid_constant__ FmSched sc,
                const void* __restrict__ w,
                const unsigned short* __restrict__ feats,
                const unsigned short* __restrict__ g2,
                float* __restrict__ out) {
  const FwSmem s = fw_carve(g.K);
  if (!fw_start(g, sc, w, s)) return;
  FwRing r{0, -1, s.full};
  const int N = g.N;
  const int C1 = 102;
  unsigned short* XA = s.XA;
  float* q_sdf = s.S + 4 * FW_TPS;
  float* q_vis = s.S + 5 * FW_TPS;
  float* vis_th = s.S + 6 * FW_TPS;
  float* vis_toh = s.S + 7 * FW_TPS;
  fw_prefetch_rows(g2, 204, N);
  fw_prefetch_rows(feats, 87, N);
  fw_load_cols(g.cxyz, 3, 0, 3, N, s.S);
  fw_load_cols(feats, 87, 86, 1, N, s.S + 3 * FW_TPS);
  fw_load_cols(feats, 87, 83, 2, N, q_sdf);  // q_sdf, q_vis
  fw_load_cols(g2, 204, 101, 1, N, vis_th);
  fw_load_cols(g2, 204, C1 + 101, 1, N, vis_toh);

  // GeoVisFusion scale 0: [fs0 | th g0 | toh g0 | ctx4] (196 rows) ->
  // fused0, written over the first input rows once they are read
  fw_load_cols(feats, 87, 0, 64, N, XA);
  fw_load_cols(g2, 204, 0, 64, N, XA + 64 * FW_TPS);
  fw_load_cols(g2, 204, C1, 64, N, XA + 128 * FW_TPS);
  fw_load_wait();
  fw_scale_rows(XA + 64 * FW_TPS, 64, vis_th);
  fw_scale_rows(XA + 128 * FW_TPS, 64, vis_toh);
  fw_copy_row(XA + 192 * FW_TPS, q_sdf);
  fw_copy_row(XA + 193 * FW_TPS, q_vis);
  fw_copy_row(XA + 194 * FW_TPS, vis_th);
  fw_copy_row(XA + 195 * FW_TPS, vis_toh);
  const int w64[3] = {64, 64, 64};
  fw_gate_fuse<16, 8, 64, 64>(r, s, XA, 196, 3, w64, 3, 64,
                              XA + FW_R_F0 * FW_TPS);

  // scale 1: [fs1 | th g1 | toh g1 | ctx4] -> fused1
  unsigned short* X1 = XA + FW_R_X1 * FW_TPS;
  fw_load_cols(feats, 87, 64, 8, N, X1);
  fw_load_cols(g2, 204, 64, 8, N, X1 + 8 * FW_TPS);
  fw_load_cols(g2, 204, C1 + 64, 8, N, X1 + 16 * FW_TPS);
  fw_load_wait();
  fw_copy_row(X1 + 24 * FW_TPS, q_sdf);
  fw_copy_row(X1 + 25 * FW_TPS, q_vis);
  fw_copy_row(X1 + 26 * FW_TPS, vis_th);
  fw_copy_row(X1 + 27 * FW_TPS, vis_toh);
  fw_scale_rows(X1 + 8 * FW_TPS, 8, vis_th);
  fw_scale_rows(X1 + 16 * FW_TPS, 8, vis_toh);
  const int w8[3] = {8, 8, 8};
  fw_gate_fuse<16, 8, 8, 8>(r, s, X1, 28, 3, w8, 3, 8,
                            XA + FW_R_F1 * FW_TPS);

  // geometry body; its latent lands in the texture gate's input rows
  unsigned short* TX = XA + FW_R_TX * FW_TPS;  // 96 rows: [qf 11 | th tf |
                                               //  toh tf | th tg 18 | toh tg
                                               //  18 | lat 24 | vis3]
  fw_geo_body(g, s, r, TX + 69 * FW_TPS);

  // TexVisFusion gate / fuse -> rgb
  fw_load_cols(feats, 87, 72, 11, N, TX);
  fw_load_cols(g2, 204, 72, 11, N, TX + 11 * FW_TPS);
  fw_load_cols(g2, 204, C1 + 72, 11, N, TX + 22 * FW_TPS);
  fw_load_cols(g2, 204, 83, 18, N, TX + 33 * FW_TPS);
  fw_load_cols(g2, 204, C1 + 83, 18, N, TX + 51 * FW_TPS);
  fw_load_wait();
  fw_copy_row(TX + 93 * FW_TPS, q_vis);
  fw_copy_row(TX + 94 * FW_TPS, vis_th);
  fw_copy_row(TX + 95 * FW_TPS, vis_toh);
  fw_scale_rows(TX + 11 * FW_TPS, 11, vis_th);
  fw_scale_rows(TX + 22 * FW_TPS, 11, vis_toh);
  fw_scale_rows(TX + 33 * FW_TPS, 18, vis_th);
  fw_scale_rows(TX + 51 * FW_TPS, 18, vis_toh);
  const int wt[6] = {11, 11, 11, 18, 18, 24};
  fw_gate_fuse<96, 8, 96, 8>(r, s, TX, 96, 6, wt, 6, 3, s.O + 2 * FW_TPS);
  fw_write_out(s.O, 5, N, out);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static size_t fw_smem_bytes(int K) { return fw_bar_offset(K) + 2 * FW_R * 8; }

// The k-steps of K rows of an M-wide layer (ceil(M / 8) tiles of 256
// bytes each), appended as the consumers take them: into the last item
// while it fits in a ring slot, else into a new one.
static bool fm_push(FmSched& sc, int K, int M) {
  const int nt = (M + 7) >> 3;
  for (int k = 0; k < K; k += 16) {
    if (sc.n > 0 && 256 * (sc.tiles[sc.n - 1] + nt) <= FW_SLOT) {
      sc.tiles[sc.n - 1] += nt;
    } else {
      if (sc.n >= FM_MAX_ITEMS) return false;
      sc.tiles[sc.n++] = static_cast<unsigned char>(nt);
    }
  }
  return true;
}

static bool fm_push_gate_fuse(FmSched& sc, int Kin, int hg, int ng,
                              int hf, int nout) {
  return fm_push(sc, Kin, hg) && fm_push(sc, hg, ng) &&
         fm_push(sc, Kin, hf) && fm_push(sc, hf, nout);
}

// The items of k-tiles the consumers take, in their order: kernel 11's two
// GeoVisFusion gate / fuse nets (full), the encoding a chunk of keypoints
// at a time, the geometry network and the latent, then TexVisFusion's
// gate / fuse net (full).
static bool fm_schedule(const FmGeo& g, bool full, FmSched& sc) {
  sc.n = 0;
  bool ok = true;
  if (full) {
    ok = ok && fm_push_gate_fuse(sc, 196, 10, 3, 64, 64);
    ok = ok && fm_push_gate_fuse(sc, 28, 10, 3, 8, 8);
  }
  const int P = 1 + 2 * g.L, per = fm_pe_per(P);
  for (int j0 = 0; j0 < g.K; j0 += per)
    ok = ok && fm_push(sc, (g.K - j0 < per ? g.K - j0 : per) * P, g.d1);
  ok = ok && fm_push(sc, FM_F0, g.d1) && fm_push(sc, g.d1, g.d2) &&
       fm_push(sc, g.d2, g.d3) && fm_push(sc, FM_F1, g.d3) &&
       fm_push(sc, g.d3, FM_F0) && fm_push(sc, 2 * FM_F0, g.e1) &&
       fm_push(sc, g.e1, g.e2) && fm_push(sc, g.e2, 2) &&
       fm_push(sc, 2 * FM_F0, g.lat);
  if (full) ok = ok && fm_push_gate_fuse(sc, 96, 96, 6, 96, 3);
  return ok;
}

static FmGeo fm_geo(const float* cxyz, const float* kpt_T, const float* b,
                    int N, int K, int L, float scale, float inv_two_sig2,
                    const int* dims) {
  FmGeo g;
  g.cxyz = cxyz;
  g.kpt_T = kpt_T;
  g.b = b;
  g.N = N;
  g.K = K;
  g.L = L;
  g.scale = scale;
  g.inv_two_sig2 = inv_two_sig2;  // 1 / (2 sigma^2), rounded once
  g.d1 = dims[0];
  g.d2 = dims[1];
  g.d3 = dims[2];
  g.e1 = dims[3];
  g.e2 = dims[4];
  g.lat = dims[5];
  return g;
}

// The checks of a launch: the widths the body is built for, K and L, the
// schedule and the stream's size (w_elems values, 128 a tile) against it,
// the shared-memory limit.
template <typename Kernel>
static int fw_prepare(Kernel kernel, const FmGeo& g, bool full,
                      long long w_elems, FmSched& sc, size_t& smem) {
  if (g.d1 != FW_D1 || g.d2 != FW_D2 || g.d3 != FW_D3 || g.e1 != FW_E1 ||
      g.e2 != FW_E2 || g.lat != FW_LAT || g.N <= 0 || g.K <= 0 ||
      g.K > 256 || g.L < 0 || 1 + 2 * g.L > FM_PE_ROWS ||
      !fm_schedule(g, full, sc))
    return static_cast<int>(cudaErrorInvalidValue);
  long long tiles = 0;
  for (int i = 0; i < sc.n; ++i) tiles += sc.tiles[i];
  if (tiles * 128 != w_elems) return static_cast<int>(cudaErrorInvalidValue);
  smem = fw_smem_bytes(g.K);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// dims: six host ints {d1, d2, d3, e1, e2, lat} (the widths above); aux,
// the stream (w_elems bfloat16 values, 16-byte aligned) and lat bfloat16
VT_EXPORT int vt_fused_geo_mlp_bf16(const float* cxyz, const float* kpt_T,
                                    const void* aux, const void* w,
                                    long long w_elems, const float* b, int N,
                                    int K, int L, float scale,
                                    float inv_two_sig2, const int* dims,
                                    float* out, void* lat, void* stream) {
  if (N <= 0) return 0;
  const FmGeo g = fm_geo(cxyz, kpt_T, b, N, K, L, scale, inv_two_sig2, dims);
  FmSched sc;
  size_t smem = 0;
  const int rc = fw_prepare(fw_geo_kernel, g, false, w_elems, sc, smem);
  if (rc) return rc;
  fw_geo_kernel<<<vt_blocks(N, FW_TP), FW_NT, smem, vt_stream(stream)>>>(
      g, sc, w, static_cast<const unsigned short*>(aux), out,
      static_cast<unsigned short*>(lat));
  return static_cast<int>(cudaGetLastError());
}

VT_EXPORT int vt_fused_query_mlp_bf16(const float* cxyz, const float* kpt_T,
                                      const void* feats, const void* g2,
                                      const void* w, long long w_elems,
                                      const float* b, int N, int K, int L,
                                      float scale, float inv_two_sig2,
                                      const int* dims, float* out,
                                      void* stream) {
  if (N <= 0) return 0;
  const FmGeo g = fm_geo(cxyz, kpt_T, b, N, K, L, scale, inv_two_sig2, dims);
  FmSched sc;
  size_t smem = 0;
  const int rc = fw_prepare(fw_query_kernel, g, true, w_elems, sc, smem);
  if (rc) return rc;
  fw_query_kernel<<<vt_blocks(N, FW_TP), FW_NT, smem, vt_stream(stream)>>>(
      g, sc, w, static_cast<const unsigned short*>(feats),
      static_cast<const unsigned short*>(g2), out);
  return static_cast<int>(cudaGetLastError());
}

// act 1: softplus, 3: sigmoid; out: 65,536 bfloat16, input i's bits i
VT_EXPORT int vt_fm_act_bf16_all(int act, void* out, void* stream) {
  if (act != FW_SOFTPLUS && act != FW_SIGMOID)
    return static_cast<int>(cudaErrorInvalidValue);
  fw_act_all_kernel<<<256, 256, 0, vt_stream(stream)>>>(
      act, static_cast<unsigned short*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The entry's occupancy for chip_smoke.py: {shared bytes a block at K
// keypoints, blocks an SM, threads a block} of kernel 11 (full) or 12.
VT_EXPORT int vt_fused_mlp_bf16_occupancy(int full, int K, int* info) {
  const size_t smem = fw_smem_bytes(K);
  int rc, blocks = 0;
  if (full) {
    rc = cudaFuncSetAttribute(fw_query_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (!rc)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fw_query_kernel, FW_NT, smem);
  } else {
    rc = cudaFuncSetAttribute(fw_geo_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (!rc)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fw_geo_kernel, FW_NT, smem);
  }
  info[0] = static_cast<int>(smem);
  info[1] = blocks;
  info[2] = FW_NT;
  return static_cast<int>(rc);
}
