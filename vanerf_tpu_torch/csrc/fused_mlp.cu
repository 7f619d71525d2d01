// Kernels 12 and 11 — the per-point query network in one launch a pass.
//
//   vt_fused_geo_mlp   (12) replaces vanerf_tpu/ops/fused_mlp.py::fused_geo_mlp
//     (body `_kernel`): rel_z_decay positional encoding over the keypoints,
//     MLPUNetFusion at one source view (layers1, the V=1 mean/var pooling,
//     layers2) and the gcompress latent.
//   vt_fused_query_mlp (11) replaces ::fused_query_mlp (body `_kernel_full`):
//     kernel 12's body between GeoVisFusion's two gate/fuse scales in front
//     and TexVisFusion's gate/fuse with the V=1 rgb columns behind, reading
//     the raw KNN gather rows.
//
// Bound on the H100: operations.  Kernel 12 is ~102k multiply-adds a point
// (~53 GFLOP for 262,144 points) against ~108 MB in and out; kernel 11 adds
// ~38k a point (~73 GFLOP against ~310 MB).  On the CUDA cores in f32 both
// are held to 67 TFLOP/s; this design puts the layer products on the
// tensor cores.
//
// Numerics: 3xTF32.  Every layer product X W runs as mma.sync m16n8k8 TF32
// in three passes, lo(X) hi(W) + hi(X) lo(W) + hi(X) hi(W), where hi(v) is
// v rounded to TF32 (cvt.rna, 10 explicit mantissa bits) and lo(v) =
// v - hi(v), itself rounded to TF32.  hi + lo carries v to ~2^-22
// relative and the dropped lo lo term is ~2^-22 of a product, so each
// product is good to a few units of f32's rounding.  The three products
// of a k-tile (8 input channels) sum on the tensor cores from zero, and
// that sum is added to the layer's on the CUDA cores, rounded to nearest:
// letting the tensor cores carry the sum over all of a layer's k-tiles
// multiplied the error several times (their f32 accumulation is not
// round-to-nearest) and moved over 1% of the fused frames' fine samples.  The outputs stay
// within rtol 2e-4 / atol 2e-5 of the plain f32 version
// (tests/test_torch_fused.py holds an emulation of these products through
// both networks to that bound); a single TF32 pass would be off by ~1e-3
// relative.  The weights are split once, when ops/fused_mlp.py::_pack
// lays them out; the activations are split as their fragments are loaded.
// The positional encoding (accurate sin/cos/exp), the activations, the V=1
// pooling and the gate scaling stay on the CUDA cores in f32, as before:
// softplus is torch's Softplus(beta=100, threshold=20) written as
// max(x, 0) + log(1 + exp(-|100 x|)) / 100 with the fast intrinsics (the
// argument of the log lies in (1, 2], where they are good to ~4e-7), the
// sigmoid's exp the accurate one.  A virtual concat (the encoding beside
// the fused features, the hidden state beside its skip input) is two
// products into one accumulator in the JAX order, the bias added last.
//
// Design.  A block owns 128 points and keeps every activation of them in
// shared memory as rows [channel][point] (row stride 136 floats: 136 = 8
// mod 32, so the m16n8k8 A fragments, rows t and t + 4 at points g and
// g + 8, load from 32 distinct banks); the rows are reused phase by phase
// (the row map below), 189 KB in all.  Eight consumer warps own 16 points
// each and every output channel of them: a warp reads and writes only its
// own points' columns, so no layer needs a block barrier, only __syncwarp.
// Narrow layers (2, 3, 5, 6, 10 outputs) take one or two n8 tiles.  The
// weights (~140k multiply-adds a point for kernel 11, 1.1 MB with both
// planes) stream once a block, in the order the layers consume them, as
// k-tiles of 8 input rows x all output tiles of a layer (512 bytes a tile:
// 32 lanes x {hi b0, hi b1, lo b0, lo b1}, the m16n8k8 B fragment, so a
// lane's four values are one conflict-free 16-byte load).  A ninth warp
// fills a ring of four 8 KB slots, one 1-D bulk copy (TMA) an item of as
// many consecutive k-tiles as fit in a slot (a narrow layer's k-tiles share
// one), each on its `full` mbarrier, and refills a slot when the eight
// consumer warps have arrived on its `empty` mbarrier: 128 points a block
// read the weights from L2 half as often as the 64 before, and no block
// barrier stands in the layer loop.  The host computes the items
// (`fm_schedule`, the consumers' order and grouping) and checks the packed
// stream against them; a producer and consumers that still disagreed would
// end the kernel with a trap, not hang.  227 KB of shared memory allow one
// block an SM (8 + 1 warps).  The inputs come by 4-byte asynchronous copies
// (cp.async), all of a phase's columns issued before one wait; the biases
// are copied into shared memory once.  What bounds it on the card
// (PERF.md section 6): the mma.sync products, then the epilogue's softplus
// (two MUFU operations an element) and the ring's waits, with two warps a
// scheduler to hide their latencies; sixteen warps (two a 16-point tile,
// every other n-tile each) and four warps a 64-point tile (a quarter of
// the n-tiles each, a quarter of the weight reads from shared memory) were
// both slower.
//
// Packed stream (ops/fused_mlp.py::_pack): for each layer, each part of
// its virtual concat (K rows zero-padded to a multiple of 8, M columns to
// 8 fm_ntiles(M)) as [k-tile][n-tile][lane][4] fragments; the first layer's
// encoding rows come keypoint-major (row j * P + part), a chunk of
// FM_PE_ROWS / P keypoints a part.  Biases unpadded, apart.
//
// The BF = true branches are the earlier bfloat16 body (one mma.sync
// m16n8k16 a k-tile), no longer exported: kernels 11 / 12 in bfloat16 are
// csrc/fused_mlp_bf16.cu (a wgmma body).
// They stay so that the float32 kernels compile from the source they were
// measured from; taking them out changed the float32 kernels' code.

#include <type_traits>

#include "bf16.cuh"
#include "common.cuh"
#include "tma.cuh"

#define FM_TP 128        // points per block
#define FM_TPS 136       // shared row stride in floats (= 8 mod 32)
#define FM_CW 8          // consumer warps, 16 points each
#define FM_WP 16         // points per consumer warp
#define FM_NT ((FM_CW + 1) * 32)  // + the producer warp
#define FM_HMAX 128      // widest layer (16 n-tiles)
#define FM_R 4           // ring slots
#define FM_SLOT (16 * 128)        // floats a slot: one k-tile of 16 n-tiles
#define FM_MAX_ITEMS 1024         // items a launch
#define FM_F0 64         // fused0 / x_view width
#define FM_F1 8          // fused1 width
// Rows of the arena XA, reused phase by phase:
#define FM_XA_ROWS 196   // kernel 11's first gate/fuse input
#define FM_R_F0 0        // fused0, 64 rows (kernel 11: written over its input)
#define FM_R_X1 64       // kernel 11: the 28 input rows of the second gate/fuse
#define FM_R_F1 64       // fused1, 8 rows (written over them)
#define FM_R_PE 72       // the positional encoding, a chunk of keypoints
#define FM_PE_ROWS 120   // rows a chunk may fill (a multiple of 8)
#define FM_R_MV 0        // pooled [mean | var], 128 rows (fused0/1 are dead)
#define FM_R_TX 100      // kernel 11: the texture input, 96 rows; the latent
                         // lands at its rows 69-92 (above the pooled rows)
#define FM_ROWS (FM_XA_ROWS + FM_HMAX + 8 + 16)  // XA, H, S, G + O
#define FM_TRIES (1u << 22)       // polls of a ring barrier before a trap
#define FM_MAX_BIAS 840  // the geometry biases at the widest (5 x 128 + 64
                         // + 2 + 96 = 802) and the 31 words past them that
                         // the last layer's padding columns read

// FM_OUT: no activation and, in the bfloat16 body, no rounding (`out`)
enum { FM_NONE = 0, FM_SOFTPLUS, FM_RELU, FM_SIGMOID, FM_POOL, FM_OUT };

// The activation rows' element: f32, or bfloat16 bits in the BF body.
template <bool BF>
using FmAct = typename std::conditional<BF, unsigned short, float>::type;

// bytes of a (k-tile, n-tile) of the stream, and the k rows of a k-tile
template <bool BF>
__host__ __device__ __forceinline__ constexpr int fm_tile_bytes() {
  return BF ? 256 : 512;
}

template <bool BF>
__host__ __device__ __forceinline__ constexpr int fm_ktile() {
  return BF ? 16 : 8;
}

__device__ __forceinline__ float fm_ld(const float* p) { return *p; }
__device__ __forceinline__ float fm_ld(const unsigned short* p) {
  return vt_bf16_float(*p);
}
__device__ __forceinline__ void fm_st(float* p, float v) { *p = v; }
// stores into a bfloat16 row round
__device__ __forceinline__ void fm_st(unsigned short* p, float v) {
  *p = vt_bf16_bits(v);
}

// x rounded to the activation dtype (the identity in the f32 body)
template <bool BF>
__device__ __forceinline__ float fm_rnd(float x) {
  return BF ? vt_bf16_round(x) : x;
}

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
// runs of consecutive k-tiles of at most FM_SLOT floats, each item's size
// in 512-byte tiles.
struct FmSched {
  int n;
  unsigned char tiles[FM_MAX_ITEMS];
};

struct FmParts {
  int n;
  int w[6];
};

// n8 tiles of an M-wide layer: ceil(M / 8) rounded up to one of the
// counts the layer routine is instantiated for
__host__ __device__ __forceinline__ int fm_ntiles(int M) {
  const int n = (M + 7) >> 3;
  return n <= 4 ? n : (n <= 8 ? 8 : (n <= 12 ? 12 : 16));
}

__host__ __device__ __forceinline__ int fm_pe_per(int P) {
  return FM_PE_ROWS / P;  // keypoints a chunk of the encoding
}

// Shared memory, in bytes: the ring, the activation rows (XA, H), the f32
// rows (S, G, O), the biases, the keypoints, then the 2 x FM_R barriers.
template <bool BF>
__host__ __device__ __forceinline__ int fm_bias_offset() {
  return 4 * (FM_R * FM_SLOT + 24 * FM_TPS) +
         static_cast<int>(sizeof(FmAct<BF>)) * (FM_XA_ROWS + FM_HMAX) *
             FM_TPS;
}

template <bool BF>
__host__ __device__ __forceinline__ int fm_kp_offset() {
  return fm_bias_offset<BF>() + 4 * FM_MAX_BIAS;
}

template <bool BF>
__host__ __device__ __forceinline__ int fm_bar_offset(int K) {
  return fm_kp_offset<BF>() + 4 * ((3 * K + 3) & ~3);
}

template <bool BF>
__host__ __device__ __forceinline__ size_t fm_smem_bytes(int K) {
  return fm_bar_offset<BF>(K) + 2 * FM_R * 8;
}

extern __shared__ __align__(128) float fm_sm[];

__device__ __forceinline__ char* fm_at(int bytes) {
  return reinterpret_cast<char*>(fm_sm) + bytes;
}

template <bool BF>
struct FmSmem {
  FmAct<BF>* XA;  // the arena: inputs, encoding, pooled features
  FmAct<BF>* H;   // hidden state (128 rows)
  float* S;   // per-point scalars: cx cy cz w_v q_sdf q_vis vis_th vis_toh
  float* G;   // gates (8 rows)
  float* O;   // outputs (8 rows)
  float* kp;  // keypoints (3, K)
};

template <bool BF>
__device__ __forceinline__ FmSmem<BF> fm_carve() {
  FmSmem<BF> s;
  s.XA = reinterpret_cast<FmAct<BF>*>(fm_sm + FM_R * FM_SLOT);
  s.H = s.XA + FM_XA_ROWS * FM_TPS;
  s.S = reinterpret_cast<float*>(s.H + FM_HMAX * FM_TPS);
  s.G = s.S + 8 * FM_TPS;
  s.O = s.G + 8 * FM_TPS;
  s.kp = reinterpret_cast<float*>(fm_at(fm_kp_offset<BF>()));
  return s;
}

template <bool BF>
__device__ __forceinline__ unsigned long long* fm_full(int K) {
  return reinterpret_cast<unsigned long long*>(fm_at(fm_bar_offset<BF>(K)));
}

// the warp's first point column within the block's rows
__device__ __forceinline__ int fm_wp() { return (threadIdx.x >> 5) * FM_WP; }

// ---------------------------------------------------------------------------
// the layer core: 3xTF32 mma.sync over the ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fm_split(float x, unsigned& hi,
                                         unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void fm_mma(float (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, from a zero sum
__device__ __forceinline__ void fm_mma0(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  const float z = 0.0f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(z));
}

// The next k-tile of the stream, of nt n-tiles, at stream position pos (in
// bytes; an item a slot of 4 FM_SLOT bytes: item pos / slot, pos % slot
// bytes of it taken).  A k-tile that does not fit in what is left of the
// item starts the next one, as fm_schedule groups them; at the start of an
// item the warp releases the one before, which it has read, and waits for
// this one's copy.  Returns the k-tile's first byte and advances pos.
template <bool BF>
__device__ __forceinline__ const char* fm_next(int& pos, int nt, int Kb) {
  constexpr int slot = 4 * FM_SLOT;
  unsigned long long* full = fm_full<BF>(Kb);
  const int need = fm_tile_bytes<BF>() * nt;
  int off = pos % slot;
  if (off != 0 && off + need > slot) {
    pos += slot - off;
    off = 0;
  }
  const int item = pos / slot, s = item % FM_R;
  if (off == 0) {
    if (item > 0) {
      __syncwarp();  // every lane has read the item before
      if ((threadIdx.x & 31) == 0) bar_arrive(full + FM_R + (item - 1) % FM_R);
    }
    if (!bar_wait_bounded(full + s, (item / FM_R) & 1, FM_TRIES)) __trap();
  }
  pos += need;
  return fm_at(s * slot + off);
}

// acc += X (K rows of shared memory, the warp's 16 points) x the next
// ceil(K / 8) k-tiles of the stream from position pos; returns the new
// position.  Rows at or past K read as 0 (the packed rows there are 0).
template <int NT>
__device__ __forceinline__ int fm_mma_acc(int pos, int K, const float* X,
                                          float (&acc)[NT][4], int Kb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* xp = X + fm_wp() + g;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const int kr = K - k0;
    // rows past K (inside the arena) are read and replaced by 0
    const float* x0 = xp + (k0 + t) * FM_TPS;
    const float a[4] = {t < kr ? x0[0] : 0.0f, t < kr ? x0[8] : 0.0f,
                        t + 4 < kr ? x0[4 * FM_TPS] : 0.0f,
                        t + 4 < kr ? x0[4 * FM_TPS + 8] : 0.0f};
    unsigned ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) fm_split(a[i], ah[i], al[i]);
    const float4* wf =
        reinterpret_cast<const float4*>(fm_next<false>(pos, NT, Kb)) + lane;
    float4 w[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) w[n] = wf[32 * n];
    // the k-tile's three products, the small ones first, in three passes
    // over the tiles (the products into one sum stand NT apart) into a
    // fresh sum, which the CUDA cores then add to the layer's, rounded to
    // nearest: the tensor cores' own f32 accumulation over a layer's
    // k-tiles loses bits (PERF.md section 6)
    float kt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      fm_mma0(kt[n], al, __float_as_uint(w[n].x), __float_as_uint(w[n].y));
#pragma unroll
    for (int n = 0; n < NT; ++n)
      fm_mma(kt[n], ah, __float_as_uint(w[n].z), __float_as_uint(w[n].w));
#pragma unroll
    for (int n = 0; n < NT; ++n)
      fm_mma(kt[n], ah, __float_as_uint(w[n].x), __float_as_uint(w[n].y));
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += kt[n][i];
  }
  return pos;
}

__device__ __forceinline__ void fm_mma_bf16(float (&c)[4],
                                            const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bfloat16 form of fm_mma_acc: acc += X (K bfloat16 rows) x the next
// ceil(K / 16) k-tiles, one m16n8k16 product each, summed on the tensor
// cores.  The A fragment of lane (g, t): points g and g + 8 at rows 2t,
// 2t + 1 (one register, the lower row in the low half) and 2t + 8, 2t + 9.
template <int NT>
__device__ __forceinline__ int fm_mma_acc(int pos, int K,
                                          const unsigned short* X,
                                          float (&acc)[NT][4], int Kb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const unsigned short* xp = X + fm_wp() + g;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int kr = K - k0 - 2 * t;  // rows 2t + r of the tile exist if r < kr
    const unsigned short* x0 = xp + (k0 + 2 * t) * FM_TPS;
    unsigned a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i >> 1) * 8, col = (i & 1) * 8;  // rows 2t + r, + 1
      const unsigned lo = r < kr ? x0[r * FM_TPS + col] : 0u;
      const unsigned hi = r + 1 < kr ? x0[(r + 1) * FM_TPS + col] : 0u;
      a[i] = lo | (hi << 16);
    }
    const uint2* wf =
        reinterpret_cast<const uint2*>(fm_next<true>(pos, NT, Kb)) + lane;
    uint2 w[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) w[n] = wf[32 * n];
#pragma unroll
    for (int n = 0; n < NT; ++n) fm_mma_bf16(acc[n], a, w[n].x, w[n].y);
  }
  return pos;
}

// The bfloat16 body (BF) evaluates softplus as the JAX kernel and the plain
// version write it, logaddexp(100 x, 0) * 0.01 = (max(100 x, 0) +
// log1p(exp(-|100 x|))) * 0.01 with the accurate functions (torch's
// logaddexp on the card), so that a sum that rounds to one bfloat16 gives
// the plain version's value to the bit and the kernel differs from it by
// the order of its sums alone; the f32 body keeps the fast intrinsics (good
// to ~4e-7, inside its f32 tolerance).
template <int ACT, bool BF = false>
__device__ __forceinline__ float fm_act(float v) {
  if (ACT == FM_SOFTPLUS) {
    const float xb = v * 100.0f;
    if (BF)
      return xb > 20.0f
                 ? v
                 : (fmaxf(xb, 0.0f) + log1pf(expf(-fabsf(xb)))) * 0.01f;
    return xb > 20.0f
               ? v
               : fmaxf(v, 0.0f) + __logf(1.0f + __expf(-fabsf(xb))) * 0.01f;
  }
  if (ACT == FM_RELU) return fmaxf(v, 0.0f);
  if (ACT == FM_SIGMOID) return 1.0f / (1.0f + expf(-v));
  return v;
}

// dst rows [0, M) = act(acc + bias) at the warp's points (bias in shared
// memory, or none); FM_POOL writes the V=1 pooled mean to rows [0, M) and
// the variance to rows [M, 2M), weighted by wv per point.  Accumulator
// element (n, i) is point g + 8 (i >> 1), channel 8 n + 2 t + (i & 1) (the
// m16n8 C fragment).  The activation is a template parameter: the lane's
// 4 NT elements then run as independent straight-line chains.  In the
// bfloat16 body (BF) the sum with its bias is rounded before the
// activation (FM_OUT: not) and the result after it, whatever the row's
// type (dst D: an activation row or an f32 row).
template <int NT, int ACT, bool BF, typename D>
__device__ __forceinline__ void fm_store(float (&acc)[NT][4],
                                         const float* bias, int M, D* dst,
                                         const float* wv) {
  __syncwarp();  // the warp has read its inputs (dst may alias them)
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p = fm_wp() + g;
  // every element is computed (the padding columns from 0 + the shared
  // words after the bias) and only M columns stored, and every bias (and
  // pooling weight) is read before the first store, which the compiler
  // must otherwise assume may write it: the lane's elements run as
  // independent chains without branches
  float bv[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      bv[n][j] = bias ? bias[8 * n + 2 * t + j] : 0.0f;
  const float wv0 = ACT == FM_POOL ? wv[p] : 0.0f;
  const float wv1 = ACT == FM_POOL ? wv[p + 8] : 0.0f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = 8 * n + 2 * t + j;
      float r[2] = {acc[n][j] + bv[n][j], acc[n][2 + j] + bv[n][j]};
      D* row = dst + m * FM_TPS + p;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ACT != FM_OUT) r[h] = fm_rnd<BF>(r[h]);
        if (ACT == FM_POOL) {
          const float w = h ? wv1 : wv0;
          const float mean = w * r[h];
          const float d = r[h] - mean;
          if (m < M) fm_st(row + M * FM_TPS + 8 * h, fm_rnd<BF>(w * (d * d)));
          r[h] = mean;
        } else {
          r[h] = fm_act<ACT, BF>(r[h]);
        }
        if (ACT != FM_OUT) r[h] = fm_rnd<BF>(r[h]);
        if (m < M) fm_st(row + 8 * h, r[h]);
      }
    }
  }
  __syncwarp();  // the outputs are written before the warp reads them
}

template <int NT, bool BF, typename D>
__device__ __forceinline__ void fm_store_act(float (&acc)[NT][4],
                                             const float* bias, int M,
                                             int act, D* dst,
                                             const float* wv) {
  switch (act) {
    case FM_SOFTPLUS:
      fm_store<NT, FM_SOFTPLUS, BF>(acc, bias, M, dst, wv);
      break;
    case FM_RELU: fm_store<NT, FM_RELU, BF>(acc, bias, M, dst, wv); break;
    case FM_SIGMOID:
      fm_store<NT, FM_SIGMOID, BF>(acc, bias, M, dst, wv);
      break;
    case FM_POOL: fm_store<NT, FM_POOL, BF>(acc, bias, M, dst, wv); break;
    case FM_OUT:  // FM_NONE's instantiation in the f32 body (no rounding)
      fm_store<NT, (BF ? FM_OUT : FM_NONE), BF>(acc, bias, M, dst, wv);
      break;
    default: fm_store<NT, FM_NONE, BF>(acc, bias, M, dst, wv);
  }
}

template <int NT, bool BF, typename D>
__device__ __noinline__ int fm_layer_t(int pos, int Kb, int M, int act,
                                       const float* bias, D* dst,
                                       const float* wv, const FmAct<BF>* X0,
                                       int K0, const FmAct<BF>* X1,
                                       int K1) {
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
  pos = fm_mma_acc<NT>(pos, K0, X0, acc, Kb);
  if (K1 > 0) pos = fm_mma_acc<NT>(pos, K1, X1, acc, Kb);
  fm_store_act<NT, BF>(acc, bias, M, act, dst, wv);
  return pos;
}

#define FM_NT_CASES(F) F(1) F(2) F(3) F(4) F(8) F(12) F(16)

// One layer over the virtual concat [X0 (K0 rows) | X1 (K1 rows)] at the
// warp's points; returns the next item of the stream.
template <bool BF, typename D>
__device__ __forceinline__ int fm_layer(int pos, int Kb, int M, int act,
                                        const float* bias, D* dst,
                                        const float* wv, const FmAct<BF>* X0,
                                        int K0,
                                        const FmAct<BF>* X1 = nullptr,
                                        int K1 = 0) {
  switch (fm_ntiles(M)) {
#define FM_CASE(n) \
  case n:          \
    return fm_layer_t<n, BF>(pos, Kb, M, act, bias, dst, wv, X0, K0, X1, K1);
    FM_NT_CASES(FM_CASE)
#undef FM_CASE
  }
  return pos;
}

// ---------------------------------------------------------------------------
// the producer warp
// ---------------------------------------------------------------------------

template <bool BF>
__device__ __forceinline__ void fm_produce(const FmSched& sc,
                                           const void* __restrict__ w,
                                           int Kb) {
  if ((threadIdx.x & 31) != 0) return;
  unsigned long long* full = fm_full<BF>(Kb);
  unsigned long long* empty = full + FM_R;
  const char* src = static_cast<const char*>(w);
  for (int i = 0; i < sc.n; ++i) {
    const int s = i % FM_R;
    if (i >= FM_R && !bar_wait_bounded(empty + s, (i / FM_R - 1) & 1,
                                       FM_TRIES))
      __trap();
    const unsigned bytes = fm_tile_bytes<BF>() * sc.tiles[i];
    bar_expect(full + s, bytes);
    bulk_load(fm_sm + s * FM_SLOT, src, bytes, full + s);
    src += bytes;
  }
}

// Barriers, keypoints, biases; then the producer warp leaves for its loop
// and the consumers go on (no block barrier after this one).
template <bool BF>
__device__ __forceinline__ bool fm_start(const FmGeo& g, const FmSched& sc,
                                         const void* __restrict__ w) {
  unsigned long long* full = fm_full<BF>(g.K);
  if (threadIdx.x == 0) {
    for (int r = 0; r < FM_R; ++r) {
      bar_init(full + r, 1);
      bar_init(full + FM_R + r, FM_CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* kp = reinterpret_cast<float*>(fm_at(fm_kp_offset<BF>()));
  for (int k = threadIdx.x; k < 3 * g.K; k += FM_NT) kp[k] = __ldg(g.kpt_T + k);
  float* bias = reinterpret_cast<float*>(fm_at(fm_bias_offset<BF>()));
  const int nb = g.d1 + g.d2 + g.d3 + FM_F0 + g.e1 + g.e2 + 2 + g.lat;
  for (int k = threadIdx.x; k < nb; k += FM_NT) bias[k] = __ldg(g.b + k);
  __syncthreads();
  if ((threadIdx.x >> 5) == FM_CW) {
    fm_produce<BF>(sc, w, g.K);
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// per-warp data movement (each warp its own 16 points)
// ---------------------------------------------------------------------------

// Columns [col0, col0 + ncols) of a row-major (N, stride) array for the
// warp's points -> shared rows [c][p], by 4-byte asynchronous copies
// (cp.async; points past N read 0); a warp reads 4 points x 8 columns
// (whole 32-byte sectors).  The copies land by fm_load_wait: a phase
// issues all its columns first, so that their latencies overlap.  A
// bfloat16 source is read by plain loads, into bfloat16 rows or widened
// into f32 rows.
template <typename S, typename D>
__device__ __forceinline__ void fm_load_cols(const S* __restrict__ src,
                                             int stride, int col0, int ncols,
                                             int N, D* dst) {
  const int wp = fm_wp();
  const int gp0 = blockIdx.x * FM_TP + wp;
  const int total = ((ncols + 7) >> 3) * 8 * FM_WP;
  for (int e = threadIdx.x & 31; e < total; e += 32) {
    const int c = ((e >> 7) << 3) + (e & 7);
    if (c >= ncols) continue;
    const int p = (e >> 3) & (FM_WP - 1);
    const int gp = gp0 + p;
    const S* from =
        src + static_cast<long long>(min(gp, N - 1)) * stride + col0 + c;
    if constexpr (std::is_same<S, float>::value) {
      static_assert(std::is_same<D, float>::value, "f32 into f32 rows");
      asm volatile(
          "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
              smem_addr(dst + c * FM_TPS + wp + p)),
          "l"(from), "r"(gp < N ? 4 : 0)
          : "memory");
    } else {
      const unsigned short v = gp < N ? __ldg(from) : 0;
      if constexpr (std::is_same<D, float>::value)
        dst[c * FM_TPS + wp + p] = vt_bf16_float(v);
      else
        dst[c * FM_TPS + wp + p] = v;
    }
  }
}

__device__ __forceinline__ void fm_load_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Ask L2 for the warp's rows of a row-major (N, stride) array, one request
// per 128-byte line, so that the later column loads find them there.
template <typename S>
__device__ __forceinline__ void fm_prefetch_rows(const S* __restrict__ src,
                                                 int stride, int N) {
  const int gp0 = blockIdx.x * FM_TP + fm_wp();
  const int rows = min(FM_WP, N - gp0);
  if (rows <= 0) return;
  const char* base = reinterpret_cast<const char*>(
      src + static_cast<long long>(gp0) * stride);
  const long long bytes =
      static_cast<long long>(rows) * stride * static_cast<long long>(sizeof(S));
  for (long long o = (threadIdx.x & 31) * 128LL; o < bytes; o += 32 * 128LL)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + o));
}

// rows [0, nrows) of X *= the per-point f32 row `scale`, at the warp's
// points (rounded in a bfloat16 row)
template <typename T>
__device__ __forceinline__ void fm_scale_rows(T* X, int nrows,
                                              const float* scale) {
  const int wp = fm_wp();
  for (int e = threadIdx.x & 31; e < nrows * FM_WP; e += 32) {
    const int p = wp + (e & (FM_WP - 1));
    T* x = X + (e / FM_WP) * FM_TPS + p;
    fm_st(x, fm_ld(x) * scale[p]);
  }
  __syncwarp();
}

template <typename T>
__device__ __forceinline__ void fm_copy_row(T* dst, const float* src) {
  const int lane = threadIdx.x & 31;
  if (lane < FM_WP) fm_st(dst + fm_wp() + lane, src[fm_wp() + lane]);
  __syncwarp();
}

// Shared rows [c][p] -> row-major (N, ncols) device memory of the rows'
// type, the warp's points.
template <typename T>
__device__ __forceinline__ void fm_write_out(const T* rows, int ncols,
                                             int N, T* __restrict__ out) {
  const int wp = fm_wp();
  const int gp0 = blockIdx.x * FM_TP + wp;
  for (int e = threadIdx.x & 31; e < ncols * FM_WP; e += 32) {
    const int p = e / ncols, c = e - p * ncols;
    if (gp0 + p < N)
      out[static_cast<long long>(gp0 + p) * ncols + c] =
          rows[c * FM_TPS + wp + p];
  }
}

// rel_z_decay encoding of keypoints [j0, j0 + nj) -> rows [jl * P + part]
// (keypoint-major, the order ops/fused_mlp.py packs the first layer's rows
// in): part 0 is dz, then sin/cos(pi dz) and their octaves by the
// double-angle recurrence, each times the Gaussian keypoint weight (in
// f32; a bfloat16 row rounds it).
template <bool BF>
__device__ __forceinline__ void fm_pe(const FmGeo& g, const FmSmem<BF>& s,
                                      FmAct<BF>* dst, int j0, int nj) {
  const int K = g.K;
  const int P = 1 + 2 * g.L;
  const int wp = fm_wp();
  for (int e = threadIdx.x & 31; e < nj * FM_WP; e += 32) {
    const int p = wp + (e & (FM_WP - 1));
    const int jl = e / FM_WP;
    const int j = j0 + jl;
    const float dxx = s.S[p] - s.kp[j];
    const float dyy = s.S[FM_TPS + p] - s.kp[K + j];
    const float dzz = s.S[2 * FM_TPS + p] - s.kp[2 * K + j];
    const float dz = g.scale * dzz;
    const float wgt =
        expf(-(dxx * dxx + dyy * dyy + dzz * dzz) * g.inv_two_sig2);
    float sn, cs;
    sincosf(3.14159274101257324f * dz, &sn, &cs);
    FmAct<BF>* col = dst + jl * P * FM_TPS + p;
    fm_st(col, dz * wgt);
    for (int l = 0; l < g.L; ++l) {
      fm_st(col + (1 + 2 * l) * FM_TPS, sn * wgt);
      fm_st(col + (2 + 2 * l) * FM_TPS, cs * wgt);
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

// The first layer: the encoding is made a chunk of keypoints at a time in
// the arena and multiplied at once, then fused0; one accumulator, the bias
// last.
template <int NT, bool BF>
__device__ __noinline__ int fm_layer0_t(const FmGeo& g, const FmSmem<BF>& s,
                                        int pos, const float* bias) {
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
  const int P = 1 + 2 * g.L;
  const int per = fm_pe_per(P);
  FmAct<BF>* pe = s.XA + FM_R_PE * FM_TPS;
  for (int j0 = 0; j0 < g.K; j0 += per) {
    const int nj = min(per, g.K - j0);
    fm_pe(g, s, pe, j0, nj);
    pos = fm_mma_acc<NT>(pos, nj * P, pe, acc, g.K);
    __syncwarp();  // the chunk is read before the next one replaces it
  }
  pos = fm_mma_acc<NT>(pos, FM_F0, s.XA + FM_R_F0 * FM_TPS, acc, g.K);
  fm_store<NT, FM_SOFTPLUS, BF>(acc, bias, g.d1, s.H, nullptr);
  return pos;
}

template <bool BF>
__device__ __forceinline__ int fm_layer0(const FmGeo& g, const FmSmem<BF>& s,
                                         int pos, const float* bias) {
  switch (fm_ntiles(g.d1)) {
#define FM_CASE(n) \
  case n:          \
    return fm_layer0_t<n, BF>(g, s, pos, bias);
    FM_NT_CASES(FM_CASE)
#undef FM_CASE
  }
  return pos;
}

// PE + MLPUNetFusion (V=1) + gcompress.  Needs S rows 0-3, F0 and F1
// loaded.  Writes (sdf residual, radiance) to O rows 0-1 and the latent to
// `lat_dst` rows (outside the pooled rows).
template <bool BF>
__device__ __forceinline__ int fm_geo_body(const FmGeo& g, const FmSmem<BF>& s,
                                           int pos, FmAct<BF>* lat_dst) {
  const float* B = reinterpret_cast<const float*>(fm_at(fm_bias_offset<BF>()));
  const float* wv = s.S + 3 * FM_TPS;
  FmAct<BF>* MV = s.XA + FM_R_MV * FM_TPS;
  const int Kb = g.K;
  pos = fm_layer0(g, s, pos, B);
  B += g.d1;
  pos = fm_layer<BF>(pos, Kb, g.d2, FM_SOFTPLUS, B, s.H, wv, s.H, g.d1);
  B += g.d2;
  pos = fm_layer<BF>(pos, Kb, g.d3, FM_SOFTPLUS, B, s.H, wv, s.H, g.d2,
                     s.XA + FM_R_F1 * FM_TPS, FM_F1);
  B += g.d3;
  pos = fm_layer<BF>(pos, Kb, FM_F0, FM_POOL, B, MV, wv, s.H, g.d3);
  B += FM_F0;
  pos = fm_layer<BF>(pos, Kb, g.e1, FM_SOFTPLUS, B, s.H, wv, MV, 2 * FM_F0);
  B += g.e1;
  pos = fm_layer<BF>(pos, Kb, g.e2, FM_SOFTPLUS, B, s.H, wv, s.H, g.e1);
  B += g.e2;
  pos = fm_layer<BF>(pos, Kb, 2, FM_OUT, B, s.O, wv, s.H, g.e2);
  B += 2;
  return fm_layer<BF>(pos, Kb, g.lat, FM_NONE, B, lat_dst, wv, MV,
                      2 * FM_F0);
}

// GateMLP + FuseMLP over the X rows (Kin of them): gate hidden hg -> ng
// sigmoid gates; the first `parts.n` row groups are re-scaled by their
// gate; fuse hidden hf -> nout rows at dst.
template <bool BF, typename D>
__device__ __forceinline__ int fm_gate_fuse(int pos, int Kb,
                                            const FmSmem<BF>& s,
                                            FmAct<BF>* X, int Kin,
                                            FmParts parts, int hg, int ng,
                                            int hf, int nout, D* dst) {
  pos = fm_layer<BF>(pos, Kb, hg, FM_RELU, nullptr, s.H, nullptr, X, Kin);
  pos = fm_layer<BF>(pos, Kb, ng, FM_SIGMOID, nullptr, s.G, nullptr, s.H,
                     hg);
  int row = 0;
  for (int i = 0; i < parts.n; ++i) {
    fm_scale_rows(X + row * FM_TPS, parts.w[i], s.G + i * FM_TPS);
    row += parts.w[i];
  }
  pos = fm_layer<BF>(pos, Kb, hf, FM_RELU, nullptr, s.H, nullptr, X, Kin);
  return fm_layer<BF>(pos, Kb, nout, FM_NONE, nullptr, dst, nullptr, s.H,
                      hf);
}

// aux (N, 74): [fused0 64 | fused1 8 | out_mask | pix_weight]
template <bool BF>
__global__ void __launch_bounds__(FM_NT, 1)
fused_geo_kernel(FmGeo g, const __grid_constant__ FmSched sc,
                 const void* __restrict__ w,
                 const FmAct<BF>* __restrict__ aux, float* __restrict__ out,
                 FmAct<BF>* __restrict__ lat) {
  if (!fm_start<BF>(g, sc, w)) return;
  const FmSmem<BF> s = fm_carve<BF>();
  fm_load_cols(g.cxyz, 3, 0, 3, g.N, s.S);
  fm_load_cols(aux, 74, 0, FM_F0, g.N, s.XA + FM_R_F0 * FM_TPS);
  fm_load_cols(aux, 74, FM_F0, FM_F1, g.N, s.XA + FM_R_F1 * FM_TPS);
  fm_load_cols(aux, 74, 73, 1, g.N, s.S + 3 * FM_TPS);
  fm_load_wait();
  fm_geo_body(g, s, 0, s.H);
  fm_write_out(s.O, 2, g.N, out);
  fm_write_out(s.H, g.lat, g.N, lat);
}

// feats (N, 87): [feat_s0 64 | feat_s1 8 | img_xy 3 | ft_xy 8 | q_sdf |
//   q_vis | out_mask | pix_weight]; g2 (N, 204): the raw KNN rows
//   [geo64 | geo8 | tex 11 | tex_global 18 | vis] x {this, other hand}.
template <bool BF>
__global__ void __launch_bounds__(FM_NT, 1)
fused_query_kernel(FmGeo g, const __grid_constant__ FmSched sc,
                   const void* __restrict__ w,
                   const FmAct<BF>* __restrict__ feats,
                   const FmAct<BF>* __restrict__ g2, float* __restrict__ out) {
  if (!fm_start<BF>(g, sc, w)) return;
  const FmSmem<BF> s = fm_carve<BF>();
  const int N = g.N, Kb = g.K;
  const int C1 = 102;
  FmAct<BF>* XA = s.XA;
  float* q_sdf = s.S + 4 * FM_TPS;
  float* q_vis = s.S + 5 * FM_TPS;
  float* vis_th = s.S + 6 * FM_TPS;
  float* vis_toh = s.S + 7 * FM_TPS;
  fm_prefetch_rows(g2, 204, N);
  fm_prefetch_rows(feats, 87, N);
  fm_load_cols(g.cxyz, 3, 0, 3, N, s.S);
  fm_load_cols(feats, 87, 86, 1, N, s.S + 3 * FM_TPS);
  fm_load_cols(feats, 87, 83, 2, N, q_sdf);  // q_sdf, q_vis
  fm_load_cols(g2, 204, 101, 1, N, vis_th);
  fm_load_cols(g2, 204, C1 + 101, 1, N, vis_toh);

  // GeoVisFusion scale 0: [fs0 | th g0 | toh g0 | ctx4] (196 rows of the
  // arena) -> fused0, written over the first input rows once they are read
  fm_load_cols(feats, 87, 0, 64, N, XA);
  fm_load_cols(g2, 204, 0, 64, N, XA + 64 * FM_TPS);
  fm_load_cols(g2, 204, C1, 64, N, XA + 128 * FM_TPS);
  fm_load_wait();
  fm_scale_rows(XA + 64 * FM_TPS, 64, vis_th);
  fm_scale_rows(XA + 128 * FM_TPS, 64, vis_toh);
  fm_copy_row(XA + 192 * FM_TPS, q_sdf);
  fm_copy_row(XA + 193 * FM_TPS, q_vis);
  fm_copy_row(XA + 194 * FM_TPS, vis_th);
  fm_copy_row(XA + 195 * FM_TPS, vis_toh);
  FmParts gp;
  gp.n = 3;
  gp.w[0] = gp.w[1] = gp.w[2] = 64;
  int pos = fm_gate_fuse(0, Kb, s, XA, 196, gp, 10, 3, 64, 64,
                        XA + FM_R_F0 * FM_TPS);

  // scale 1: [fs1 | th g1 | toh g1 | ctx4] -> fused1
  FmAct<BF>* X1 = XA + FM_R_X1 * FM_TPS;
  fm_load_cols(feats, 87, 64, 8, N, X1);
  fm_load_cols(g2, 204, 64, 8, N, X1 + 8 * FM_TPS);
  fm_load_cols(g2, 204, C1 + 64, 8, N, X1 + 16 * FM_TPS);
  fm_load_wait();
  fm_copy_row(X1 + 24 * FM_TPS, q_sdf);
  fm_copy_row(X1 + 25 * FM_TPS, q_vis);
  fm_copy_row(X1 + 26 * FM_TPS, vis_th);
  fm_copy_row(X1 + 27 * FM_TPS, vis_toh);
  fm_scale_rows(X1 + 8 * FM_TPS, 8, vis_th);
  fm_scale_rows(X1 + 16 * FM_TPS, 8, vis_toh);
  gp.w[0] = gp.w[1] = gp.w[2] = 8;
  pos = fm_gate_fuse(pos, Kb, s, X1, 28, gp, 10, 3, 8, 8,
                    XA + FM_R_F1 * FM_TPS);

  // geometry body; its latent lands in the texture gate's input rows
  FmAct<BF>* TX = XA + FM_R_TX * FM_TPS;  // 96 rows: [qf 11 | th tf |
                                          //  toh tf | th tg 18 | toh tg 18
                                          //  | lat 24 | vis3]
  pos = fm_geo_body(g, s, pos, TX + 69 * FM_TPS);

  // TexVisFusion gate/fuse -> rgb
  fm_load_cols(feats, 87, 72, 11, N, TX);
  fm_load_cols(g2, 204, 72, 11, N, TX + 11 * FM_TPS);
  fm_load_cols(g2, 204, C1 + 72, 11, N, TX + 22 * FM_TPS);
  fm_load_cols(g2, 204, 83, 18, N, TX + 33 * FM_TPS);
  fm_load_cols(g2, 204, C1 + 83, 18, N, TX + 51 * FM_TPS);
  fm_load_wait();
  fm_copy_row(TX + 93 * FM_TPS, q_vis);
  fm_copy_row(TX + 94 * FM_TPS, vis_th);
  fm_copy_row(TX + 95 * FM_TPS, vis_toh);
  fm_scale_rows(TX + 11 * FM_TPS, 11, vis_th);
  fm_scale_rows(TX + 22 * FM_TPS, 11, vis_toh);
  fm_scale_rows(TX + 33 * FM_TPS, 18, vis_th);
  fm_scale_rows(TX + 51 * FM_TPS, 18, vis_toh);
  FmParts tp;
  tp.n = 6;
  tp.w[0] = tp.w[1] = tp.w[2] = 11;
  tp.w[3] = tp.w[4] = 18;
  tp.w[5] = 24;
  fm_gate_fuse(pos, Kb, s, TX, 96, tp, 96, 6, 96, 3, s.O + 2 * FM_TPS);
  fm_write_out(s.O, 5, N, out);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The k-tiles of K rows of an M-wide layer, appended as fm_next takes them:
// into the last item while it has room, else into a new one.
template <bool BF>
static bool fm_push(FmSched& sc, int K, int M) {
  const int nt = fm_ntiles(M);
  for (int k = 0; k < K; k += fm_ktile<BF>()) {
    if (sc.n > 0 &&
        fm_tile_bytes<BF>() * (sc.tiles[sc.n - 1] + nt) <= 4 * FM_SLOT) {
      sc.tiles[sc.n - 1] += nt;
    } else {
      if (sc.n >= FM_MAX_ITEMS) return false;
      sc.tiles[sc.n++] = static_cast<unsigned char>(nt);
    }
  }
  return true;
}

template <bool BF>
static bool fm_push_gate_fuse(FmSched& sc, int Kin, int hg, int ng, int hf,
                              int nout) {
  return fm_push<BF>(sc, Kin, hg) && fm_push<BF>(sc, hg, ng) &&
         fm_push<BF>(sc, Kin, hf) && fm_push<BF>(sc, hf, nout);
}

// The items of k-tiles the consumers take, in their order (fm_geo_body,
// fm_gate_fuse, the kernels above).
template <bool BF>
static bool fm_schedule(const FmGeo& g, bool full, FmSched& sc) {
  sc.n = 0;
  bool ok = true;
  if (full) {
    ok = ok && fm_push_gate_fuse<BF>(sc, 196, 10, 3, 64, 64);
    ok = ok && fm_push_gate_fuse<BF>(sc, 28, 10, 3, 8, 8);
  }
  const int P = 1 + 2 * g.L, per = fm_pe_per(P);
  for (int j0 = 0; j0 < g.K; j0 += per)
    ok = ok && fm_push<BF>(sc, (g.K - j0 < per ? g.K - j0 : per) * P, g.d1);
  ok = ok && fm_push<BF>(sc, FM_F0, g.d1) && fm_push<BF>(sc, g.d1, g.d2) &&
       fm_push<BF>(sc, g.d2, g.d3) && fm_push<BF>(sc, FM_F1, g.d3) &&
       fm_push<BF>(sc, g.d3, FM_F0) && fm_push<BF>(sc, 2 * FM_F0, g.e1) &&
       fm_push<BF>(sc, g.e1, g.e2) && fm_push<BF>(sc, g.e2, 2) &&
       fm_push<BF>(sc, 2 * FM_F0, g.lat);
  if (full) ok = ok && fm_push_gate_fuse<BF>(sc, 96, 96, 6, 96, 3);
  return ok;
}

static int fm_check(const FmGeo& g, int need_lat) {
  if (g.N <= 0 || g.K <= 0 || g.K > 256 || g.L < 0 ||
      1 + 2 * g.L > FM_PE_ROWS)
    return 1;
  const int widths[] = {g.d1, g.d2, g.d3, g.e1, g.e2};
  for (int w : widths)
    if (w <= 0 || w > FM_HMAX) return 1;
  if (g.lat <= 0 || g.lat > 96) return 1;
  if (need_lat && g.lat != need_lat) return 1;
  return 0;
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

// The checks shared by the entry points: the widths, the schedule and the
// stream's size (w_elems values, 128 a tile) against it, the shared-memory
// limit.
template <bool BF, typename Kernel>
static int fm_prepare(Kernel kernel, const FmGeo& g, bool full,
                      long long w_elems, FmSched& sc, size_t& smem) {
  if (fm_check(g, full ? 24 : 0) || !fm_schedule<BF>(g, full, sc))
    return static_cast<int>(cudaErrorInvalidValue);
  long long tiles = 0;
  for (int i = 0; i < sc.n; ++i) tiles += sc.tiles[i];
  if (tiles * 128 != w_elems) return static_cast<int>(cudaErrorInvalidValue);
  smem = fm_smem_bytes<BF>(g.K);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <bool BF>
static int fm_run_geo(const float* cxyz, const float* kpt_T, const void* aux,
                      const void* w, long long w_elems, const float* b, int N,
                      int K, int L, float scale, float inv_two_sig2, const int* dims,
                      float* out, void* lat, void* stream) {
  if (N <= 0) return 0;
  const FmGeo g = fm_geo(cxyz, kpt_T, b, N, K, L, scale, inv_two_sig2, dims);
  FmSched sc;
  size_t smem = 0;
  const int rc =
      fm_prepare<BF>(fused_geo_kernel<BF>, g, false, w_elems, sc, smem);
  if (rc) return rc;
  fused_geo_kernel<BF>
      <<<vt_blocks(N, FM_TP), FM_NT, smem, vt_stream(stream)>>>(
          g, sc, w, static_cast<const FmAct<BF>*>(aux), out,
          static_cast<FmAct<BF>*>(lat));
  return static_cast<int>(cudaGetLastError());
}

template <bool BF>
static int fm_run_query(const float* cxyz, const float* kpt_T,
                        const void* feats, const void* g2, const void* w,
                        long long w_elems, const float* b, int N, int K,
                        int L, float scale, float inv_two_sig2, const int* dims,
                        float* out, void* stream) {
  if (N <= 0) return 0;
  const FmGeo g = fm_geo(cxyz, kpt_T, b, N, K, L, scale, inv_two_sig2, dims);
  FmSched sc;
  size_t smem = 0;
  const int rc =
      fm_prepare<BF>(fused_query_kernel<BF>, g, true, w_elems, sc, smem);
  if (rc) return rc;
  fused_query_kernel<BF>
      <<<vt_blocks(N, FM_TP), FM_NT, smem, vt_stream(stream)>>>(
          g, sc, w, static_cast<const FmAct<BF>*>(feats),
          static_cast<const FmAct<BF>*>(g2), out);
  return static_cast<int>(cudaGetLastError());
}

// dims: six host ints {d1, d2, d3, e1, e2, lat}; w: the packed stream of
// w_floats floats (16-byte aligned)
VT_EXPORT int vt_fused_geo_mlp(const float* cxyz, const float* kpt_T,
                               const float* aux, const float* w,
                               long long w_floats, const float* b, int N,
                               int K, int L, float scale, float inv_two_sig2,
                               const int* dims, float* out, float* lat,
                               void* stream) {
  return fm_run_geo<false>(cxyz, kpt_T, aux, w, w_floats, b, N, K, L, scale,
                           inv_two_sig2, dims, out, lat, stream);
}

VT_EXPORT int vt_fused_query_mlp(const float* cxyz, const float* kpt_T,
                                 const float* feats, const float* g2,
                                 const float* w, long long w_floats,
                                 const float* b, int N, int K, int L,
                                 float scale, float inv_two_sig2, const int* dims,
                                 float* out, void* stream) {
  return fm_run_query<false>(cxyz, kpt_T, feats, g2, w, w_floats, b, N, K, L,
                             scale, inv_two_sig2, dims, out, stream);
}
