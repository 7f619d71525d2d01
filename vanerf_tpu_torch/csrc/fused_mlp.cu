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
// ~38k a point (~73 GFLOP against ~310 MB): both sit two orders above the
// memory bound and run on the f32 CUDA cores (no TF32, no tensor cores:
// the port computes in float32).
//
// Design (not the TPU kernel's 256-row VMEM tiles): a block of 256 threads
// owns 64 points and keeps every activation of those points in shared
// memory as rows [channel][point] (row stride 68 floats, so the transposing
// loads are conflict-free and every row stays 16-byte aligned); the rows
// are reused phase by phase so that a block needs 108 KB and two blocks
// share an SM (one block an SM left the kernel 22-29% slower: nothing hid
// its barriers and its loads).  A layer is a small matrix product: each
// thread accumulates a 4-point x MT-output tile in registers (MT = 8, 4, 2
// or 1 by the layer's width), reading the activations as one float4 and
// the weights as broadcast vectors.  The weights (~101k floats for kernel
// 12, more than a block's shared memory) are read from L2 in chunks of 16 input rows into an 8 KB staging buffer;
// the next chunk's loads are in flight in registers while the current one
// is multiplied.  A "virtual concat" (the positional encoding beside the
// fused features, the hidden state beside its skip input) is two such
// products into one accumulator, in the JAX order, with the bias added
// last.  The positional encoding is made in shared memory, a chunk of
// keypoints at a time, and consumed there; nothing but the inputs and the
// 2 + 24 (or 5) outputs touches device memory.
//
// Numerics: float32 in, float32 accumulate.  The products use fmaf
// explicitly (the library is built with -fmad=false for the kernels that
// must equal their plain versions bit for bit; this one cannot, because
// the plain version's matrix products sum in the library's own order) and
// is held to rtol 2e-4 / atol 2e-5.  sin/cos/exp of the encoding and the
// sigmoid's exp are the accurate versions.  Softplus is torch's
// Softplus(beta=100, threshold=20) written as max(x, 0) +
// log(1 + exp(-|100 x|)) / 100 with the fast intrinsics (see fm_act): the
// accurate log1pf(expf()) and its division took 30% of kernel 12.
//
// Weight layout (packed by ops/fused_mlp.py::_pack): each matrix (K, M)
// row-major with its columns zero-padded to MP = 128 / 64 / 32 / 16 for
// M > 64 / > 32 / > 16 / else, matrices back to back; biases unpadded.  The
// first layer's encoding rows come keypoint-major (row j * P + part).

#include "common.cuh"

#define FM_TP 64     // points per block
#define FM_TPS 68    // shared row stride in floats
#define FM_NT 256    // threads per block
#define FM_KC 16     // weight rows per staged chunk
#define FM_HMAX 128  // widest hidden layer
#define FM_F0 64     // fused0 / x_view width
#define FM_F1 8      // fused1 width
// Rows of the shared arena XA, reused phase by phase (see the kernels):
#define FM_XA_ROWS 224
#define FM_R_F0 0     // fused0, 64 rows (kernel 11: written over its own input)
#define FM_R_X1 64    // kernel 11: the 28 input rows of the second gate/fuse
#define FM_R_F1 92    // fused1, 8 rows
#define FM_R_PE 100   // the positional encoding, a chunk of keypoints at a time
#define FM_PE_ROWS (FM_XA_ROWS - FM_R_PE)
#define FM_R_MV 0     // pooled [mean | var], 128 rows (fused0/1 are dead)
#define FM_R_TX 128   // kernel 12: the latent; kernel 11: the texture input

enum { FM_NONE = 0, FM_SOFTPLUS, FM_RELU, FM_SIGMOID, FM_POOL };

struct FmGeo {
  const float* cxyz;   // (N, 3) camera-frame points
  const float* kpt_T;  // (3, K) camera-frame keypoints
  const float* w;      // packed geometry weights
  const float* b;      // biases b0..b7
  int N, K, L;
  float scale, two_sig2;
  int d1, d2, d3;      // layers1 widths (the last is FM_F0)
  int e1, e2;          // layers2 hidden widths (the last is 2)
  int lat;             // gcompress width
};

struct FmParts {
  int n;
  int w[6];
};

__host__ __device__ __forceinline__ int fm_mp(int M) {
  return M > 64 ? 128 : (M > 32 ? 64 : (M > 16 ? 32 : 16));
}

// acc += X (K rows in shared) x W (K x 16*MT in device memory)
template <int MT>
__device__ __forceinline__ void fm_dense_acc(const float* __restrict__ W,
                                             int K, const float* Xs,
                                             float* Ws, float (&acc)[4][MT]) {
  constexpr int MP = 16 * MT;
  constexpr int C4 = FM_KC * MP / 4;
  constexpr int NV = (C4 + FM_NT - 1) / FM_NT;
  const int tid = threadIdx.x;
  const int pg = tid & 15, mg = tid >> 4;
  const float4* W4 = reinterpret_cast<const float4*>(W);
  float4* Ws4 = reinterpret_cast<float4*>(Ws);
  const int total4 = K * (MP / 4);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 pre[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = tid + v * FM_NT;
    pre[v] = (i < C4 && i < total4) ? __ldg(W4 + i) : zero4;
  }
  for (int k0 = 0; k0 < K; k0 += FM_KC) {
    __syncthreads();  // the staging buffer is free, the inputs are written
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = tid + v * FM_NT;
      if (i < C4) Ws4[i] = pre[v];
    }
    __syncthreads();
    const int nbase = (k0 + FM_KC) * (MP / 4);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = tid + v * FM_NT;
      pre[v] = (i < C4 && nbase + i < total4) ? __ldg(W4 + nbase + i) : zero4;
    }
    const int kc = min(FM_KC, K - k0);
    const float* xp = Xs + k0 * FM_TPS + 4 * pg;
    const float* wp = Ws + mg * MT;
#pragma unroll 8
    for (int kk = 0; kk < kc; ++kk) {
      const float4 x4 = *reinterpret_cast<const float4*>(xp + kk * FM_TPS);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      float w[MT];
      if constexpr (MT == 8) {
        const float4 a = *reinterpret_cast<const float4*>(wp + kk * MP);
        const float4 b = *reinterpret_cast<const float4*>(wp + kk * MP + 4);
        w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
        w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
      } else if constexpr (MT == 4) {
        const float4 a = *reinterpret_cast<const float4*>(wp + kk * MP);
        w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      } else if constexpr (MT == 2) {
        const float2 a = *reinterpret_cast<const float2*>(wp + kk * MP);
        w[0] = a.x; w[1] = a.y;
      } else {
        w[0] = wp[kk * MP];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(x[i], w[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ float fm_act(float v, int act) {
  if (act == FM_SOFTPLUS) {
    // max(x, 0) + log(1 + exp(-|100 x|)) / 100: the argument of the log
    // lies in (1, 2], where the fast exp/log intrinsics are good to ~4e-7
    // absolute, 4e-9 after the division by 100
    const float xb = v * 100.0f;
    return xb > 20.0f
               ? v
               : fmaxf(v, 0.0f) + __logf(1.0f + __expf(-fabsf(xb))) * 0.01f;
  }
  if (act == FM_RELU) return fmaxf(v, 0.0f);
  if (act == FM_SIGMOID) return 1.0f / (1.0f + expf(-v));
  return v;
}

// dst rows [0, M) = act(acc + bias); FM_POOL writes the V=1 pooled mean to
// rows [0, M) and the variance to rows [M, 2M), weighted by wv per point.
template <int MT>
__device__ __forceinline__ void fm_store(float (&acc)[4][MT],
                                         const float* __restrict__ bias,
                                         int M, int act, float* dst,
                                         const float* wv) {
  __syncthreads();  // every thread has read its inputs (dst may alias them)
  const int tid = threadIdx.x;
  const int pg = tid & 15, mg = tid >> 4;
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int m = mg * MT + j;
    if (m >= M) continue;
    const float b = bias ? __ldg(bias + m) : 0.0f;
    float r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = acc[i][j] + b;
    float* row = dst + m * FM_TPS + 4 * pg;
    if (act == FM_POOL) {
      float var[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = wv[4 * pg + i];
        const float mean = w * r[i];
        const float d = r[i] - mean;
        var[i] = w * (d * d);
        r[i] = mean;
      }
      *reinterpret_cast<float4*>(row + M * FM_TPS) =
          make_float4(var[0], var[1], var[2], var[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = fm_act(r[i], act);
    }
    *reinterpret_cast<float4*>(row) = make_float4(r[0], r[1], r[2], r[3]);
  }
}

template <int MT>
__device__ __noinline__ void fm_layer_t(const float* __restrict__ W, int M,
                                        int act,
                                        const float* __restrict__ bias,
                                        float* dst, float* Ws,
                                        const float* wv, const float* X0,
                                        int K0, const float* X1, int K1) {
  float acc[4][MT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j] = 0.0f;
  fm_dense_acc<MT>(W, K0, X0, Ws, acc);
  if (K1 > 0) fm_dense_acc<MT>(W + K0 * 16 * MT, K1, X1, Ws, acc);
  fm_store<MT>(acc, bias, M, act, dst, wv);
}

// One layer over the virtual concat [X0 (K0 rows) | X1 (K1 rows)]; returns
// the packed size of its weight matrix in floats.
__device__ __forceinline__ int fm_layer(const float* __restrict__ W, int M,
                                        int act,
                                        const float* __restrict__ bias,
                                        float* dst, float* Ws,
                                        const float* wv, const float* X0,
                                        int K0, const float* X1, int K1) {
  const int mp = fm_mp(M);
  if (mp == 128) {
    fm_layer_t<8>(W, M, act, bias, dst, Ws, wv, X0, K0, X1, K1);
  } else if (mp == 64) {
    fm_layer_t<4>(W, M, act, bias, dst, Ws, wv, X0, K0, X1, K1);
  } else if (mp == 32) {
    fm_layer_t<2>(W, M, act, bias, dst, Ws, wv, X0, K0, X1, K1);
  } else {
    fm_layer_t<1>(W, M, act, bias, dst, Ws, wv, X0, K0, X1, K1);
  }
  return (K0 + K1) * mp;
}

// Columns [col0, col0 + ncols) of a row-major (N, stride) array for the
// block's points -> shared rows [c][p]; a warp reads 4 points x 8 columns
// (whole 32-byte sectors) and writes 32 distinct banks.  Each thread keeps
// FM_LD loads in flight before it stores any: two blocks an SM are too few
// to hide the latency of device memory by themselves.
#define FM_LD 8
__device__ __forceinline__ void fm_load_cols(const float* __restrict__ src,
                                             int stride, int col0, int ncols,
                                             int p0, int N, float* dst) {
  const int total = ((ncols + 7) >> 3) * 8 * FM_TP;
  for (int e0 = threadIdx.x; e0 < total; e0 += FM_LD * FM_NT) {
    float v[FM_LD];
#pragma unroll
    for (int u = 0; u < FM_LD; ++u) {
      const int e = e0 + u * FM_NT;
      const int c = ((e >> 9) << 3) + (e & 7);
      const int gp = p0 + ((e >> 3) & (FM_TP - 1));
      v[u] = (e < total && c < ncols && gp < N)
                 ? __ldg(src + static_cast<long long>(gp) * stride + col0 + c)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < FM_LD; ++u) {
      const int e = e0 + u * FM_NT;
      const int c = ((e >> 9) << 3) + (e & 7);
      if (e < total && c < ncols)
        dst[c * FM_TPS + ((e >> 3) & (FM_TP - 1))] = v[u];
    }
  }
}

// Ask L2 for the block's rows of a row-major (N, stride) array, one
// request per 128-byte line, so that the later column loads find them there.
__device__ __forceinline__ void fm_prefetch_rows(const float* __restrict__ src,
                                                 int stride, int p0, int N) {
  const int rows = min(FM_TP, N - p0);
  const char* base = reinterpret_cast<const char*>(
      src + static_cast<long long>(p0) * stride);
  const long long bytes = static_cast<long long>(rows) * stride * 4;
  for (long long o = threadIdx.x * 128LL; o < bytes; o += FM_NT * 128LL)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + o));
}

// rows [0, nrows) of X *= the per-point row `scale`
__device__ __forceinline__ void fm_scale_rows(float* X, int nrows,
                                              const float* scale) {
  for (int e = threadIdx.x; e < nrows * FM_TP; e += FM_NT) {
    const int p = e & (FM_TP - 1);
    X[(e >> 6) * FM_TPS + p] *= scale[p];
  }
}

__device__ __forceinline__ void fm_copy_row(float* dst, const float* src) {
  if (threadIdx.x < FM_TP) dst[threadIdx.x] = src[threadIdx.x];
}

// Shared rows [c][p] -> row-major (N, ncols) device memory.
__device__ __forceinline__ void fm_write_out(const float* rows, int ncols,
                                             int p0, int N,
                                             float* __restrict__ out) {
  for (int e = threadIdx.x; e < ncols * FM_TP; e += FM_NT) {
    const int p = e / ncols, c = e - p * ncols;
    if (p0 + p < N)
      out[static_cast<long long>(p0 + p) * ncols + c] = rows[c * FM_TPS + p];
  }
}

// rel_z_decay encoding of keypoints [j0, j0 + nj) -> rows [jl * P + part]
// (keypoint-major, the order ops/fused_mlp.py packs the first layer's rows
// in): part 0 is dz, then sin/cos(pi dz) and their octaves by the
// double-angle recurrence, each times the Gaussian keypoint weight.
__device__ __forceinline__ void fm_pe(const FmGeo& g, const float* S,
                                      const float* kp, float* dst, int j0,
                                      int nj) {
  const int K = g.K;
  const int P = 1 + 2 * g.L;
  for (int e = threadIdx.x; e < nj * FM_TP; e += FM_NT) {
    const int p = e & (FM_TP - 1);
    const int jl = e >> 6;
    const int j = j0 + jl;
    const float dxx = S[p] - kp[j];
    const float dyy = S[FM_TPS + p] - kp[K + j];
    const float dzz = S[2 * FM_TPS + p] - kp[2 * K + j];
    const float dz = g.scale * dzz;
    const float wgt =
        expf(-(dxx * dxx + dyy * dyy + dzz * dzz) / g.two_sig2);
    float s, c;
    sincosf(3.14159274101257324f * dz, &s, &c);
    float* col = dst + jl * P * FM_TPS + p;
    col[0] = dz * wgt;
    for (int l = 0; l < g.L; ++l) {
      col[(1 + 2 * l) * FM_TPS] = s * wgt;
      col[(2 + 2 * l) * FM_TPS] = c * wgt;
      const float s2 = 2.0f * s * c;
      c = 1.0f - 2.0f * s * s;
      s = s2;
    }
  }
}

struct FmSmem {
  float* Ws;  // weight staging, FM_KC x 128
  float* XA;  // the arena (FM_XA_ROWS rows): inputs, encoding, pooled features
  float* F0;  // fused0 (64 rows of XA)
  float* F1;  // fused1 (8 rows of XA)
  float* H;   // hidden state (128 rows)
  float* S;   // per-point scalars: cx cy cz w_v q_sdf q_vis vis_th vis_toh
  float* G;   // gates (8 rows)
  float* O;   // outputs (8 rows)
  float* kp;  // keypoints (3, K)
};

// 110,968 bytes at 42 keypoints: two blocks fit the SM's 227 KB.
__host__ __device__ __forceinline__ int fm_smem_floats(int K) {
  return FM_KC * 128 + (FM_XA_ROWS + FM_HMAX + 8 + 8 + 8) * FM_TPS + 3 * K;
}

__device__ __forceinline__ FmSmem fm_carve(float* sm) {
  FmSmem s;
  s.Ws = sm;
  s.XA = s.Ws + FM_KC * 128;
  s.F0 = s.XA + FM_R_F0 * FM_TPS;
  s.F1 = s.XA + FM_R_F1 * FM_TPS;
  s.H = s.XA + FM_XA_ROWS * FM_TPS;
  s.S = s.H + FM_HMAX * FM_TPS;
  s.G = s.S + 8 * FM_TPS;
  s.O = s.G + 8 * FM_TPS;
  s.kp = s.O + 8 * FM_TPS;
  return s;
}

// The first layer: the encoding is made a chunk of keypoints at a time in
// the arena and multiplied at once (all of it would not leave room for two
// blocks an SM), then fused0; one accumulator, the bias last.
template <int MT>
__device__ __noinline__ void fm_layer0_t(const FmGeo& g, const FmSmem& s,
                                         const float* __restrict__ W,
                                         const float* __restrict__ bias) {
  float acc[4][MT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j] = 0.0f;
  const int P = 1 + 2 * g.L;
  const int per = FM_PE_ROWS / P;  // keypoints a chunk
  float* pe = s.XA + FM_R_PE * FM_TPS;
  for (int j0 = 0; j0 < g.K; j0 += per) {
    const int nj = min(per, g.K - j0);
    __syncthreads();  // the last chunk has been read
    fm_pe(g, s.S, s.kp, pe, j0, nj);
    fm_dense_acc<MT>(W + j0 * P * 16 * MT, nj * P, pe, s.Ws, acc);
  }
  fm_dense_acc<MT>(W + g.K * P * 16 * MT, FM_F0, s.F0, s.Ws, acc);
  fm_store<MT>(acc, bias, g.d1, FM_SOFTPLUS, s.H, nullptr);
}

__device__ __forceinline__ int fm_layer0(const FmGeo& g, const FmSmem& s,
                                         const float* __restrict__ W,
                                         const float* __restrict__ bias) {
  const int mp = fm_mp(g.d1);
  if (mp == 128) {
    fm_layer0_t<8>(g, s, W, bias);
  } else if (mp == 64) {
    fm_layer0_t<4>(g, s, W, bias);
  } else if (mp == 32) {
    fm_layer0_t<2>(g, s, W, bias);
  } else {
    fm_layer0_t<1>(g, s, W, bias);
  }
  return ((1 + 2 * g.L) * g.K + FM_F0) * mp;
}

// PE + MLPUNetFusion (V=1) + gcompress.  Needs S rows 0-3, F0 and F1
// loaded.  Writes (sdf residual, radiance) to O rows 0-1 and the latent to
// `lat_dst` rows (shared, outside the pooled rows).  Leaves the pooled
// [mean | var] in XA rows 0-127.
__device__ __forceinline__ void fm_geo_body(const FmGeo& g, const FmSmem& s,
                                            float* lat_dst) {
  const float* W = g.w;
  const float* B = g.b;
  const float* wv = s.S + 3 * FM_TPS;
  float* MV = s.XA + FM_R_MV * FM_TPS;
  W += fm_layer0(g, s, W, B);
  B += g.d1;
  W += fm_layer(W, g.d2, FM_SOFTPLUS, B, s.H, s.Ws, wv, s.H, g.d1, nullptr,
                0);
  B += g.d2;
  W += fm_layer(W, g.d3, FM_SOFTPLUS, B, s.H, s.Ws, wv, s.H, g.d2, s.F1,
                FM_F1);
  B += g.d3;
  W += fm_layer(W, FM_F0, FM_POOL, B, MV, s.Ws, wv, s.H, g.d3, nullptr, 0);
  B += FM_F0;
  W += fm_layer(W, g.e1, FM_SOFTPLUS, B, s.H, s.Ws, wv, MV, 2 * FM_F0,
                nullptr, 0);
  B += g.e1;
  W += fm_layer(W, g.e2, FM_SOFTPLUS, B, s.H, s.Ws, wv, s.H, g.e1, nullptr,
                0);
  B += g.e2;
  W += fm_layer(W, 2, FM_NONE, B, s.O, s.Ws, wv, s.H, g.e2, nullptr, 0);
  B += 2;
  fm_layer(W, g.lat, FM_NONE, B, lat_dst, s.Ws, wv, MV, 2 * FM_F0, nullptr,
           0);
}

// GateMLP + FuseMLP over the X rows (Kin of them): gate hidden hg -> ng
// sigmoid gates; the first `parts.n` row groups are re-scaled by their
// gate; fuse hidden hf -> nout rows at dst.  Returns the packed size of
// its four matrices.
__device__ __forceinline__ int fm_gate_fuse(const float* __restrict__ W,
                                            const FmSmem& s, float* X,
                                            int Kin, FmParts parts, int hg,
                                            int ng, int hf, int nout,
                                            float* dst) {
  int used = fm_layer(W, hg, FM_RELU, nullptr, s.H, s.Ws, nullptr, X, Kin,
                      nullptr, 0);
  used += fm_layer(W + used, ng, FM_SIGMOID, nullptr, s.G, s.Ws, nullptr, s.H,
                   hg, nullptr, 0);
  __syncthreads();
  int row = 0;
  for (int i = 0; i < parts.n; ++i) {
    fm_scale_rows(X + row * FM_TPS, parts.w[i], s.G + i * FM_TPS);
    row += parts.w[i];
  }
  used += fm_layer(W + used, hf, FM_RELU, nullptr, s.H, s.Ws, nullptr, X, Kin,
                   nullptr, 0);
  used += fm_layer(W + used, nout, FM_NONE, nullptr, dst, s.Ws, nullptr, s.H,
                   hf, nullptr, 0);
  return used;
}

__device__ __forceinline__ void fm_load_common(const FmGeo& g,
                                               const FmSmem& s, int p0) {
  for (int k = threadIdx.x; k < 3 * g.K; k += FM_NT)
    s.kp[k] = __ldg(g.kpt_T + k);
  fm_load_cols(g.cxyz, 3, 0, 3, p0, g.N, s.S);
}

// aux (N, 74): [fused0 64 | fused1 8 | out_mask | pix_weight]
__global__ void __launch_bounds__(FM_NT, 2)
fused_geo_kernel(FmGeo g, const float* __restrict__ aux,
                 float* __restrict__ out, float* __restrict__ lat) {
  extern __shared__ __align__(16) float fm_sm[];
  const FmSmem s = fm_carve(fm_sm);
  const int p0 = blockIdx.x * FM_TP;
  fm_load_common(g, s, p0);
  fm_load_cols(aux, 74, 0, FM_F0, p0, g.N, s.F0);
  fm_load_cols(aux, 74, FM_F0, FM_F1, p0, g.N, s.F1);
  fm_load_cols(aux, 74, 73, 1, p0, g.N, s.S + 3 * FM_TPS);
  float* lat_rows = s.XA + FM_R_TX * FM_TPS;
  fm_geo_body(g, s, lat_rows);
  __syncthreads();
  fm_write_out(s.O, 2, p0, g.N, out);
  fm_write_out(lat_rows, g.lat, p0, g.N, lat);
}

// feats (N, 87): [feat_s0 64 | feat_s1 8 | img_xy 3 | ft_xy 8 | q_sdf |
//   q_vis | out_mask | pix_weight]; g2 (N, 204): the raw KNN rows
//   [geo64 | geo8 | tex 11 | tex_global 18 | vis] x {this, other hand}.
__global__ void __launch_bounds__(FM_NT, 2)
fused_query_kernel(FmGeo g, const float* __restrict__ fw,
                   const float* __restrict__ feats,
                   const float* __restrict__ g2, float* __restrict__ out) {
  extern __shared__ __align__(16) float fm_sm[];
  const FmSmem s = fm_carve(fm_sm);
  const int p0 = blockIdx.x * FM_TP;
  const int N = g.N;
  const int C1 = 102;
  float* XA = s.XA;
  float* q_sdf = s.S + 4 * FM_TPS;
  float* q_vis = s.S + 5 * FM_TPS;
  float* vis_th = s.S + 6 * FM_TPS;
  float* vis_toh = s.S + 7 * FM_TPS;
  fm_prefetch_rows(g2, 204, p0, N);
  fm_prefetch_rows(feats, 87, p0, N);
  fm_load_common(g, s, p0);
  fm_load_cols(feats, 87, 86, 1, p0, N, s.S + 3 * FM_TPS);
  fm_load_cols(feats, 87, 83, 2, p0, N, q_sdf);  // q_sdf, q_vis
  fm_load_cols(g2, 204, 101, 1, p0, N, vis_th);
  fm_load_cols(g2, 204, C1 + 101, 1, p0, N, vis_toh);

  // GeoVisFusion scale 0: [fs0 | th g0 | toh g0 | ctx4] (196 rows of the
  // arena) -> fused0, written over the first input rows once they are read
  fm_load_cols(feats, 87, 0, 64, p0, N, XA);
  fm_load_cols(g2, 204, 0, 64, p0, N, XA + 64 * FM_TPS);
  fm_load_cols(g2, 204, C1, 64, p0, N, XA + 128 * FM_TPS);
  __syncthreads();
  fm_scale_rows(XA + 64 * FM_TPS, 64, vis_th);
  fm_scale_rows(XA + 128 * FM_TPS, 64, vis_toh);
  fm_copy_row(XA + 192 * FM_TPS, q_sdf);
  fm_copy_row(XA + 193 * FM_TPS, q_vis);
  fm_copy_row(XA + 194 * FM_TPS, vis_th);
  fm_copy_row(XA + 195 * FM_TPS, vis_toh);
  FmParts gp;
  gp.n = 3;
  gp.w[0] = gp.w[1] = gp.w[2] = 64;
  const float* W = fw;
  W += fm_gate_fuse(W, s, XA, 196, gp, 10, 3, 64, 64, s.F0);

  // scale 1: [fs1 | th g1 | toh g1 | ctx4] -> fused1
  __syncthreads();
  float* X1 = XA + FM_R_X1 * FM_TPS;
  fm_load_cols(feats, 87, 64, 8, p0, N, X1);
  fm_load_cols(g2, 204, 64, 8, p0, N, X1 + 8 * FM_TPS);
  fm_load_cols(g2, 204, C1 + 64, 8, p0, N, X1 + 16 * FM_TPS);
  fm_copy_row(X1 + 24 * FM_TPS, q_sdf);
  fm_copy_row(X1 + 25 * FM_TPS, q_vis);
  fm_copy_row(X1 + 26 * FM_TPS, vis_th);
  fm_copy_row(X1 + 27 * FM_TPS, vis_toh);
  __syncthreads();
  fm_scale_rows(X1 + 8 * FM_TPS, 8, vis_th);
  fm_scale_rows(X1 + 16 * FM_TPS, 8, vis_toh);
  gp.w[0] = gp.w[1] = gp.w[2] = 8;
  W += fm_gate_fuse(W, s, X1, 28, gp, 10, 3, 8, 8, s.F1);

  // geometry body; its latent lands in the texture gate's input rows
  float* TX = XA + FM_R_TX * FM_TPS;  // 96 rows: [qf 11 | th tf | toh tf |
                                      //  th tg 18 | toh tg 18 | lat 24 | vis3]
  fm_geo_body(g, s, TX + 69 * FM_TPS);

  // TexVisFusion gate/fuse -> rgb
  fm_load_cols(feats, 87, 72, 11, p0, N, TX);
  fm_load_cols(g2, 204, 72, 11, p0, N, TX + 11 * FM_TPS);
  fm_load_cols(g2, 204, C1 + 72, 11, p0, N, TX + 22 * FM_TPS);
  fm_load_cols(g2, 204, 83, 18, p0, N, TX + 33 * FM_TPS);
  fm_load_cols(g2, 204, C1 + 83, 18, p0, N, TX + 51 * FM_TPS);
  fm_copy_row(TX + 93 * FM_TPS, q_vis);
  fm_copy_row(TX + 94 * FM_TPS, vis_th);
  fm_copy_row(TX + 95 * FM_TPS, vis_toh);
  __syncthreads();
  fm_scale_rows(TX + 11 * FM_TPS, 11, vis_th);
  fm_scale_rows(TX + 22 * FM_TPS, 11, vis_toh);
  fm_scale_rows(TX + 33 * FM_TPS, 18, vis_th);
  fm_scale_rows(TX + 51 * FM_TPS, 18, vis_toh);
  FmParts tp;
  tp.n = 6;
  tp.w[0] = tp.w[1] = tp.w[2] = 11;
  tp.w[3] = tp.w[4] = 18;
  tp.w[5] = 24;
  fm_gate_fuse(W, s, TX, 96, tp, 96, 6, 96, 3, s.O + 2 * FM_TPS);
  __syncthreads();
  fm_write_out(s.O, 5, p0, N, out);
}

static int fm_check(const FmGeo& g, int need_lat) {
  if (g.N <= 0 || g.K <= 0 || g.L < 0 || 1 + 2 * g.L > FM_PE_ROWS) return 1;
  const int widths[] = {g.d1, g.d2, g.d3, g.e1, g.e2};
  for (int w : widths)
    if (w <= 0 || w > FM_HMAX) return 1;
  if (g.lat <= 0 || g.lat > 96) return 1;
  if (need_lat && g.lat != need_lat) return 1;
  return 0;
}

static FmGeo fm_geo(const float* cxyz, const float* kpt_T, const float* w,
                    const float* b, int N, int K, int L, float scale,
                    float sigma, const int* dims) {
  FmGeo g;
  g.cxyz = cxyz;
  g.kpt_T = kpt_T;
  g.w = w;
  g.b = b;
  g.N = N;
  g.K = K;
  g.L = L;
  g.scale = scale;
  g.two_sig2 = 2.0f * sigma * sigma;
  g.d1 = dims[0];
  g.d2 = dims[1];
  g.d3 = dims[2];
  g.e1 = dims[3];
  g.e2 = dims[4];
  g.lat = dims[5];
  return g;
}

// dims: six host ints {d1, d2, d3, e1, e2, lat}
VT_EXPORT int vt_fused_geo_mlp(const float* cxyz, const float* kpt_T,
                               const float* aux, const float* w,
                               const float* b, int N, int K, int L,
                               float scale, float sigma, const int* dims,
                               float* out, float* lat, void* stream) {
  if (N <= 0) return 0;
  FmGeo g = fm_geo(cxyz, kpt_T, w, b, N, K, L, scale, sigma, dims);
  if (fm_check(g, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * fm_smem_floats(K);
  cudaError_t rc = cudaFuncSetAttribute(
      fused_geo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  fused_geo_kernel<<<vt_blocks(N, FM_TP), FM_NT, smem, vt_stream(stream)>>>(
      g, aux, out, lat);
  return static_cast<int>(cudaGetLastError());
}

VT_EXPORT int vt_fused_query_mlp(const float* cxyz, const float* kpt_T,
                                 const float* feats, const float* g2,
                                 const float* w, const float* b,
                                 const float* fw, int N, int K, int L,
                                 float scale, float sigma, const int* dims,
                                 float* out, void* stream) {
  if (N <= 0) return 0;
  FmGeo g = fm_geo(cxyz, kpt_T, w, b, N, K, L, scale, sigma, dims);
  if (fm_check(g, 24)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * fm_smem_floats(K);
  cudaError_t rc = cudaFuncSetAttribute(
      fused_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  fused_query_kernel<<<vt_blocks(N, FM_TP), FM_NT, smem, vt_stream(stream)>>>(
      g, fw, feats, g2, out);
  return static_cast<int>(cudaGetLastError());
}
