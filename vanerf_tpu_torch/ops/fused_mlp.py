"""The per-point query network in one kernel a pass (port of
``vanerf_tpu/ops/fused_mlp.py``).

:func:`fused_geo_mlp` is kernel 12 (``csrc/fused_mlp.cu::vt_fused_geo_mlp``):
the rel_z_decay positional encoding, ``MLPUNetFusion`` at one source view
(the view pooling reduces to ``mean = w * x``, ``var = w * (x - mean)^2``)
and the ``gcompress`` latent.  :func:`fused_query_mlp` is kernel 11
(``vt_fused_query_mlp``): the same body between ``GeoVisFusion``'s two
gate/fuse scales in front and ``TexVisFusion``'s gate/fuse with the V=1 rgb
columns behind, reading the raw KNN gather rows of
:func:`~.knn.knn_gather_raw`.  On CUDA tensors both launch their kernel;
CPU tensors take the plain versions :func:`fused_geo_mlp_plain` /
:func:`fused_query_mlp_plain`, which repeat the kernels' arithmetic (the
same virtual-concat splits in the same order, the bias added last).

The activation dtype is the packs' (``aux`` / ``feats`` and ``g2``): float32
or bfloat16, each with a kernel of its own.  In bfloat16 the weights are
bfloat16 (the biases stay float32), every layer product takes bfloat16
operands with a float32 sum and rounds once to bfloat16 where the JAX
kernel does (``vanerf_tpu/ops/fused_mlp.py:88-119``, ``:199-222``): the
encoding in float32, rounded; softplus' predicate and log in float32 on
the rounded sum, the linear branch the rounded sum itself; the V=1 pooling
in float32 on the rounded ``x_view``, then rounded; the gates' sigmoid in
float32 on the rounded product, then rounded; ``out`` (sdf, radiance)
float32 and not rounded, the latent and the rgb rounded.  The plain
versions hold the activations as float32 tensors of bfloat16 values, which
makes every product exact and every sum float32; in float32 the rounding
is the identity.

Gradients (``VANERF_FUSED_TRAIN``): neither package has a backward kernel.
The JAX package's ``custom_vjp`` sits around the whole query
(``vanerf_tpu/renderer.py:514-526``): its forward runs the query at the
fused level, its backward the VJP of the query at level 0, the unfused
composition, from the saved inputs.  :func:`fused_train_query` is the same
boundary: the forward runs the query at the fused level without a graph
and saves only its inputs; the backward runs it again at level 0 under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` for the
points, the view, the feature maps, the visibility / SDF inputs and the
parameters.  So the cotangents come from the fused outputs and the
gradients from the level-0 query, in float32 and in bfloat16 alike (in
bfloat16 every op of that backward rounds as JAX's level-0 backward
does, which the plain versions' float32 sums would not).  The kernel
entry points have no backward and refuse inputs that want a gradient.

:func:`prepare_geo_mlp_weights` / :func:`prepare_query_weights` build the
kernel-ready weight groups from the port's modules in differentiable torch
ops, so those gradients reach ``weight_v`` / ``weight_g``.
:func:`pack_geo_weights` / :func:`pack_query_weights` lay them out as the
kernels read them: one stream of the layer products' weights in the order
the kernel runs them, each split into TF32 hi / lo parts (the kernels
multiply in 3xTF32 on the tensor cores, within the plain versions'
rtol 2e-4 / atol 2e-5), or in bfloat16 as the core matrices that
``wgmma`` reads B from (``csrc/fused_mlp_bf16.cu``: one product a layer
on the tensor cores); a caller that
launches many passes on one set of weights (``models/vanerf.py`` at
inference) packs once and hands the buffers to every pass.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _cuda

# g2 rows: [geo64 | geo8 | tex img+ft 11 | tex global 18 | vis 1] x
# {this hand, other hand}
_G2 = dict(g0=(0, 64), g1=(64, 72), tf=(72, 83), tg=(83, 101),
           vis=(101, 102))
_C1 = 102
AUX_WIDTH = 74
FEATS_WIDTH = 87
G2_WIDTH = 2 * _C1

# canonical order of kernel 11's named weight groups (the JAX package's)
_WEIGHT_ORDER = ("gat0_0", "gat0_1", "gfu0_0", "gfu0_1",
                 "gat1_0", "gat1_1", "gfu1_0", "gfu1_1",
                 "w0", "w0f", "w1", "w2h", "w2f", "w3", "w4m", "w4v",
                 "w5", "w6", "w7m", "w7v", "b",
                 "tat_0", "tat_1", "tfu_0", "tfu_1")
_TEX_SPLITS = (11, 11, 11, 18, 18, 24, 3)

# csrc/fused_mlp.cu: FM_HMAX, the latent's rows in the wide buffer, and
# the rows a chunk of the first layer's encoding fills (FM_PE_ROWS)
_MAX_WIDTH = 128
_MAX_LAT = 96
_PE_ROWS = 120

# csrc/fused_mlp_bf16.cu: the widths (d1, d2, d3, e1, e2, latent) its
# register chains are built for (configs/vanerf.json)
BF16_DIMS = (128, 128, 120, 64, 64, 24)
# its activations by number (FW_SOFTPLUS, FW_SIGMOID)
ACT_SOFTPLUS, ACT_SIGMOID = 1, 3

geo_launches = 0
query_launches = 0
geo_launches_bf16 = 0
query_launches_bf16 = 0


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _wn(linear):
    """(in, out) weight and (1, out) bias of a ``WNLinear`` (weight norm
    ``v * g / (|v| + 1e-12)`` per output unit) or a plain ``nn.Linear``."""
    if hasattr(linear, "weight_v"):
        v = linear.weight_v
        norm = torch.linalg.norm(v, dim=1, keepdim=True) + 1e-12
        w = v * (linear.weight_g / norm)
    else:
        w = linear.weight
    return w.t(), linear.bias[None]


def _pointwise_w(conv) -> torch.Tensor:
    """(in, out) weight of a 1x1 ``Conv1d(bias=False)``."""
    return conv.weight[..., 0].t()


def prepare_geo_mlp_weights(model, cdt=torch.float32) -> dict:
    """Kernel-ready weights of :func:`fused_geo_mlp` from a
    :class:`~vanerf_tpu_torch.models.VANeRF`: weight norm applied (in
    float32), every matrix (in, out) in ``cdt``, the biases float32, the
    first layers split at their virtual concats."""
    l1 = [lay.linear for lay in model.mlp_geo.layers1.layers]
    l2 = [lay.linear for lay in model.mlp_geo.layers2.layers]
    if len(l1) != 4 or len(l2) != 3:
        raise ValueError("the fused kernels take 4 + 3 MLP layers")
    (w0, b0), (w1, b1), (w2, b2), (w3, b3) = (_wn(x) for x in l1)
    (w4, b4), (w5, b5), (w6, b6) = (_wn(x) for x in l2)
    w7, b7 = _wn(model.ibr_compress_gfeat)
    w0, w1, w2, w3, w4, w5, w6, w7 = (w.to(cdt) for w in (w0, w1, w2, w3,
                                                          w4, w5, w6, w7))
    pe_in = w0.shape[0] - 64          # PE width (e.g. 294); fused0 = 64
    return {
        "w0_parts": w0[:pe_in], "w0_f": w0[pe_in:],
        "w1": w1, "w2_h": w2[:-8], "w2_f": w2[-8:], "w3": w3,
        "w4_m": w4[:64], "w4_v": w4[64:], "w5": w5, "w6": w6,
        "w7_m": w7[:64], "w7_v": w7[64:],
        "biases": (b0, b1, b2, b3, b4, b5, b6, b7),
    }


def _row_splits(w: torch.Tensor, splits) -> list:
    out, o = [], 0
    for s in splits:
        out.append(w[o:o + s])
        o += s
    return out


def prepare_query_weights(model, n_parts: int = 7,
                          cdt=torch.float32) -> dict:
    """Kernel-ready weight groups of :func:`fused_query_mlp`: name -> list
    of tensors, with the row splits of every first layer and the V=1 rgb
    column slice of the texture fuse layer; matrices in ``cdt``, the
    biases float32."""
    geo = prepare_geo_mlp_weights(model, cdt)
    out = {}
    gvf = model.geo_vis_fusion

    def pw(conv):
        return _pointwise_w(conv).to(cdt)

    for si, w, at, ated in ((0, 64, gvf.fconv_at, gvf.fconv_ated),
                            (1, 8, gvf.fconv_at1, gvf.fconv_ated1)):
        splits = (w, w, w, 4)
        out[f"gat{si}_0"] = _row_splits(pw(at[0]), splits)
        out[f"gat{si}_1"] = [pw(at[2])]
        out[f"gfu{si}_0"] = _row_splits(pw(ated[0]), splits)
        out[f"gfu{si}_1"] = [pw(ated[2])]
    kk = geo["w0_parts"].shape[0] // n_parts   # keypoint count per part
    out["w0"] = _row_splits(geo["w0_parts"], (kk,) * n_parts)
    for name, key in (("w0f", "w0_f"), ("w1", "w1"), ("w2h", "w2_h"),
                      ("w2f", "w2_f"), ("w3", "w3"), ("w4m", "w4_m"),
                      ("w4v", "w4_v"), ("w5", "w5"), ("w6", "w6"),
                      ("w7m", "w7_m"), ("w7v", "w7_v")):
        out[name] = [geo[key]]
    out["b"] = list(geo["biases"])
    tvf = model.tex_vis_fusion
    out["tat_0"] = _row_splits(pw(tvf.fconv_at[0]), _TEX_SPLITS)
    out["tat_1"] = [pw(tvf.fconv_at[2])]
    out["tfu_0"] = _row_splits(pw(tvf.fconv[0]), _TEX_SPLITS)
    # V=1: only the first 3 output columns (src_rgb) survive the IBR head
    out["tfu_1"] = [pw(tvf.fconv[2])[:, :3]]
    return out


def _geo_of_query(weights: dict) -> dict:
    """The geometry groups of a query-weights dict, keyed as
    :func:`prepare_geo_mlp_weights`."""
    return {"w0_parts": weights["w0"], "w0_f": weights["w0f"][0],
            "w1": weights["w1"][0], "w2_h": weights["w2h"][0],
            "w2_f": weights["w2f"][0], "w3": weights["w3"][0],
            "w4_m": weights["w4m"][0], "w4_v": weights["w4v"][0],
            "w5": weights["w5"][0], "w6": weights["w6"][0],
            "w7_m": weights["w7m"][0], "w7_v": weights["w7v"][0],
            "biases": tuple(weights["b"])}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _softplus100(x):
    """torch Softplus(beta=100, threshold=20) as the JAX kernel writes it
    (``vanerf_tpu/ops/fused_mlp.py:41-50``): ``x`` above 20 / 100, else
    ``logaddexp(100 x, 0) / 100`` in float32, the division XLA's product
    by 0.01 (XLA rewrites a division by a constant so)."""
    xf = x * 100.0
    return torch.where(xf > 20.0, x,
                       torch.logaddexp(xf, torch.zeros_like(xf)) * 0.01)


def _rounder(cdt):
    """x -> x rounded to ``cdt`` and held in float32: the JAX kernel's
    ``.astype(cdt)`` on a float32 value (the identity in float32)."""
    if cdt == torch.float32:
        return lambda x: x
    return lambda x: x.to(cdt).float()


def _inv_two_sig2(sigma: float) -> float:
    """The encoding's Gaussian factor 1 / (2 sigma^2): computed in double
    and rounded once to float32 (by ctypes for the kernels, by torch for
    the plain version's product), one value for both.  The JAX kernel
    divides by the constant 2 sigma^2, which XLA compiles to this product
    (``tests/test_torch_fused.py::test_gaussian_factor_is_xlas``)."""
    return 1.0 / (2.0 * sigma * sigma)


def _pe_parts(cxyz, kpt_T, sp_level: int, scale: float, sigma: float):
    """rel_z_decay encoding parts, each (N, K), in float32."""
    cx, cy, cz = cxyz[:, 0:1], cxyz[:, 1:2], cxyz[:, 2:3]
    kx, ky, kz = kpt_T[0:1], kpt_T[1:2], kpt_T[2:3]
    dz = scale * (cz - kz)
    dxx, dyy, dzz = cx - kx, cy - ky, cz - kz
    wgt = torch.exp(-(dxx * dxx + dyy * dyy + dzz * dzz)
                    * _inv_two_sig2(sigma))
    a = math.pi * dz
    s, c = torch.sin(a), torch.cos(a)
    parts = [dz]
    for _ in range(sp_level):
        parts.append(s)
        parts.append(c)
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
    return [p * wgt for p in parts]


def _geo_mlp(parts, w0_list, fused0, fused1, w_v, wts, q):
    """MLPUNetFusion (V=1) + gcompress on float32 activations, rounded by
    ``q`` where the JAX kernel rounds: out2 (N, 2), lat (N, gcompress)."""
    b = wts["biases"]
    W = {k: v.float() for k, v in wts.items()
         if k not in ("biases", "w0_parts")}
    acc = parts[0] @ w0_list[0].float()
    for p, w in zip(parts[1:], w0_list[1:]):
        acc = acc + p @ w.float()

    def sp(x):
        return q(_softplus100(q(x)))

    h = sp(acc + fused0 @ W["w0_f"] + b[0])
    h = sp(h @ W["w1"] + b[1])
    h = sp(h @ W["w2_h"] + fused1 @ W["w2_f"] + b[2])
    x_view = q(h @ W["w3"] + b[3])
    mean = w_v * x_view
    var = w_v * (x_view - mean) ** 2
    mean, var = q(mean), q(var)
    h = sp(mean @ W["w4_m"] + var @ W["w4_v"] + b[4])
    h = sp(h @ W["w5"] + b[5])
    out2 = h @ W["w6"] + b[6]
    lat = q(mean @ W["w7_m"] + var @ W["w7_v"] + b[7])
    return out2, lat


def _w0_list(w0_parts, n_parts: int, K: int) -> list:
    if torch.is_tensor(w0_parts):
        if w0_parts.shape[0] != n_parts * K:
            raise ValueError(f"w0_parts has {w0_parts.shape[0]} rows, "
                             f"expected {n_parts} x {K}")
        return [w0_parts[i * K:(i + 1) * K] for i in range(n_parts)]
    return list(w0_parts)


def fused_geo_mlp_plain(cxyz, kpt_T, aux, weights: dict, *,
                        sp_level: int = 3, scale: float = 1.0,
                        sigma: float = 0.1):
    """Plain-PyTorch twin of kernel 12; contract of :func:`fused_geo_mlp`
    (in ``aux``'s dtype)."""
    cdt = aux.dtype
    q = _rounder(cdt)
    parts = [q(p) for p in _pe_parts(cxyz, kpt_T, sp_level, scale, sigma)]
    w0 = _w0_list(weights["w0_parts"], len(parts), kpt_T.shape[1])
    aux = aux.float()
    out2, lat = _geo_mlp(parts, w0, aux[:, 0:64], aux[:, 64:72],
                         aux[:, 73:74], weights, q)
    return out2, lat.to(cdt)


def _gate_fuse(parts, at0, at1, fu0, fu1, n_gated: int, q):
    """GateMLP + FuseMLP over a virtual-concat parts list: the first
    ``n_gated`` parts are re-scaled by their gate channel; rounded by ``q``
    where the JAX kernel rounds."""
    acc = parts[0] @ at0[0].float()
    for p, w in zip(parts[1:], at0[1:]):
        acc = acc + p @ w.float()
    g = q(torch.sigmoid(q(q(torch.relu(acc)) @ at1.float())))
    acc = None
    for i, p in enumerate(parts):
        d = (q(p * g[:, i:i + 1]) if i < n_gated else p) @ fu0[i].float()
        acc = d if acc is None else acc + d
    return q(q(torch.relu(acc)) @ fu1.float())


def fused_query_mlp_plain(cxyz, kpt_T, feats, g2, weights: dict, *,
                          sp_level: int = 3, scale: float = 1.0,
                          sigma: float = 0.1):
    """Plain-PyTorch twin of kernel 11; contract of
    :func:`fused_query_mlp` (in ``feats``' dtype)."""
    q = _rounder(feats.dtype)
    feats, g2 = feats.float(), g2.float()
    fs0, fs1 = feats[:, 0:64], feats[:, 64:72]
    img_xy, ft_xy = feats[:, 72:75], feats[:, 75:83]
    q_sdf, q_vis = feats[:, 83:84], feats[:, 84:85]
    w_v = feats[:, 86:87]
    vis_th = g2[:, _G2["vis"][0]:_G2["vis"][1]]
    vis_toh = g2[:, _C1 + _G2["vis"][0]:_C1 + _G2["vis"][1]]

    def th(k):
        lo, hi = _G2[k]
        return q(g2[:, lo:hi] * vis_th)

    def toh(k):
        lo, hi = _G2[k]
        return q(g2[:, _C1 + lo:_C1 + hi] * vis_toh)

    ctx4 = torch.cat([q_sdf, q_vis, vis_th, vis_toh], 1)
    w = weights
    fused0 = _gate_fuse([fs0, th("g0"), toh("g0"), ctx4], w["gat0_0"],
                        w["gat0_1"][0], w["gfu0_0"], w["gfu0_1"][0], 3, q)
    fused1 = _gate_fuse([fs1, th("g1"), toh("g1"), ctx4], w["gat1_0"],
                        w["gat1_1"][0], w["gfu1_0"], w["gfu1_1"][0], 3, q)
    parts = [q(p) for p in _pe_parts(cxyz, kpt_T, sp_level, scale, sigma)]
    out2, lat = _geo_mlp(parts, w["w0"], fused0, fused1, w_v,
                         _geo_of_query(w), q)
    qf = torch.cat([img_xy, ft_xy], 1)
    vis3 = torch.cat([q_vis, vis_th, vis_toh], 1)
    rgb = _gate_fuse([qf, th("tf"), toh("tf"), th("tg"), toh("tg"), lat,
                      vis3], w["tat_0"], w["tat_1"][0], w["tfu_0"],
                     w["tfu_1"][0], 6, q)
    return torch.cat([out2, rgb], 1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero: the card's ``cvt.rna.tf32.f32``."""
    bits = x.detach().float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): hi = x rounded to TF32, lo = x - hi rounded to TF32, so
    hi + lo carries x to ~2^-22 relative (the 3xTF32 operands)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def _ntiles(m: int, dtype=torch.float32) -> int:
    """The n8 tiles an m-wide layer takes in the stream: ceil(m / 8) in
    bfloat16 (csrc/fused_mlp_bf16.cu::fm_push), in float32 rounded up to a
    count the float32 body is built for (csrc/fused_mlp.cu::fm_ntiles)."""
    n = -(-m // 8)
    if dtype == torch.bfloat16:
        return n
    return n if n <= 4 else (8 if n <= 8 else (12 if n <= 12 else 16))


def _fragments(part: torch.Tensor, nt: int) -> torch.Tensor:
    """One part (K, M) of a layer's weight as the kernel reads B, (k-tile,
    n-tile, 128).  float32: rows zero-padded to 8 ceil(K / 8), columns to
    8 nt, split into TF32 hi and lo, lane 4 g + t holding {hi, hi, lo, lo}
    of rows t and t + 4 of column g (mma m16n8k8).  bfloat16: rows padded
    to 16 ceil(K / 16), columns to 8 nt; a k-tile's n8 group j is two
    K-major core matrices of 8 columns x 8 rows (128 bytes, the rows of a
    column contiguous), rows 0-7 then 8-15 (the wgmma descriptor of
    csrc/fused_mlp_bf16.cu: leading byte offset 128, stride 256)."""
    K, M = part.shape
    if part.dtype == torch.bfloat16:
        kt = -(-K // 16)
        w = F.pad(part.detach(), (0, 8 * nt - M, 0, 16 * kt - K))
        # x[16 a + 8 h + k, 8 j + n] -> [a, j, h, n, k]
        return (w.reshape(kt, 2, 8, nt, 8).permute(0, 3, 1, 4, 2)
                .reshape(kt, nt, 128))
    kt = -(-K // 8)
    w = F.pad(part.float(), (0, 8 * nt - M, 0, 8 * kt - K))

    def frag(x):      # x[8 a + 4 j + t, 8 b + g] -> [a, b, g, t, j]
        return x.reshape(kt, 2, 4, nt, 8).permute(0, 3, 4, 2, 1)

    hi, lo = tf32_split(w)
    return torch.cat([frag(hi), frag(lo)], -1).reshape(kt, nt, 32, 4)


def _pack(layers):
    """The weight stream in the order the kernel consumes it, and the
    n-tile count of each k-tile: ``layers`` lists (parts, M) per layer,
    the parts of its virtual concat in order (each padded on its own)."""
    blocks, items = [], []
    for parts, M in layers:
        nt = _ntiles(M, parts[0].dtype)
        for p in parts:
            f = _fragments(p, nt)
            blocks.append(f.reshape(-1))
            items += [nt] * f.shape[0]
    return torch.cat(blocks).contiguous(), tuple(items)


def _cat_rows(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.cat(list(x), 0)


class PackedWeights(NamedTuple):
    """Kernel-ready buffers of one set of weights: the stream of every
    layer product the kernel runs, as fragments in its order (kernel 11:
    the two GeoVisFusion gate/fuse nets, the geometry, the TexVisFusion
    gate/fuse), float32 TF32 hi / lo or bfloat16 as the weights were
    prepared; the float32 geometry biases and the six widths the kernel is
    told."""
    w: torch.Tensor
    b: torch.Tensor
    dims: tuple


def _geo_layers(wts: dict, K: int, sp_level: int):
    """(layers, biases, dims) of the geometry network from
    :func:`prepare_geo_mlp_weights`'s dict for K keypoints, checked against
    what the kernel takes."""
    n_parts = 1 + 2 * sp_level
    w0p = _cat_rows(wts["w0_parts"])
    if w0p.shape[0] != n_parts * K:
        raise ValueError(f"fused MLP: {w0p.shape[0]} encoding rows, "
                         f"expected {n_parts} x {K}")
    if n_parts > _PE_ROWS or K > 256:
        raise ValueError("fused MLP: the kernel takes at most "
                         f"{_PE_ROWS} encoding parts and 256 keypoints")
    # the kernel makes the encoding a chunk of keypoints at a time:
    # part-major rows (i * K + j) -> keypoint-major (j * P + i)
    w0p = w0p.reshape(n_parts, K, -1).transpose(0, 1).reshape(n_parts * K, -1)
    mats = [torch.cat([w0p, wts["w0_f"]], 0), wts["w1"],
            torch.cat([wts["w2_h"], wts["w2_f"]], 0), wts["w3"],
            torch.cat([wts["w4_m"], wts["w4_v"]], 0), wts["w5"], wts["w6"],
            torch.cat([wts["w7_m"], wts["w7_v"]], 0)]
    d1, d2, d3, e1, e2, lat = (mats[i].shape[1] for i in (0, 1, 2, 4, 5, 7))
    rows = [n_parts * K + 64, d1, d2 + 8, d3, 128, e1, e2, 128]
    cols = [d1, d2, d3, 64, e1, e2, 2, lat]
    for i, (m, r, c) in enumerate(zip(mats, rows, cols)):
        if tuple(m.shape) != (r, c):
            raise ValueError(f"fused MLP layer {i}: weight {tuple(m.shape)}"
                             f", the kernel takes {(r, c)}")
    if max(d1, d2, d3, e1, e2) > _MAX_WIDTH or lat > _MAX_LAT:
        raise ValueError("fused MLP: a layer is wider than the kernel's "
                         f"{_MAX_WIDTH} (latent {_MAX_LAT})")
    biases = torch.cat([b.float().reshape(-1) for b in wts["biases"]])
    if biases.numel() != sum(cols):
        raise ValueError("fused MLP: bias widths do not match the layers")
    per = (_PE_ROWS // n_parts) * n_parts   # rows of a chunk of keypoints
    pe = [w0p[r:r + per] for r in range(0, n_parts * K, per)]
    layers = [(pe + [wts["w0_f"]], d1), ([mats[1]], d2),
              ([wts["w2_h"], wts["w2_f"]], d3), ([mats[3]], 64),
              ([mats[4]], e1), ([mats[5]], e2), ([mats[6]], 2),
              ([mats[7]], lat)]
    return layers, biases, (d1, d2, d3, e1, e2, lat)


def pack_geo_weights(wts: dict, K: int, sp_level: int) -> PackedWeights:
    """The buffers kernel 12 reads, from :func:`prepare_geo_mlp_weights`'s
    dict for K keypoints."""
    return _packed(*_geo_layers(wts, K, sp_level))


def _packed(layers, biases, dims) -> PackedWeights:
    return PackedWeights(_pack(layers)[0], biases, dims)


def _query_layers(weights: dict, K: int, sp_level: int):
    """(layers, biases, dims) of the whole query network from
    :func:`prepare_query_weights`'s dict, in kernel 11's order: the two
    GeoVisFusion gate/fuse nets, the geometry, the TexVisFusion one."""
    layers, biases, dims = _geo_layers(_geo_of_query(weights), K, sp_level)
    if dims[5] != 24:
        raise ValueError("fused_query_mlp: the latent must be 24 wide")
    fmats = []
    for si in (0, 1):
        fmats += [_cat_rows(weights[f"gat{si}_0"]), weights[f"gat{si}_1"][0],
                  _cat_rows(weights[f"gfu{si}_0"]), weights[f"gfu{si}_1"][0]]
    fmats += [_cat_rows(weights["tat_0"]), weights["tat_1"][0],
              _cat_rows(weights["tfu_0"]), weights["tfu_1"][0]]
    shapes = [(196, 10), (10, 3), (196, 64), (64, 64), (28, 10), (10, 3),
              (28, 8), (8, 8), (96, 96), (96, 6), (96, 96), (96, 3)]
    for i, (m, s) in enumerate(zip(fmats, shapes)):
        if tuple(m.shape) != s:
            raise ValueError(f"fused_query_mlp: fusion weight {i} is "
                             f"{tuple(m.shape)}, the kernel takes {s}")
    fusion = [([m], m.shape[1]) for m in fmats]     # one product each
    return fusion[:8] + layers + fusion[8:], biases, dims


def pack_query_weights(weights: dict, K: int, sp_level: int) -> PackedWeights:
    """The buffers kernel 11 reads, from :func:`prepare_query_weights`'s
    dict."""
    return _packed(*_query_layers(weights, K, sp_level))


def _check_points(cxyz, kpt_T, packs):
    """(N, K, the C entry points' suffix): the points and keypoints
    float32, the packs all in one activation dtype a kernel is built for
    (float32 or bfloat16); anything else raises."""
    N = cxyz.shape[0]
    cdt = packs[0][1].dtype
    sfx = _cuda.dtype_suffix(cdt, "fused MLP activations")
    _cuda.require(cxyz, "cxyz", torch.float32, (N, 3))
    _cuda.require(kpt_T, "kpt_T", torch.float32, (3, kpt_T.shape[1]),
                  cxyz.device)
    for name, t, width in packs:
        _cuda.require(t, name, cdt, (N, width), cxyz.device)
    return N, kpt_T.shape[1], sfx


def _check_packed(packed: PackedWeights, cdt, device) -> None:
    """The stream is read by 16-byte bulk copies, in the activations'
    dtype; the kernel checks its size against the layers it runs, and the
    bfloat16 body refuses widths other than BF16_DIMS."""
    _cuda.require(packed.w, "packed.w", cdt, device=device)
    _cuda.require(packed.b, "packed.b", torch.float32, device=device)
    if packed.w.data_ptr() % 16:
        raise ValueError("packed.w must start on a 16-byte boundary")


def fused_geo_mlp_cuda(cxyz, kpt_T, aux, packed: PackedWeights, *,
                       sp_level: int = 3, scale: float = 1.0,
                       sigma: float = 0.1):
    """Kernel 12; contract of :func:`fused_geo_mlp` on contiguous CUDA
    tensors (float32 points, float32 or bfloat16 ``aux``: the kernel of
    that dtype) and the buffers of :func:`pack_geo_weights` in that
    dtype."""
    global geo_launches, geo_launches_bf16
    N, K, sfx = _check_points(cxyz, kpt_T, [("aux", aux, AUX_WIDTH)])
    out = torch.empty(N, 2, dtype=torch.float32, device=cxyz.device)
    lat = torch.empty(N, packed.dims[5], dtype=aux.dtype,
                      device=cxyz.device)
    _check_packed(packed, aux.dtype, cxyz.device)
    rc = getattr(_cuda.lib(), "vt_fused_geo_mlp" + sfx)(
        cxyz.data_ptr(), kpt_T.data_ptr(), aux.data_ptr(),
        packed.w.data_ptr(), packed.w.numel(), packed.b.data_ptr(), N, K,
        sp_level, float(scale), _inv_two_sig2(sigma),
        (ctypes.c_int * 6)(*packed.dims),
        out.data_ptr(), lat.data_ptr(), _cuda.stream_ptr(cxyz.device))
    _cuda.check(rc, "vt_fused_geo_mlp" + sfx)
    if sfx:
        geo_launches_bf16 += 1
    else:
        geo_launches += 1
    return out, lat


def fused_query_mlp_cuda(cxyz, kpt_T, feats, g2, packed: PackedWeights, *,
                         sp_level: int = 3, scale: float = 1.0,
                         sigma: float = 0.1):
    """Kernel 11; contract of :func:`fused_query_mlp` on contiguous CUDA
    tensors (float32 points, ``feats`` and ``g2`` both float32 or both
    bfloat16: the kernel of that dtype) and the buffers of
    :func:`pack_query_weights` in that dtype."""
    global query_launches, query_launches_bf16
    N, K, sfx = _check_points(cxyz, kpt_T, [("feats", feats, FEATS_WIDTH),
                                            ("g2", g2, G2_WIDTH)])
    out = torch.empty(N, 5, dtype=torch.float32, device=cxyz.device)
    _check_packed(packed, feats.dtype, cxyz.device)
    rc = getattr(_cuda.lib(), "vt_fused_query_mlp" + sfx)(
        cxyz.data_ptr(), kpt_T.data_ptr(), feats.data_ptr(), g2.data_ptr(),
        packed.w.data_ptr(), packed.w.numel(), packed.b.data_ptr(), N, K,
        sp_level, float(scale), _inv_two_sig2(sigma),
        (ctypes.c_int * 6)(*packed.dims), out.data_ptr(),
        _cuda.stream_ptr(cxyz.device))
    _cuda.check(rc, "vt_fused_query_mlp" + sfx)
    if sfx:
        query_launches_bf16 += 1
    else:
        query_launches += 1
    return out


def act_bf16_all_cuda(act: int, device) -> torch.Tensor:
    """The bfloat16 kernels' softplus (``ACT_SOFTPLUS``) or sigmoid
    (``ACT_SIGMOID``) on every bfloat16 input: (65,536,) bfloat16, entry
    i the result for the input whose bits are i (the device function the
    kernels' epilogues call, ``vt_fm_act_bf16_all``)."""
    out = torch.empty(1 << 16, dtype=torch.bfloat16, device=device)
    rc = _cuda.lib().vt_fm_act_bf16_all(act, out.data_ptr(),
                                        _cuda.stream_ptr(out.device))
    _cuda.check(rc, "vt_fm_act_bf16_all")
    return out


def act_bf16_all_plain(act: int, device) -> torch.Tensor:
    """The plain version's rounded softplus / sigmoid of every bfloat16
    input, as :func:`act_bf16_all_cuda` orders them."""
    x = (torch.arange(1 << 16, dtype=torch.int32, device=device)
         .to(torch.int16).view(torch.bfloat16).float())
    q = _rounder(torch.bfloat16)
    if act == ACT_SOFTPLUS:
        return _softplus100(q(x)).to(torch.bfloat16)
    if act == ACT_SIGMOID:
        return torch.sigmoid(q(x)).to(torch.bfloat16)
    raise ValueError(f"activation {act}: ACT_SOFTPLUS or ACT_SIGMOID")


# ---------------------------------------------------------------------------
# entry points: the kernel (its plain version on CPU tensors), no backward
# ---------------------------------------------------------------------------

def _no_graph(name: str, data, weights: dict) -> None:
    """Raise where a gradient is wanted: the kernels have no backward.  A
    weight group is one tensor or a list of them."""
    leaves = list(data) + [t for g in weights.values()
                           for t in ([g] if torch.is_tensor(g) else g)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        raise RuntimeError(
            f"{name} has no backward: differentiate the query at fused "
            "level 0 (VANERF_FUSED_TRAIN runs its backward there, "
            "fused_train_query)")


def _run(full: bool, data, weights: dict, packed, kw: dict):
    """The kernel on CUDA tensors (weights packed here unless ``packed``),
    the plain version on CPU tensors."""
    data = [t.contiguous() for t in data]
    if data[0].device.type == "cpu":
        if full:
            return fused_query_mlp_plain(*data, weights, **kw)
        return fused_geo_mlp_plain(*data, weights, **kw)
    if packed is None:
        pack = pack_query_weights if full else pack_geo_weights
        packed = pack(weights, data[1].shape[1], kw["sp_level"])
    if full:
        return fused_query_mlp_cuda(*data, packed, **kw)
    return fused_geo_mlp_cuda(*data, packed, **kw)


class _FusedTrain(torch.autograd.Function):
    """Forward: ``query(True, *data)``, the query at the fused level,
    without a graph, saving only its inputs.  Backward: the gradients of
    ``query(False, *data)``, the level-0 query, at the saved inputs, driven
    by the cotangent of the fused output."""

    @staticmethod
    def forward(ctx, query, n_data, *tensors):
        ctx.query, ctx.n_data = query, n_data
        ctx.save_for_backward(*tensors)
        out, valid = query(True, *tensors[:n_data])
        ctx.mark_non_differentiable(valid)
        return out, valid

    @staticmethod
    @once_differentiable
    def backward(ctx, ct, _ct_valid):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            data = [t.detach().requires_grad_(n)
                    for t, n in zip(saved[:ctx.n_data], need)]
            out, _ = ctx.query(False, *data)
            wanted = [t for t, n in zip(data + list(saved[ctx.n_data:]),
                                        need) if n]
            grads = iter(torch.autograd.grad(out, wanted, ct,
                                             allow_unused=True))
        return (None, None) + tuple(next(grads) if n else None for n in need)


def fused_train_query(query, data, params):
    """``VANERF_FUSED_TRAIN``'s gradient boundary around one query call.

    ``query(fused, *data)`` returns the query's (out, valid) at the fused
    level (``fused`` True) or at level 0 (False); ``data`` are its
    differentiable inputs (points, view, feature maps, visibility, SDF) and
    ``params`` the parameters it reads.  Returns (out, valid): the fused
    level's values, with the level-0 query's gradients for ``data`` and
    ``params`` (``vanerf_tpu/renderer.py:514-526``)."""
    return _FusedTrain.apply(query, len(data), *data, *params)


def fused_geo_mlp(cxyz, kpt_T, aux, weights: dict, *, sp_level: int = 3,
                  scale: float = 1.0, sigma: float = 0.1,
                  packed: PackedWeights = None):
    """PE + MLPUNetFusion + gcompress in one pass (V=1).

    Args:
      cxyz: (N, 3) f32 camera-frame query points.
      kpt_T: (3, K) f32 camera-frame keypoints.
      aux: (N, 74) per-point inputs in the activation dtype (float32 or
        bfloat16) packed as
        [fused0 (64) | fused1 (8) | out_mask (1) | pix_weight (1)].
      weights: output of :func:`prepare_geo_mlp_weights` in that dtype.
      packed: ``pack_geo_weights(weights, K, sp_level)`` made earlier by
        the caller; else CUDA tensors are packed at this call.
    Returns:
      out (N, 2) float32 (sdf residual, radiance), lat (N, gcompress) in
      the activation dtype (the compressed pooled latent).
    """
    kw = dict(sp_level=int(sp_level), scale=float(scale), sigma=float(sigma))
    _no_graph("fused_geo_mlp", (cxyz, kpt_T, aux), weights)
    return _run(False, (cxyz, kpt_T, aux), weights, packed, kw)


def fused_query_mlp(cxyz, kpt_T, feats, g2, weights: dict, *,
                    sp_level: int = 3, scale: float = 1.0,
                    sigma: float = 0.1, packed: PackedWeights = None):
    """The whole per-point query network in one pass (V=1).

    Args:
      cxyz: (N, 3) f32 camera-frame query points.
      kpt_T: (3, K) f32 camera-frame keypoints.
      feats: (N, 87) pack [feat_s0 64 | feat_s1 8 | img_xy 3 | ft_xy 8 |
        q_sdf | q_vis | out_mask | pix_weight], float32 or bfloat16.
      g2: (N, 204) raw shared-KNN gather rows (:func:`~.knn.knn_gather_raw`)
        in ``feats``' dtype.
      weights: output of :func:`prepare_query_weights` in that dtype.
      packed: ``pack_query_weights(weights, K, sp_level)`` made earlier by
        the caller; else CUDA tensors are packed at this call.
    Returns:
      out (N, 5) float32 = [sdf_ch, rad, rgb3].
    """
    kw = dict(sp_level=int(sp_level), scale=float(scale), sigma=float(sigma))
    _no_graph("fused_query_mlp", (cxyz, kpt_T, feats, g2), weights)
    return _run(True, (cxyz, kpt_T, feats, g2), weights, packed, kw)
