"""Visibility-gated feature fusion (port of ``vanerf_tpu/models/fusion.py``;
reference ``GeoVisFusion`` ``src/networks.py:43-106`` and
``TexVisFusion`` ``src/networks.py:219-293``).

The reference's 1x1 ``Conv1d`` stacks keep their module names and weight
shapes (so state-dict keys match); they are applied per point as dense
layers on (B, N, C) tensors, in the input's dtype (``models/mlp.py``).
A gate's or a fuse net's first layer takes its parts concatenated with
their widths, so that in bfloat16 it rounds each part's product and each
sum as the JAX package's virtual concat does
(``vanerf_tpu/models/fusion.py:28-45``).  The global-context branch of the
texture table runs in the parameters' dtype (float32) and is cast to the
table's, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.grid_sample import feat_sample_nhwc
from ..ops.knn import knn_gather_1, nearest_vertex_d2
from .mlp import act, dense


def _pointwise(seq: nn.Sequential, parts) -> torch.Tensor:
    """Apply a stack of 1x1 Conv1d (+ activations) to the (..., C) rows of
    the concatenated ``parts``, in their dtype; the first layer is the JAX
    package's ``VDense`` over those parts (``models/mlp.py::dense``)."""
    widths = tuple(p.shape[-1] for p in parts)
    x = torch.cat(parts, -1)
    for m in seq:
        if isinstance(m, nn.Conv1d):
            x = dense(x, m.weight[..., 0], m.bias, widths)
            widths = None
        else:
            x = act(m, x)
    return x


def _gate(c_in: int, hidden: int, out: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(c_in, hidden, 1, bias=False), nn.ReLU(),
                         nn.Conv1d(hidden, out, 1, bias=False), nn.Sigmoid())


def _fuse(c_in: int, hidden: int, out: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(c_in, hidden, 1, bias=False), nn.ReLU(),
                         nn.Conv1d(hidden, out, 1, bias=False))


def _nn_idx(v, vert):
    return torch.stack([nearest_vertex_d2(v[b], vert[b])[0]
                        for b in range(v.shape[0])])


class GeoVisFusion(nn.Module):
    """Fuse pixel-aligned, same-hand KNN and other-hand KNN geometry
    features, gated by visibility/SDF context, at two feature scales."""

    def __init__(self, num_v: int = 779):
        super().__init__()
        self.num_v = num_v
        self.fconv_at = _gate(196, 10, 3)
        self.fconv_ated = _fuse(196, 64, 64)
        self.fconv_at1 = _gate(28, 10, 3)
        self.fconv_ated1 = _fuse(28, 8, 8)

    def vertex_table(self, fg, vert_xy):
        """Both feature scales sampled at the projected vertices
        (B, V2, 64 + 8)."""
        return torch.cat([feat_sample_nhwc(fg[0], vert_xy),
                          feat_sample_nhwc(fg[1], vert_xy)], -1)

    def forward(self, vert_xy, fg, feat_sampled, vert, v, vert_vis,
                query_vis, query_sdf, nn_idx=None, knn=None):
        """
        vert_xy (B, V2, 2); fg [coarse (B,h,w,64), fine (B,H,W,8)];
        feat_sampled [(B, N, 64), (B, N, 8)]; vert (B, V2, 3);
        v (B, N, 3); vert_vis (B, V2, 1); query_vis, query_sdf (B, N, 1);
        knn: optional precomputed (f, f_toh, vis, vis_toh) of this module's
        vertex_table.  Returns [(B, N, 64), (B, N, 8)].
        """
        c0 = fg[0].shape[-1]
        if knn is None:
            if nn_idx is None:
                nn_idx = _nn_idx(v, vert)
            knn = knn_gather_1(v, vert, self.vertex_table(fg, vert_xy),
                               vert_vis, self.num_v, nn_idx)
        f_all, f_toh_all, vis_th, vis_toh = knn
        per_scale = [(f_all[..., :c0], f_toh_all[..., :c0]),
                     (f_all[..., c0:], f_toh_all[..., c0:])]
        outs = []
        for si, (at, ated) in enumerate([(self.fconv_at, self.fconv_ated),
                                         (self.fconv_at1,
                                          self.fconv_ated1)]):
            f_knn, f_knn_toh = per_scale[si]
            ctx = torch.cat([query_sdf, query_vis, vis_th, vis_toh], -1)
            gate = _pointwise(at, [feat_sampled[si], f_knn, f_knn_toh, ctx])
            regated = [feat_sampled[si] * gate[..., 0:1],
                       f_knn * gate[..., 1:2], f_knn_toh * gate[..., 2:3],
                       ctx]
            outs.append(_pointwise(ated, regated))
        return outs


class AdaptiveAvgPool2d(nn.Module):
    """torch's ``AdaptiveAvgPool2d`` bins (edges floor(i H / out) and
    ceil((i + 1) H / out)) as the mean of each bin's slice, as the JAX
    package computes them (``vanerf_tpu/models/fusion.py:155-166``).  Its
    backward adds no atomics: torch's ``adaptive_avg_pool2d_backward_cuda``
    has no deterministic form, and a train step repeats to the bit on the
    card only without it."""

    def __init__(self, out: int):
        super().__init__()
        self.out = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        o = self.out

        def edges(n):
            return [(i * n // o, -(-(i + 1) * n // o)) for i in range(o)]
        return torch.stack([
            torch.stack([x[..., h0:h1, w0:w1].mean((-2, -1))
                         for w0, w1 in edges(W)], -1)
            for h0, h1 in edges(H)], -2)


def _global_ctx(in_ch: int, hw) -> nn.Sequential:
    """3x3 convs + LayerNorm over (H, W) + adaptive 3x3 average pool
    (networks.py:246-264)."""
    return nn.Sequential(
        nn.Conv2d(in_ch, 21, 3, padding=1, bias=False),
        nn.LayerNorm(list(hw), eps=1e-6), nn.ReLU(),
        nn.Conv2d(21, 42, 3, padding=1, bias=False),
        nn.LayerNorm(list(hw), eps=1e-6), nn.ReLU(),
        AdaptiveAvgPool2d(3))


class TexVisFusion(nn.Module):
    """Visibility-gated texture feature fusion (networks.py:268-293).

    ``hw3`` / ``hw4`` are the texture-map and image sizes, which fix the
    shapes of the global-context LayerNorm affines (as in the reference).
    """

    def __init__(self, num_v: int = 779, q_feat_in: int = 96,
                 q_feat_out: int = 40, if_ch3: int = 8, hw3=(64, 64),
                 hw4=(256, 256)):
        super().__init__()
        self.num_v = num_v
        self.fconv = _fuse(q_feat_in, q_feat_in, q_feat_out)
        self.fconv_at = _gate(q_feat_in, q_feat_in, 6)
        self.fconv_gt = nn.Sequential(
            nn.Conv1d(42, num_v, 3, padding=1, bias=False),
            nn.LayerNorm(18, eps=1e-6), nn.ReLU(),
            nn.Conv1d(num_v, num_v * 2, 3, padding=1, bias=False),
            nn.LayerNorm(18, eps=1e-6), nn.ReLU())
        self.fconv3 = _global_ctx(if_ch3, hw3)
        self.fconv4 = _global_ctx(3, hw4)

    def vertex_table(self, ft1, img_fmap, vert_xy):
        """Source RGB + texture features at the projected vertices plus the
        broadcast global-context features: (B, V2, 11 + 18)."""
        vert_feat = feat_sample_nhwc(ft1, vert_xy)
        vert_img = feat_sample_nhwc(img_fmap, vert_xy)
        pdt = self.fconv3[0].weight.dtype       # the parameters' dtype
        gf_tex = self.fconv3(ft1.permute(0, 3, 1, 2).to(pdt)).flatten(2)
        gf_img = self.fconv4(img_fmap.permute(0, 3, 1, 2).to(pdt)).flatten(2)
        gf = self.fconv_gt(torch.cat([gf_img, gf_tex], -1))       # (B,V2,18)
        return torch.cat([vert_img, vert_feat, gf.to(vert_feat.dtype)], -1)

    def forward(self, vert_xy, ft1, ft_xy, vert, v, vert_vis, query_vis,
                img_xy, img_fmap, latent_fused, nn_idx=None, knn=None):
        """Returns the (B, N, 40) per-view IBR feature."""
        if knn is None:
            if nn_idx is None:
                nn_idx = _nn_idx(v, vert)
            knn = knn_gather_1(v, vert,
                               self.vertex_table(ft1, img_fmap, vert_xy),
                               vert_vis, self.num_v, nn_idx)
        f_knn, f_knn_toh, vis_th, vis_toh = knn
        knn_gf, knn_toh_gf = f_knn[..., 11:], f_knn_toh[..., 11:]
        knn_f, knn_toh_f = f_knn[..., :11], f_knn_toh[..., :11]
        query_feat = torch.cat([img_xy, ft_xy], -1)
        vis_ctx = torch.cat([query_vis, vis_th, vis_toh], -1)
        gate = _pointwise(self.fconv_at, [query_feat, knn_f, knn_toh_f,
                                          knn_gf, knn_toh_gf, latent_fused,
                                          vis_ctx])
        y = [query_feat * gate[..., 0:1], knn_f * gate[..., 1:2],
             knn_toh_f * gate[..., 2:3], knn_gf * gate[..., 3:4],
             knn_toh_gf * gate[..., 4:5], latent_fused * gate[..., 5:6],
             vis_ctx]
        return _pointwise(self.fconv, y)
