"""The dense voxel fusion branch, ``sp_conv: true`` (port of
``vanerf_tpu/models/voxel_fusion.py``; reference ``GeoVisFusion_spconv`` /
``TexVisFusion_spconv`` / ``SparseConvNet``, ``src/networks.py:108-217,
295-533``).

The vertex features are scattered into a 5 mm voxel grid and a four-stage
U-net of 3-D convolutions is sampled at the query points at scales 1-4.
As the JAX package (``PARITY.md``), the grid is a dense channels-last
volume and the norms are GroupNorm, not spconv's sparse tensors and
BatchNorm1d.  The JAX package ``vmap``s the net over the batch with batch
1 inside; one ``Conv3d`` over the stack computes the same, GroupNorm being
per sample.  The volumes are a frame-view's (the vertex tables are), so
the net runs once for each of a pass's Bf V frame-views and each of the
B V element-views samples its frame-view's pyramid (a ``render_full_image``
tile group shares it; the JAX package repeats it per element).

The modules and their children keep the flax tree's names (``conv0`` ..
``conv4``, ``down0`` .. ``down3``, ``Conv_<i>`` / ``GroupNorm_<i>``,
``Dense_<i>`` / ``LayerNorm_0``), so the state-dict keys read as the flax
paths (e.g. ``geo_vis_fusion.xyzc0.conv0.Conv_0.weight``): the reference
checkpoint has no key for this U-net (``weights.py``).  The texture
branch's global context keeps the dense branch's keys (``fconv3``,
``fconv4``, ``fconv_gt``, ``models/fusion.py``).

Every layer here computes in the parameters' dtype (float32): flax's
layers promote a bfloat16 input to it (``dtype=None``).  The query casts
what these modules return to its compute dtype.

The nearest-vertex rows come from the query's index (``nn_idx``): the JAX
package's ``knn_gather_1`` calls here take none and search again, twice in
the geometry branch and once in the texture branch, on the same points and
vertices, which gives the same index.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops._cuda import batch_index
from ..ops.grid_sample import feat_sample_nhwc
from ..ops.knn import knn_gather_1
from ..ops.voxel import (grid_sample_3d, scatter_to_grid, vertex_voxels,
                         world_to_grid_coords)
from .fusion import _global_ctx


def _groups(ch: int) -> int:
    """The largest divisor of ``ch`` up to 8 (``voxel_fusion.py:27-29``)."""
    return max(g for g in range(1, min(8, ch) + 1) if ch % g == 0)


class _ConvBlock3D(nn.Module):
    """``n_convs`` x (3x3x3 conv, padding 1, no bias; GroupNorm eps 1e-3;
    ReLU), the first with ``stride``."""

    def __init__(self, in_ch: int, out_ch: int, n_convs: int = 2,
                 stride: int = 1):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(f"Conv_{i}", nn.Conv3d(
                in_ch if i == 0 else out_ch, out_ch, 3,
                stride=stride if i == 0 else 1, padding=1, bias=False))
            self.add_module(f"GroupNorm_{i}", nn.GroupNorm(
                _groups(out_ch), out_ch, eps=1e-3))

    def forward(self, x):
        for i in range(self.n_convs):
            x = getattr(self, f"Conv_{i}")(x)
            x = F.relu(getattr(self, f"GroupNorm_{i}")(x))
        return x


class VoxelConvNet(nn.Module):
    """Four-scale voxel pyramid sampled at the query points (SparseConvNet,
    ``networks.py:478-533``): 2 f_in + 2 f_up channels."""

    def __init__(self, f_in: int = 16, f_up: int = 32):
        super().__init__()
        self.conv0 = _ConvBlock3D(f_in, f_in, 2)
        self.down0 = _ConvBlock3D(f_in, f_in, 1, stride=2)
        self.conv1 = _ConvBlock3D(f_in, f_in, 2)
        self.down1 = _ConvBlock3D(f_in, f_in, 1, stride=2)
        self.conv2 = _ConvBlock3D(f_in, f_in, 3)
        self.down2 = _ConvBlock3D(f_in, f_up, 1, stride=2)
        self.conv3 = _ConvBlock3D(f_up, f_up, 3)
        self.down3 = _ConvBlock3D(f_up, f_up, 1, stride=2)
        self.conv4 = _ConvBlock3D(f_up, f_up, 3)

    def forward(self, vol: torch.Tensor, grid_coords: torch.Tensor
                ) -> torch.Tensor:
        """vol (Bm, D, H, W, f_in), grid_coords (B, N, 3) in [-1, 1] (w, h,
        d), element e on volume e % Bm -> (B, N, 2 f_in + 2 f_up)."""
        x = vol.permute(0, 4, 1, 2, 3)

        def sample(x):
            return grid_sample_3d(x.permute(0, 2, 3, 4, 1), grid_coords)

        x = self.down0(self.conv0(x))
        x = self.conv1(x)
        f1 = sample(x)
        x = self.conv2(self.down1(x))
        f2 = sample(x)
        x = self.conv3(self.down2(x))
        f3 = sample(x)
        x = self.conv4(self.down3(x))
        f4 = sample(x)
        return torch.cat([f1, f2, f3, f4], -1)


class LinearGate(nn.Module):
    """Dense -> LayerNorm (eps 1e-6, flax's) -> ReLU -> Dense -> sigmoid
    (``networks.py:112-126``)."""

    def __init__(self, c_in: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(c_in, hidden)
        self.LayerNorm_0 = nn.LayerNorm(hidden, eps=1e-6)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x):
        return torch.sigmoid(self.Dense_1(F.relu(self.LayerNorm_0(
            self.Dense_0(x)))))


class LinearFuse(nn.Module):
    """Dense -> LayerNorm (eps 1e-6) -> ReLU -> Dense
    (``networks.py:128-133``)."""

    def __init__(self, c_in: int, hidden: int, out: int):
        super().__init__()
        self.Dense_0 = nn.Linear(c_in, hidden)
        self.LayerNorm_0 = nn.LayerNorm(hidden, eps=1e-6)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.Dense_1(F.relu(self.LayerNorm_0(self.Dense_0(x))))


def _grid_inputs(v, vert, bounds, grid_shape):
    """The element-views' grid coordinates (the shape passed reversed, as
    the JAX package passes it) and the frame-views' vertex voxels."""
    B, Bm = v.shape[0], bounds.shape[0]
    bounds_e = bounds if B == Bm else bounds[batch_index(B, Bm, v.device)]
    grid_coords = world_to_grid_coords(v, bounds_e, tuple(grid_shape)[::-1])
    return grid_coords, vertex_voxels(vert, bounds)


class GeoVisFusionSP(nn.Module):
    """Geometry fusion with the voxel branch (``networks.py:169-217``): the
    gates are a feature gate times a visibility gate, at two scales."""

    # (compress, channels, f_in, f_up, gate hidden, fuse hidden, out)
    SPECS = ((True, 64, 16, 32, 10, 64, 64), (False, 8, 8, 16, 10, 8, 8))

    def __init__(self, num_v: int = 779):
        super().__init__()
        self.num_v = num_v
        for si, (compress, ch, f_in, f_up, at_h, fu_h, out) in \
                enumerate(self.SPECS):
            if compress:
                self.add_module(f"compress{si}", LinearFuse(ch, 32, f_in))
            self.add_module(f"xyzc{si}", VoxelConvNet(f_in, f_up))
            n_fused = ch + 2 * f_in + 2 * f_in + 2 * f_up + 1
            self.add_module(f"at{si}", LinearGate(n_fused, at_h, 5))
            self.add_module(f"vis_at{si}", LinearGate(3, 10, 5))
            self.add_module(f"ated{si}", LinearFuse(n_fused + 3, fu_h, out))

    def forward(self, vert_xy, fg, feat_sampled, vert, v, vert_vis,
                query_vis, query_sdf, bounds, nn_idx,
                grid_shape: Sequence[int] = (64, 64, 64)):
        """vert_xy (Bm, V2, 2), fg [(Bm, h, w, 64), (Bm, H2, W2, 8)], vert
        (Bm, V2, 3), vert_vis (Bm, V2, 1) and bounds (Bm, 2, 3) of the Bm
        frame-views; feat_sampled [(B, N, 64), (B, N, 8)], v (B, N, 3),
        query_vis (B, N, 1), query_sdf (B, N, 1) (the activated prior
        density) and nn_idx (B, N) of the B element-views, e on frame-view
        e % Bm.  Returns [(B, N, 64), (B, N, 8)] in the parameters'
        dtype."""
        pdt = self.at0.Dense_0.weight.dtype      # the parameters' dtype
        grid_coords, vcoords = _grid_inputs(v, vert, bounds, grid_shape)
        query_vis, query_sdf = query_vis.to(pdt), query_sdf.to(pdt)
        outs = []
        for si, (compress, *_rest) in enumerate(self.SPECS):
            vert_feat = feat_sample_nhwc(fg[si], vert_xy).to(pdt)
            if compress:
                vert_feat = getattr(self, f"compress{si}")(vert_feat)
            vol = scatter_to_grid(vert_feat, vcoords, grid_shape)
            xyzc = getattr(self, f"xyzc{si}")(vol, grid_coords)
            f_knn, f_knn_toh, vis_th, vis_toh = knn_gather_1(
                v, vert, vert_feat, vert_vis.to(pdt), self.num_v, nn_idx,
                weight_by_vis=False)
            fs = feat_sampled[si].to(pdt)
            fused = torch.cat([fs, f_knn, f_knn_toh, xyzc, query_sdf], -1)
            vis_ctx = torch.cat([query_vis, vis_th, vis_toh], -1)
            gate = (getattr(self, f"at{si}")(fused)
                    * getattr(self, f"vis_at{si}")(vis_ctx))
            ated = torch.cat([fs * gate[..., 0:1], f_knn * gate[..., 1:2],
                              f_knn_toh * gate[..., 2:3],
                              xyzc * gate[..., 3:4],
                              query_sdf * gate[..., 4:5], vis_ctx], -1)
            outs.append(getattr(self, f"ated{si}")(ated))
        return outs


class TexVisFusionSP(nn.Module):
    """Texture fusion with the voxel branch (``networks.py:357-394``).

    ``hw3`` / ``hw4`` are the texture-map and image sizes of the global
    context's LayerNorm affines (as :class:`~.fusion.TexVisFusion`)."""

    def __init__(self, num_v: int = 779, q_feat_in: int = 96,
                 q_feat_out: int = 40, if_ch3: int = 8, hw3=(64, 64),
                 hw4=(256, 256), latent: int = 24):
        super().__init__()
        self.num_v = num_v
        self.fconv_gt = nn.Sequential(
            nn.Conv1d(42, num_v, 3, padding=1, bias=False),
            nn.LayerNorm(18, eps=1e-6), nn.ReLU(),
            nn.Conv1d(num_v, num_v * 2, 3, padding=1, bias=False),
            nn.LayerNorm(18, eps=1e-6), nn.ReLU())
        self.fconv3 = _global_ctx(if_ch3, hw3)
        self.fconv4 = _global_ctx(3, hw4)
        f_in = 3 + if_ch3 + 18                                    # 29
        self.xyzc = VoxelConvNet(f_in, 32)
        n_y = (3 + if_ch3) * 3 + 18 * 2 + 2 * f_in + 2 * 32 + latent
        self.at = LinearGate(n_y, q_feat_in, 7)
        self.vis_at = LinearGate(3, 10, 7)
        self.fuse = LinearFuse(n_y + 3, q_feat_in, q_feat_out)

    def forward(self, vert_xy, ft1, ft_xy, vert, v, vert_vis, query_vis,
                img_xy, img_fmap, latent_fused, bounds, nn_idx,
                grid_shape: Sequence[int] = (64, 64, 64)):
        """The frame-views' vert_xy, ft1 (texture maps), vert, vert_vis,
        img_fmap (source images) and bounds; the element-views' ft_xy,
        v, query_vis, img_xy, latent_fused (B, N, 24) and nn_idx.  Returns
        the (B, N, 40) per-view IBR feature in the parameters' dtype."""
        pdt = self.at.Dense_0.weight.dtype       # the parameters' dtype
        vert_feat = feat_sample_nhwc(ft1, vert_xy).to(pdt)
        vert_img = feat_sample_nhwc(img_fmap, vert_xy).to(pdt)
        gf_tex = self.fconv3(ft1.permute(0, 3, 1, 2).to(pdt)).flatten(2)
        gf_img = self.fconv4(img_fmap.permute(0, 3, 1, 2).to(pdt)).flatten(2)
        gf = self.fconv_gt(torch.cat([gf_img, gf_tex], -1))       # (Bm,V2,18)
        vert_feat = torch.cat([vert_img, vert_feat, gf], -1)      # 29

        grid_coords, vcoords = _grid_inputs(v, vert, bounds, grid_shape)
        vol = scatter_to_grid(vert_feat, vcoords, grid_shape)
        xyzc = self.xyzc(vol, grid_coords)                        # 122

        f_knn, f_knn_toh, vis_th, vis_toh = knn_gather_1(
            v, vert, vert_feat, vert_vis.to(pdt), self.num_v, nn_idx,
            weight_by_vis=False)
        c = vert_img.shape[-1] + ft1.shape[-1]                    # 11
        knn_gf, knn_toh_gf = f_knn[..., c:], f_knn_toh[..., c:]
        knn_f, knn_toh_f = f_knn[..., :c], f_knn_toh[..., :c]
        query_feat = torch.cat([img_xy, ft_xy], -1).to(pdt)
        latent_fused = latent_fused.to(pdt)
        y = torch.cat([query_feat, knn_f, knn_toh_f, knn_gf, knn_toh_gf,
                       xyzc, latent_fused], -1)                  # 215
        vis_ctx = torch.cat([query_vis.to(pdt), vis_th, vis_toh], -1)
        gate = self.at(y) * self.vis_at(vis_ctx)
        y_ated = torch.cat(
            [query_feat * gate[..., 0:1], knn_f * gate[..., 1:2],
             knn_toh_f * gate[..., 2:3], knn_gf * gate[..., 3:4],
             knn_toh_gf * gate[..., 4:5], xyzc * gate[..., 5:6],
             latent_fused * gate[..., 6:7], vis_ctx], -1)        # 218
        return self.fuse(y_ated)
