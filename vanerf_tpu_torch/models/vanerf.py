"""VANeRF generator (port of ``vanerf_tpu/models/vanerf.py``; reference
``VANeRF``, ``src/model.py:604-1024``).

Supported: one source view, ``sp_type=rel_z_decay``, ``sp_conv=false``,
float32, eval and training (at one view the training query equals the eval
query: view dropout needs two views).  The fused-MLP, two-resolution and
MXU row-gather variants of the JAX package are not ported and raise when
their environment switches are set.  At inference small encoder maps
(``interp_mxu_viable``) are sampled through kernel D, as the JAX package
does on a TPU; kernel D has no gradient, so under training or an autograd
graph they take the gather path, as in JAX (``models/vanerf.py:304-324``).
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn

from ..ops.grid_sample import feat_sample_nhwc
from ..ops.interp_mxu import interp_mxu_viable, interp_sample_nhwc
from ..ops.knn import knn_gather_1, nearest_vertex_d2
from .blocks import HGFilter, ResBlkEncoder, avg_pool2
from .fusion import GeoVisFusion, TexVisFusion
from .ibr import IBRRenderingHead
from .mlp import MLPUNetFusion
from .spatial import SpatialEncoder

_UNPORTED_ENV = ("VANERF_FUSED_MLP", "VANERF_TWO_RES", "VANERF_MXU_ROWS")


def _check_env():
    for name in _UNPORTED_ENV:
        if os.environ.get(name, "0") not in ("", "0"):
            raise NotImplementedError(f"{name} is not ported to PyTorch")
    if os.environ.get("VANERF_IBR_V1_SHORTCUT", "1") == "0":
        raise NotImplementedError(
            "VANERF_IBR_V1_SHORTCUT=0: the port uses the exact one-view "
            "shortcut of the IBR head")


def _psamp(f, xy, training: bool):
    """Bilinear sample; small maps go through kernel D at inference."""
    if (not training and not torch.is_grad_enabled()
            and interp_mxu_viable(f.shape[1], f.shape[2])):
        return interp_sample_nhwc(f, xy)
    return feat_sample_nhwc(f, xy)


class VANeRF(nn.Module):
    """The generator.  Build with :meth:`from_config`."""

    def __init__(self, sp_args: dict, geo_args: dict, mlp_geo_args: dict,
                 tex_args: dict, gcompress_in: int = 128,
                 gcompress_out: int = 24, ibr_in_channels: int = 37,
                 ds_geo: int = 1, ds_tex: int = 1, num_v: int = 779,
                 image_hw=(256, 256), far_tau: float = 0.02, far_skip: float = 0.0,
                 far_net: float = 0.0, far_tnet: float = 0.0):
        super().__init__()
        self.sp_args = dict(sp_args)
        self.num_v = num_v
        self.ds_geo, self.ds_tex = ds_geo, ds_tex
        self.far_tau, self.far_skip = far_tau, far_skip
        self.far_net, self.far_tnet = far_net, far_tnet
        self.sp_encoder = SpatialEncoder(
            sp_level=sp_args["sp_level"], sp_type=sp_args["sp_type"],
            scale=sp_args["scale"], n_kpt=sp_args["n_kpt"],
            sigma=sp_args.get("sigma", 150.0))
        g = dict(geo_args)
        self.geo_encoder = HGFilter(
            n_stack=g.get("n_stack", 1), n_downsample=g.get("n_downsample", 4),
            out_ch=g.get("out_ch", 64), out_ch_hd=g.get("out_ch_hd", 8),
            hd=g.get("hd", False))
        t = dict(tex_args)
        self.tex_encoder = ResBlkEncoder(
            out_ch=t.get("out_ch", 8), ngf=t.get("ngf", 16),
            n_downsample=t.get("n_downsample", 3),
            n_blocks=t.get("n_blocks", 4), n_upsample=t.get("n_upsample", 3),
            norm=t.get("norm", "instance"))
        mg = dict(mlp_geo_args)
        nd = list(mg["n_dims1"])
        nd[0] = self.sp_encoder.get_dim()
        self.mlp_geo = MLPUNetFusion(
            nd, mg["n_dims2"], mg["skip_dims"], mg["skip_layers"],
            nl_layer=mg.get("nl_layer", "softplus"),
            norm=mg.get("norm", "weight"),
            pool_types=mg.get("pool_types", ("mean",)))
        H, W = image_hw
        th, tw = H >> ds_tex, W >> ds_tex
        n_dn, n_up = t.get("n_downsample", 3), t.get("n_upsample", 3)
        tex_hw = ((th >> n_dn) << n_up, (tw >> n_dn) << n_up)
        self.geo_vis_fusion = GeoVisFusion(num_v=num_v)
        self.tex_vis_fusion = TexVisFusion(
            num_v=num_v, if_ch3=t.get("out_ch", 8), hw3=tex_hw, hw4=(H, W))
        self.ibr_compress_gfeat = nn.Linear(gcompress_in, gcompress_out)
        self.mlp_tex = IBRRenderingHead(in_channels=ibr_in_channels)
        self.sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))

    @classmethod
    def from_config(cls, cfg: dict, num_v: int = 779, image_hw=(256, 256)):
        m = cfg["models"]["VANeRF"]
        for unported in ("sp_conv", "disable_fg_mask"):
            if m.get(unported, False):
                raise NotImplementedError(f"{unported} is not ported")
        cdt = m.get("compute_dtype", "float32")
        if cdt != "float32":
            raise NotImplementedError(f"compute_dtype {cdt!r}: the port "
                                      "computes in float32")
        inf = cfg.get("inference", {})
        gc = m["mlp_tex_args"]["gcompress"]
        return cls(
            sp_args=m["sp_args"], geo_args=m["geo_args"],
            mlp_geo_args=m["mlp_geo_args"], tex_args=m["tex_args"],
            gcompress_in=gc.get("in_ch", 128), gcompress_out=gc["out_ch"],
            ds_geo=m.get("ds_geo", 0), ds_tex=m.get("ds_tex", 0),
            num_v=num_v, image_hw=tuple(image_hw),
            far_tau=float(inf.get("far_tau", 0.02)),
            far_skip=float(inf.get("far_skip", 0.0)),
            far_net=float(inf.get("far_net", 0.0)),
            far_tnet=float(inf.get("far_tnet", 0.0)))

    # ------------------------------------------------------------------
    # encoders (reference attach_geo_feat / attach_tex_feat)
    # ------------------------------------------------------------------

    def encode(self, im: torch.Tensor):
        """im (BV, H, W, 3) in [0, 1] -> feat_geo [coarse, fine], feat_tex,
        channels-last."""
        im_g = im
        for _ in range(self.ds_geo):
            im_g = avg_pool2(im_g)
        feat_geo = self.geo_encoder(2.0 * im_g - 1.0)
        im_t = im
        for _ in range(self.ds_tex):
            im_t = avg_pool2(im_t)
        feat_tex = self.tex_encoder(2.0 * im_t - 1.0)
        return feat_geo, feat_tex

    # ------------------------------------------------------------------
    # per-point query (reference VANeRF.query, model.py:748-877)
    # ------------------------------------------------------------------

    def query(self, pts, view, cam, feat_geo, feat_tex, src_img, fg_mask,
              verts, vert_vis, query_vis, query_sdf, kpt3d, n_samples: int,
              n_views: int = 1, training: bool = False, nn_idx=None,
              far_mask=None):
        """(sdf_channel, radiance, rgb) at world points.

        pts/view (B, N, 3); cam: 'KRT'/'extrin' (B, 4, 4), 'width',
        'height', 'znear', 'zfar'; feat_geo [(B,h,w,64), (B,H2,W2,8)];
        feat_tex (B, h2, w2, 8); src_img (B, H, W, 3); fg_mask (B, H, W, 1);
        verts (B, V2, 3); vert_vis (B, V2, 1); query_vis/query_sdf
        (B, N, 1); kpt3d (B, K, 3); nn_idx (B, N) nearest-vertex ids;
        far_mask (B, N, 1) bool or None; ``training`` keeps kernel D off.
        Returns out (B, N, 5), valid (B, N, 1).
        """
        if n_views != 1:
            raise NotImplementedError("the port renders one source view")
        _check_env()
        B, N, _ = pts.shape
        krt = cam["KRT"]
        width, height = cam["width"], cam["height"]
        znear, zfar = cam["znear"], cam["zfar"]
        v = pts

        vh = v @ krt[:, :3, :3].transpose(-1, -2) + krt[:, None, :3, 3]
        z = vh[..., 2:3]
        xy = vh[..., :2] / z
        xy = torch.stack([2.0 * (xy[..., 0] / (width - 1.0)) - 1.0,
                          2.0 * (xy[..., 1] / (height - 1.0)) - 1.0], -1)
        z = 2.0 * (z - znear) / (zfar - znear) - 1.0

        eps = 1e-2
        mask_xy = (xy >= -1.0 - eps) & (xy <= 1.0 + eps)
        out_mask = (mask_xy[..., 0] & mask_xy[..., 1]
                    & (z[..., 0] >= -1.0))[..., None].to(pts.dtype)
        out_mask = out_mask.reshape(B, 1, N, 1)

        if fg_mask.shape[1:3] == src_img.shape[1:3]:
            fm = feat_sample_nhwc(torch.cat([fg_mask, src_img], -1), xy)
            fg_xy, img_xy = fm[..., :1], fm[..., 1:]
        else:
            fg_xy = feat_sample_nhwc(fg_mask, xy)
            img_xy = feat_sample_nhwc(src_img, xy)
        ok = ((fg_xy.reshape(B, 1, N, 1) > 0.1)
              & (out_mask > 0)).all(1, keepdim=True)
        out_mask = out_mask * ok

        # boundary-smooth pixel weights (model.py:813-821)
        xyz01 = 0.5 * torch.cat([xy, z], -1) + 0.5
        dist_b = torch.minimum(xyz01, 1.0 - xyz01)
        pw = torch.sigmoid(5.0 * (dist_b / 0.1 - 1.0))
        pw = (pw[..., 0] * pw[..., 1] * pw[..., 2]).reshape(B, 1, N, 1)
        pw = pw.detach() * out_mask
        pix_weight = pw / (pw.sum(1, keepdim=True) + 1e-6)

        if feat_geo[1].shape[1:3] == feat_tex.shape[1:3]:
            half = _psamp(torch.cat([feat_geo[1], feat_tex], -1), xy,
                          training)
            ch1 = feat_geo[1].shape[-1]
            feat_sampled = [_psamp(feat_geo[0], xy, training),
                            half[..., :ch1]]
            feat_tex_xy = half[..., ch1:]
        else:
            feat_sampled = [_psamp(f, xy, training) for f in feat_geo]
            feat_tex_xy = feat_sample_nhwc(feat_tex, xy)

        y = self.sp_encoder(v=v, extrin=cam["extrin"], kpt3d=kpt3d)
        y = y.reshape(B, 1, N, -1)

        # project mesh vertices into the source view (model.py:845-853)
        vvh = verts @ krt[:, :3, :3].transpose(-1, -2) + krt[:, None, :3, 3]
        vz = vvh[..., 2:3]
        vxy = vvh[..., :2] / (vz + 1e-8)
        vert_xy = torch.stack([2.0 * (vxy[..., 0] / (width - 1.0)) - 1.0,
                               2.0 * (vxy[..., 1] / (height - 1.0)) - 1.0],
                              -1)

        if nn_idx is None:
            nn_idx = torch.stack([nearest_vertex_d2(v[b], verts[b])[0]
                                  for b in range(B)])
        # one shared KNN gather for both fusion branches
        gv = self.geo_vis_fusion.vertex_table(feat_geo, vert_xy)
        tv = self.tex_vis_fusion.vertex_table(feat_tex, src_img, vert_xy)
        f_s, f_toh_s, vis_th, vis_toh = knn_gather_1(
            v, verts, torch.cat([gv, tv], -1), vert_vis, self.num_v, nn_idx)
        if far_mask is not None:
            # far-field tier: the nearest vertex's visibility stands in
            query_vis = torch.where(far_mask, vis_th, query_vis)
        cg = gv.shape[-1]
        geo_knn = (f_s[..., :cg], f_toh_s[..., :cg], vis_th, vis_toh)
        tex_knn = (f_s[..., cg:], f_toh_s[..., cg:], vis_th, vis_toh)
        fused = self.geo_vis_fusion(vert_xy, feat_geo, feat_sampled, verts,
                                    v, vert_vis, query_vis, query_sdf,
                                    knn=geo_knn)
        fused = [f.reshape(B, 1, N, -1) for f in fused]

        out, valid, _x_view, latent_fused = self.mlp_geo(
            y, fused, out_mask, pix_weight)
        rgb = self._query_color(vert_xy, verts, vert_vis, query_vis, v,
                                feat_tex, latent_fused, src_img, img_xy,
                                feat_tex_xy, tex_knn)
        out = torch.cat([out, rgb], -1)
        return out, valid.to(out.dtype)

    def _query_color(self, vert_xy, vert, vert_vis, query_vis, v, feat_tex,
                     latent_fused, img, img_xy, feat_xy, tex_knn):
        """IBR colour query (model.py:884-957) at one source view: the
        blend is a softmax over a single view (== 1), so the head reduces
        exactly to the fused feature's rgb (the JAX package's default
        VANERF_IBR_V1_SHORTCUT)."""
        latent = self.ibr_compress_gfeat(latent_fused)
        rgb_feat = self.tex_vis_fusion(vert_xy, feat_tex, feat_xy, vert, v,
                                       vert_vis, query_vis, img_xy, img,
                                       latent, knn=tex_knn)
        return rgb_feat[..., :3]


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation following flax's defaults: lecun-normal
    (truncated) weights, zero biases, unit norm scales and weight-norm
    gains, sigmoid_beta 0.1, ani_al 0.2."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = model.get_submodule(name.rsplit(".", 1)[0]) \
                if "." in name else model
            if leaf == "sigmoid_beta":
                p.fill_(0.1)
            elif leaf == "ani_al":
                p.fill_(0.2)
            elif leaf in ("bias",):
                p.zero_()
            elif leaf == "weight_g" or isinstance(
                    owner, (nn.GroupNorm, nn.LayerNorm)):
                p.fill_(1.0)
            else:
                if isinstance(owner, nn.ConvTranspose2d):
                    # flax ConvTranspose(transpose_kernel=True) kernels are
                    # (kh, kw, out, in): fan-in over the OUTPUT channels
                    fan_in = p.shape[1] * p[0, 0].numel()
                else:
                    fan_in = p[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
