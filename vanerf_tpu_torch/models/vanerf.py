"""VANeRF generator (port of ``vanerf_tpu/models/vanerf.py``; reference
``VANeRF``, ``src/model.py:604-1024``).

Supported: ``n_views`` source views (the shipped configs take one, the
reference one or two), the ten ``sp_type``s (``models/spatial.py``;
``mxyz`` / ``rel_mxyz`` read the query's ``model_T``), ``sp_conv`` false
or true (the dense voxel fusion branch of ``models/voxel_fusion.py`` on a
``voxel_grid`` of 64^3 unless the config or the attribute says otherwise;
the query then takes the frames' ``bounds``),
``disable_fg_mask``, the geometry MLP's activations and ``max`` pooling
(``models/mlp.py``), the texture encoder's norms (``models/blocks.py``),
eval and training.  At one view the training query
equals the eval query and the IBR colour head reduces to the fused
feature's rgb, exactly (``VANERF_IBR_V1_SHORTCUT=0`` runs the head anyway);
at more views the points are repeated per view, the geometry MLP pools
over the views, the IBR head blends them, and a training query takes the
view-dropout mask its caller draws (:func:`view_dropout_mask`).
``compute_dtype`` (``VANERF_COMPUTE_DTYPE``
first, then the config's, else float32 as the JAX package's default off a
TPU) is ``"float32"`` or ``"bfloat16"``, for serving and for training;
any other type raises.  In bfloat16 the query follows the JAX package's
policy (``vanerf_tpu/models/vanerf.py:233-245``): the feature maps, the
source image and mask, the encoding, the visibility / SDF inputs and every
per-point activation are bfloat16; the parameters, the projection math and
the query's output stay float32, and so do the encoders and the mesh
priors, whose outputs are cast at the query.  Under autograd the
gradients pass back through those casts (and the layers' casts of their
float32 weights) to float32, as through flax's ``Dense(dtype=bfloat16,
param_dtype=float32)``, and every op of the bfloat16 backward rounds to
bfloat16.  ``VANERF_FUSED_MLP=1`` runs the
positional encoding, ``MLPUNetFusion`` and ``gcompress`` as kernel 12, ``=2``
the whole per-point network behind the gathers as kernel 11
(``ops/fused_mlp.py``), both at one view, at inference and for
``sp_type=rel_z_decay`` only, as in JAX; the port also keeps them off
unless the geometry MLP runs softplus with [mean, var] pooling, the only
network the kernels compute (JAX's kernel computes it whatever the config
says); the KNN rows
come through kernel 10 whenever no
graph is built (``ops/knn.py``; the JAX package's ``VANERF_MXU_ROWS`` is
not read).  ``VANERF_TWO_RES=1`` samples the texture map on the fine
geometry map's row gather (``ops/grid_sample.py::
feat_sample_two_res_nhwc``) at inference where the texture map is no
larger than that map, as in JAX.  At inference small encoder maps
(``interp_mxu_viable``) are sampled through kernel D, as the JAX package
does on a TPU (``VANERF_MXU_INTERP=0`` turns it off); kernel D has no
gradient, so under training or an autograd graph they take the gather
path, as in JAX (``models/vanerf.py:304-324``).
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn

from ..ops._cuda import batch_index
from ..ops.fused_mlp import (fused_geo_mlp, fused_query_mlp,
                             pack_geo_weights, pack_query_weights,
                             prepare_geo_mlp_weights, prepare_query_weights)
from ..ops.grid_sample import feat_sample_nhwc, feat_sample_two_res_nhwc
from ..ops.interp_mxu import interp_mxu_viable, interp_sample_nhwc
from ..ops.knn import knn_gather_1, knn_gather_raw, nearest_vertex_d2
from ..ops.mesh_query import cull_sizes
from ..profiling import span, spanned
from .blocks import HGFilter, ResBlkEncoder, avg_pool2
from .fusion import GeoVisFusion, TexVisFusion
from .ibr import IBRRenderingHead
from .mlp import MLPUNetFusion, dense
from .spatial import SpatialEncoder
from .voxel_fusion import GeoVisFusionSP, TexVisFusionSP

# the compute dtypes the port takes, by the JAX package's names
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(cfg_model: dict) -> str:
    """``VANERF_COMPUTE_DTYPE`` first, then ``models.VANeRF.compute_dtype``,
    else float32 (``vanerf_tpu/models/vanerf.py:106-117``; float32 is the
    JAX package's default off a TPU).  Raises on a type the port does not
    compute in."""
    cdt = os.environ.get("VANERF_COMPUTE_DTYPE",
                         cfg_model.get("compute_dtype", "float32"))
    if cdt not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype {cdt!r}: the port computes in "
            f"{' or '.join(COMPUTE_DTYPES)}")
    return cdt


def _check_env():
    """Raise on culled-query tile and chunk sizes the CUDA body is not
    built for (``mesh_query.cull_sizes``).  VANERF_PE_CONCAT,
    VANERF_MXU_TILE_N and VANERF_MXU_CHUNK change only the TPU's layout
    and have no effect here (README)."""
    cull_sizes()


def fused_network(mlp_geo_args: dict) -> bool:
    """Whether the fused kernels compute the geometry MLP of this config:
    softplus with [mean, var] pooling is the only network they hold
    (``ops/fused_mlp.py``)."""
    return (mlp_geo_args.get("nl_layer", "softplus") == "softplus"
            and tuple(mlp_geo_args.get("pool_types", ("mean",)))
            == ("mean", "var"))


def view_dropout_mask(B: int, n_views: int, u_keep=None, u_perm=None,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """The reference's training view dropout (``model.py:804-810``; the
    JAX package's ``view_dropout_mask``, ``vanerf_tpu/models/vanerf.py:
    32-50``): one view is always kept, each other view is kept where its
    uniform exceeds 0.5, and a stable argsort of the per-view scores
    places the guaranteed view.  The mask is per view and per batch
    element, (B, V, 1, 1) float32 on ``u_keep``'s device, and broadcasts
    over the points.

    Args:
      u_keep: (B, V - 1, 1, 1) uniforms in [0, 1); u_perm: (B, V, 1, 1) on
        the same device.  Either, when not given, is drawn from
        ``generator`` on its device.
    """
    gdev = generator.device if generator is not None else torch.device("cpu")
    if u_keep is None:
        u_keep = torch.rand((B, n_views - 1, 1, 1), generator=generator,
                            device=gdev)
    if u_perm is None:
        u_perm = torch.rand((B, n_views, 1, 1), generator=generator,
                            device=gdev)
    drop = torch.cat([torch.ones((B, 1, 1, 1), device=u_keep.device),
                      (u_keep > 0.5).float()], 1)
    order = torch.argsort(u_perm, dim=1, stable=True)
    return torch.take_along_dim(drop, order, dim=1)


def per_element(x: torch.Tensor, B: int) -> torch.Tensor:
    """A per-frame tensor (Bf, ...) for B = G x Bf batch elements, element
    e taking frame e % Bf (``x`` itself when B = Bf): a small copy, for the
    cameras and keypoints only."""
    Bf = x.shape[0]
    return x if Bf == B else x[batch_index(B, Bf, x.device)]


def _psamp(f, xy, training: bool):
    """Bilinear sample; small maps go through kernel D at inference unless
    ``VANERF_MXU_INTERP`` is 0 or empty (``vanerf_tpu/models/vanerf.py``
    reads it so; its "on the TPU only" for ``1`` reads "on the card" here,
    and CPU tensors take kernel D's plain version)."""
    flag = os.environ.get("VANERF_MXU_INTERP", "1")
    if (flag not in ("", "0") and not training and not torch.is_grad_enabled()
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
                 far_net: float = 0.0, far_tnet: float = 0.0,
                 compute_dtype: str = "float32",
                 disable_fg_mask: bool = False, sp_conv: bool = False,
                 voxel_grid=(64, 64, 64)):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise NotImplementedError(f"compute_dtype {compute_dtype!r}")
        self.compute_dtype = compute_dtype
        self.disable_fg_mask = disable_fg_mask
        self.sp_args = dict(sp_args)
        self.sp_conv = bool(sp_conv)
        # the dense grid (D, H, W) of the sp_conv branch, read at each query
        self.voxel_grid = tuple(int(s) for s in voxel_grid)
        self.fused_ok = (sp_args["sp_type"] == "rel_z_decay"
                         and fused_network(mlp_geo_args) and not sp_conv)
        self.gcompress_out = gcompress_out
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
        if sp_conv:
            self.geo_vis_fusion = GeoVisFusionSP(num_v=num_v)
            self.tex_vis_fusion = TexVisFusionSP(
                num_v=num_v, if_ch3=t.get("out_ch", 8), hw3=tex_hw,
                hw4=(H, W), latent=gcompress_out)
        else:
            self.geo_vis_fusion = GeoVisFusion(num_v=num_v)
            self.tex_vis_fusion = TexVisFusion(
                num_v=num_v, if_ch3=t.get("out_ch", 8), hw3=tex_hw,
                hw4=(H, W))
        self.ibr_compress_gfeat = nn.Linear(gcompress_in, gcompress_out)
        self.mlp_tex = IBRRenderingHead(in_channels=ibr_in_channels)
        self.sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))
        self._fused_cache = {}

    @classmethod
    def from_config(cls, cfg: dict, num_v: int = 779, image_hw=(256, 256)):
        m = cfg["models"]["VANeRF"]
        cdt = resolve_compute_dtype(m)
        inf = cfg.get("inference", {})
        gc = m["mlp_tex_args"]["gcompress"]
        mg = m["mlp_geo_args"]
        return cls(
            sp_args=m["sp_args"], geo_args=m["geo_args"],
            mlp_geo_args=mg, tex_args=m["tex_args"],
            # gcompress reads the pooled latent, whose width the JAX
            # package's Dense infers (the config's in_ch at [mean, var])
            gcompress_in=len(mg.get("pool_types", ("mean",)))
            * mg["n_dims1"][-1], gcompress_out=gc["out_ch"],
            ds_geo=m.get("ds_geo", 0), ds_tex=m.get("ds_tex", 0),
            num_v=num_v, image_hw=tuple(image_hw),
            far_tau=float(inf.get("far_tau", 0.02)),
            far_skip=float(inf.get("far_skip", 0.0)),
            far_net=float(inf.get("far_net", 0.0)),
            far_tnet=float(inf.get("far_tnet", 0.0)), compute_dtype=cdt,
            disable_fg_mask=bool(m.get("disable_fg_mask", False)),
            sp_conv=bool(m.get("sp_conv", False)),
            voxel_grid=tuple(m.get("voxel_grid", (64, 64, 64))))

    @property
    def cdt(self) -> torch.dtype:
        """The torch dtype of :attr:`compute_dtype`."""
        return COMPUTE_DTYPES[self.compute_dtype]

    # ------------------------------------------------------------------
    # encoders (reference attach_geo_feat / attach_tex_feat)
    # ------------------------------------------------------------------

    def encode(self, im: torch.Tensor):
        """im (BV, H, W, 3) in [0, 1] -> feat_geo [coarse, fine], feat_tex,
        channels-last.  On the card the convolutions take cuDNN's
        deterministic algorithms, so two encodes of one frame are equal to
        the bit (as the JAX program's are)."""
        cd = torch.backends.cudnn
        # flags() sets every switch it takes: the caller's cuDNN and TF32
        # settings pass through unchanged
        with cd.flags(enabled=cd.enabled, benchmark=False, deterministic=True,
                      allow_tf32=cd.allow_tf32):
            return self._encode(im)

    def _encode(self, im: torch.Tensor):
        """:meth:`encode` with cuDNN's algorithms as the process's flags
        leave them."""
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

    @spanned("vanerf.query")
    def query(self, pts, view, cam, feat_geo, feat_tex, src_img, fg_mask,
              verts, vert_vis, query_vis, query_sdf, kpt3d, n_samples: int,
              n_views: int = 1, training: bool = False, nn_idx=None,
              far_mask=None, fused_override=None, view_mask=None,
              model_T=None, bounds=None):
        """(sdf_channel, radiance, rgb) at world points.

        pts/view (B, N, 3); cam: 'KRT'/'extrin' (Bf V, 4, 4), the V source
        views of each frame in a row, 'width', 'height', 'znear', 'zfar';
        feat_geo [(Bf V,h,w,64), (Bf V,H2,W2,8)]; feat_tex (Bf V, h2, w2,
        8); src_img (Bf V, H, W, 3); fg_mask (Bf V, H, W, 1); verts
        (Bf, V2, 3); vert_vis (Bf, V2, 1); query_vis/query_sdf (B, N, 1);
        kpt3d (Bf, K, 3); nn_idx (B, N) nearest-vertex ids; far_mask
        (B, N, 1) bool or None; ``training`` keeps kernel D off and, with
        ``n_views`` > 1, multiplies the projection mask by ``view_mask``
        (B, V, 1, 1) (:func:`view_dropout_mask`; None keeps every view).
        The points' batch holds B = G x Bf elements, element e of frame
        e % Bf (the tiles of a ``render_full_image`` tile group); the
        points are repeated per view, element e view v at e V + v, which
        reads map (e V + v) % (Bf V) = f V + v, frame f's view v: the
        frame's maps and vertex tables are read in place by the batched
        kernels and samplers, and only its cameras and keypoints are
        repeated per element.
        ``fused_override`` pins the fused level (0, 1, 2) instead of the
        ``VANERF_FUSED_MLP`` read; level 2 ignores ``far_mask``.  Both
        fused levels take one view at inference and ``rel_z_decay``
        (JAX's gate), and the network they hold (:func:`fused_network`):
        else the level is 0.  ``model_T`` (Bf, 4, 4) is the model
        transform of the ``mxyz`` / ``rel_mxyz`` encodings, a frame's
        for its elements.  ``bounds`` (Bf, 2, 3), the frames' boxes, place
        the voxel grid of ``sp_conv`` (which ignores ``far_mask``, as the
        JAX package's branch does).
        Returns out (B, N, 5) float32, valid (B, N, 1).
        """
        _check_env()
        B, N, _ = pts.shape
        V = n_views
        BV = B * V
        # each element-view's camera and each element's keypoints (the
        # frames' at B = Bf)
        krt_e, extrin_e = (per_element(cam[k], BV) for k in ("KRT", "extrin"))
        kpt3d_e = per_element(kpt3d, B)
        model_T_e = None if model_T is None else per_element(model_T, B)
        # the activation dtype (models/vanerf.py:233-245): the maps, the
        # image and the mask now, the encoding and the visibility / SDF
        # inputs below; coordinates and projection math stay float32
        cdt = self.cdt
        feat_geo = [f.to(cdt) for f in feat_geo]
        feat_tex, src_img, fg_mask = (t.to(cdt) for t in (feat_tex, src_img,
                                                          fg_mask))

        def per_view(t):
            """(n, ...) -> (n V, ...), each row repeated per view."""
            return t if V == 1 or t is None else t.repeat_interleave(V, 0)

        vert_rep = per_view(verts)
        vert_vis, query_vis, query_sdf = (
            per_view(t).to(cdt) for t in (vert_vis, query_vis, query_sdf))
        krt = cam["KRT"]
        width, height = cam["width"], cam["height"]
        znear, zfar = cam["znear"], cam["zfar"]
        with span("vanerf.query.sample"):
            v = per_view(pts)                                  # (B V, N, 3)

            vh = (v @ krt_e[:, :3, :3].transpose(-1, -2)
                  + krt_e[:, None, :3, 3])
            z = vh[..., 2:3]
            xy = vh[..., :2] / z
            xy = torch.stack([2.0 * (xy[..., 0] / (width - 1.0)) - 1.0,
                              2.0 * (xy[..., 1] / (height - 1.0)) - 1.0],
                             -1)
            z = 2.0 * (z - znear) / (zfar - znear) - 1.0

            eps = 1e-2
            mask_xy = (xy >= -1.0 - eps) & (xy <= 1.0 + eps)
            out_mask = (mask_xy[..., 0] & mask_xy[..., 1]
                        & (z[..., 0] >= -1.0))[..., None].to(pts.dtype)
            out_mask = out_mask.reshape(B, V, N, 1)

            if fg_mask.shape[1:3] == src_img.shape[1:3]:
                fm = feat_sample_nhwc(torch.cat([fg_mask, src_img], -1), xy)
                fg_xy, img_xy = fm[..., :1], fm[..., 1:]
            else:
                fg_xy = feat_sample_nhwc(fg_mask, xy)
                img_xy = feat_sample_nhwc(src_img, xy)
            # a point counts where every view sees it (in its foreground)
            ok = out_mask > 0
            if not self.disable_fg_mask:
                ok = ok & (fg_xy.reshape(B, V, N, 1) > 0.1)
            out_mask = out_mask * ok.all(1, keepdim=True)
            if training and V > 1 and view_mask is not None:
                out_mask = out_mask * view_mask.to(out_mask.dtype)

            # boundary-smooth pixel weights (model.py:813-821), normalised
            # over the views
            xyz01 = 0.5 * torch.cat([xy, z], -1) + 0.5
            dist_b = torch.minimum(xyz01, 1.0 - xyz01)
            pw = torch.sigmoid(5.0 * (dist_b / 0.1 - 1.0))
            pw = (pw[..., 0] * pw[..., 1] * pw[..., 2]).reshape(B, V, N, 1)
            pw = pw.detach() * out_mask
            pix_weight = pw / (pw.sum(1, keepdim=True) + 1e-6)

            if feat_geo[1].shape[1:3] == feat_tex.shape[1:3]:
                half = _psamp(torch.cat([feat_geo[1], feat_tex], -1), xy,
                              training)
                ch1 = feat_geo[1].shape[-1]
                feat_sampled = [_psamp(feat_geo[0], xy, training),
                                half[..., :ch1]]
                feat_tex_xy = half[..., ch1:]
            elif (os.environ.get("VANERF_TWO_RES", "0") != "0"
                  and not training
                  and feat_tex.shape[1] <= feat_geo[1].shape[1]
                  and feat_tex.shape[2] <= feat_geo[1].shape[2]):
                # VANERF_TWO_RES=1 (inference): the coarser texture map rides
                # the fine geometry map's row gather (vanerf_tpu/models/
                # vanerf.py:333-363)
                g1_xy, feat_tex_xy = feat_sample_two_res_nhwc(feat_geo[1],
                                                              feat_tex, xy)
                feat_sampled = [_psamp(feat_geo[0], xy, training), g1_xy]
            else:
                feat_sampled = [_psamp(f, xy, training) for f in feat_geo]
                feat_tex_xy = feat_sample_nhwc(feat_tex, xy)

        # fused query kernels (ops/fused_mlp.py), one source view only:
        #   1: PE + MLPUNetFusion + gcompress; 2: additionally both
        #   gate/fuse nets and the V=1 rgb head.
        fused_level = (fused_override if fused_override is not None
                       else int(os.environ.get("VANERF_FUSED_MLP", "0") or 0))
        if training or V != 1 or not self.fused_ok:
            fused_level = 0
        if fused_level >= 2 and not (
                feat_geo[0].shape[-1] == 64 and feat_geo[1].shape[-1] == 8
                and feat_tex.shape[-1] == 8 and self.gcompress_out == 24
                and kpt3d.shape[1] == self.sp_args["n_kpt"]):
            fused_level = 1          # the full kernel assumes shipped dims

        y = None
        if fused_level == 0:
            with span("vanerf.query.net"):
                y = self.sp_encoder(v=v, pts=pts, z=z, xy=xy, extrin=extrin_e,
                                    kpt3d=kpt3d_e, n_view=V,
                                    model_T=model_T_e)
                y = y.reshape(B, V, N, -1).to(cdt)

        with span("vanerf.query.gather"):
            # project mesh vertices into the source views
            # (model.py:845-853)
            vvh = vert_rep @ krt[:, :3, :3].transpose(-1, -2) \
                + krt[:, None, :3, 3]
            vz = vvh[..., 2:3]
            vxy = vvh[..., :2] / (vz + 1e-8)
            vert_xy = torch.stack(
                [2.0 * (vxy[..., 0] / (width - 1.0)) - 1.0,
                 2.0 * (vxy[..., 1] / (height - 1.0)) - 1.0],
                -1)                                        # (Bf V, V2, 2)

            if nn_idx is None:
                nn_idx = nearest_vertex_d2(v, vert_rep)[0]
            else:
                nn_idx = per_view(nn_idx)
        if self.sp_conv:
            return self._query_sp(v, view, V, krt_e, vert_xy, vert_rep,
                                  vert_vis, query_vis, query_sdf, feat_geo,
                                  feat_sampled, feat_tex, feat_tex_xy,
                                  src_img, img_xy, y, out_mask, pix_weight,
                                  per_view(bounds), nn_idx, n_samples)
        with span("vanerf.query.gather"):
            # one shared KNN gather for both fusion branches
            gv = self.geo_vis_fusion.vertex_table(feat_geo, vert_xy)
            tv = self.tex_vis_fusion.vertex_table(feat_tex, src_img, vert_xy)
            shared = torch.cat([gv, tv], -1)
            if fused_level >= 2:
                # raw rows: slicing, visibility weighting and both fusion
                # nets run inside the kernel
                g2_raw = knn_gather_raw(v, vert_rep, shared, vert_vis,
                                        self.num_v, nn_idx)
            else:
                f_s, f_toh_s, vis_th, vis_toh = knn_gather_1(
                    v, vert_rep, shared, vert_vis, self.num_v, nn_idx)
                if far_mask is not None:
                    # far-field tier: the nearest vertex's visibility stands
                    # in
                    query_vis = torch.where(per_view(far_mask), vis_th,
                                            query_vis)
                cg = gv.shape[-1]
                geo_knn = (f_s[..., :cg], f_toh_s[..., :cg], vis_th, vis_toh)
                tex_knn = (f_s[..., cg:], f_toh_s[..., cg:], vis_th, vis_toh)
        if fused_level >= 2:
            with span("vanerf.query.net"):
                return self._query_fused_full(
                    v, extrin_e, kpt3d_e, feat_sampled, img_xy, feat_tex_xy,
                    query_sdf, query_vis, out_mask, pix_weight, g2_raw)
        with span("vanerf.query.net"):
            fused = self.geo_vis_fusion(vert_xy, feat_geo, feat_sampled,
                                        vert_rep, v, vert_vis, query_vis,
                                        query_sdf, knn=geo_knn)
            fused = [f.reshape(B, V, N, -1) for f in fused]

            if fused_level >= 1:
                cxyz, kptc_T = self._camera_frame(v, kpt3d_e, extrin_e)
                wts, packed = self._fused_weights(False, kptc_T)
                aux = torch.cat([fused[0][:, 0], fused[1][:, 0],
                                 out_mask[:, 0].to(cdt),
                                 pix_weight[:, 0].to(cdt)], -1)  # (B, N, 74)
                sp = self.sp_encoder
                res = [fused_geo_mlp(cxyz[b], kptc_T[b], aux[b], wts,
                                     sp_level=sp.sp_level, scale=sp.scale,
                                     sigma=sp.sigma, packed=packed)
                       for b in range(B)]
                out = torch.stack([r[0] for r in res])
                latent_fused = torch.stack([r[1] for r in res])
                valid = out_mask.sum(1) > 0                     # (B, N, 1)
            else:
                out, valid, _x_view, latent_fused = self.mlp_geo(
                    y, fused, out_mask.to(cdt), pix_weight.to(cdt))
            rgb = self._query_color(vert_xy, vert_rep, vert_vis, query_vis,
                                    v, view, V, krt_e, feat_tex,
                                    latent_fused, src_img, img_xy,
                                    feat_tex_xy, tex_knn, out_mask,
                                    n_samples,
                                    latent_compressed=fused_level >= 1)
        # compositing and the losses stay float32 (models/vanerf.py:533),
        # or float64 where the caller runs the model in it
        odt = torch.promote_types(out.dtype, torch.float32)
        out = torch.cat([out.to(odt), rgb.to(odt)], -1)
        return out, valid.to(out.dtype)

    def _query_sp(self, v, view, V, krt_e, vert_xy, vert_rep, vert_vis,
                  query_vis, query_sdf, feat_geo, feat_sampled, feat_tex,
                  feat_tex_xy, src_img, img_xy, y, out_mask, pix_weight,
                  bounds, nn_idx, n_samples):
        """The ``sp_conv`` tail of :meth:`query` (``vanerf_tpu/models/
        vanerf.py:443-453``, ``:591-594``): the voxel geometry fusion fed
        the activated prior density sigmoid(-sdf / beta) / beta (beta at
        least 2e-3), the geometry MLP, then the voxel texture fusion.
        ``bounds`` (Bf V, 2, 3), a frame-view's box each.  The voxel
        branch's vertex tables and KNN rows are ``vanerf.query.gather``
        ranges inside this ``vanerf.query.net`` range."""
        BV, N, _ = v.shape
        B = BV // V
        cdt = self.cdt
        with span("vanerf.query.net"):
            beta = self.sigmoid_beta.clamp(min=2e-3)
            q_sdf_act = torch.sigmoid(-query_sdf.float() / beta) / beta
            fused = self.geo_vis_fusion(
                vert_xy, feat_geo, feat_sampled, vert_rep, v, vert_vis,
                query_vis, q_sdf_act, bounds, nn_idx, self.voxel_grid)
            fused = [f.to(cdt).reshape(B, V, N, -1) for f in fused]
            out, valid, _x_view, latent_fused = self.mlp_geo(
                y, fused, out_mask.to(cdt), pix_weight.to(cdt))
            rgb = self._query_color(vert_xy, vert_rep, vert_vis, query_vis,
                                    v, view, V, krt_e, feat_tex,
                                    latent_fused, src_img, img_xy,
                                    feat_tex_xy, None, out_mask, n_samples,
                                    sp=(bounds, nn_idx))
        odt = torch.promote_types(out.dtype, torch.float32)
        out = torch.cat([out.to(odt), rgb.to(odt)], -1)
        return out, valid.to(out.dtype)

    @staticmethod
    def _camera_frame(v, kpt3d, extrin):
        """Camera-frame points (B, N, 3) and keypoints (B, 3, K)."""
        R = extrin[:, :3, :3].transpose(-1, -2)
        t = extrin[:, None, :3, 3]
        return ((v @ R + t).float(),
                (kpt3d @ R + t).float().transpose(1, 2).contiguous())

    def _fused_weights(self, full: bool, kpt_T: torch.Tensor):
        """The prepared weights of kernel 12 (``full=False``) or 11 and,
        on the card, their packed buffers.  Where a graph may be built the
        weights are prepared anew (the gradients reach ``weight_v`` /
        ``weight_g`` through them) and packed at the launch.  Without one
        every pass of a frame shares one preparation, kept until a
        parameter is written to or replaced; one for each of ``full`` and
        the compute dtype, in which the weights are prepared."""
        sp_level = self.sp_encoder.sp_level
        cdt = self.cdt
        mods = (self.mlp_geo, self.ibr_compress_gfeat) + (
            (self.geo_vis_fusion, self.tex_vis_fusion) if full else ())

        def prepare():
            if full:
                return prepare_query_weights(self, n_parts=1 + 2 * sp_level,
                                             cdt=cdt)
            return prepare_geo_mlp_weights(self, cdt=cdt)

        if torch.is_grad_enabled():
            return prepare(), None
        K = kpt_T.shape[-1]
        key = (K,) + tuple((p.data_ptr(), p._version)
                           for m in mods for p in m.parameters())
        hit = self._fused_cache.get((full, cdt))
        if hit is None or hit[0] != key:
            wts = prepare()
            pack = pack_query_weights if full else pack_geo_weights
            packed = pack(wts, K, sp_level) if kpt_T.is_cuda else None
            hit = self._fused_cache[(full, cdt)] = (key, wts, packed)
        return hit[1], hit[2]

    def _query_fused_full(self, v, extrin, kpt3d, feat_sampled, img_xy,
                          feat_tex_xy, query_sdf, query_vis, out_mask,
                          pix_weight, g2_raw):
        """``VANERF_FUSED_MLP=2`` tail of :meth:`query`: one kernel pass
        runs the GeoVisFusion gates, the geometry MLP stack, gcompress, the
        TexVisFusion gates and the V=1 rgb head over the raw gather rows
        (``ops/fused_mlp.py::fused_query_mlp``); ``extrin`` and ``kpt3d``
        per batch element."""
        cxyz, kptc_T = self._camera_frame(v, kpt3d, extrin)
        sp = self.sp_encoder
        wts, packed = self._fused_weights(True, kptc_T)
        cdt = self.cdt
        feats = torch.cat([feat_sampled[0], feat_sampled[1], img_xy,
                           feat_tex_xy, query_sdf, query_vis,
                           out_mask[:, 0].to(cdt), pix_weight[:, 0].to(cdt)],
                          -1)                                   # (B, N, 87)
        out5 = torch.stack([
            fused_query_mlp(cxyz[b], kptc_T[b], feats[b], g2_raw[b], wts,
                            sp_level=sp.sp_level, scale=sp.scale,
                            sigma=sp.sigma, packed=packed)
            for b in range(v.shape[0])])
        valid = out_mask.sum(1) > 0                             # (B, N, 1)
        return out5, valid.to(out5.dtype)

    def _query_color(self, vert_xy, vert, vert_vis, query_vis, v, view,
                     n_views, krt, feat_tex, latent_fused, img, img_xy,
                     feat_xy, tex_knn, out_mask, n_samples,
                     latent_compressed: bool = False, sp=None):
        """IBR colour query (model.py:884-957; JAX
        ``vanerf_tpu/models/vanerf.py:584-633``): the per-view texture
        fusion of the latent (repeated per view), then the IBR head's
        blend over the views.  At one view the blend is a softmax over a
        single view (== 1), so the head reduces exactly to the fused
        feature's rgb, which is returned unless ``VANERF_IBR_V1_SHORTCUT``
        is ``0`` (the JAX package's switch).  v (B V, N, 3) the points
        repeated per view, view (B, N, 3), krt (B V, 4, 4), out_mask
        (B, V, N, 1); ``latent_compressed``: kernel 12 has already applied
        gcompress; ``sp``: (bounds, nn_idx) of the ``sp_conv`` texture
        fusion."""
        BV, N, _ = v.shape
        B = BV // n_views
        gc = self.ibr_compress_gfeat
        latent = (latent_fused if latent_compressed
                  else dense(latent_fused, gc.weight, gc.bias))
        if n_views != 1:
            latent = latent.repeat_interleave(n_views, 0)
        if sp is not None:
            rgb_feat = self.tex_vis_fusion(
                vert_xy, feat_tex, feat_xy, vert, v, vert_vis, query_vis,
                img_xy, img, latent, *sp, self.voxel_grid).to(latent.dtype)
        else:
            rgb_feat = self.tex_vis_fusion(
                vert_xy, feat_tex, feat_xy, vert, v, vert_vis, query_vis,
                img_xy, img, latent, knn=tex_knn)             # (B V, N, 40)
        if (n_views == 1
                and os.environ.get("VANERF_IBR_V1_SHORTCUT", "1") != "0"):
            return rgb_feat[..., :3]

        # inv_ex: no check of the result on the host, which would wait for
        # the card
        cam_pos = torch.linalg.inv_ex(krt)[0][:, :3, 3]         # (B V, 3)
        cam_rays = v - cam_pos[:, None]
        cam_rays = cam_rays / (torch.linalg.vector_norm(
            cam_rays, dim=-1, keepdim=True) + 1e-12)
        view_rep = (view.repeat_interleave(n_views, 0) if n_views != 1
                    else view)
        ray_diff = view_rep - cam_rays
        rd_norm = torch.linalg.vector_norm(ray_diff, dim=-1, keepdim=True)
        rd_dot = (cam_rays * view_rep).sum(-1, keepdim=True)
        ray_diff = torch.cat([ray_diff / rd_norm.clamp(min=1e-6), rd_dot],
                             -1)                                # (B V, N, 4)
        pHW = N // n_samples

        def to_ibr(x):
            """(B V, N, C) -> (B pHW, S, V, C): rays, samples, views."""
            C = x.shape[-1]
            return (x.reshape(B, n_views, pHW, n_samples, C)
                    .permute(0, 2, 3, 1, 4).reshape(B * pHW, n_samples,
                                                    n_views, C))

        dt = rgb_feat.dtype
        out = self.mlp_tex(to_ibr(rgb_feat), to_ibr(ray_diff.to(dt)),
                           to_ibr(out_mask.reshape(BV, N, 1).to(dt)))
        return out.reshape(B, N, 3)

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
