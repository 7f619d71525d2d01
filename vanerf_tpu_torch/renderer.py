"""Ray-marching renderer (port of ``vanerf_tpu/renderer.py``; reference
``batch_render_pifu_nerf`` ``src/model.py:1102-1422`` and the
stride-tiled ``render_pifu_nerf`` ``model.py:1026-1100``).

Per patch: rays through the target camera, AABB clip, stratified samples,
then per pass the nearest MANO vertex of every sample (kernel B), the
point->mesh query (kernel A) with the far-field tier, and the network
query (kernel D for the small encoder map at inference); compositing,
importance sampling of the fine pass, and a depth sort that merges both
passes.  The per-frame vertex visibility and the target-view GT
visibility map come from the z-buffer rasterizer (kernel C).  Under
training the samples are jittered, the radiance takes noise, the render
builds an autograd graph, and the table gradients of the small-table
gathers (at most 8,192 rows) go through kernel 13.  The
JAX package's approximate serving tiers FAR_SKIP / FAR_NET / FAR_TNET and
the SoA point layout are not ported and raise when asked for.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .ops.composite import rgba2out
from .ops.knn import nearest_vertex_d2
from .ops.mesh_query import cal_vis_sdf_prepared, prepare_culled_mesh
from .ops.rasterize import render_vis_map, vertex_visibility
from .ops.ray import pixel_grid_rays, ray_bbox_intersection
from .ops.sampling import importance_sample, stratified_sample
from .ops.sorting import sort_by_key

# the reference eval_func's normal scale: invalid samples read 0.1/100
_NML_SCALE = 100.0


def resolve_tier(env_name: str, config_val: float, training: bool) -> float:
    """Serving-tier knob: env var > config value > 0 at training."""
    raw = os.environ.get(env_name, "")
    if raw != "":
        try:
            return float(raw)
        except ValueError:
            raise ValueError(f"{env_name}={raw!r} is not a number") from None
    return 0.0 if training else float(config_val or 0.0)


def mask_centered_grid(generator: Optional[torch.Generator],
                       mask: torch.Tensor, out_h: int, out_w: int):
    """Random mask-centred out_h x out_w pixel grid (``model.py:1172-1189``):
    a foreground pixel drawn with probability proportional to the mask is
    the centre; the grid is clamped to the image.

    mask: (B, H, W).  The draw runs on the generator's device.
    Returns (B, out_h*out_w, 2) float pixel coords (x, y) on mask.device.
    """
    B, H, W = mask.shape
    gdev = generator.device if generator is not None else torch.device("cpu")
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32),
                            torch.arange(out_w, dtype=torch.float32),
                            indexing="ij")
    g = torch.stack([xs, ys], -1).reshape(-1, 2)
    hi = torch.tensor([W - 1.0, H - 1.0])
    grids = []
    for b in range(B):
        p = mask[b].reshape(-1).float().to(gdev)
        p = p / p.sum() if float(p.sum()) > 0 else torch.ones_like(p)
        flat = int(torch.multinomial(p, 1, generator=generator))
        c = torch.tensor([flat % W - out_w // 2, flat // W - out_h // 2],
                         dtype=torch.float32)
        grids.append(torch.minimum(torch.clamp(g + c, min=0.0), hi))
    return torch.stack(grids).to(mask.device)


def strided_grid(B: int, H: int, W: int, level: int, stride,
                 device=None) -> torch.Tensor:
    """Strided full-image subsampling grid (``model.py:1191-1198``): every
    2^(level-1)-th pixel plus a (B, 2) [x, y] offset."""
    s = 2 ** (level - 1)
    ys, xs = torch.meshgrid(
        torch.arange(0, H, s, dtype=torch.float32, device=device),
        torch.arange(0, W, s, dtype=torch.float32, device=device),
        indexing="ij")
    g = torch.stack([xs, ys], -1).reshape(1, -1, 2).expand(B, -1, -1)
    stride = torch.as_tensor(stride, dtype=torch.float32,
                             device=device).reshape(B, 1, 2)
    return g + stride


def gather_pixels(img: torch.Tensor, index: torch.Tensor, out_h: int,
                  out_w: int) -> torch.Tensor:
    """(B, H, W, C) pixels at flat (B, P) indices -> (B, out_h, out_w, C)."""
    B, H, W, C = img.shape
    flat = img.reshape(B, H * W, C)
    out = torch.gather(flat, 1, index.long()[..., None].expand(-1, -1, C))
    return out.reshape(B, out_h, out_w, C)


def _project01(verts, krt, H, W, znear, zfar):
    """Vertices in [0, 1] source-view pixel coords + normalised depth
    (``renderer.py:298-305``)."""
    vh = verts @ krt[:, :3, :3].transpose(-1, -2) + krt[:, None, :3, 3]
    v_z = vh[..., 2:3]
    v_xy = vh[..., :2] / (v_z + 1e-8)
    v_xy01 = torch.stack([v_xy[..., 0] / (W - 1.0),
                          v_xy[..., 1] / (H - 1.0)], -1)
    return v_xy01, (v_z - znear) / (zfar - znear)


def encode_frame(model, batch: Dict[str, Any], vis_size: int = 256):
    """Per-frame work shared by every tile: the encoders and the source-
    view vertex visibility (kernel C).  Returns (feat_geo, feat_tex,
    vert_vis)."""
    H, W = batch["src_img"].shape[1:3]
    feat_geo, feat_tex = model.encode(batch["src_img"])
    v_xy01, v_z01 = _project01(batch["verts"], batch["src_krt"], H, W,
                               batch["znear"], batch["zfar"])
    vert_vis = torch.stack([
        vertex_visibility(v_xy01[b], v_z01[b], batch["faces"], size=vis_size)
        for b in range(v_xy01.shape[0])])
    return feat_geo, feat_tex, vert_vis


def patch_rays(batch: Dict[str, Any], grids: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None):
    """Target-camera rays of a pixel grid, clipped to the mesh bounds, and
    stratified sample depths (``renderer.py:283-294``), jittered by the
    uniforms ``u`` (B, P, n_samples) when given.  Returns cam_pos
    (B, 1, 3), unit cam_rays (B, P, 3) and depths z (B, P, n_samples)."""
    znear, zfar = batch["znear"], batch["zfar"]
    cam_pos, cam_rays, znear_rays, zfar_rays = pixel_grid_rays(
        grids, batch["tar_k"], batch["tar_rt"], znear, zfar)
    z1, z2, hit = ray_bbox_intersection(batch["bounds"], cam_pos, cam_rays)
    m1 = (hit & (z1 > znear_rays)).to(grids.dtype)
    znear_rays = m1 * z1 + (1.0 - m1) * znear_rays
    m2 = (hit & (z2 < zfar_rays)).to(grids.dtype)
    zfar_rays = m2 * z2 + (1.0 - m2) * zfar_rays
    return cam_pos, cam_rays, stratified_sample(znear_rays, zfar_rays,
                                                n_samples, u)


def as_float_tensor(x) -> torch.Tensor:
    """A float32 tensor from a tensor or an array (copied, so read-only
    numpy buffers are fine)."""
    if torch.is_tensor(x):
        return x.float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _draw(draws, key: str, shape, normal: bool, generator, device):
    """A training draw: ``draws[key]`` when given (tests feed the JAX
    draws), else uniforms / normals from ``generator`` on its device."""
    if draws is not None and key in draws:
        x = as_float_tensor(draws[key])
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"draws[{key!r}]: shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        return x.to(device)
    gdev = generator.device if generator is not None else torch.device("cpu")
    fn = torch.randn if normal else torch.rand
    return fn(tuple(shape), generator=generator, device=gdev).to(device)


def _check_unported(model, training: bool, n_views: int):
    if n_views != 1:
        raise NotImplementedError("the port renders one source view")
    if os.environ.get("VANERF_SOA_POINTS", "0") not in ("", "0"):
        raise NotImplementedError("VANERF_SOA_POINTS is not ported")
    for env, attr in (("VANERF_FAR_SKIP", "far_skip"),
                      ("VANERF_FAR_NET", "far_net"),
                      ("VANERF_FAR_TNET", "far_tnet")):
        if resolve_tier(env, getattr(model, attr, 0.0), training) > 0.0:
            raise NotImplementedError(f"{env} / inference.{attr} serving "
                                      "tier is not ported")


def render_patch(model, batch: Dict[str, Any], *, grids: torch.Tensor,
                 out_h: int, out_w: int, sample_per_ray_c: int = 64,
                 sample_per_ray_f: int = 64, training: bool = False,
                 n_views: int = 1, compute_vis_map: bool = False,
                 cached=None, uniform: bool = False,
                 rand_noise_std: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None):
    """Render one (out_h x out_w) ray patch.

    At eval (``training=False``) the render is deterministic and runs under
    ``torch.no_grad()``.  With ``training=True`` it builds an autograd
    graph and draws, unless ``uniform``: stratified jitter ``u_c``
    (B, P, S_c) and importance uniforms ``u_f`` (B, P, S_f); with
    ``rand_noise_std`` > 0 also radiance noise ``noise_c`` (B, P*S_c, 1)
    and ``noise_f`` (B, P*S_f, 1).  Each comes from ``draws[name]`` when
    given, else from ``generator``.

    Args:
      model: :class:`vanerf_tpu_torch.models.VANeRF`.
      batch: channels-last tensors on one device: 'src_img' (B,H,W,3),
        'src_mask' (B,H,W,1), 'src_krt'/'src_extrin' (B,4,4),
        'tar_k'/'tar_rt' (B,4,4), 'verts' (B,V2,3), 'faces' (F,3),
        'kpt3d' (B,K,3), 'bounds' (B,2,3), 'znear'/'zfar' scalars;
        optional 'tar_img', 'tar_mask', 'input_densepose', 'tar_densepose'.
      grids: (B, P, 2) pixel grid.
      cached: optional (feat_geo, feat_tex, vert_vis) of
        :func:`encode_frame`.
      compute_vis_map: also rasterize the GT visibility map in the target
        view ('vis_img_all' (B, 1, H, W), 'vis_img' at the grid).
    Returns:
      dict of channels-last outputs mirroring the JAX package's.
    """
    _check_unported(model, training, n_views)
    with contextlib.nullcontext() if training else torch.no_grad():
        src_img = batch["src_img"]
        B = batch["tar_k"].shape[0]
        H, W = src_img.shape[1:3]
        znear, zfar = batch["znear"], batch["zfar"]
        faces, verts = batch["faces"], batch["verts"]
        P = grids.shape[1]

        feat_geo, feat_tex, vert_vis = (encode_frame(model, batch)
                                        if cached is None else cached)
        cam_in = {"KRT": batch["src_krt"], "extrin": batch["src_extrin"],
                  "width": W, "height": H, "znear": znear, "zfar": zfar}
        dev = grids.device
        jitter = training and not uniform
        noise = training and rand_noise_std > 0.0
        u_c = (_draw(draws, "u_c", (B, P, sample_per_ray_c), False, generator,
                     dev) if jitter else None)
        cam_pos, cam_rays, z = patch_rays(batch, grids, sample_per_ray_c, u_c)
        beta = model.sigmoid_beta
        mesh_prep = [prepare_culled_mesh(verts[b], faces, vert_vis[b])
                     for b in range(B)]

        far_tau = resolve_tier("VANERF_FAR_TAU",
                               getattr(model, "far_tau", 0.02),
                               training)
        far2 = (far_tau ** 2) if far_tau > 0 else None

        def query_at(z_depths, n_samples, noise_key):
            pts = (cam_pos[:, :, None] + cam_rays[:, :, None]
                   * z_depths[..., None]).reshape(B, -1, 3)       # (B, P*S, 3)
            nn_idx, sdf, q_vis, far = [], [], [], []
            for b in range(B):
                pb = pts[b].contiguous()
                i_b, d2_b = nearest_vertex_d2(pb, verts[b].contiguous())
                s_b, q_b, f_b = cal_vis_sdf_prepared(
                    mesh_prep[b], pb, d2_b, n_samples=n_samples, far2=far2)
                nn_idx.append(i_b)
                sdf.append(s_b)
                q_vis.append(q_b)
                far.append(f_b)
            nn_idx = torch.stack(nn_idx)
            q_sdf = torch.stack(sdf)[..., None]                   # (B, N, 1)
            q_vis = torch.stack(q_vis)
            far_mask = (torch.stack(far)[..., None]
                        if far[0] is not None else None)
            view = cam_rays[:, :, None, :].expand(B, P, n_samples, 3) \
                .reshape(B, -1, 3)
            out, valid = model.query(
                pts, view, cam_in, feat_geo, feat_tex, src_img,
                batch["src_mask"], verts, vert_vis, q_vis, q_sdf,
                batch["kpt3d"], n_samples, training=training, nn_idx=nn_idx,
                far_mask=far_mask)
            sdf_ch = valid * out[..., 0:1] + (1.0 - valid) * (0.1 / _NML_SCALE)
            rad = out[..., 1:2]
            if noise:
                rad = rad + _draw(draws, noise_key, rad.shape, True, generator,
                                  dev) * rand_noise_std
            alpha = valid * F.relu(rad)
            return alpha[..., 0], sdf_ch[..., 0], out[..., 2:], q_sdf[..., 0]

        # ---- coarse pass ----
        alpha_c, sdf_c, rgb_c, qsdf_c = query_at(z, sample_per_ray_c,
                                                 "noise_c")
        shp = (B, P, sample_per_ray_c)
        color, depth, acc, contrib, _sdf_out = rgba2out(
            alpha_c.reshape(shp), sdf_c.reshape(shp),
            rgb_c.reshape(shp + (3,)),
            z, qsdf_c.reshape(shp), beta)
        out = {"tex_fg": color.reshape(B, out_h, out_w, 3),
               "depth": depth.reshape(B, out_h, out_w),
               "alpha": acc.reshape(B, out_h, out_w)}

        # ---- fine pass: evaluate only the new importance samples, then merge
        # both passes by a stable depth sort ----
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        u_f = (_draw(draws, "u_f", (B, P, sample_per_ray_f), False, generator,
                     dev) if jitter else None)
        z_new = importance_sample(contrib[..., 1:-1].detach(), z_mid,
                                  sample_per_ray_f, u_f)
        if jitter:
            # random-u samples come back unordered; sort them per ray, as the
            # JAX package does for its kernel's depth-coherent tiles
            (z_new,) = sort_by_key(z_new)
        alpha_n, sdf_n, rgb_n, qsdf_n = query_at(z_new, sample_per_ray_f,
                                                 "noise_f")

        def cat_cf(cv, nv):
            return torch.cat([cv.reshape(B, P, sample_per_ray_c),
                              nv.reshape(B, P, sample_per_ray_f)], 2)

        rgb_cat = torch.cat([rgb_c.reshape(B, P, sample_per_ray_c, 3),
                             rgb_n.reshape(B, P, sample_per_ray_f, 3)], 2)
        (z_fine, alpha_f, sdf_f, qsdf_f, r_f, g_f, b_f) = sort_by_key(
            torch.cat([z, z_new], -1), cat_cf(alpha_c, alpha_n),
            cat_cf(sdf_c, sdf_n), cat_cf(qsdf_c, qsdf_n), rgb_cat[..., 0],
            rgb_cat[..., 1], rgb_cat[..., 2])
        rgb_f = torch.stack([r_f, g_f, b_f], -1)
        color_f, depth_f, acc_f, _, sdf_out_f = rgba2out(
            alpha_f, sdf_f, rgb_f, z_fine, qsdf_f, beta)
        out.update({"tex_fg_fine": color_f.reshape(B, out_h, out_w, 3),
                    "depth_fine": depth_f.reshape(B, out_h, out_w),
                    "alpha_fine": acc_f.reshape(B, out_h, out_w),
                    "sdf": sdf_out_f.reshape(B, out_h, out_w)})

        # ---- GT / context patches at the grid (model.py:1361-1418) ----
        index = (grids[..., 0] + grids[..., 1] * W).to(torch.int32)
        if batch.get("tar_img") is not None:
            out["tar_img"] = gather_pixels(batch["tar_img"], index, out_h,
                                           out_w)
        if batch.get("tar_mask") is not None:
            out["tar_alpha"] = gather_pixels(batch["tar_mask"], index, out_h,
                                             out_w)
        if compute_vis_map:
            vis_map = torch.stack([
                render_vis_map(verts[b], faces, vert_vis[b], batch["tar_k"][b],
                               batch["tar_rt"][b], H, W)[1] for b in range(B)])
            out["vis_img_all"] = vis_map                  # (B, 1, H, W)
            out["vis_img"] = gather_pixels(vis_map.permute(0, 2, 3, 1), index,
                                           out_h, out_w)
        out["input_mask"] = gather_pixels(batch["src_mask"], index, out_h,
                                          out_w)
        out["img_in"] = gather_pixels(src_img, index, out_h, out_w)
        for k in ("input_densepose", "tar_densepose"):
            if batch.get(k) is not None:
                out[k] = gather_pixels(batch[k], index, out_h, out_w)
        out["vert_vis"] = vert_vis
        out["index"] = index
        return out


@torch.no_grad()
def render_full_image(model, batch: Dict[str, Any], *, level: int,
                      sample_per_ray_c: int = 64, sample_per_ray_f: int = 64,
                      n_views: int = 1):
    """Render the full target image by stride^2 interleaved patch passes
    (``render_pifu_nerf``, ``model.py:1026-1100``) on one device: the
    encoders and vertex visibility run once per frame, then one
    :func:`render_patch` per stride offset; tiles are reassembled by an
    inverse pixel shuffle.  Deterministic."""
    B = batch["tar_k"].shape[0]
    H, W = batch["src_img"].shape[1:3]
    s = 2 ** (level - 1)
    out_h, out_w = H // s, W // s
    cached = encode_frame(model, batch)
    dev = batch["src_img"].device
    tiles = []
    for i in range(s):
        for j in range(s):
            grids = strided_grid(B, H, W, level, [[j, i]] * B, device=dev)
            tiles.append(render_patch(
                model, batch, grids=grids, out_h=out_h, out_w=out_w,
                sample_per_ray_c=sample_per_ray_c,
                sample_per_ray_f=sample_per_ray_f, n_views=n_views,
                cached=cached))
    merged = {}
    for k, v in tiles[0].items():
        if k in ("vert_vis", "index"):
            merged[k] = v
        elif v.ndim == 4:
            merged[k] = _unshuffle([t[k] for t in tiles], s)
        elif v.ndim == 3:
            merged[k] = _unshuffle([t[k][..., None] for t in tiles],
                                   s)[..., 0]
        else:
            merged[k] = v
    return merged


def _unshuffle(tiles, s: int) -> torch.Tensor:
    """Inverse pixel shuffle: s*s tiles of (B, h, w, C) -> (B, h*s, w*s, C);
    tile (i, j) holds pixels (y*s + i, x*s + j)."""
    B, h, w, C = tiles[0].shape
    grid = torch.stack(tiles, 0).reshape(s, s, B, h, w, C)
    return grid.permute(2, 3, 0, 4, 1, 5).reshape(B, h * s, w * s, C)
