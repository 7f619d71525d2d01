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
gathers (at most 8,192 rows) go through kernel 13.
``VANERF_FUSED_MLP=1/2`` runs the per-point network as kernel 12 / 11 at
eval (``models/vanerf.py``), and ``VANERF_FUSED_TRAIN=<level>`` runs the
training render's query forward through the same kernels, with the
gradients of the level-0 query (``ops/fused_mlp.py::fused_train_query``,
as ``vanerf_tpu/renderer.py:514-526``); both switch the far tier off,
which those kernels do not take.
``VANERF_SOA_POINTS=1/2`` generates the points coordinate-major, (3, N):
the nearest-vertex search is then kernel 8 and the mesh query kernel 7,
neither ever seeing an (N, 3) copy, and ``VANERF_BLOCK_2D`` may tile the far
tier by pixel blocks; the network's (N, 3) points are the transpose (mode
1) or are generated a second time from the rays (mode 2), with results
equal to mode 0's.  ``VANERF_KNN_CULL`` swaps the nearest-vertex search for
kernel 9 (``ops/knn.py``), with equal results.

The approximate serving tiers run the per-point network on a budget of the
samples nearest the surface by the certified nearest-vertex distance, at
eval only (off in training, under the SoA layout and the fused switches):
``VANERF_FAR_SKIP=<frac>`` keeps round(frac S) samples of every ray,
``VANERF_FAR_NET=<frac>`` the round(frac N) nearest of the whole patch
(both leave the dropped samples on the mesh-prior density, with no
colour), ``VANERF_FAR_TNET=<frac>`` the same global budget with the dropped
samples inheriting the nearest evaluated sample's outputs along their ray
(``VANERF_TNET_IMPL=select|scan``, ``VANERF_TNET_STEPS``); TNET takes
precedence over NET, NET over SKIP.

``render_full_image(tile_group=G)`` folds G stride offsets into the batch
of one :func:`render_patch` call, as the JAX package does: the patch then
renders G x Bf elements of Bf frames, element e of frame e % Bf.  The
frame's encode, vertex visibility and prepared meshes are made once and read
in place (nothing per frame is copied G times but its cameras and
keypoints), and kernels B / 8, A / 7, D and 10 each take the whole batch in
one launch a pass.

``n_views`` V source views (``dataset.num_input_view``) come as Bf V
images, cameras and masks, the views of a frame in a row: the encoders run
on all of them, the vertex visibility and the GT visibility map are the
first view's (``renderer.py:298``, ``:735-737`` of the JAX package), and
the query repeats each element's points per view; a training render draws
a view-dropout mask a pass (``drop_keep_c`` / ``drop_perm_c``,
``drop_keep_f`` / ``drop_perm_f``).  As in JAX the fused levels, the
fused training switch and the FAR_NET / FAR_TNET tiers take one view and
are off at more; FAR_TAU and FAR_SKIP are per sample and stay on.

``VANERF_REMAT_QUERY=1/2`` (a training render, as ``vanerf_tpu/renderer.py:
332-339``, ``:629-633``) recomputes the per-point network in the backward
instead of keeping its activations: 1 keeps nothing of it
(``torch.utils.checkpoint``), 2 keeps the outputs of its matrix products
(a selective checkpoint policy, JAX's ``dots_with_no_batch_dims_saveable``).
Every draw of the render is made outside the recomputed call, so the
recompute draws nothing again, and losses and gradients equal the render's
without the switch.  The ``kc`` / far-skip tiers are off under it, as in
JAX (they are eval-only here anyway), and so is ``VANERF_FUSED_TRAIN``'s
boundary, which recomputes the query itself.  A ``batch["model_T"]``
(Bf, 4, 4) reaches every query (the ``mxyz`` / ``rel_mxyz`` encodings).

Under ``sp_conv`` (the dense voxel branch, ``models/voxel_fusion.py``)
the query takes the frames' ``bounds``, the far tier and the serving tiers
are off, and the composite takes the network's output as the density
(no mesh prior), as in JAX (``vanerf_tpu/renderer.py:374-443``, ``:650``).

A model with ``compute_dtype="bfloat16"`` (``models/vanerf.py``) serves
and trains here unchanged: the query takes the float32 points, visibility,
SDF and far flags, casts them itself and returns float32, so the tiers'
compaction and scatter back, the compositing, the fine pass's sampling and
the losses all run on float32 buffers, and the far tier decides on the
float32 nearest-vertex distances of the mesh priors.  Under training the
gradients flow back through the query's casts to the float32 encoders and
parameters.

While a ``torch.profiler`` records, the render opens the program's spans
(``profiling.span``): ``vanerf.frame`` (``render_full_image``) holds
``vanerf.encode``, ``vanerf.prepare``, ``vanerf.patch`` and
``vanerf.assemble``; a patch holds ``vanerf.pass.coarse`` /
``vanerf.pass.fine``, each with ``vanerf.mesh_prior`` (kernels B / 8 and
A / 7), ``vanerf.query`` (``models/vanerf.py``) and ``vanerf.composite``.
Each pass counts its ``samples``, the rows handed to the network
(``net_points``) and its far samples (``far_samples``); kernel A / 7 counts
its visited chunk pairs (``ops/mesh_query.py``).  With no profiler each
is one flag read.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .ops.composite import rgba2out
from .ops.fused_mlp import fused_train_query
from .ops.knn import nearest_vertex_d2, nearest_vertex_d2_T
from .models.vanerf import per_element, view_dropout_mask
from .ops._cuda import batch_index
from .ops.mesh_query import (cal_vis_sdf_prepared, cal_vis_sdf_prepared_T,
                             prepare_culled_mesh, stack_culled_meshes)
from .ops.rasterize import render_vis_map, vertex_visibility
from .ops.ray import pixel_grid_rays, ray_bbox_intersection
from .ops.sampling import importance_sample, stratified_sample
from .ops.sorting import sort_by_key
from .profiling import count, count_device, span, spanned


def resolve_tier(env_name: str, config_val: float, training: bool) -> float:
    """Serving-tier knob: env var > config value > 0 at training."""
    raw = os.environ.get(env_name, "")
    if raw != "":
        try:
            return float(raw)
        except ValueError:
            raise ValueError(f"{env_name}={raw!r} is not a number") from None
    return 0.0 if training else float(config_val or 0.0)


def inherit_nearest_evaluated(full: torch.Tensor, ev: torch.Tensor,
                              z: torch.Tensor, n_samples: int
                              ) -> torch.Tensor:
    """FAR_TNET inheritance: samples the network did not evaluate copy the
    row of the nearest (by ray depth) evaluated sample of their own ray;
    the earlier sample wins a depth tie.

    Args:
      full: (B, N, C) scattered network outputs (+ valid flag), zero rows
        where not evaluated; N = rays * n_samples, sample-contiguous.
      ev:   (B, N) bool, True where the network ran.
      z:    (B, N) ray depths.
    Returns:
      (B, N, C); rays with no evaluated sample keep their zero rows (the
      caller's mesh-prior fallback).
    """
    B, Ntot, C = full.shape
    S = n_samples
    Pn = Ntot // S
    evr = ev.reshape(B, Pn, S)
    fullr = full.reshape(B, Pn, S, C)
    zr = z.reshape(B, Pn, S)
    ar = torch.arange(S, device=full.device)
    none = torch.full_like(ar, -1)
    # last evaluated index at or before i / first at or after i
    fwdi = torch.cummax(torch.where(evr, ar, none), -1).values
    rev = torch.where(evr, S - 1 - ar, none).flip(-1)
    bwdr = torch.cummax(rev, -1).values.flip(-1)
    bwdi = torch.where(bwdr >= 0, S - 1 - bwdr, none)
    zf = torch.gather(zr, -1, fwdi.clamp(min=0))
    zb = torch.gather(zr, -1, bwdi.clamp(min=0))
    inf = torch.full_like(zr, float("inf"))
    df = torch.where(fwdi >= 0, (zr - zf).abs(), inf)
    db = torch.where(bwdi >= 0, (zr - zb).abs(), inf)
    nb = torch.where(df <= db, fwdi, bwdi)                  # -1: none
    inh = torch.gather(fullr, 2,
                       nb.clamp(min=0)[..., None].expand(-1, -1, -1, C))
    keep = (evr | (nb < 0))[..., None]
    return torch.where(keep, fullr, inh).reshape(B, Ntot, C)


def inherit_nearest_evaluated_select(full: torch.Tensor, ev: torch.Tensor,
                                     z: torch.Tensor, n_samples: int,
                                     steps: int = 4) -> torch.Tensor:
    """:func:`inherit_nearest_evaluated` by ``steps`` rounds of doubling
    shifted selects, a 1-D flood fill that carries each source's depth so
    that every cell keeps the nearest source it was reached by.  After
    round k the fill radius is 2^k - 1: ``steps=4`` inherits exactly for a
    skipped sample whose nearest evaluated neighbour lies within 15 slots
    and leaves farther ones on the zero rows; ``2^steps - 1 >= S - 1``
    reproduces the scan's result."""
    B, Ntot, C = full.shape
    S = n_samples
    Pn = Ntot // S
    fullr = full.reshape(B, Pn, S, C)
    evr = ev.reshape(B, Pn, S)
    zr = z.reshape(B, Pn, S)
    inf = torch.full_like(zr, float("inf"))

    val = torch.where(evr[..., None], fullr, torch.zeros_like(fullr))
    src_z = torch.where(evr, zr, torch.zeros_like(zr))
    best = torch.where(evr, torch.zeros_like(zr), inf)  # |z - source's z|

    def shift(x, d, fill):
        """Shift along the sample axis by d (d > 0: the value of slot
        i - d)."""
        pad = x.new_full(x.shape[:2] + (abs(d),) + x.shape[3:], fill)
        if d > 0:
            return torch.cat([pad, x[:, :, :-d]], 2)
        return torch.cat([x[:, :, -d:], pad], 2)

    d = 1
    for _ in range(max(1, steps)):
        if d >= S:
            break
        for sd in (d, -d):
            c_z = shift(src_z, sd, 0.0)
            c_best = shift(best, sd, float("inf"))
            c_val = shift(val, sd, 0.0)
            cand = torch.where(torch.isfinite(c_best), (zr - c_z).abs(), inf)
            better = cand < best
            best = torch.where(better, cand, best)
            src_z = torch.where(better, c_z, src_z)
            val = torch.where(better[..., None], c_val, val)
        d *= 2
    # evaluated rows keep their own outputs; unreached rows are zero
    return torch.where(evr[..., None], fullr, val).reshape(B, Ntot, C)


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
    """(Bf, H, W, C) pixels at flat (B, P) indices -> (B, out_h, out_w, C),
    element e reading frame e % Bf."""
    Bf, H, W, C = img.shape
    B = index.shape[0]
    rows = (index.long()
            + (batch_index(B, Bf, index.device) * (H * W))[:, None])
    return img.reshape(Bf * H * W, C)[rows].reshape(B, out_h, out_w, C)


def _project01(verts, krt, H, W, znear, zfar):
    """Vertices in [0, 1] source-view pixel coords + normalised depth
    (``renderer.py:298-305``)."""
    vh = verts @ krt[:, :3, :3].transpose(-1, -2) + krt[:, None, :3, 3]
    v_z = vh[..., 2:3]
    v_xy = vh[..., :2] / (v_z + 1e-8)
    v_xy01 = torch.stack([v_xy[..., 0] / (W - 1.0),
                          v_xy[..., 1] / (H - 1.0)], -1)
    return v_xy01, (v_z - znear) / (zfar - znear)


@spanned("vanerf.encode")
def encode_frame(model, batch: Dict[str, Any], vis_size: int = 256,
                 n_views: int = 1):
    """Per-frame work shared by every tile: the encoders on all Bf V source
    images and the vertex visibility (kernel C) in each frame's first
    source view (``renderer.py:298`` of the JAX package).  Returns
    (feat_geo, feat_tex, vert_vis), the maps Bf V, vert_vis Bf."""
    H, W = batch["src_img"].shape[1:3]
    feat_geo, feat_tex = model.encode(batch["src_img"])
    Bf = batch["verts"].shape[0]
    krt0 = batch["src_krt"].reshape(Bf, n_views, 4, 4)[:, 0]
    v_xy01, v_z01 = _project01(batch["verts"], krt0, H, W,
                               batch["znear"], batch["zfar"])
    vert_vis = torch.stack([
        vertex_visibility(v_xy01[b], v_z01[b], batch["faces"], size=vis_size)
        for b in range(v_xy01.shape[0])])
    return feat_geo, feat_tex, vert_vis


@spanned("vanerf.prepare")
def prepare_frame_meshes(batch: Dict[str, Any], vert_vis: torch.Tensor):
    """Per-frame work of the culled mesh query: one prepared mesh for each
    frame (:func:`prepare_culled_mesh`: the Morton sort of the faces, the
    face table and the chunk boxes), stacked (:func:`stack_culled_meshes`)
    so that kernel A reads the mesh of element e at e % Bf.
    ``render_full_image`` makes it once beside the encode and hands it to
    every tile group."""
    return stack_culled_meshes([
        prepare_culled_mesh(batch["verts"][b], batch["faces"], vert_vis[b])
        for b in range(batch["verts"].shape[0])])


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


def soa_points_mode() -> int:
    """``VANERF_SOA_POINTS``: 0 = (N, 3) points everywhere; 1 = (3, N)
    points into the nearest-vertex and mesh-query kernels, the network's
    (N, 3) points transposed from them; 2 = the network's points generated
    a second time from (o, d, z) instead.  An unparsable value means 1."""
    try:
        return int(os.environ.get("VANERF_SOA_POINTS", "0") or 0)
    except ValueError:
        return 1


def remat_query_mode(training: bool) -> int:
    """``VANERF_REMAT_QUERY`` of a training render (0 outside one, as
    ``vanerf_tpu/renderer.py:338-339`` reads it): 0 off, 1 recompute the
    per-point network, 2 keep its matrix products' outputs (any other
    non-zero integer acts as 1, as JAX's policy does).  A value that is not
    an integer raises ``ValueError``."""
    if not training:
        return 0
    val = os.environ.get("VANERF_REMAT_QUERY", "0") or "0"
    try:
        return int(val)
    except ValueError:
        raise ValueError(f"VANERF_REMAT_QUERY={val!r}: 0, 1 or 2") from None


def _remat_context(mode: int):
    """The checkpoint's ``context_fn``: under ``VANERF_REMAT_QUERY=2`` the
    outputs of ``mm`` / ``addmm`` / ``bmm`` are saved and the rest is
    recomputed; under 1 nothing is saved (torch's default)."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    aten = torch.ops.aten
    saved = (aten.mm.default, aten.addmm.default, aten.bmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    if mode == 2:
        return lambda: create_selective_checkpoint_contexts(policy)
    return lambda: (contextlib.nullcontext(), contextlib.nullcontext())


def _network_budget(n_total: int, n_samples: int, frac_skip: float,
                    frac_net: float, frac_tnet: float):
    """(kc, ks, inherit) of the serving tiers (``renderer.py:530-543``):
    kc rows of the whole patch (FAR_TNET, else FAR_NET; rounded up to 128
    rows, 0 when that is every row), else ks samples a ray (FAR_SKIP)."""
    inherit = 0.0 < frac_tnet < 1.0
    kc_frac = frac_tnet if inherit else frac_net
    kc = 0
    if 0.0 < kc_frac < 1.0:
        kc = min(n_total, max(128, (int(round(n_total * kc_frac)) + 127)
                              // 128 * 128))
        if kc >= n_total:
            kc = 0
    ks = 0
    if 0.0 < frac_skip <= 1.0 and not kc:
        ks = min(n_samples, max(1, int(round(n_samples * frac_skip))))
    return kc, ks, inherit


def render_patch(model, batch: Dict[str, Any], *, grids: torch.Tensor,
                 out_h: int, out_w: int, sample_per_ray_c: int = 64,
                 sample_per_ray_f: int = 64, fine: bool = True,
                 uniform: bool = False, rand_noise_std: float = 0.0,
                 training: bool = False, nml_scale: float = 100.0,
                 vis_size: int = 256, n_views: int = 1,
                 sdf_chunk: int = 2048, compute_vis_map: bool = True,
                 cached=None, generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None):
    """Render one (out_h x out_w) ray patch.  The keywords are the JAX
    package's (``vanerf_tpu/renderer.py:239-246``), with ``generator`` /
    ``draws`` for its ``rng``.

    At eval (``training=False``) the render is deterministic and runs under
    ``torch.no_grad()``.  With ``training=True`` it builds an autograd
    graph and draws, unless ``uniform``: stratified jitter ``u_c``
    (B, P, S_c) and importance uniforms ``u_f`` (B, P, S_f); with
    ``rand_noise_std`` > 0 also radiance noise ``noise_c`` (B, P*S_c, 1)
    and ``noise_f`` (B, P*S_f, 1); with ``n_views`` V > 1 (``uniform`` or
    not) the view-dropout uniforms of each pass, ``drop_keep_c`` /
    ``drop_keep_f`` (B, V - 1, 1, 1) and ``drop_perm_c`` / ``drop_perm_f``
    (B, V, 1, 1) (:func:`~.models.vanerf.view_dropout_mask`).  Each comes
    from ``draws[name]`` when given, else from ``generator``.

    Args:
      model: :class:`vanerf_tpu_torch.models.VANeRF`.
      batch: channels-last tensors of Bf frames on one device: 'src_img'
        (Bf V,H,W,3), 'src_mask' (Bf V,H,W,1), 'src_krt'/'src_extrin'
        (Bf V,4,4) (a frame's V views in a row), 'tar_k'/'tar_rt' (Bf,4,4), 'verts' (Bf,V2,3), 'faces'
        (F,3), 'kpt3d' (Bf,K,3), 'bounds' (Bf,2,3), 'znear'/'zfar' scalars;
        optional 'tar_img', 'tar_mask', 'input_densepose', 'tar_densepose'.
      grids: (B, P, 2) pixel grid, B a multiple of Bf: element e renders
        frame e % Bf (a ``render_full_image`` tile group has B = G Bf).
      cached: optional (feat_geo, feat_tex, vert_vis) of
        :func:`encode_frame`, and as an optional fourth element the
        frame's :func:`prepare_frame_meshes`.
      fine: False skips the fine pass and its outputs ('tex_fg_fine',
        'depth_fine', 'alpha_fine', 'sdf').
      nml_scale: the sdf channel of a sample outside every view is
        0.1 / nml_scale (the reference eval_func's normal scale).
      vis_size: the raster size of the source-view vertex visibility
        (when ``cached`` is None).
      sdf_chunk: accepted and unused: the CUDA mesh query needs no
        chunking.
      compute_vis_map: also rasterize the GT visibility map in the target
        view ('vis_img_all' (B, 1, H, W), 'vis_img' at the grid).
    Returns:
      dict of channels-last outputs mirroring the JAX package's, each with
      a leading B but 'vert_vis' and 'vis_img_all', which are the frames'.
    """
    remat_mode = remat_query_mode(training)
    soa_points = soa_points_mode()
    with (span("vanerf.patch"),
          contextlib.nullcontext() if training else torch.no_grad()):
        src_img = batch["src_img"]
        B = grids.shape[0]                 # batch elements, G x Bf frames
        Bf = batch["tar_k"].shape[0]
        if B % Bf:
            raise ValueError(f"{B} grids for {Bf} frames: each frame takes "
                             "the same number of tiles")
        H, W = src_img.shape[1:3]
        znear, zfar = batch["znear"], batch["zfar"]
        faces, verts = batch["faces"], batch["verts"]
        P = grids.shape[1]

        feat_geo, feat_tex, vert_vis, *frame_meshes = (
            encode_frame(model, batch, vis_size, n_views) if cached is None
            else cached)
        cam_in = {"KRT": batch["src_krt"], "extrin": batch["src_extrin"],
                  "width": W, "height": H, "znear": znear, "zfar": zfar}
        dev = grids.device
        jitter = training and not uniform
        noise = training and rand_noise_std > 0.0
        u_c = (_draw(draws, "u_c", (B, P, sample_per_ray_c), False, generator,
                     dev) if jitter else None)
        cam_pos, cam_rays, z = patch_rays(
            dict(batch, **{k: per_element(batch[k], B)
                           for k in ("tar_k", "tar_rt", "bounds")}),
            grids, sample_per_ray_c, u_c)
        beta = model.sigmoid_beta
        mesh_prep = (frame_meshes[0] if frame_meshes
                     else prepare_frame_meshes(batch, vert_vis))

        far_tau = resolve_tier("VANERF_FAR_TAU",
                               getattr(model, "far_tau", 0.02),
                               training)
        far2 = (far_tau ** 2) if far_tau > 0 else None
        # VANERF_FUSED_TRAIN=<level> (training, one view): the query's
        # forward at the fused level, its backward through the level-0
        # query.  At one view query(training=True) equals
        # query(training=False), which is what lets the fused level in.
        fused_train = (int(os.environ.get("VANERF_FUSED_TRAIN", "0") or 0)
                       if training and n_views == 1 else 0)
        sp_conv = getattr(model, "sp_conv", False)
        if fused_train or sp_conv or os.environ.get("VANERF_FUSED_MLP"):
            # the fused kernels and the sp_conv branch hold the consumers of
            # query_vis and do not take the far substitution (set at all,
            # as in the JAX package: VANERF_FUSED_MLP=0 is the exact
            # baseline of the fused levels; renderer.py:374-379)
            far2 = None
        # the serving tiers: eval only, off under the SoA layout, the fused
        # switches and sp_conv; FAR_NET / FAR_TNET also at more than one
        # view, whose IBR head reads a ray's samples together
        # (renderer.py:396-443)
        tiers_on = (not training and not soa_points and not remat_mode
                    and not sp_conv
                    and not os.environ.get("VANERF_FUSED_MLP"))
        far_skip_frac, far_net_frac, far_tnet_frac = (
            resolve_tier(env, getattr(model, attr, 0.0), training)
            if tiers_on and (per_sample or n_views == 1) else 0.0
            for env, attr, per_sample in (
                ("VANERF_FAR_SKIP", "far_skip", True),
                ("VANERF_FAR_NET", "far_net", False),
                ("VANERF_FAR_TNET", "far_tnet", False)))

        bounds = as_float_tensor(batch["bounds"]).to(dev)
        model_T = batch.get("model_T")
        if model_T is not None:
            model_T = as_float_tensor(model_T).to(dev)

        def query_rows(pts, view, q_vis, q_sdf, nn_idx, far_mask,
                       n_samples, view_mask=None):
            def query(level, pts, view, ft, q_vis, q_sdf, *fg):
                return model.query(
                    pts, view, cam_in, list(fg), ft, src_img,
                    batch["src_mask"], verts, vert_vis, q_vis, q_sdf,
                    batch["kpt3d"], n_samples, n_views,
                    training=training and not fused_train, nn_idx=nn_idx,
                    far_mask=far_mask, fused_override=level,
                    view_mask=view_mask, model_T=model_T, bounds=bounds)

            data = (pts, view, feat_tex, q_vis, q_sdf, *feat_geo)
            if remat_mode and not fused_train:
                # the per-point network recomputed in the backward (JAX
                # wraps _net in jax.checkpoint at the same place)
                from torch.utils.checkpoint import checkpoint
                return checkpoint(lambda *d: query(None, *d), *data,
                                  use_reentrant=False,
                                  context_fn=_remat_context(remat_mode))
            if not fused_train:
                return query(None, *data)
            return fused_train_query(
                lambda fused, *d: query(fused_train if fused else 0, *d),
                data, [p for p in model.parameters() if p.requires_grad])

        def query_budget(sel, pts, view, q_vis, q_sdf, nn_idx, far_mask,
                         n_rows):
            """The network on the rows ``sel`` (B, K) of the (B, N, .)
            inputs, packed into one gather; returns [out | valid] (B, K, .)
            (``renderer.py:550-568``; the nearest-vertex index travels
            through float32, exact below 2^24)."""
            parts = [pts, view, q_vis.float(), q_sdf,
                     nn_idx[..., None].float()]
            if far_mask is not None:
                parts.append(far_mask.float())
            packed = torch.cat(parts, -1)                     # (B, N, 9|10)
            sub = torch.gather(
                packed, 1, sel[..., None].expand(-1, -1, packed.shape[-1]))
            far_k = (sub[..., 9:10] > 0.5) if far_mask is not None else None
            out_k, valid_k = query_rows(
                sub[..., :3].contiguous(), sub[..., 3:6].contiguous(),
                sub[..., 6:7].to(q_vis.dtype), sub[..., 7:8],
                sub[..., 8].to(torch.int32), far_k, n_rows)
            return torch.cat([out_k, valid_k], -1)

        def query_at(z_depths, n_samples, tag):
            if soa_points:
                # each coordinate a packed (B, P*S) row: kernels 8 and 7
                pts_T = (cam_pos.transpose(1, 2)[:, :, :, None]
                         + cam_rays.transpose(1, 2)[:, :, :, None]
                         * z_depths[:, None]).reshape(B, 3, -1)
            if soa_points != 1:
                pts = (cam_pos[:, :, None] + cam_rays[:, :, None]
                       * z_depths[..., None]).reshape(B, -1, 3)   # (B, P*S, 3)
            else:
                # the same values: o + d*z rounds alike in either layout
                pts = pts_T.transpose(1, 2).contiguous()
            # kernels B / 8 and A / 7: one launch each for the whole batch,
            # element e against frame e % Bf's vertices and mesh
            with span("vanerf.mesh_prior"):
                vs = verts.contiguous()
                if soa_points:
                    pts_T = pts_T.contiguous()
                    nn_idx, nn_d2 = nearest_vertex_d2_T(pts_T, vs)
                    sdf, q_vis, far = cal_vis_sdf_prepared_T(
                        mesh_prep, pts_T, nn_d2, n_samples=n_samples,
                        rays_hw=(out_h, out_w), far2=far2)
                else:
                    pts = pts.contiguous()
                    nn_idx, nn_d2 = nearest_vertex_d2(pts, vs)
                    sdf, q_vis, far = cal_vis_sdf_prepared(
                        mesh_prep, pts, nn_d2, n_samples=n_samples,
                        far2=far2)
            count("samples", B * P * n_samples)
            if far is None:
                count("far_samples", 0)
            else:
                count_device("far_samples", far.sum())
            q_sdf = sdf[..., None]                                # (B, N, 1)
            far_mask = far[..., None] if far is not None else None
            view = cam_rays[:, :, None, :].expand(B, P, n_samples, 3) \
                .reshape(B, -1, 3)
            Ntot = pts.shape[1]
            kc, ks, inherit = (
                _network_budget(Ntot, n_samples, far_skip_frac, far_net_frac,
                                far_tnet_frac) if tiers_on else (0, 0, False))
            # the rows handed to the network: kc, ks a ray, or every sample
            count("net_points", B * (kc or (Ntot // n_samples * ks if ks
                                            else Ntot)))
            if kc:
                # global budget: the network on the kc rows nearest the
                # surface, scattered back; dropped rows keep the mesh-prior
                # density and no colour (jnp.argsort is stable, and equal
                # bounds do occur)
                sel = torch.argsort(nn_d2, dim=-1,
                                    stable=True)[:, :kc]        # (B, kc)
                buf = query_budget(sel, pts, view, q_vis, q_sdf, nn_idx,
                                   far_mask, kc)
                co = buf.shape[-1] - 1
                full = buf.new_zeros(B, Ntot, co + 1).scatter_(
                    1, sel[..., None].expand(-1, -1, co + 1), buf)
                if inherit:
                    ev = torch.zeros(B, Ntot, dtype=torch.bool,
                                     device=dev).scatter_(
                        1, sel, torch.ones_like(sel, dtype=torch.bool))
                    zs = z_depths.reshape(B, -1)
                    if os.environ.get("VANERF_TNET_IMPL", "select") == "scan":
                        full = inherit_nearest_evaluated(full, ev, zs,
                                                         n_samples)
                    else:
                        full = inherit_nearest_evaluated_select(
                            full, ev, zs, n_samples, steps=int(
                                os.environ.get("VANERF_TNET_STEPS", "4")
                                or 4))
                out, valid = full[..., :co], full[..., co:]
            elif ks:
                # per-ray budget: the ks samples of each ray nearest the
                # surface; the query is per sample, so reordering within a
                # ray preserves each row's value
                S = n_samples
                Pn = Ntot // S
                sel = torch.argsort(nn_d2.reshape(B, Pn, S),
                                    dim=-1, stable=True)[..., :ks]
                sel = (sel + (torch.arange(Pn, device=dev) * S)[None, :, None]
                       ).reshape(B, Pn * ks)
                buf = query_budget(sel, pts, view, q_vis, q_sdf, nn_idx,
                                   far_mask, ks)
                co = buf.shape[-1] - 1
                full = buf.new_zeros(B, Ntot, co + 1).scatter_(
                    1, sel[..., None].expand(-1, -1, co + 1), buf)
                out, valid = full[..., :co], full[..., co:]
            else:
                view_mask = None
                if training and n_views > 1:
                    # one view-dropout mask a pass (renderer.py:494-501)
                    view_mask = view_dropout_mask(
                        B, n_views, u_keep=_draw(
                            draws, f"drop_keep_{tag}", (B, n_views - 1, 1, 1),
                            False, generator, dev),
                        u_perm=_draw(draws, f"drop_perm_{tag}",
                                     (B, n_views, 1, 1), False, generator,
                                     dev))
                out, valid = query_rows(pts, view, q_vis, q_sdf, nn_idx,
                                        far_mask, n_samples, view_mask)
            sdf_ch = valid * out[..., 0:1] + (1.0 - valid) * (0.1 / nml_scale)
            rad = out[..., 1:2]
            if noise:
                rad = rad + _draw(draws, f"noise_{tag}", rad.shape, True,
                                  generator, dev) * rand_noise_std
            alpha = valid * F.relu(rad)
            return alpha[..., 0], sdf_ch[..., 0], out[..., 2:], q_sdf[..., 0]

        # ---- coarse pass ----
        with span("vanerf.pass.coarse"):
            alpha_c, sdf_c, rgb_c, qsdf_c = query_at(z, sample_per_ray_c,
                                                     "c")
            shp = (B, P, sample_per_ray_c)
            # under sp_conv the network's output is the density itself
            # (renderer.py:650)
            with span("vanerf.composite"):
                color, depth, acc, contrib, _sdf_out = rgba2out(
                    alpha_c.reshape(shp), sdf_c.reshape(shp),
                    rgb_c.reshape(shp + (3,)),
                    z, qsdf_c.reshape(shp), beta, use_sdf_prior=not sp_conv)
                out = {"tex_fg": color.reshape(B, out_h, out_w, 3),
                       "depth": depth.reshape(B, out_h, out_w),
                       "alpha": acc.reshape(B, out_h, out_w)}

        # ---- fine pass: evaluate only the new importance samples, then merge
        # both passes by a stable depth sort ----
        if fine:
            with span("vanerf.pass.fine"):
                with span("vanerf.composite"):
                    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
                    u_f = (_draw(draws, "u_f", (B, P, sample_per_ray_f),
                                 False, generator, dev) if jitter else None)
                    z_new = importance_sample(contrib[..., 1:-1].detach(),
                                              z_mid, sample_per_ray_f, u_f)
                    if jitter:
                        # random-u samples come back unordered; sort them
                        # per ray, as the JAX package does for its kernel's
                        # depth-coherent tiles
                        (z_new,) = sort_by_key(z_new)
                alpha_n, sdf_n, rgb_n, qsdf_n = query_at(
                    z_new, sample_per_ray_f, "f")

                def cat_cf(cv, nv):
                    return torch.cat([cv.reshape(B, P, sample_per_ray_c),
                                      nv.reshape(B, P, sample_per_ray_f)], 2)

                with span("vanerf.composite"):
                    rgb_cat = torch.cat(
                        [rgb_c.reshape(B, P, sample_per_ray_c, 3),
                         rgb_n.reshape(B, P, sample_per_ray_f, 3)], 2)
                    (z_fine, alpha_f, sdf_f, qsdf_f, r_f, g_f,
                     b_f) = sort_by_key(
                        torch.cat([z, z_new], -1), cat_cf(alpha_c, alpha_n),
                        cat_cf(sdf_c, sdf_n), cat_cf(qsdf_c, qsdf_n),
                        rgb_cat[..., 0], rgb_cat[..., 1], rgb_cat[..., 2])
                    rgb_f = torch.stack([r_f, g_f, b_f], -1)
                    color_f, depth_f, acc_f, _, sdf_out_f = rgba2out(
                        alpha_f, sdf_f, rgb_f, z_fine, qsdf_f, beta,
                        use_sdf_prior=not sp_conv)
                    out.update({
                        "tex_fg_fine": color_f.reshape(B, out_h, out_w, 3),
                        "depth_fine": depth_f.reshape(B, out_h, out_w),
                        "alpha_fine": acc_f.reshape(B, out_h, out_w),
                        "sdf": sdf_out_f.reshape(B, out_h, out_w)})

        # ---- GT / context patches at the grid (model.py:1361-1418) ----
        with span("vanerf.assemble"):
            index = (grids[..., 0] + grids[..., 1] * W).to(torch.int32)
            if batch.get("tar_img") is not None:
                out["tar_img"] = gather_pixels(batch["tar_img"], index, out_h,
                                               out_w)
            if batch.get("tar_mask") is not None:
                out["tar_alpha"] = gather_pixels(batch["tar_mask"], index,
                                                 out_h, out_w)
            if compute_vis_map:
                vis_map = torch.stack([
                    render_vis_map(verts[b], faces, vert_vis[b],
                                   batch["tar_k"][b], batch["tar_rt"][b], H,
                                   W)[1]
                    for b in range(Bf)])
                out["vis_img_all"] = vis_map              # (Bf, 1, H, W)
                out["vis_img"] = gather_pixels(vis_map.permute(0, 2, 3, 1),
                                               index, out_h, out_w)
            # the context patches of each frame's first source view
            first = (lambda x: x.reshape(Bf, n_views, *x.shape[1:])[:, 0])
            out["input_mask"] = gather_pixels(first(batch["src_mask"]), index,
                                              out_h, out_w)
            out["img_in"] = gather_pixels(first(src_img), index, out_h, out_w)
            for k in ("input_densepose", "tar_densepose"):
                if batch.get(k) is not None:
                    out[k] = gather_pixels(batch[k], index, out_h, out_w)
            out["vert_vis"] = vert_vis
            out["index"] = index
        return out


def plan_tile_group(n_tiles: int, tile_group: int, mesh=None):
    """The (tile_group, mesh) pair of a full-image render
    (``vanerf_tpu/renderer.py:811-828``): ``tile_group`` (at least 1)
    capped at the frame's ``n_tiles`` stride offsets.  With a data-parallel
    ``mesh`` (``parallel.Mesh``) the group is the unit split over its
    ranks: rounded to a multiple of the world size (up from below it,
    down from above), and the mesh dropped (one device renders) where the
    frame's tiles do not split."""
    tg = max(1, tile_group)
    if mesh is not None:
        tg = max(tg, mesh.size) // mesh.size * mesh.size
        if min(tg, n_tiles) % mesh.size != 0:
            mesh = None
    return min(tg, n_tiles), mesh


@torch.no_grad()
@spanned("vanerf.frame")
def render_full_image(model, batch: Dict[str, Any], *, level: int,
                      sample_per_ray_c: int = 64, sample_per_ray_f: int = 64,
                      n_views: int = 1, rng=None, sdf_chunk: int = 2048,
                      compute_vis_map: bool = False, tile_group: int = 1,
                      mesh=None):
    """Render the full target image by stride^2 interleaved patch passes
    (``render_pifu_nerf``, ``model.py:1026-1100``): the encoders, vertex
    visibility and prepared meshes run once per frame, then one
    :func:`render_patch` per group of ``tile_group`` stride offsets; tiles
    are reassembled by an inverse pixel shuffle.  Deterministic: ``rng``
    and ``sdf_chunk`` are accepted and unused.  The keywords are the JAX
    package's (``vanerf_tpu/renderer.py:831-949``): ``tile_group`` G
    (clamped to stride^2, which it must divide) folds G offsets, in the
    order (j, i) for i, j in range(s), into a batch of G x B elements,
    g-major and b-minor, whose element t B + b renders frame b at the
    group's t-th offset.

    With a data-parallel ``mesh`` (``parallel.Mesh``; G a multiple of its
    size, as :func:`plan_tile_group` makes it) every rank encodes the
    frames, renders its G / N offsets of each group (``_lazy_sharded_tile``,
    ``renderer.py:755-809``) into a zeroed frame, and one sum over the
    ranks joins the frames, exactly: each pixel has one writer.  Every
    rank returns the whole frame."""
    B = batch["tar_k"].shape[0]
    H, W = batch["src_img"].shape[1:3]
    s = 2 ** (level - 1)
    out_h, out_w = H // s, W // s
    G = max(1, min(tile_group, s * s))
    if (s * s) % G:
        raise ValueError(f"tile_group {tile_group} must divide stride^2 = "
                         f"{s * s}")
    n_ranks = 1 if mesh is None else mesh.size
    if G % n_ranks:
        raise ValueError(f"tile_group {G} does not split over {n_ranks} "
                         "ranks (plan_tile_group rounds it)")
    G_r = G // n_ranks
    r0 = 0 if mesh is None else mesh.rank * G_r
    cached = tuple(encode_frame(model, batch, n_views=n_views))
    cached += (prepare_frame_meshes(batch, cached[2]),)
    dev = batch["src_img"].device
    offsets = [(j, i) for i in range(s) for j in range(s)]
    tiles = []
    for g0 in range(0, s * s, G):
        # this rank's offsets of the group (all of them on one device)
        own = offsets[g0 + r0:g0 + r0 + G_r]
        strides = torch.tensor([[o] * B for o in own],
                               dtype=torch.float32).reshape(G_r * B, 2)
        grids = strided_grid(G_r * B, H, W, level, strides, device=dev)
        out = render_patch(
            model, batch, grids=grids, out_h=out_h, out_w=out_w,
            sample_per_ray_c=sample_per_ray_c,
            sample_per_ray_f=sample_per_ray_f, n_views=n_views,
            compute_vis_map=compute_vis_map, cached=cached)
        with span("vanerf.assemble"):
            for t in range(G):
                mine = r0 <= t < r0 + G_r
                tiles.append({k: ((v[(t - r0) * B:(t - r0 + 1) * B] if mine
                                   else torch.zeros_like(v[:B]))
                                  if torch.is_tensor(v) and v.ndim >= 1
                                  and v.shape[0] == G_r * B
                                  and k not in _FRAME_KEYS else v)
                              for k, v in out.items()})
    merged = {}
    with span("vanerf.assemble"):
        for k, v in tiles[0].items():
            if k in _FRAME_KEYS or k == "index":
                merged[k] = v
            elif v.ndim == 4:
                merged[k] = _unshuffle([t[k] for t in tiles], s)
            elif v.ndim == 3:
                merged[k] = _unshuffle([t[k][..., None] for t in tiles],
                                       s)[..., 0]
            else:
                merged[k] = v
            if n_ranks > 1 and k not in _FRAME_KEYS and torch.is_tensor(v):
                # zeros where another rank wrote: the sum is that rank's
                # value
                mesh.all_reduce_sum_(merged[k])
    return merged


# the outputs that are a frame's, not a tile's (every rank has them whole)
_FRAME_KEYS = ("vert_vis", "vis_img_all")


def _unshuffle(tiles, s: int) -> torch.Tensor:
    """Inverse pixel shuffle: s*s tiles of (B, h, w, C) -> (B, h*s, w*s, C);
    tile (i, j) holds pixels (y*s + i, x*s + j)."""
    B, h, w, C = tiles[0].shape
    grid = torch.stack(tiles, 0).reshape(s, s, B, h, w, C)
    return grid.permute(2, 3, 0, 4, 1, 5).reshape(B, h * s, w * s, C)
