"""A full novel-view frame in plain PyTorch: the reference of what the
program's ``renderer.render_full_image`` serves.

The frame is rendered tile by tile: 2^(level-1) x 2^(level-1) interleaved
stride offsets, each a patch of (H / s) x (W / s) rays with ``n_c``
stratified samples, the query, compositing, ``n_f`` importance samples,
their query and the depth-sorted merge of both passes (reference
``render_pifu_nerf`` / ``batch_render_pifu_nerf``, ``src/model.py:
1026-1422``).  The per-frame work (the encoders, the vertex visibility in
the first source view, the vertex feature tables) is done once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import geometry as geo
from .nets import Generator, sample


class Frame:
    """A frame's inputs and its per-frame features."""

    def __init__(self, G: Generator, req: dict, n_views: int):
        self.V = n_views
        self.img = req["src_img"]                         # (V, H, W, 3)
        self.mask = req["src_mask"]
        self.krt, self.extrin = req["src_krt"], req["src_extrin"]
        self.H, self.W = self.img.shape[1:3]
        self.znear, self.zfar = float(req["znear"]), float(req["zfar"])
        self.verts, self.faces = req["verts"][0], req["faces"]
        self.kpt = req["kpt3d"][0]
        (self.g0, self.g1), self.tex = G.encode(self.img)
        self.vert_vis = geo.vertex_visibility(
            self.verts, self.faces, self.krt[0], self.H, self.W, self.znear,
            self.zfar)
        vh = self.verts @ self.krt[:, :3, :3].transpose(1, 2) \
            + self.krt[:, None, :3, 3]
        vxy = vh[..., :2] / (vh[..., 2:3] + 1e-8)
        vert_xy = torch.stack([2 * vxy[..., 0] / (self.W - 1) - 1,
                               2 * vxy[..., 1] / (self.H - 1) - 1], -1)
        table = torch.cat([
            sample(self.g0, vert_xy), sample(self.g1, vert_xy),
            sample(self.img, vert_xy), sample(self.tex, vert_xy),
            G.tex_vis_fusion.global_feature(self.tex, self.img),
            self.vert_vis[None].expand(self.V, -1, -1)], -1)  # (V, V2, 102)
        self.table = torch.cat([table, torch.roll(table, -G.num_v, 1)], -1)


def query(G: Generator, fr: Frame, pts, view, q_vis, q_sdf, nn_idx, far):
    """The network at (N, 3) points of one frame: (N, 2) [sdf, density],
    (N, 1) valid, (N, 3) rgb (reference ``VANeRF.query``,
    ``model.py:748-957``)."""
    V, N = fr.V, pts.shape[0]
    v = pts[None].expand(V, N, 3)
    vh = v @ fr.krt[:, :3, :3].transpose(1, 2) + fr.krt[:, None, :3, 3]
    z = vh[..., 2:3]
    xy = vh[..., :2] / z
    xy = torch.stack([2 * xy[..., 0] / (fr.W - 1) - 1,
                      2 * xy[..., 1] / (fr.H - 1) - 1], -1)
    z = 2 * (z - fr.znear) / (fr.zfar - fr.znear) - 1
    inside = ((xy.abs() <= 1 + 1e-2).all(-1, keepdim=True) & (z >= -1))
    fg_img = sample(torch.cat([fr.mask, fr.img], -1), xy)
    img_xy = fg_img[..., 1:]
    seen = (inside & (fg_img[..., :1] > 0.1)).all(0, keepdim=True)
    mask = inside.float() * seen
    e = 0.5 * torch.cat([xy, z], -1) + 0.5
    pw = torch.sigmoid(5 * (torch.minimum(e, 1 - e) / 0.1 - 1)).prod(
        -1, keepdim=True) * mask
    pw = pw / (pw.sum(0, keepdim=True) + 1e-6)

    # keypoint-relative depth encoding, weighted by keypoint proximity
    R, t = fr.extrin[:, :3, :3], fr.extrin[:, None, :3, 3]
    cxyz = v @ R.transpose(1, 2) + t
    kc = fr.kpt[None] @ R.transpose(1, 2) + t                 # (V, K, 3)
    sp = G.sp
    dxyz = cxyz[:, :, None] - kc[:, None]
    dz = sp["scale"] * dxyz[..., 2]
    w = torch.exp(-(dxyz ** 2).sum(-1) / (2 * sp["sigma"] ** 2))
    parts = [dz]
    for lv in range(sp["sp_level"]):
        a = (2.0 ** lv) * torch.pi * dz
        parts += [torch.sin(a), torch.cos(a)]
    enc = torch.cat([p * w for p in parts], -1)

    rows = torch.stack([fr.table[i][nn_idx] for i in range(V)])  # (V,N,204)
    C = rows.shape[-1] // 2
    vis = rows[..., C - 1:C]
    vis_o = rows[..., 2 * C - 1:]
    f = rows[..., :C - 1] * vis
    f_o = rows[..., C:2 * C - 1] * vis_o
    qv = torch.where(far, vis, q_vis.expand(V, N, 1))
    ctx = torch.cat([q_sdf.expand(V, N, 1), qv, vis, vis_o], -1)
    g = G.geo_vis_fusion([sample(fr.g0, xy), sample(fr.g1, xy)],
                         [f[..., :64], f[..., 64:72]],
                         [f_o[..., :64], f_o[..., 64:72]], ctx)
    out, valid, pooled = G.mlp_geo(enc[None], [g[0][None], g[1][None]],
                                   mask[None], pw[None])
    latent = G.ibr_compress_gfeat(pooled[0]).expand(V, N, -1)
    q = torch.cat([img_xy, sample(fr.tex, xy)], -1)
    rgbf = G.tex_vis_fusion(q, f[..., 72:83], f_o[..., 72:83],
                            f[..., 83:], f_o[..., 83:], latent,
                            torch.cat([qv, vis, vis_o], -1))
    if V == 1:
        return out[0], valid[0].float(), rgbf[0, :, :3]
    cam = torch.linalg.inv(fr.krt)[:, :3, 3]
    cr = v - cam[:, None]
    cr = cr / (cr.norm(dim=-1, keepdim=True) + 1e-12)
    rd = view[None] - cr
    dirs = torch.cat([rd / rd.norm(dim=-1, keepdim=True).clamp(min=1e-6),
                      (cr * view[None]).sum(-1, keepdim=True)], -1)
    rgb = G.mlp_tex(rgbf.transpose(0, 1), dirs.transpose(0, 1),
                    mask.transpose(0, 1))
    return out[0], valid[0].float(), rgb


def _pass(G, fr, o, d, z, far_tau, chunk):
    """The mesh priors and the network at every sample of a patch's rays:
    (P, S) density, sdf channel, prior sdf and (P, S, 3) rgb."""
    P, S = z.shape
    pts = (o + d[:, None] * z[..., None]).reshape(-1, 3)
    view = d[:, None].expand(P, S, 3).reshape(-1, 3)
    nn_idx, nn_d2 = geo.nearest_vertex(pts, fr.verts)
    far = geo.far_tiles(nn_d2, P, S, far_tau)
    d2, qv, wind = geo.mesh_query(pts, fr.verts, fr.faces, fr.vert_vis,
                                  need=~far)
    d2 = torch.where(far, nn_d2, d2)
    q_vis = torch.where(far | (qv < 0.1), 0.0, 1.0)[:, None]
    q_sdf = (torch.sqrt(d2 + 1e-6) * torch.where(wind > 0.5, -1.0, 1.0)
             )[:, None]
    outs = []
    for s in range(0, pts.shape[0], chunk):
        sl = slice(s, s + chunk)
        outs.append(torch.cat(query(G, fr, pts[sl], view[sl], q_vis[sl],
                                    q_sdf[sl], nn_idx[sl],
                                    far[sl, None]), -1))
    out = torch.cat(outs)                       # (N, 6): out 2, valid, rgb
    valid = out[:, 2]
    dens = valid * F.relu(out[:, 1])
    sdf = valid * out[:, 0] + (1 - valid) * 1e-3
    return (dens.reshape(P, S), sdf.reshape(P, S), q_sdf.reshape(P, S),
            out[:, 3:].reshape(P, S, 3))


@torch.no_grad()
def render_frame(G: Generator, req: dict, *, level: int, n_c: int, n_f: int,
                 n_views: int, far_tau: float, chunk: int = 32768) -> dict:
    """The frame of one request (tensors on one device): 'tex_fg_fine'
    (H, W, 3), 'alpha_fine' and 'depth_fine' (H, W)."""
    fr = Frame(G, req, n_views)
    H, W = fr.H, fr.W
    s = 2 ** (level - 1)
    dev = fr.img.device
    ys, xs = torch.meshgrid(torch.arange(0, H, s, device=dev).float(),
                            torch.arange(0, W, s, device=dev).float(),
                            indexing="ij")
    out = {"tex_fg_fine": torch.zeros(H, W, 3, device=dev),
           "alpha_fine": torch.zeros(H, W, device=dev),
           "depth_fine": torch.zeros(H, W, device=dev)}
    beta = G.sigmoid_beta
    for i in range(s):
        for j in range(s):
            grid = torch.stack([xs + j, ys + i], -1).reshape(-1, 2)
            o, d, near, far = geo.rays(grid, req["tar_k"][0], req["tar_rt"][0],
                                       req["bounds"][0], fr.znear, fr.zfar)
            z = geo.stratified(near, far, n_c)
            dens_c, sdf_c, qs_c, rgb_c = _pass(G, fr, o, d, z, far_tau, chunk)
            _, _, _, w, _ = geo.composite(dens_c, sdf_c, rgb_c, z, qs_c, beta)
            z_f = geo.importance(w[:, 1:-1], 0.5 * (z[:, 1:] + z[:, :-1]), n_f)
            dens_f, sdf_f, qs_f, rgb_f = _pass(G, fr, o, d, z_f, far_tau,
                                               chunk)
            z_all, order = torch.sort(torch.cat([z, z_f], -1), dim=-1,
                                      stable=True)
            pick = lambda a, b: torch.cat([a, b], 1).gather(1, order)
            rgb = torch.cat([rgb_c, rgb_f], 1).gather(
                1, order[..., None].expand(-1, -1, 3))
            color, depth, acc, _, _ = geo.composite(
                pick(dens_c, dens_f), pick(sdf_c, sdf_f), rgb, z_all,
                pick(qs_c, qs_f), beta)
            h, w_ = ys.shape
            out["tex_fg_fine"][i::s, j::s] = color.reshape(h, w_, 3)
            out["alpha_fine"][i::s, j::s] = acc.reshape(h, w_)
            out["depth_fine"][i::s, j::s] = depth.reshape(h, w_)
    return out
