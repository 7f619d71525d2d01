"""The faithful GAN train step in plain PyTorch (reference
``VANeRFLightningModule.training_step``, ``src/model.py:381-459``; losses
``src/utils.py:159-328``, ``:882-937``; ``Discriminator_vis`` and the GAN
losses ``src/networks.py:535-601``).

One step: the generator renders a mask-centred patch with jittered
samples and radiance noise, takes L1 + VGG + the non-saturating GAN loss +
the visibility BCE, and Adam updates it; the discriminator then judges a
fresh patch rendered without gradients through the updated generator,
with the logistic loss, R1 (weight 300 x 0.5) and the masked visibility
BCEs, and Adam updates it.  Every draw comes in from the caller.  Adam is
written out (betas 0.9 / 0.999, eps 1e-8, the configuration's rate: the
first halving falls after two epochs).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import geometry as geo
from .nets import Generator
from .render import Frame, query

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG_SLICES = (("slice1", 0, 2), ("slice2", 2, 7), ("slice3", 7, 12),
              ("slice4", 12, 21))
VGG_CH = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128),
          10: (128, 256), 12: (256, 256), 14: (256, 256), 16: (256, 256),
          19: (256, 512)}


class Vgg19(nn.Module):
    """torchvision's VGG19 ``features[0:21]`` in four slices."""

    def __init__(self):
        super().__init__()
        for name, lo, hi in VGG_SLICES:
            s = nn.Sequential()
            for i in range(lo, hi):
                s.add_module(str(i), nn.Conv2d(*VGG_CH[i], 3, padding=1)
                             if i in VGG_CH else
                             nn.MaxPool2d(2) if i in (4, 9, 18) else nn.ReLU())
            self.add_module(name, s)

    def loss(self, x, y):
        """L1 between the slices' features of (1, H, W, 3) images, weights
        1/16, 1/8, 1/4, 1; no gradient through the target's."""
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        fx = ((x - mean) / std).permute(0, 3, 1, 2)
        fy = ((y - mean) / std).permute(0, 3, 1, 2)
        total = 0.0
        for w, (name, _, _) in zip((1 / 16, 1 / 8, 1 / 4, 1.0), VGG_SLICES):
            fx, fy = getattr(self, name)(fx), getattr(self, name)(fy)
            total = total + w * (fx - fy.detach()).abs().mean()
        return total


class Discriminator(nn.Module):
    """Global real / fake score and per-pixel visibility."""

    def __init__(self):
        super().__init__()
        self.fconv3 = nn.Sequential(
            nn.Conv2d(12, 10, 3, padding=1), nn.ReLU(),
            nn.Conv2d(10, 10, 3, padding=1), nn.ReLU(),
            nn.AdaptiveAvgPool2d(1))
        self.fconv4 = nn.Sequential(
            nn.Conv2d(12, 20, 3, padding=1), nn.ReLU(),
            nn.Conv2d(20, 20, 3, padding=1), nn.ReLU(),
            nn.Conv2d(20, 12, 3, padding=1))
        self.fconv2 = nn.Sequential(
            nn.Conv2d(24, 30, 3, padding=1), nn.ReLU(),
            nn.Conv2d(30, 20, 3, padding=1), nn.ReLU(),
            nn.Conv2d(20, 1, 3, padding=1), nn.Sigmoid())
        self.linear = nn.Sequential(nn.Linear(10, 3), nn.ReLU(),
                                    nn.Linear(3, 1), nn.Sigmoid())

    def forward(self, img_in, dp_in, dp_tar, pred):
        x = torch.cat([img_in, dp_in, dp_tar, pred], -1).permute(0, 3, 1, 2)
        score = self.linear(self.fconv3(x).flatten(1))
        vis = self.fconv2(torch.cat([x, self.fconv4(x)], 1))
        return score, vis.permute(0, 2, 3, 1)


def bce(p, t, eps=1e-7):
    p = p.clamp(eps, 1 - eps)
    return -(t * torch.log(p) + (1 - t) * torch.log(1 - p))


def vis_map(verts, faces, vert_vis, K, Rt, H, W):
    """The target view's visibility: the z-buffer's winning face, its
    vertices' visibility interpolated barycentrically and binarised at
    0.392; the background reads 1 (reference ``render_vis``)."""
    cam = verts @ Rt[:3, :3].T + Rt[:3, 3]
    z = cam[:, 2]
    xy = torch.stack([cam[:, 0] / (z + 1e-8) * K[0, 0] + K[0, 2],
                      cam[:, 1] / (z + 1e-8) * K[1, 1] + K[1, 2]], -1)
    face = geo.zbuffer(xy, z, faces, H, W)
    t = xy[faces[face.clamp(min=0)]]                        # (HW, 3, 2)
    pix = torch.arange(H * W, device=xy.device)
    p = torch.stack([(pix % W).float(), (pix // W).float()], -1)

    def edge(o, d, q):
        return ((q[..., 0] - o[..., 0]) * (d[..., 1] - o[..., 1])
                - (q[..., 1] - o[..., 1]) * (d[..., 0] - o[..., 0]))
    a, b, c = t[:, 0], t[:, 1], t[:, 2]
    area = edge(a, b, c)
    area = torch.where(area.abs() < 1e-12, torch.ones_like(area), area)
    bary = torch.stack([edge(b, c, p), edge(c, a, p), edge(a, b, p)], -1) \
        / area[:, None]
    vis = (vert_vis[:, 0][faces[face.clamp(min=0)]] * bary).sum(-1)
    return torch.where(face < 0, 1.0, (vis >= 0.392).float()).reshape(H, W)


def _pass(G, fr, o, d, z, noise, std):
    P, S = z.shape
    pts = (o + d[:, None] * z[..., None]).reshape(-1, 3)
    view = d[:, None].expand(P, S, 3).reshape(-1, 3)
    with torch.no_grad():
        nn_idx, _ = geo.nearest_vertex(pts, fr.verts)
        d2, qv, wind = geo.mesh_query(pts, fr.verts, fr.faces, fr.vert_vis)
    q_vis = (qv >= 0.1).float()[:, None]
    q_sdf = (torch.sqrt(d2 + 1e-6) * torch.where(wind > 0.5, -1.0, 1.0)
             )[:, None]
    far = torch.zeros_like(q_vis, dtype=torch.bool)
    out, valid, rgb = query(G, fr, pts, view, q_vis, q_sdf, nn_idx, far)
    dens = valid[:, 0] * F.relu(out[:, 1] + noise.reshape(-1) * std)
    sdf = valid[:, 0] * out[:, 0] + (1 - valid[:, 0]) * 1e-3
    return (dens.reshape(P, S), sdf.reshape(P, S), q_sdf.reshape(P, S),
            rgb.reshape(P, S, 3))


def render_patch(G: Generator, req: dict, draws: dict, m: dict,
                 n_views: int) -> dict:
    """The training patch of a request at ``draws['grids']`` (1, P, 2):
    coarse and fine images (1, h, w, 3) and the ground-truth and context
    patches the losses read."""
    drk = m["dr_kwargs"]
    h, w = m["train_out_h"], m["train_out_w"]
    fr = Frame(G, req, n_views)
    grid = draws["grids"][0]
    o, d, near, far = geo.rays(grid, req["tar_k"][0], req["tar_rt"][0],
                               req["bounds"][0], fr.znear, fr.zfar)
    n_c, n_f = drk["sample_per_ray_c"], drk["sample_per_ray_f"]
    t = torch.linspace(0.0, 1.0, n_c, device=grid.device)
    mid = 0.5 * (t[1:] + t[:-1])
    lo = torch.cat([t[:1], mid])
    hi = torch.cat([mid, t[-1:]])
    z = near + (far - near) * (lo + draws["u_c"][0] * (hi - lo))
    std = drk["rand_noise_std"]
    dens_c, sdf_c, qs_c, rgb_c = _pass(G, fr, o, d, z, draws["noise_c"], std)
    color_c, _, _, wts, _ = geo.composite(dens_c, sdf_c, rgb_c, z, qs_c,
                                          G.sigmoid_beta)
    z_f = geo.importance(wts[:, 1:-1].detach(), 0.5 * (z[:, 1:] + z[:, :-1]),
                         n_f, u=draws["u_f"][0])
    z_f, _ = torch.sort(z_f, dim=-1)
    dens_f, sdf_f, qs_f, rgb_f = _pass(G, fr, o, d, z_f, draws["noise_f"],
                                       std)
    z_all, order = torch.sort(torch.cat([z, z_f], -1), dim=-1, stable=True)
    pick = lambda a, b: torch.cat([a, b], 1).gather(1, order)
    rgb = torch.cat([rgb_c, rgb_f], 1).gather(
        1, order[..., None].expand(-1, -1, 3))
    color_f, _, _, _, _ = geo.composite(
        pick(dens_c, dens_f), pick(sdf_c, sdf_f), rgb, z_all,
        pick(qs_c, qs_f), G.sigmoid_beta)
    H, W = fr.H, fr.W
    idx = (grid[:, 0] + grid[:, 1] * W).long()
    at = lambda img: img.reshape(H * W, -1)[idx].reshape(1, h, w, -1)
    vm = vis_map(fr.verts, fr.faces, fr.vert_vis, req["tar_k"][0],
                 req["tar_rt"][0], H, W)
    return {"tex": color_c.reshape(1, h, w, 3),
            "tex_fine": color_f.reshape(1, h, w, 3),
            "tar_img": at(req["tar_img"][0]), "tar_alpha": at(req["tar_mask"][0]),
            "vis_img": at(vm[..., None]), "img_in": at(req["src_img"][0]),
            "dp_in": at(req["input_densepose"][0]),
            "dp_tar": at(req["tar_densepose"][0])}


def g_loss(out, D, vgg, m, dl):
    lam = m["lambdas"]
    tar = out["tar_img"]
    loss = lam["lambda_l1_c"] * (out["tex"] - tar).abs().mean()
    loss = loss + lam["lambda_l1"] * (out["tex_fine"] - tar).abs().mean()
    loss = loss + lam["lambda_vgg"] * (vgg.loss(out["tex"], tar)
                                       + vgg.loss(out["tex_fine"], tar))
    score, vis = D(out["img_in"], out["dp_in"], out["dp_tar"],
                   out["tex_fine"].clamp(0, 1))
    vis_pix = torch.where(out["tar_alpha"] == 0, 0.0,
                          bce(vis, torch.ones_like(vis))).mean()
    return loss + dl["lambda_dis1"] * F.softplus(-score).mean() \
        + dl["lambda_dis2"] * vis_pix


def d_loss(out, D):
    fake = out["tex_fine"].clamp(0, 1).detach()
    real = out["tar_img"].detach().requires_grad_(True)
    ctx = (out["img_in"], out["dp_in"], out["dp_tar"])
    r_score, r_vis = D(*ctx, real)
    f_score, f_vis = D(*ctx, fake)
    msk, vgt = out["tar_alpha"], out["vis_img"]
    real_l = torch.where(msk == 0, 0.0, bce(r_vis, torch.ones_like(r_vis))
                         ).mean()
    fake_l = torch.where(msk == 0, 0.0, bce(f_vis, vgt))
    fake_l = torch.where(vgt == 0, 5 * fake_l, fake_l).mean()
    (g,) = torch.autograd.grad(r_score.sum(), real, create_graph=True)
    r1 = g.pow(2).reshape(1, -1).sum(1).mean()
    return (F.softplus(-r_score).mean() + F.softplus(f_score).mean()
            + 150.0 * r1 + real_l + fake_l)


class Adam:
    """torch.optim.Adam's update, written out."""

    def __init__(self, params, lr):
        self.params, self.lr, self.t = list(params), lr, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = 0.9, 0.999
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = torch.zeros_like(p) if g is None else g
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** self.t)).add_(1e-8)
            p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** self.t))


def step(G, D, vgg, opt_g, opt_d, req, draws, cfg, n_views):
    """One faithful GAN step; returns (g_loss, d_loss, G's gradients)."""
    m = cfg["models"]["VANeRF"]
    dl = cfg["models"]["Discriminator"]["lambdas"]
    out = render_patch(G, req, draws["g"], m, n_views)
    lg = g_loss(out, D, vgg, m, dl)
    grads_g = torch.autograd.grad(lg, opt_g.params, allow_unused=True)
    opt_g.step(grads_g)
    with torch.no_grad():
        out_d = render_patch(G, req, draws["d"], m, n_views)
    ld = d_loss(out_d, D)
    grads_d = torch.autograd.grad(ld, opt_d.params, allow_unused=True)
    opt_d.step(grads_d)
    return lg.detach(), ld.detach(), grads_g, grads_d
