"""Mesh priors, rays, sampling and compositing in plain PyTorch.

The semantics the program documents for its kernels, written again without
them: the nearest mesh vertex of each point (kernel B); the signed
distance to the mesh with the winding sign and the visibility of the
closest face interpolated at the point's projection onto its plane
(kernel A), with the far tier the configuration's ``far_tau`` states; the
z-buffer vertex visibility (kernel C); the rays, the stratified and
importance samples and the volume compositing (reference ``src/model.py:
1102-1570``).  Every mesh query is a sweep over every face, in chunks of
points.
"""

from __future__ import annotations

import torch

# the winding ray's direction (the program's fixed generic direction)
RAY_D = (0.5773502691896258, 0.7071067811865476, 0.40824829046386296)
TILE_RAYS, TILE_SAMPLES = 16, 8      # the far tier's tiles of points


def nearest_vertex(pts: torch.Tensor, verts: torch.Tensor,
                   chunk: int = 8192):
    """(N, 3) points, (V, 3) vertices -> index (N,), squared distance
    (N,) of the nearest vertex (the first on a tie)."""
    idx, d2 = [], []
    for p in torch.split(pts, chunk):
        d = ((p[:, None, :] - verts[None]) ** 2).sum(-1)
        m, i = d.min(-1)
        idx.append(i)
        d2.append(m)
    return torch.cat(idx), torch.cat(d2)


def zbuffer(xy: torch.Tensor, z: torch.Tensor, faces: torch.Tensor, H: int,
            W: int, chunk: int = 2048) -> torch.Tensor:
    """The nearest face at each pixel centre (x, y) of an H x W raster, -1
    on the background; a pixel is inside a face where its three
    barycentrics are >= 0; the first face wins a depth tie."""
    a, b, c = (xy[faces[:, i]] for i in range(3))
    za, zb, zc = (z[faces[:, i]] for i in range(3))
    area = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) \
        - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    ok = area.abs() >= 1e-12
    den = torch.where(ok, area, torch.ones_like(area))
    out = []
    for p in torch.split(torch.arange(H * W, device=xy.device), chunk):
        px = (p % W).float()[:, None]
        py = (p // W).float()[:, None]
        l0 = ((c[:, 0] - b[:, 0]) * (py - b[:, 1])
              - (c[:, 1] - b[:, 1]) * (px - b[:, 0])) / den
        l1 = ((a[:, 0] - c[:, 0]) * (py - c[:, 1])
              - (a[:, 1] - c[:, 1]) * (px - c[:, 0])) / den
        l2 = ((b[:, 0] - a[:, 0]) * (py - a[:, 1])
              - (b[:, 1] - a[:, 1]) * (px - a[:, 0])) / den
        inside = ok & (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        depth = l0 * za + l1 * zb + l2 * zc
        depth = torch.where(inside & ~torch.isnan(depth), depth,
                            torch.full_like(depth, float("inf")))
        zmin, f = depth.min(-1)
        out.append(torch.where(torch.isfinite(zmin), f, -1))
    return torch.cat(out)


def vertex_visibility(verts: torch.Tensor, faces: torch.Tensor,
                      krt: torch.Tensor, H: int, W: int, znear, zfar,
                      size: int = 256) -> torch.Tensor:
    """(V, 1) 0/1: a vertex is visible in the source view ``krt`` where a
    face holding it wins the z-test at some pixel of a size x size raster
    (reference ``get_visibility``, ``mesh_util.py:284-318``)."""
    vh = verts @ krt[:3, :3].T + krt[:3, 3]
    z = vh[:, 2]
    xy = vh[:, :2] / (z[:, None] + 1e-8)
    xy01 = torch.stack([xy[:, 0] / (W - 1.0), xy[:, 1] / (H - 1.0)], -1)
    face = zbuffer(xy01 * (size - 1.0), (z - znear) / (zfar - znear), faces,
                   size, size)
    hit = torch.zeros(faces.shape[0], dtype=torch.bool, device=verts.device)
    hit[face[face >= 0]] = True
    vis = torch.zeros(verts.shape[0], device=verts.device)
    vis[faces[hit].reshape(-1)] = 1.0
    return vis[:, None]


def _dot(x, y):
    return x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1] + x[..., 2] * y[..., 2]


def _cross(x, y):
    return torch.stack([x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1],
                        x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2],
                        x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]], -1)


def _tri_dist(p, a, b, c):
    """Squared distance from points (..., 3) to triangles given by their
    corners (..., 3) broadcast alike: Ericson's closest point (Real-Time
    Collision Detection 5.1.5: a corner, a point on an edge or the
    projection into the face), every product and sum rounded on its own."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    den = va + vb + vc
    den = torch.where(den == 0, torch.ones_like(den), den)
    v, w = vb / den, vc / den
    eps = torch.tensor(1e-20, dtype=d1.dtype, device=d1.device)
    t_ab = d1 / torch.maximum(d1 - d3, eps)
    t_ac = d2 / torch.maximum(d2 - d6, eps)
    t_bc = (d4 - d3) / torch.maximum((d4 - d3) + (d5 - d6), eps)
    q = a + v[..., None] * ab + w[..., None] * ac
    q = torch.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None],
                    b + t_bc[..., None] * (c - b), q)
    q = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None],
                    a + t_ac[..., None] * ac, q)
    q = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None],
                    a + t_ab[..., None] * ab, q)
    q = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c, q)
    q = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b, q)
    q = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, q)
    d = p - q
    return _dot(d, d)


def morton_order(cen: torch.Tensor) -> torch.Tensor:
    """The faces in Morton (z-curve) order of their centroids, 10 bits an
    axis, stable: the order in which the closest face is the first of
    equally distant ones (the program's documented rule)."""
    lo, hi = cen.amin(0), cen.amax(0)
    q = ((cen - lo) / torch.clamp_min(hi - lo, 1e-9) * 1023.0).clamp(
        0, 1023).to(torch.int64)
    code = torch.zeros_like(q[:, 0])
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return torch.argsort(code, stable=True)


def mesh_query(pts: torch.Tensor, verts: torch.Tensor, faces: torch.Tensor,
               vert_vis: torch.Tensor, need: torch.Tensor | None = None,
               chunk: int = 8192, k: int = 128):
    """The squared distance to the mesh, the closest face's vertex
    visibility interpolated at the point's projection onto that face's
    plane, and the winding number by signed crossings of the ray from the
    point along :data:`RAY_D`, over every face; coordinates relative to
    the centre of the mesh's box.

    Each point's distance is taken over the ``k`` faces nearest by the
    distance to their bounding spheres (the centroid, the farthest
    corner), which hold every face at or below the best distance found
    unless the ``k``-th sphere lies within it: then over every face.  Of
    equally distant faces the first in :func:`morton_order` is the
    closest.  Points outside ``need`` (N,) get no distance (d2 = inf,
    qvis = 0).  Returns d2 (N,), qvis (N,), wind (N,)."""
    centre = 0.5 * (verts.amin(0) + verts.amax(0))
    tri = verts[faces] - centre                         # (F, 3, 3)
    order = morton_order(tri.mean(1))
    tri, fvis = tri[order], vert_vis[:, 0][faces[order]]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    pts = pts - centre
    F_ = faces.shape[0]
    ab, ac = b - a, c - a
    d = torch.tensor(RAY_D, device=pts.device).expand_as(ab)
    pv, w2 = _cross(d, ac), _cross(ab, d)
    n = _cross(ab, ac)
    det = _dot(ab, pv)
    ok = det != 0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    Mw = torch.cat([pv * inv[:, None], w2 * inv[:, None], n * inv[:, None]],
                   0).T                                 # (3, 3F)
    cw = torch.cat([_dot(pv, a) * inv, _dot(w2, a) * inv, _dot(n, a) * inv])
    sgn = torch.where(det > 0, -1.0, 1.0) * ok
    cen = tri.mean(1)
    rad = (tri - cen[:, None]).norm(dim=-1).amax(1)
    cc = _dot(cen, cen)
    need = (torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
            if need is None else need)
    d2 = torch.full((pts.shape[0],), float("inf"), device=pts.device)
    qvis = torch.zeros_like(d2)
    winds = []
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk]
        g = (p @ Mw - cw).split(F_, -1)                 # u, v, t over det
        hit = (g[0] >= 0) & (g[1] >= 0) & (g[0] + g[1] <= 1) & (g[2] > 0)
        winds.append((hit * sgn).sum(-1))
        sel = need[s:s + chunk].nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        q = p[sel]
        sd = (_dot(q, q)[:, None] - 2 * q @ cen.T + cc).clamp(min=0).sqrt() \
            - rad
        lb, cand = torch.topk(sd, min(k, F_), dim=-1, largest=False)
        cand = cand.sort(-1).values                     # Morton order
        m, j = _tri_dist(q[:, None], a[cand], b[cand], c[cand]).min(-1)
        f = cand.gather(1, j[:, None])[:, 0]
        full = (lb[:, -1] <= m.sqrt() + 1e-5) & (k < F_)
        if full.any():
            r = full.nonzero()[:, 0]
            m[r], f[r] = _tri_dist(q[r][:, None], a[None], b[None],
                                   c[None]).min(-1)
        u_, v_, w_ = b[f] - a[f], c[f] - a[f], q - a[f]
        nf = _cross(u_, v_)
        s2 = _dot(nf, nf)
        s2 = torch.where(s2 == 0, torch.full_like(s2, 1e-6), s2)
        b2 = _dot(_cross(u_, w_), nf) / s2
        b1 = _dot(_cross(w_, v_), nf) / s2
        fv = fvis[f]
        d2[s + sel] = m
        qvis[s + sel] = fv[:, 0] * (1.0 - b1 - b2) + fv[:, 1] * b1 \
            + fv[:, 2] * b2
    return d2, qvis, torch.cat(winds)


def far_tiles(nn_d2: torch.Tensor, n_rays: int, n_samples: int,
              far_tau: float) -> torch.Tensor:
    """(N,) bool: the points of the tiles of 16 consecutive rays x 8
    consecutive samples (ray-major points) whose every nearest-vertex
    distance exceeds ``far_tau``."""
    if far_tau <= 0 or n_rays % TILE_RAYS or n_samples % TILE_SAMPLES:
        return torch.zeros_like(nn_d2, dtype=torch.bool)
    x = nn_d2.reshape(n_rays // TILE_RAYS, TILE_RAYS,
                      n_samples // TILE_SAMPLES, TILE_SAMPLES)
    far = (x > far_tau ** 2).all(3, keepdim=True).all(1, keepdim=True)
    return far.expand_as(x).reshape(-1)


def rays(grid: torch.Tensor, K: torch.Tensor, Rt: torch.Tensor, bounds,
         znear: float, zfar: float):
    """World rays through pixels (P, 2) of the target camera, clipped to
    the padded box ``bounds`` (2, 3) where they hit it.  Returns origin
    (3,), unit directions (P, 3), near (P, 1), far (P, 1)."""
    pix = torch.cat([grid, torch.ones_like(grid[:, :1])], -1)
    cam = pix @ torch.linalg.inv(K[:3, :3]).T
    near = znear * cam.norm(dim=-1, keepdim=True)
    far = zfar * cam.norm(dim=-1, keepdim=True)
    R = Rt[:3, :3]
    d = cam @ R
    d = d / (d.norm(dim=-1, keepdim=True) + 1e-12)
    o = -(Rt[:3, 3] @ R)
    lo = bounds[0] - 0.01
    hi = bounds[1] + 0.01
    dd = torch.where(d.abs() < 1e-5, torch.full_like(d, 1e-5), d)
    t = torch.cat([(lo - o) / dd, (hi - o) / dd], -1)          # (P, 6)
    q = t[..., None] * dd[:, None] + o                         # (P, 6, 3)
    inside = ((q >= lo - 1e-6) & (q <= hi + 1e-6)).all(-1)
    hit = inside.sum(-1) == 2
    ta = t.abs()
    t1 = torch.where(inside, ta, torch.full_like(ta, float("inf"))).amin(-1)
    t2 = torch.where(inside, ta, torch.full_like(ta, -float("inf"))).amax(-1)
    near = torch.where((hit & (t1 > near[:, 0]))[:, None], t1[:, None], near)
    far = torch.where((hit & (t2 < far[:, 0]))[:, None], t2[:, None], far)
    return o, d, near, far


def stratified(near: torch.Tensor, far: torch.Tensor, n: int) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    return near + (far - near) * t


def importance(weights: torch.Tensor, bins: torch.Tensor, n: int,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF depths at n evenly spaced quantiles, or at the uniforms
    ``u`` (P, n) (reference ``model.py:1424-1462``): weights (P, D - 1)
    + 1e-5, bins (P, D)."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=w.device).expand(
            cdf.shape[0], n)
    u = u.contiguous()
    i = torch.searchsorted(cdf, u, right=True)
    lo = (i - 1).clamp(min=0)
    hi = i.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, lo), cdf.gather(-1, hi)
    z0, z1 = bins.gather(-1, lo), bins.gather(-1, hi)
    den = c1 - c0
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return z0 + (u - c0) / den * (z1 - z0)


def composite(density: torch.Tensor, sdf: torch.Tensor, rgb: torch.Tensor,
              z: torch.Tensor, q_sdf: torch.Tensor, beta: torch.Tensor):
    """Volume rendering of (P, D) samples (reference ``rgba2out``,
    ``model.py:1464-1494``): the density is sigmoid(-(out + sdf_prior) /
    beta) / beta.  Returns colour (P, 3), depth (P,), alpha (P,), weights
    (P, D), sdf (P,)."""
    beta = beta.clamp(min=2e-3)
    sigma = torch.sigmoid(-(density + q_sdf) / beta) / beta
    dist = torch.cat([z[:, 1:] - z[:, :-1],
                      torch.full_like(z[:, :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-sigma * dist)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha[:, :-1]], -1), -1)
    w = alpha * trans
    acc = w.sum(-1)
    return ((rgb * w[..., None]).sum(1), (z * w).sum(-1) / (acc + 1e-8), acc,
            w, (sdf * w).sum(-1) / (acc + 1e-8))
