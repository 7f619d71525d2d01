"""Z-buffer rasterization and per-vertex visibility (port of
``vanerf_tpu/ops/rasterize.py`` + ``ops/rasterize_pallas.py``).

:func:`rasterize_zbuffer` runs kernel C (``csrc/rasterize.cu``) on CUDA
tensors and its plain-PyTorch twin on CPU tensors; the winner's
barycentrics and :func:`vertex_visibility`'s scatter-max stay plain
PyTorch (XLA in the JAX package).
"""

from __future__ import annotations

import torch

from . import _cuda

launches = 0


def _packed_faces(verts_xy, verts_z, faces):
    """(F, 9) rows [ax ay az bx by bz cx cy cz] (z = depth)."""
    f = faces.long()
    xy = verts_xy[f]                                     # (F, 3, 2)
    z = verts_z.reshape(-1)[f]                           # (F, 3)
    return torch.cat([xy, z[..., None]], -1).reshape(-1, 9).contiguous()


def _raster_pixels(tri: torch.Tensor, pix: torch.Tensor, W: int):
    """The z-argmin over the packed faces ``tri`` at the flat pixel indices
    ``pix`` (row-major, width W): face (n,) int64 (-1 = background), z (n,)
    (inf = background).  The arithmetic of ``rasterize_pallas.py:48-66``.
    The first face of least depth wins, as the kernel's strict ``<`` in
    ascending order and ``jnp.argmin`` take it; a NaN depth never wins."""
    ax, ay, az, bx, by, bz, cx, cy, cz = [tri[:, k] for k in range(9)]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    ok = area.abs() >= 1e-12
    den = torch.where(ok, area, torch.ones_like(area))
    px = (pix % W).float()[:, None]
    py = (pix // W).float()[:, None]
    w0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
    w1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
    w2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
    b0 = w0 / den
    b1 = w1 / den
    b2 = w2 / den
    inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & ok
    zi = b0 * az + b1 * bz + b2 * cz
    inf = torch.full_like(zi, float("inf"))
    zi = torch.where(inside & ~torch.isnan(zi), zi, inf)
    if zi.shape[1] == 0:
        zmin = torch.full((pix.shape[0],), float("inf"), device=tri.device)
    else:
        zmin = zi.amin(-1)
    first = torch.arange(zi.shape[1], device=tri.device).expand_as(zi)
    fidx = torch.where(zi == zmin[:, None], first, zi.shape[1])
    hit = zmin < float("inf")
    fidx = fidx.amin(-1) if zi.shape[1] else torch.zeros_like(pix)
    return torch.where(hit, fidx, -1), zmin


def raster_plain(tri: torch.Tensor, H: int, W: int):
    """Plain-PyTorch z-buffer over packed (F, 9) faces -> face (H*W,) int32
    (-1 = background), zbuf (H*W,) (inf = background): the sweep over
    every face, kernel C's independent reference (it applies no culling).
    Ties go to the lowest face index."""
    pix = torch.arange(H * W, device=tri.device)
    faces, zs = [], []
    for p in torch.split(pix, 2048):
        f, z = _raster_pixels(tri, p, W)
        faces.append(f.int())
        zs.append(z)
    return torch.cat(faces), torch.cat(zs)


# kernel C's tile (csrc/rasterize.cu RC_TILE)
RASTER_TILE = 16


def _tiles(H: int, W: int, device):
    """The tiles of an H x W raster in launch order (row of tiles major):
    the first and last pixel centre of each, (n_tiles, 4) float64 x0 x1 y0
    y1, and the pixels each holds."""
    ty = torch.arange(0, H, RASTER_TILE, device=device)
    tx = torch.arange(0, W, RASTER_TILE, device=device)
    y0, x0 = torch.meshgrid(ty, tx, indexing="ij")
    x0, y0 = x0.reshape(-1), y0.reshape(-1)
    x1 = torch.clamp(x0 + RASTER_TILE, max=W) - 1
    y1 = torch.clamp(y0 + RASTER_TILE, max=H) - 1
    rect = torch.stack([x0, x1, y0, y1], 1).double()
    return rect, (x1 - x0 + 1) * (y1 - y0 + 1)


def tile_face_keep(tri: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Which faces kernel C walks for each 16 x 16 tile: (n_tiles, F) bool,
    tiles in launch order.  The mirror of ``csrc/rasterize.cu::rc_skip``,
    which holds the certificate: a face is dropped for a tile only where
    it can cover none of the tile's pixel centres under the walk's rounded
    ``inside`` test, so the walk over the kept faces in ascending order
    equals :func:`raster_plain` bit for bit.  The same float32 and float64
    operations in the same order as the kernel, so the two decide alike."""
    rect, _ = _tiles(H, W, tri.device)
    t = tri.float()
    area = (t[:, 3] - t[:, 0]) * (t[:, 7] - t[:, 1]) \
        - (t[:, 4] - t[:, 1]) * (t[:, 6] - t[:, 0])
    trivial = ~(area.abs() >= 1e-12)                             # (a)
    G, E, K, LIM = 2.0 ** -21, 2.0 ** -100, 2.0 ** -100, 2.0 ** 60
    ax, ay, bx, by, cx, cy = (t[:, k].double() for k in (0, 1, 3, 4, 6, 7))
    bounded = torch.stack([ax, ay, bx, by, cx, cy]).abs().le(LIM).all(0)
    A = area.abs().double()
    aerr = G * (((bx - ax) * (cy - ay)).abs()
                + ((by - ay) * (cx - ax)).abs()) + E
    solid = bounded & (aerr < 0.5 * A)
    fx0 = torch.minimum(torch.minimum(ax, bx), cx)
    fx1 = torch.maximum(torch.maximum(ax, bx), cx)
    fy0 = torch.minimum(torch.minimum(ay, by), cy)
    fy1 = torch.maximum(torch.maximum(ay, by), cy)
    X0, X1, Y0, Y1 = (rect[:, k:k + 1] for k in range(4))

    def edge_t(ex, ey, vx, vy):
        return ex.abs() * torch.maximum((Y0 - vy).abs(), (Y1 - vy).abs()) \
            + ey.abs() * torch.maximum((X0 - vx).abs(), (X1 - vx).abs())

    tmax = torch.maximum(torch.maximum(edge_t(cx - bx, cy - by, bx, by),
                                       edge_t(ax - cx, ay - cy, cx, cy)),
                         edge_t(bx - ax, by - ay, ax, ay))
    margin = (G * tmax + K * A + E) * (1.0 + 2.0 ** -20)
    wx, wy = fx1 - fx0, fy1 - fy0
    dx = torch.maximum(fx0 - X1, X0 - fx1)
    dy = torch.maximum(fy0 - Y1, Y0 - fy1)
    beside = ((wx > 0) & (dx > 0) & (dx * A > 4.0 * wx * margin)) \
        | ((wy > 0) & (dy > 0) & (dy * A > 4.0 * wy * margin))
    return ~(trivial | (solid & beside))


def raster_work(tri: torch.Tensor, H: int, W: int) -> dict:
    """What kernel C does on these faces: its tiles, the (tile, face) tests
    (every face in every tile), those that reach the float64 certificate
    (a face of area >= 1e-12 whose box misses the tile), the faces kept and
    the (pixel, face) pairs the walk evaluates (the kept faces times the
    tile's pixels)."""
    keep = tile_face_keep(tri, H, W)
    rect, npix = _tiles(H, W, tri.device)
    t = tri.float()
    area = (t[:, 3] - t[:, 0]) * (t[:, 7] - t[:, 1]) \
        - (t[:, 4] - t[:, 1]) * (t[:, 6] - t[:, 0])
    xs, ys = t[:, [0, 3, 6]].double(), t[:, [1, 4, 7]].double()
    X0, X1, Y0, Y1 = (rect[:, k:k + 1] for k in range(4))
    misses = (X1 < xs.amin(1)) | (X0 > xs.amax(1)) | (Y1 < ys.amin(1)) \
        | (Y0 > ys.amax(1))
    return dict(tiles=keep.shape[0], tests=keep.numel(),
                certified=int((misses & (area.abs() >= 1e-12)).sum()),
                kept=int(keep.sum()),
                pairs=int((keep.sum(1) * npix).sum()))


def raster_cuda(tri: torch.Tensor, H: int, W: int):
    """Kernel C on packed (F, 9) CUDA faces; same contract as
    :func:`raster_plain`."""
    global launches
    F = tri.shape[0]
    _cuda.require(tri, "tri", torch.float32, (F, 9))
    face = torch.empty(H * W, dtype=torch.int32, device=tri.device)
    zbuf = torch.empty(H * W, dtype=torch.float32, device=tri.device)
    rc = _cuda.lib().vt_raster(tri.data_ptr(), F, H, W, face.data_ptr(),
                               zbuf.data_ptr(), _cuda.stream_ptr(tri.device))
    _cuda.check(rc, "vt_raster")
    launches += 1
    return face, zbuf


def rasterize_zbuffer(verts_xy: torch.Tensor, verts_z: torch.Tensor,
                      faces: torch.Tensor, H: int, W: int):
    """Rasterize a mesh with a z-buffer.

    Args:
      verts_xy: (V, 2) pixel coordinates; verts_z: (V,) depths;
      faces: (F, 3) int.
    Returns:
      pix_to_face (H*W,) int32 (-1 = background), bary (H*W, 3),
      zbuf (H*W,).
    """
    tri = _packed_faces(verts_xy.float(), verts_z.float(), faces)
    if tri.device.type == "cpu":
        face, zbuf = raster_plain(tri, H, W)
    else:
        face, zbuf = raster_cuda(tri, H, W)
    # barycentrics of the winning face only (rasterize_pallas.py:117-136)
    safe = face.clamp(min=0).long()
    t = verts_xy.float()[faces.long()[safe]]            # (HW, 3, 2)
    pix = torch.arange(H * W, device=tri.device)
    p = torch.stack([(pix % W).float(), (pix // W).float()], -1)

    def edge(o, d, q):
        return ((q[..., 0] - o[..., 0]) * (d[..., 1] - o[..., 1])
                - (q[..., 1] - o[..., 1]) * (d[..., 0] - o[..., 0]))

    a, b, c = t[:, 0], t[:, 1], t[:, 2]
    area = edge(a, b, c)
    denom = torch.where(area.abs() < 1e-12, torch.ones_like(area), area)
    bary = torch.stack([edge(b, c, p) / denom, edge(c, a, p) / denom,
                        edge(a, b, p) / denom], -1)
    hit = face >= 0
    bary = torch.where(hit[:, None], bary, torch.zeros_like(bary))
    zbuf = torch.where(hit, zbuf, torch.full_like(zbuf, float("inf")))
    return face, bary, zbuf


def vertex_visibility(verts_xy01: torch.Tensor, verts_z01: torch.Tensor,
                      faces: torch.Tensor, size: int = 256) -> torch.Tensor:
    """Per-vertex visibility by rasterizing the mesh at ``size``^2
    (reference ``get_visibility``, ``mesh_util.py:284-318``): a vertex is
    visible iff a face containing it wins the depth test at some pixel.

    Args:
      verts_xy01: (V, 2) in [0, 1]; verts_z01: (V, 1) or (V,); faces (F, 3).
    Returns:
      (V, 1) float 0/1.
    """
    V = verts_xy01.shape[0]
    F = faces.shape[0]
    pix_to_face, _, _ = rasterize_zbuffer(verts_xy01 * (size - 1.0),
                                          verts_z01.reshape(-1), faces,
                                          size, size)
    dev = verts_xy01.device
    hit = pix_to_face >= 0
    slot = torch.where(hit, pix_to_face, F).long()
    face_hit = torch.zeros(F + 1, device=dev).scatter_reduce(
        0, slot, hit.float(), "amax")[:F]
    vis = torch.zeros(V, device=dev).scatter_reduce(
        0, faces.reshape(-1).long(), face_hit.repeat_interleave(3), "amax")
    return vis[:, None]


def render_vis_map(verts: torch.Tensor, faces: torch.Tensor,
                   vert_vis: torch.Tensor, K: torch.Tensor, Rt: torch.Tensor,
                   H: int = 256, W: int = 256):
    """Ground-truth visibility map of the mesh in a target camera
    (``rasterize.py:155-185``; reference ``render_vis``,
    ``render_vis.py:181-226``): rasterize (kernel C on CUDA tensors), then
    interpolate the per-vertex visibility barycentrically on the winning
    face and binarise at 0.392; background reads 1.

    Args:
      verts (V, 3) world vertices; faces (F, 3); vert_vis (V, 1) 0/1;
      K (3, 3) or (4, 4) intrinsics; Rt (3, 4) or (4, 4) extrinsics
      (x_cam = R x + t).
    Returns:
      vis_rgb (3, H, W) in [0, 1], vis_map (1, H, W) in {0, 1}.
    """
    cam = verts @ Rt[:3, :3].T + Rt[:3, 3]
    z = cam[:, 2]
    u = cam[:, 0] / (z + 1e-8) * K[0, 0] + K[0, 2]
    v = cam[:, 1] / (z + 1e-8) * K[1, 1] + K[1, 2]
    pix_to_face, bary, _ = rasterize_zbuffer(torch.stack([u, v], -1), z,
                                             faces, H, W)
    vis_tri = vert_vis.reshape(-1)[faces.long()]               # (F, 3)
    interp = (vis_tri[pix_to_face.clamp(min=0).long()] * bary).sum(-1)
    bg = pix_to_face < 0
    one = torch.ones_like(interp)
    vis_rgb = torch.where(bg, one, interp)
    vis_bin = torch.where(bg, one, (interp >= 0.392).to(interp.dtype))
    return (vis_rgb.reshape(1, H, W).expand(3, H, W),
            vis_bin.reshape(1, H, W))
