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


def raster_plain(tri: torch.Tensor, H: int, W: int):
    """Plain-PyTorch z-buffer over packed (F, 9) faces -> face (H*W,) int32
    (-1 = background), zbuf (H*W,) (inf = background).  The arithmetic of
    ``rasterize_pallas.py:48-66``; ties go to the lowest face index."""
    ax, ay, az, bx, by, bz, cx, cy, cz = [tri[:, k] for k in range(9)]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    ok = area.abs() >= 1e-12
    den = torch.where(ok, area, torch.ones_like(area))
    pix = torch.arange(H * W, device=tri.device)
    faces, zs = [], []
    for p in torch.split(pix, 2048):
        px = (p % W).float()[:, None]
        py = (p // W).float()[:, None]
        w0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
        w1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
        w2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        b0 = w0 / den
        b1 = w1 / den
        b2 = w2 / den
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & ok
        zi = b0 * az + b1 * bz + b2 * cz
        zi = torch.where(inside, zi, torch.full_like(zi, float("inf")))
        if zi.shape[1] == 0:
            zmin = torch.full((p.shape[0],), float("inf"), device=tri.device)
            fidx = torch.zeros(p.shape[0], dtype=torch.long,
                               device=tri.device)
        else:
            zmin, fidx = zi.min(-1)
        hit = torch.isfinite(zmin)
        faces.append(torch.where(hit, fidx, -1).int())
        zs.append(zmin)
    return torch.cat(faces), torch.cat(zs)


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
