"""Camera rays and ray/AABB intersection (port of ``vanerf_tpu/ops/ray.py``)."""

from __future__ import annotations

import torch


def ray_bbox_intersection(bounds: torch.Tensor, orig: torch.Tensor,
                          direct: torch.Tensor, boffset=(-0.01, 0.01)):
    """Batched ray/AABB intersection, the 6-plane "exactly two hits" rule
    (reference ``model.py:1496-1570``) with |t| as the distance.

    Args:
      bounds: (B, 2, 3); orig: (B, 1, 3); direct: (B, N, 3).
    Returns:
      near (B, N, 1), far (B, N, 1), hit (B, N, 1) bool.
    """
    off = torch.tensor(boffset, dtype=bounds.dtype, device=bounds.device)
    bounds = bounds + off[:, None]                                # (B, 2, 3)
    d = torch.where(direct.abs() < 1e-5,
                    torch.full_like(direct, 1e-5), direct)        # (B, N, 3)
    t = (bounds[:, None] - orig[:, :, None]) / d[:, :, None]      # (B,N,2,3)
    t = t.reshape(*t.shape[:2], 6)                                # (B, N, 6)
    p = t[..., None] * d[:, :, None] + orig[:, :, None]           # (B,N,6,3)
    eps = 1e-6
    lo = bounds[:, None, None, 0]
    hi = bounds[:, None, None, 1]
    inside = ((p >= lo - eps) & (p <= hi + eps)).all(-1)          # (B, N, 6)
    hit = inside.sum(-1) == 2
    ta = t.abs()
    inf = torch.full_like(ta, float("inf"))
    near = torch.where(inside, ta, inf).amin(-1)
    far = torch.where(inside, ta, -inf).amax(-1)
    one = torch.ones_like(near)
    near = torch.where(hit, near, one)
    far = torch.where(hit, far, one)
    return near[..., None], far[..., None], hit[..., None]


def pixel_grid_rays(grids: torch.Tensor, K: torch.Tensor, RT: torch.Tensor,
                    znear, zfar):
    """World-space rays for a batch of pixel grids (``model.py:1203-1213``).

    Args:
      grids: (B, P, 2) pixel coordinates (x, y).
      K: (B, 4, 4) or (B, 3, 3); RT: (B, 4, 4) or (B, 3, 4) [R|t].
      znear, zfar: scalars or (B,)-broadcastable.
    Returns:
      cam_pos (B, 1, 3), cam_rays (B, P, 3) unit, znear_rays (B, P, 1),
      zfar_rays (B, P, 1).
    """
    dt, dev = grids.dtype, grids.device
    grids_h = torch.cat([grids, torch.ones_like(grids[..., :1])], -1)
    inv_K = torch.linalg.inv(K[:, :3, :3])
    cam_rays = grids_h @ inv_K.transpose(-1, -2)
    znear = torch.as_tensor(znear, dtype=dt, device=dev).reshape(-1, 1, 1)
    zfar = torch.as_tensor(zfar, dtype=dt, device=dev).reshape(-1, 1, 1)
    znear_rays = torch.linalg.norm(znear * cam_rays, dim=-1, keepdim=True)
    zfar_rays = torch.linalg.norm(zfar * cam_rays, dim=-1, keepdim=True)
    R = RT[:, :3, :3]
    cam_rays = cam_rays @ R
    cam_rays = cam_rays / (torch.linalg.norm(cam_rays, dim=-1, keepdim=True)
                           + 1e-12)
    cam_pos = -(RT[:, None, :3, 3] @ R)                           # (B, 1, 3)
    return cam_pos, cam_rays, znear_rays, zfar_rays
