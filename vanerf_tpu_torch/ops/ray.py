"""Camera rays and ray/AABB intersection (port of ``vanerf_tpu/ops/ray.py``):
numpy copies for the input pipeline, torch functions for the renderer."""

from __future__ import annotations

import numpy as np
import torch


# ------------------------- numpy (input pipeline) --------------------------

def get_rays_np(H: int, W: int, K: np.ndarray, R: np.ndarray, T: np.ndarray):
    """Per-pixel world rays, numpy (``vanerf_tpu/ops/ray.py:18``; reference
    ``dataset.py:609-623``)."""
    rays_o = -np.dot(R.T, T).ravel()
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = np.dot(xy1, np.linalg.inv(K).T)
    pixel_world = np.dot(pixel_camera - T.ravel(), R)
    rays_d = pixel_world - rays_o[None, None]
    rays_o = np.broadcast_to(rays_o, rays_d.shape)
    return rays_o, rays_d


def get_near_far_np(bounds: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray,
                    boffset=(-0.01, 0.01)):
    """Ray/AABB near-far by the 6-plane method in float32, near / far as
    |t| (``vanerf_tpu/ops/ray.py:31``; reference ``dataset.py:625-658``).
    Returns near (M,), far (M,) of the M rays that hit, and the (N,) hit
    mask."""
    dt = np.float32
    bounds = bounds.astype(dt) + np.asarray(boffset, dt)[:, None]
    ray_o = ray_o.astype(dt, copy=False)
    ray_d = ray_d.astype(dt, copy=True)
    ray_d[np.abs(ray_d) < 1e-5] = 1e-5
    t_hit = ((bounds[None] - ray_o[:, None]) / ray_d[:, None]) \
        .reshape(-1, 6)                                       # (N, 6)
    p = t_hit[..., None] * ray_d[:, None] + ray_o[:, None]    # (N, 6, 3)
    eps = dt(1e-6)
    ok = ((p >= (bounds[0] - eps)) & (p <= (bounds[1] + eps))).all(-1)
    mask_at_box = ok.sum(-1) == 2
    ta = np.abs(t_hit)
    near = np.where(ok, ta, np.inf).min(-1)[mask_at_box]
    far = np.where(ok, ta, -np.inf).max(-1)[mask_at_box]
    return near, far, mask_at_box


# ------------------------------ torch (on device) --------------------------


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
