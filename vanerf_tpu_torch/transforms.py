"""Coordinate transforms (world/camera/pixel), numpy + torch variants, port
of ``vanerf_tpu/transforms.py``.

Capability parity with reference ``src/transforms.py:4-42`` and the projection
idioms used throughout ``src/model.py`` (e.g. ``model.py:780-788``).  All
functions are pure and shape-polymorphic over leading batch dims.  The
renderer and the model keep private copies of these formulas on their hot
paths (``renderer.py::_project01``, ``models/vanerf.py``).
"""

from __future__ import annotations

import numpy as np
import torch


# --------------------------- numpy (input pipeline) ------------------------

def cam2pixel(cam_coord: np.ndarray, f, c) -> np.ndarray:
    """Perspective projection; ``(N,3) cam -> (N,3) [u,v,z]``."""
    x = cam_coord[:, 0] / (cam_coord[:, 2] + 1e-8) * f[0] + c[0]
    y = cam_coord[:, 1] / (cam_coord[:, 2] + 1e-8) * f[1] + c[1]
    z = cam_coord[:, 2]
    return np.stack([x, y, z], axis=1)


def pixel2cam(pixel_coord: np.ndarray, f, c) -> np.ndarray:
    x = (pixel_coord[:, 0] - c[0]) / f[0] * pixel_coord[:, 2]
    y = (pixel_coord[:, 1] - c[1]) / f[1] * pixel_coord[:, 2]
    z = pixel_coord[:, 2]
    return np.stack([x, y, z], axis=1)


def world2cam(world_coord: np.ndarray, R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """``(3,N)`` world points -> camera frame, ``x_c = R (x_w - T)``."""
    return np.dot(R, world_coord - T.reshape(3, 1))


def cam2world(cam_coord: np.ndarray, R: np.ndarray, T: np.ndarray) -> np.ndarray:
    return np.dot(np.linalg.inv(R), cam_coord) + T


# ------------------------------ torch (on device) ---------------------------

def project_points(pts: torch.Tensor, krt: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Project world points with a 4x4 KRT into pixel coords.

    Args:
      pts: (..., N, 3) world points.
      krt: (..., 4, 4) combined intrinsic @ extrinsic.
    Returns:
      xy: (..., N, 2) pixel coordinates, z: (..., N, 1) camera depth.

    Matches ``model.py:780-783`` (homogeneous transform then divide by z).
    """
    vh = pts @ krt[..., :3, :3].transpose(-1, -2) + krt[..., None, :3, 3]
    z = vh[..., 2:3]
    xy = vh[..., :2] / (z + 1e-8)
    return xy, z


def normalize_pixel(xy: torch.Tensor, width, height) -> torch.Tensor:
    """Pixel coords -> [-1, 1] NDC with align_corners=True semantics
    (``model.py:786-787``)."""
    x = 2.0 * (xy[..., 0] / (width - 1.0)) - 1.0
    y = 2.0 * (xy[..., 1] / (height - 1.0)) - 1.0
    return torch.stack([x, y], dim=-1)


def normalize_depth(z: torch.Tensor, znear, zfar) -> torch.Tensor:
    """Camera z -> [-1, 1] (``model.py:788``)."""
    return 2.0 * (z - znear) / (zfar - znear) - 1.0


def make_krt(K: torch.Tensor, Rt: torch.Tensor):
    """Assemble 4x4 KRT from (...,3,3) K and (...,3,4) Rt
    (``model.py:306-312``).  Returns (krt, intrin, extrin)."""
    batch = torch.broadcast_shapes(K.shape[:-2], Rt.shape[:-2])
    eye = torch.eye(4, dtype=K.dtype, device=K.device).expand(
        batch + (4, 4))
    intrin = eye.clone()
    intrin[..., :3, :3] = K[..., :3, :3]
    extrin = eye.clone()
    extrin[..., :3, :4] = Rt
    return intrin @ extrin, intrin, extrin
