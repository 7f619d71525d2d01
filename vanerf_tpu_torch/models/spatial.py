"""Keypoint-relative spatial encoding (port of
``vanerf_tpu/models/spatial.py``; reference ``src/spatial.py:4-134``).

Only ``rel_z_decay`` — the shipped configs' type — is ported; the other
nine types raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def position_embedding(x: torch.Tensor, nlevels: int, scale: float = 1.0,
                       weight: torch.Tensor | None = None) -> torch.Tensor:
    """[x, sin(pi x), cos(pi x), sin(2 pi x), cos(2 pi x), ...], each part
    optionally multiplied by ``weight``.  Octaves come from the double-angle
    recurrence sin 2a = 2 sin a cos a, cos 2a = 1 - 2 sin^2 a, as the JAX
    package computes them."""
    if nlevels <= 0:
        return x if weight is None else x * weight
    a = (scale * math.pi) * x
    s = torch.sin(a)
    c = torch.cos(a)
    parts = [x]
    for _ in range(nlevels):
        parts.append(s)
        parts.append(c)
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
    if weight is not None:
        parts = [p * weight for p in parts]
    return torch.cat(parts, -1)


@dataclasses.dataclass(frozen=True)
class SpatialEncoder:
    sp_level: int = 3
    sp_type: str = "rel_z_decay"
    scale: float = 1.0
    n_kpt: int = 42
    sigma: float = 0.1

    def __post_init__(self):
        if self.sp_type != "rel_z_decay":
            raise NotImplementedError(
                f"sp_type {self.sp_type!r}: the port has rel_z_decay only")

    def get_dim(self) -> int:
        """Output width (spatial.py:45-57)."""
        return (1 + 2 * self.sp_level) * self.n_kpt

    def __call__(self, *, v, extrin, kpt3d):
        """Encode query points.

        v: (B, N, 3) world points; extrin: (B, 4, 4) world->camera;
        kpt3d: (B, K, 3).  Returns (B, N, (1 + 2L) * K).
        """
        if kpt3d.shape[1] != self.n_kpt:
            raise ValueError(f"{kpt3d.shape[1]} keypoints, the encoder was "
                             f"built for {self.n_kpt}")
        R = extrin[:, :3, :3].transpose(-1, -2)
        t = extrin[:, None, :3, 3]
        cxyz = v @ R + t
        kptxyz = kpt3d @ R + t
        dz = self.scale * (cxyz[:, :, None, 2:3] - kptxyz[:, None, :, 2:3])
        dxyz = cxyz[:, :, None] - kptxyz[:, None, :]
        w = torch.exp(-(dxyz ** 2).sum(-1, keepdim=True)
                      / (2.0 * self.sigma ** 2))
        w = w.reshape(*w.shape[:2], -1)                       # (B, N, K)
        return position_embedding(dz.reshape(*dz.shape[:2], -1),
                                  self.sp_level, weight=w)
