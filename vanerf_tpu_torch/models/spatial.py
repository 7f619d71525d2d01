"""Keypoint-relative spatial encoding (port of
``vanerf_tpu/models/spatial.py``; reference ``src/spatial.py:4-134``).

All ten ``sp_type``s: ``z``, ``ixyz``, ``cxyz``, ``wxyz``, ``mxyz``,
``rel_z``, ``rel_z_decay`` (the shipped configs' type), ``rel_cxyz``,
``rel_wxyz`` and ``rel_mxyz``.  The model-space types take the points
before the view expansion through a per-batch model transform ``model_T``
(B, 4, 4), which the renderer forwards from ``batch["model_T"]``; without
it they raise ``ValueError``, as the JAX package does (the reference never
reaches them: its ``sp_data`` has no ``'T'``).  ``VANERF_PE_DIRECT=1``
computes each octave's sin / cos pair from ``2**lv * a`` instead of the
double-angle recurrence (``vanerf_tpu/models/spatial.py:46-58``).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

SP_TYPES = ("z", "ixyz", "cxyz", "wxyz", "mxyz", "rel_z", "rel_z_decay",
            "rel_cxyz", "rel_wxyz", "rel_mxyz")


def position_embedding(x: torch.Tensor, nlevels: int, scale: float = 1.0,
                       weight: torch.Tensor | None = None) -> torch.Tensor:
    """[x, sin(pi x), cos(pi x), sin(2 pi x), cos(2 pi x), ...], each part
    optionally multiplied by ``weight``.  Octaves come from the double-angle
    recurrence sin 2a = 2 sin a cos a, cos 2a = 1 - 2 sin^2 a, as the JAX
    package computes them, or under ``VANERF_PE_DIRECT`` (not "0") from one
    sin / cos pair an octave of ``2**lv * a``."""
    if nlevels <= 0:
        return x if weight is None else x * weight
    a = (scale * math.pi) * x
    parts = [x]
    if os.environ.get("VANERF_PE_DIRECT", "0") != "0":
        for lv in range(nlevels):
            f = float(2 ** lv) * a
            parts.append(torch.sin(f))
            parts.append(torch.cos(f))
    else:
        s = torch.sin(a)
        c = torch.cos(a)
        for _ in range(nlevels):
            parts.append(s)
            parts.append(c)
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
    if weight is not None:
        parts = [p * weight for p in parts]
    return torch.cat(parts, -1)


def _rigid(x: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points through (B, 4, 4) transforms: x R^T + t."""
    return x @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]


@dataclasses.dataclass(frozen=True)
class SpatialEncoder:
    sp_level: int = 3
    sp_type: str = "rel_z_decay"
    scale: float = 1.0
    n_kpt: int = 42
    sigma: float = 0.1
    center: tuple = (0.0, 0.0, 0.0)

    def get_dim(self) -> int:
        """Output width (spatial.py:45-57); 0 for an unknown type, which
        raises at the call."""
        t = self.sp_type
        per = 1 + 2 * self.sp_level
        if t in ("z", "rel_z", "rel_z_decay"):
            return per * self.n_kpt if "rel" in t else per
        if "xyz" in t:
            return per * 3 * self.n_kpt if "rel" in t else per * 3
        return 0

    def __call__(self, *, v, pts=None, z=None, xy=None, extrin, kpt3d=None,
                 n_view: int = 1, model_T=None):
        """Encode query points.

        v: (B V, N, 3) world points, each repeated per source view; pts:
        (B, N, 3) the points before that repetition (``mxyz`` /
        ``rel_mxyz``); z: (B V, N, 1) normalised depth and xy: (B V, N, 2)
        normalised pixel coordinates (``z``, ``ixyz``); extrin: (B V, 4, 4)
        world->camera of each element's view; kpt3d: (B, K, 3), repeated
        per view here (the ``rel_*`` types); model_T: (B, 4, 4).  Returns
        (B V, N, :meth:`get_dim`).
        """
        t = self.sp_type
        if t not in SP_TYPES:
            raise ValueError(
                f"unknown sp_type '{t}'; valid: {', '.join(SP_TYPES)}")
        L = self.sp_level

        def per_view(x):
            return x if n_view == 1 else x.repeat_interleave(n_view, 0)

        if "rel" in t and (kpt3d is None or kpt3d.shape[1] != self.n_kpt):
            raise ValueError(
                f"sp_type '{t}' needs (B, {self.n_kpt}, 3) keypoints, got "
                f"{None if kpt3d is None else tuple(kpt3d.shape)}")
        if t == "z":
            return position_embedding(z, L)
        if t == "ixyz":
            return position_embedding(torch.cat([xy, z], -1), L)
        if t == "wxyz":
            c = torch.tensor(self.center, dtype=v.dtype, device=v.device)
            return position_embedding(self.scale * (v - c), L)
        if t in ("mxyz", "rel_mxyz"):
            # model-space encoding, once a batch row, then per view
            if model_T is None:
                raise ValueError(
                    f"sp_type '{t}' needs a (B,4,4) model transform: pass "
                    "model_T (renderer: batch['model_T'])")
            m = self.scale * _rigid(pts, model_T)
            if t == "mxyz":
                return per_view(position_embedding(m, L))
            km = self.scale * _rigid(kpt3d, model_T)
            d = m[:, :, None] - km[:, None]
            return per_view(position_embedding(d.reshape(*d.shape[:2], -1),
                                               L))
        if t == "rel_wxyz":
            d = v[:, :, None] - per_view(kpt3d)[:, None]
            return position_embedding(d.reshape(*d.shape[:2], -1), L)
        cxyz = _rigid(v, extrin)
        if t == "cxyz":
            return position_embedding(cxyz, L)
        kptxyz = _rigid(per_view(kpt3d), extrin)
        if t == "rel_cxyz":
            d = self.scale * (cxyz[:, :, None] - kptxyz[:, None])
            return position_embedding(d.reshape(*d.shape[:2], -1), L)
        dz = self.scale * (cxyz[:, :, None, 2:3] - kptxyz[:, None, :, 2:3])
        dz = dz.reshape(*dz.shape[:2], -1)                    # (B V, N, K)
        if t == "rel_z":
            return position_embedding(dz, L)
        dxyz = cxyz[:, :, None] - kptxyz[:, None, :]
        w = torch.exp(-(dxyz ** 2).sum(-1, keepdim=True)
                      / (2.0 * self.sigma ** 2))
        w = w.reshape(*w.shape[:2], -1)                       # (B V, N, K)
        return position_embedding(dz, L, weight=w)
