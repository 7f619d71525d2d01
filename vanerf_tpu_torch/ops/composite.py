"""Volume compositing (port of ``vanerf_tpu/ops/composite.py``; reference
``VANeRF.rgba2out``, ``model.py:1464-1494``)."""

from __future__ import annotations

import torch


def sdf_activation(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """sigma = sigmoid(x / beta) / beta with beta clamped >= 2e-3."""
    beta = torch.clamp(beta, min=2e-3)
    return torch.sigmoid(x / beta) / beta


def rgba2out(rad: torch.Tensor, sdf: torch.Tensor, rgb: torch.Tensor,
             z: torch.Tensor, query_sdf: torch.Tensor, beta: torch.Tensor,
             use_sdf_prior: bool = True):
    """Composite per-sample predictions into per-ray outputs.

    Args:
      rad, sdf, z, query_sdf: (B, N, D); rgb: (B, N, D, 3); beta: (1,).
    Returns:
      color (B, N, 3), depth (B, N), alpha (B, N), contrib (B, N, D),
      sdf_out (B, N).
    """
    if use_sdf_prior:
        alpha = sdf_activation(-(rad + query_sdf), beta)
    else:
        alpha = rad
    dist = torch.cat([z[..., 1:] - z[..., :-1],
                      torch.full_like(z[..., :1], 1e10)], -1)
    contrib = 1.0 - torch.exp(-alpha * dist)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(contrib[..., :1]),
                   1.0 - contrib[..., :-1]], -1), -1)
    contrib = contrib * trans
    color = (rgb * contrib[..., None]).sum(-2)
    acc = contrib.sum(-1)
    sdf_out = (sdf * contrib).sum(-1) / (acc + 1e-8)
    depth = (z * contrib).sum(-1) / (acc + 1e-8)
    return color, depth, acc, contrib, sdf_out
