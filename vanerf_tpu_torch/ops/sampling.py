"""Stratified + inverse-CDF importance sampling (port of
``vanerf_tpu/ops/sampling.py``; reference ``model.py:1222-1232``,
``model.py:1424-1462``).  Without uniforms both are the deterministic eval
form (``uniform=True``); the training draws come in as an explicit tensor
``u`` (the caller draws them, or a test feeds the JAX draws)."""

from __future__ import annotations

import torch


def stratified_sample(znear: torch.Tensor, zfar: torch.Tensor,
                      n_samples: int, u: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Depths along each ray: (..., 1) bounds -> (..., n_samples).

    Evenly spaced without ``u``; with uniforms ``u`` (..., n_samples) in
    [0, 1), each depth is jittered inside its stratum (the midpoints of the
    evenly spaced depths bound the strata)."""
    z = torch.linspace(0.0, 1.0, n_samples, dtype=znear.dtype,
                       device=znear.device)
    z = z.expand(*znear.shape[:-1], n_samples)
    if u is not None:
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        z_lower = torch.cat([z[..., :1], z_mid], -1)
        z_upper = torch.cat([z_mid, z[..., -1:]], -1)
        z = z_lower + u * (z_upper - z_lower)
    return znear + (zfar - znear) * z


def importance_sample(contrib: torch.Tensor, z: torch.Tensor,
                      n_samples: int, u: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Inverse-CDF samples of new depths, at evenly spaced quantiles or at
    the uniforms ``u`` (B, N, n_samples).

    Args:
      contrib: (B, N, D-1) per-bin weights; z: (B, N, D) sorted bin edges.
    Returns:
      (B, N, n_samples) depths (+1e-5 floor, right-searchsorted,
      degenerate-bin guard, as the reference).
    """
    assert contrib.shape[-1] == z.shape[-1] - 1
    contrib = contrib + 1e-5
    pdf = contrib / contrib.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)     # (B,N,D)
    if u is None:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=z.dtype,
                           device=z.device).expand(*cdf.shape[:-1],
                                                   n_samples)
    u = u.contiguous()
    D = cdf.shape[-1]
    # right-searchsorted: prev = last edge with cdf <= u, next = the one
    # after, both clipped to the last edge (model.py:1449-1453)
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    i_prev = (idx - 1).clamp(min=0)
    i_next = idx.clamp(max=D - 1)
    cdf_prev = torch.gather(cdf, -1, i_prev)
    cdf_next = torch.gather(cdf, -1, i_next)
    z_prev = torch.gather(z, -1, i_prev)
    z_next = torch.gather(z, -1, i_next)
    num = u - cdf_prev
    den = cdf_next - cdf_prev
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return z_prev + (num / den) * (z_next - z_prev)
