"""Voxel grid ops of the dense ``sp_conv`` branch: vertex-feature scatter
and trilinear volume sampling (port of ``vanerf_tpu/ops/voxel.py``).

The JAX package computes these in plain XLA, outside any Pallas kernel, so
the port keeps them plain PyTorch.  Each op takes a batch: a stack of Bm
volumes (one a frame-view) and B elements, element e reading volume
e % Bm, as the batched kernels read their tables (``ops/_cuda.py::
batch_index``).

Determinism on the card: the scatter of :func:`scatter_to_grid` and the
backward of :func:`grid_sample_3d`'s row reads are ``index_put_`` with
``accumulate=True`` (advanced indexing), which CUDA runs as a sort of the
indices and ordered sums, without float atomics (``index_add_`` and the
backward of ``index_select`` add with atomics, and are not used here).
Where a volume's gradient is wanted and the volume fits kernel 13 (at most
8,192 voxels: 16^3 and smaller), the eight corner reads of an element go
through one :func:`~.onehot_gather.take_rows`, whose table gradient is the
kernel's stable counting sort and ordered sums.
"""

from __future__ import annotations

import torch

from ._cuda import batch_index
from .onehot_gather import take_rows, take_rows_route

VOXEL_SIZE = 0.005           # metres (the reference's 5 mm grid)


def scatter_to_grid(feat: torch.Tensor, coord: torch.Tensor,
                    grid_shape) -> torch.Tensor:
    """Scatter per-vertex features into dense channels-last volumes.

    Args:
      feat: (B, V, C); coord: (B, V, 3) integer [d, h, w] voxel indices,
        clipped into the grid.
      grid_shape: (D, H, W).
    Returns:
      (B, D, H, W, C), vertices sharing a voxel averaged: the sum, then
      divided by max(count, 1) (``voxel.py:15-33``).
    """
    D, H, W = (int(s) for s in grid_shape)
    B, V, C = feat.shape
    hi = torch.tensor([D - 1, H - 1, W - 1], device=coord.device)
    c = torch.minimum(coord.long().clamp(min=0), hi)
    flat = (c[..., 0] * H + c[..., 1]) * W + c[..., 2]
    flat = (flat + torch.arange(B, device=flat.device)[:, None]
            * (D * H * W)).reshape(-1)
    vol = feat.new_zeros(B * D * H * W, C).index_put(
        (flat,), feat.reshape(-1, C), accumulate=True)
    cnt = feat.new_zeros(B * D * H * W, 1).index_put(
        (flat,), feat.new_ones(B * V, 1), accumulate=True)
    return (vol / cnt.clamp(min=1.0)).reshape(B, D, H, W, C)


def _axis(v: torch.Tensor, n: int):
    """Corner indices, the upper corner's weight and the in-bounds test of
    one axis: both corners clamped into the grid, the point zeroed only
    where it lies more than half a voxel outside (``voxel.py:49-55``)."""
    v0 = torch.floor(v)
    w1 = v - v0
    i0 = v0.clamp(0, n - 1).long()
    i1 = (v0 + 1).clamp(0, n - 1).long()
    inb = (v >= -0.5) & (v <= n - 0.5)
    return i0, i1, w1[..., None], inb


def grid_sample_3d(vol: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear sampling of channels-last volumes at normalised points.

    Args:
      vol: (Bm, D, H, W, C).
      pts: (B, N, 3) in [-1, 1], ordered (w, h, d) (torch grid_sample's
        (x, y, z)), align_corners=True; element e reads volume e % Bm.
    Returns:
      (B, N, C).  Not ``F.grid_sample``: its zeros padding drops each
      outside corner on its own, where this clamps both corners into the
      grid and zeroes a point only more than half a voxel outside.
    """
    Bm, D, H, W, C = vol.shape
    B = pts.shape[0]
    x = (pts[..., 0] + 1.0) * 0.5 * (W - 1.0)
    y = (pts[..., 1] + 1.0) * 0.5 * (H - 1.0)
    z = (pts[..., 2] + 1.0) * 0.5 * (D - 1.0)
    x0, x1, wx, bx = _axis(x, W)
    y0, y1, wy, by = _axis(y, H)
    z0, z1, wz, bz = _axis(z, D)
    inb = (bx & by & bz)[..., None].to(vol.dtype)
    rows = torch.stack([(zi * H + yi) * W + xi
                        for zi in (z0, z1) for yi in (y0, y1)
                        for xi in (x0, x1)], 1)              # (B, 8, N)
    n_vox = D * H * W
    if take_rows_route(n_vox, vol):
        g = torch.stack([
            take_rows(vol[e % Bm].reshape(n_vox, C), rows[e].reshape(-1))
            for e in range(B)]).reshape(B, 8, -1, C)
    else:
        base = (batch_index(B, Bm, pts.device) * n_vox)[:, None, None]
        g = vol.reshape(Bm * n_vox, C)[rows + base]           # (B, 8, N, C)
    g000, g001, g010, g011, g100, g101, g110, g111 = g.unbind(1)
    c00 = g000 * (1 - wx) + g001 * wx
    c01 = g010 * (1 - wx) + g011 * wx
    c10 = g100 * (1 - wx) + g101 * wx
    c11 = g110 * (1 - wx) + g111 * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return (c0 * (1 - wz) + c1 * wz) * inb


def world_to_grid_coords(pts: torch.Tensor, bounds: torch.Tensor,
                         out_sh) -> torch.Tensor:
    """World points (B, N, 3) -> [-1, 1] grid coordinates in (w, h, d)
    order (reference ``get_grid_coords``, ``networks.py:396-407``), bounds
    (B, 2, 3) of each element, 5 mm voxels.  The (d, h, w) offsets are
    divided by ``out_sh`` in its given order; the callers pass the grid
    shape reversed, (W, H, D), as the JAX package's do, so on a non-cubic
    grid the depth offset is divided by W (mirrored on purpose)."""
    dhw = pts.flip(-1)                                       # xyz -> zyx
    min_dhw = bounds[:, 0].flip(-1)[:, None]
    dhw = (dhw - min_dhw) / VOXEL_SIZE
    out = torch.tensor([float(s) for s in out_sh], dtype=pts.dtype,
                       device=pts.device)
    dhw = dhw / out * 2.0 - 1.0
    return dhw.flip(-1)                                      # back to whd


def vertex_voxels(verts: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) vertices -> (B, V, 3) int [d, h, w] voxel indices from each
    element's bounds minimum, rounded half to even (``voxel_fusion.py:
    132-134``)."""
    off = (verts.flip(-1) - bounds[:, 0].flip(-1)[:, None]) / VOXEL_SIZE
    return torch.round(off).to(torch.int32)
