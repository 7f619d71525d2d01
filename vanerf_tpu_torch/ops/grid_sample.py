"""Bilinear feature sampling (port of ``vanerf_tpu/ops/grid_sample.py``).

Semantics of the reference ``feat_sample`` (``src/utils.py:136-151``,
``F.grid_sample`` bilinear, border padding, align_corners=True) on
channels-last maps, as gather + lerp.  The JAX package runs this op in
XLA, so the port keeps it plain PyTorch, except that a small map whose
gradient is wanted is read through :func:`take_rows` on its packed 2x2
corners (``grid_sample.py:56-69``), whose table gradient is kernel 13.
The lerp runs in the map's dtype (``grid_sample.py:70-77``): on a bfloat16
map the weights are rounded to bfloat16 and every product and sum rounds
in bfloat16, and autograd differentiates it as it stands.

A map of more than ``SCATTER_MAX_T`` (8,192) texels keeps the native
gather, whose backward is torch's ``index_put_(accumulate=True)``: on the
training path of ``configs/vanerf.json`` the 128^2 x 8 fine geometry map
(16,384 rows; the 64^2 texture map and the 32^2 coarse map take
``take_rows``).  On a bfloat16 map that backward rounds every add to
bfloat16 on the CPU, as XLA's native scatter does on every backend (the
JAX package takes it there off a TPU), and on the card it sums in float32
and rounds once (``chip_smoke.py`` phase 5d: 300 ones into one row give
300, not 256).
"""

from __future__ import annotations

import torch

from .onehot_gather import take_rows, take_rows_route


def pack_corners(feat: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W, 4C): packed[y, x] = [f(y,x), f(y,x+1), f(y+1,x),
    f(y+1,x+1)] with edge replication, so one row gather at (y0, x0)
    fetches all four bilinear corners."""
    sx = torch.cat([feat[:, 1:], feat[:, -1:]], 1)
    sy = torch.cat([feat[1:], feat[-1:]], 0)
    sxy = torch.cat([sx[1:], sx[-1:]], 0)
    return torch.cat([feat, sx, sy, sxy], -1)


def grid_sample_2d(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(H, W, C) map at (N, 2) coords in [-1, 1] (x, y) -> (N, C)."""
    H, W, C = feat.shape
    x = ((uv[:, 0] + 1.0) * 0.5 * (W - 1.0)).clamp(0.0, W - 1.0)
    y = ((uv[:, 1] + 1.0) * 0.5 * (H - 1.0)).clamp(0.0, H - 1.0)
    x0 = torch.floor(x).clamp(0, W - 1)
    y0 = torch.floor(y).clamp(0, H - 1)
    wx = (x - x0)[:, None].to(feat.dtype)
    wy = (y - y0)[:, None].to(feat.dtype)
    ix0 = x0.long()
    iy0 = y0.long()
    if take_rows_route(H * W, feat):
        g = take_rows(pack_corners(feat).reshape(H * W, 4 * C),
                      iy0 * W + ix0)
        f00, f01, f10, f11 = torch.split(g, C, -1)
    else:
        ix1 = (ix0 + 1).clamp(max=W - 1)
        iy1 = (iy0 + 1).clamp(max=H - 1)
        flat = feat.reshape(H * W, C)
        f00 = flat[iy0 * W + ix0]
        f01 = flat[iy0 * W + ix1]
        f10 = flat[iy1 * W + ix0]
        f11 = flat[iy1 * W + ix1]
    top = f00 * (1 - wx) + f01 * wx
    bot = f10 * (1 - wx) + f11 * wx
    return top * (1 - wy) + bot * wy


def feat_sample_nhwc(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) maps at (B, N, 2) coords -> (B, N, C)."""
    return torch.stack([grid_sample_2d(feat[b], uv[b])
                        for b in range(feat.shape[0])])
