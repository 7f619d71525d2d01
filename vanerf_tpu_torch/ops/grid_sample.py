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

``VANERF_TWO_RES=1`` (:func:`feat_sample_two_res_nhwc`, the JAX package's
``grid_sample.py:112-250``): a coarse map sampled at the points of a finer
one rides the fine map's row gather.  Each fine row (y0, x0) also holds
the coarse map's 3x3 neighbourhood anchored at floor((y0, x0) r), r =
(Hc - 1) / (Hf - 1) <= 1, so the coarse cell of any point in that fine
cell starts at the anchor + {0, 1} on each axis and two 2-way selects an
axis pick its corners.  The coarse values equal :func:`feat_sample_nhwc`'s
but where a point lies within ~1 ulp of a coarse cell boundary (the
coarse coordinate, rounded on its own, may pick the neighbouring corners,
whose weight is ~0 there).  The packed table's rows are gathered as the
KNN vertex table's are (:func:`~.knn._take_batched`): without a graph by
kernel 10 (any row width), with a gradient wanted by ``take_rows`` or the
native gather.
"""

from __future__ import annotations

import torch

from ._cuda import batch_index
from .knn import _take_batched
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
    return feat_sample_nhwc(feat[None], uv[None])[0]


def feat_sample_nhwc(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(Bm, H, W, C) maps at (B, N, 2) coords -> (B, N, C), element e on
    map e % Bm (the G tiles of a frame in a tile group share the frame's
    map): one gather and lerp for the whole batch, or, where a map's
    gradient goes through kernel 13 (:func:`take_rows`), one
    :func:`take_rows` of the packed corners a batch element."""
    Bm, H, W, C = feat.shape
    B = uv.shape[0]
    x = ((uv[..., 0] + 1.0) * 0.5 * (W - 1.0)).clamp(0.0, W - 1.0)
    y = ((uv[..., 1] + 1.0) * 0.5 * (H - 1.0)).clamp(0.0, H - 1.0)
    x0 = torch.floor(x).clamp(0, W - 1)
    y0 = torch.floor(y).clamp(0, H - 1)
    wx = (x - x0)[..., None].to(feat.dtype)
    wy = (y - y0)[..., None].to(feat.dtype)
    ix0 = x0.long()
    iy0 = y0.long()
    if take_rows_route(H * W, feat):
        g = torch.stack([
            take_rows(pack_corners(feat[e % Bm]).reshape(H * W, 4 * C),
                      iy0[e] * W + ix0[e]) for e in range(B)])
        f00, f01, f10, f11 = torch.split(g, C, -1)
    else:
        ix1 = (ix0 + 1).clamp(max=W - 1)
        iy1 = (iy0 + 1).clamp(max=H - 1)
        flat = feat.reshape(Bm * H * W, C)
        base = (batch_index(B, Bm, uv.device) * (H * W))[:, None]
        f00 = flat[base + iy0 * W + ix0]
        f01 = flat[base + iy0 * W + ix1]
        f10 = flat[base + iy1 * W + ix0]
        f11 = flat[base + iy1 * W + ix1]
    top = f00 * (1 - wx) + f01 * wx
    bot = f10 * (1 - wx) + f11 * wx
    return top * (1 - wy) + bot * wy


# ---------------------------------------------------------------------------
# two-resolution sampling: one row gather serves two maps
# ---------------------------------------------------------------------------

def _coarse_base(fine_idx: torch.Tensor, n_fine: int, n_coarse: int
                 ) -> torch.Tensor:
    """floor(fine_idx r) in float32, r = (n_coarse - 1) / (n_fine - 1)
    rounded once to float32: the one expression both the pack and the
    lookup round alike (``grid_sample.py:131-136``)."""
    r = torch.tensor((n_coarse - 1.0) / (n_fine - 1.0), dtype=torch.float32,
                     device=fine_idx.device)
    return torch.floor(fine_idx.float() * r)


def pack_two_res(fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
    """(..., Hf, Wf, 4 Cf + 9 Cc): the fine map's 2x2 corner pack and the
    coarse map's 3x3 neighbourhood at each fine row's anchor (edge
    replicated), a map or a stack of them."""
    Hf, Wf = fine.shape[-3:-1]
    Hc, Wc = coarse.shape[-3:-1]
    sx = torch.cat([fine[..., 1:, :], fine[..., -1:, :]], -2)
    sy = torch.cat([fine[..., 1:, :, :], fine[..., -1:, :, :]], -3)
    sxy = torch.cat([sx[..., 1:, :, :], sx[..., -1:, :, :]], -3)
    dev = fine.device
    by = _coarse_base(torch.arange(Hf, device=dev), Hf, Hc).long()
    bx = _coarse_base(torch.arange(Wf, device=dev), Wf, Wc).long()
    blocks = []
    for a in range(3):
        # (..., Hf, Wc, Cc)
        rows_a = coarse[..., (by + a).clamp(0, Hc - 1), :, :]
        for b in range(3):
            blocks.append(rows_a[..., (bx + b).clamp(0, Wc - 1), :])
    return torch.cat([fine, sx, sy, sxy] + blocks, -1)


def feat_sample_two_res_nhwc(fine: torch.Tensor, coarse: torch.Tensor,
                             uv: torch.Tensor):
    """Bilinear-sample a fine and a coarse map with one row gather.

    fine (Bm, Hf, Wf, Cf), coarse (Bm, Hc, Wc, Cc) with Hc <= Hf and
    Wc <= Wf (cast to the fine map's dtype), uv (B, N, 2) in [-1, 1],
    element e on maps e % Bm.  Returns (B, N, Cf), (B, N, Cc): the fine
    values equal :func:`feat_sample_nhwc`'s, the coarse ones up to the
    boundary ulp in the module note."""
    Bm, Hf, Wf, Cf = fine.shape
    Hc, Wc, Cc = coarse.shape[1:]
    if Hf < 2 or Wf < 2 or Hc > Hf or Wc > Wf:
        raise ValueError(f"two-resolution sampling of a {Hc}x{Wc} map on a "
                         f"{Hf}x{Wf} one")
    coarse = coarse.to(fine.dtype)
    dt = fine.dtype
    x = ((uv[..., 0] + 1.0) * 0.5 * (Wf - 1.0)).clamp(0.0, Wf - 1.0)
    y = ((uv[..., 1] + 1.0) * 0.5 * (Hf - 1.0)).clamp(0.0, Hf - 1.0)
    x0 = torch.floor(x).clamp(0, Wf - 1)
    y0 = torch.floor(y).clamp(0, Hf - 1)
    wx = (x - x0)[..., None].to(dt)
    wy = (y - y0)[..., None].to(dt)
    table = pack_two_res(fine, coarse).reshape(Bm, Hf * Wf, 4 * Cf + 9 * Cc)
    g = _take_batched(table, (y0.long() * Wf + x0.long()).to(torch.int32))
    f00, f01, f10, f11 = torch.split(g[..., :4 * Cf], Cf, -1)
    fine_xy = ((f00 * (1 - wx) + f01 * wx) * (1 - wy)
               + (f10 * (1 - wx) + f11 * wx) * wy)

    # the coarse corners, their coordinates rounded as feat_sample_nhwc's
    xc = ((uv[..., 0] + 1.0) * 0.5 * (Wc - 1.0)).clamp(0.0, Wc - 1.0)
    yc = ((uv[..., 1] + 1.0) * 0.5 * (Hc - 1.0)).clamp(0.0, Hc - 1.0)
    xc0 = torch.floor(xc).clamp(0, Wc - 1)
    yc0 = torch.floor(yc).clamp(0, Hc - 1)
    wxc = (xc - xc0)[..., None].to(dt)
    wyc = (yc - yc0)[..., None].to(dt)
    # xc0 - anchor is 0 or 1 (r <= 1, one rounding for both)
    dx = ((xc0 - _coarse_base(x0, Wf, Wc)).clamp(0.0, 1.0) > 0.5)[..., None]
    dy = ((yc0 - _coarse_base(y0, Hf, Hc)).clamp(0.0, 1.0) > 0.5)[..., None]

    def blk(a, b):
        o = 4 * Cf + (a * 3 + b) * Cc
        return g[..., o:o + Cc]

    def corner(a, b):
        """The corner (a, b) of the cell, rows a + dy, columns b + dx."""
        return torch.where(dx, torch.where(dy, blk(a + 1, b + 1),
                                           blk(a, b + 1)),
                           torch.where(dy, blk(a + 1, b), blk(a, b)))

    c00, c01, c10, c11 = corner(0, 0), corner(0, 1), corner(1, 0), corner(1, 1)
    coarse_xy = ((c00 * (1 - wxc) + c01 * wxc) * (1 - wyc)
                 + (c10 * (1 - wxc) + c11 * wxc) * wyc)
    return fine_xy, coarse_xy
