"""Nearest-vertex search and the K=1 vertex-feature gather (port of
``vanerf_tpu/ops/knn.py`` + ``ops/knn_pallas.py``).

:func:`nearest_vertex_d2` is kernel B (``csrc/knn.cu``) on CUDA tensors
and its plain-PyTorch twin :func:`nearest_vertex_d2_plain` on CPU tensors;
:func:`nearest_vertex_d2_T` is kernel 8, the same search on coordinate-major
(3, N) queries, with :func:`nearest_vertex_d2_T_plain`.  With
``VANERF_KNN_CULL`` set both take kernel 9, the landmark-culled search
(:func:`nearest_vertex_d2_culled`, :func:`nearest_vertex_d2_T_culled`):
tiles of 256 consecutive points skip the 128-vertex chunks whose box cannot
hold a tile point's nearest vertex, with results equal to B's bit for bit.
Under a graph the vertex-table gather goes through
:func:`~.onehot_gather.take_rows`, whose table gradient is kernel 13;
without one it goes through kernel 10,
:func:`~.interp_mxu.mxu_row_gather`.
"""

from __future__ import annotations

import os

import torch

from . import _cuda
from .interp_mxu import mxu_row_gather
from .onehot_gather import take_rows, take_rows_route

KNN_MAX_VERTS = 4096        # csrc/knn.cu: the vertex table in shared memory
# kernel 9: points per tile and vertices per chunk (knn_pallas TILE_P,
# VERT_CHUNK; csrc/knn.cu KNC_TILE, KNC_CHUNK)
CULL_TILE_P = 256
VERT_CHUNK = 128

# launches of kernels B, 8 and 9 in its two layouts (plain counters; callers
# reset them)
launches = 0
launches_T = 0
culled_launches = 0
culled_launches_T = 0


def nearest_vertex_d2_plain(query: torch.Tensor, verts: torch.Tensor):
    """Plain-PyTorch nearest vertex: (N, 3) x (V, 3) -> idx (N,) int32,
    d2 (N,) f32.  Difference form dx*dx + dy*dy + dz*dz, first index on
    ties (the kernel's arithmetic and tie-break)."""
    query = query.float()
    verts = verts.float()
    idx, d2 = [], []
    for q in torch.split(query, 4096):
        d = q[:, None, :] - verts[None]
        dd = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        m, i = dd.min(-1)
        idx.append(i.int())
        d2.append(m)
    return torch.cat(idx), torch.cat(d2)


def _launch(entry: str, query: torch.Tensor, N: int, verts: torch.Tensor):
    """One launch of kernel B (``vt_knn``, query (N, 3)) or kernel 8
    (``vt_knn_T``, query (3, N)); the caller counts it."""
    V = verts.shape[0]
    _cuda.require(verts, "verts", torch.float32, (V, 3), query.device)
    if not 0 < V <= KNN_MAX_VERTS:
        raise ValueError(f"nearest vertex: {V} vertices; the kernel holds "
                         f"at most {KNN_MAX_VERTS} in shared memory")
    idx = torch.empty(N, dtype=torch.int32, device=query.device)
    d2 = torch.empty(N, dtype=torch.float32, device=query.device)
    rc = getattr(_cuda.lib(), entry)(
        query.data_ptr(), N, verts.data_ptr(), V, idx.data_ptr(),
        d2.data_ptr(), _cuda.stream_ptr(query.device))
    _cuda.check(rc, entry)
    return idx, d2


def nearest_vertex_d2(query: torch.Tensor, verts: torch.Tensor):
    """Nearest vertex index + squared distance per query point.

    The squared distance is a certified upper bound on the point-to-mesh
    squared distance (vertices lie on the mesh).  ``VANERF_KNN_CULL`` set to
    any non-empty value takes the culled search, with the same results.

    Args:
      query: (N, 3); verts: (V, 3) float32, same device.
    Returns:
      idx (N,) int32, d2 (N,) float32.
    """
    if os.environ.get("VANERF_KNN_CULL"):
        return nearest_vertex_d2_culled(query, verts)
    if query.device.type == "cpu":
        return nearest_vertex_d2_plain(query, verts)
    global launches
    N = query.shape[0]
    _cuda.require(query, "query", torch.float32, (N, 3))
    out = _launch("vt_knn", query, N, verts)
    launches += 1
    return out


def nearest_vertex_d2_T_plain(query_T: torch.Tensor, verts: torch.Tensor):
    """Plain-PyTorch version of kernel 8: :func:`nearest_vertex_d2_plain`
    read through a strided (N, 3) view of the (3, N) queries (no copy)."""
    return nearest_vertex_d2_plain(query_T.t(), verts)


def nearest_vertex_d2_T(query_T: torch.Tensor, verts: torch.Tensor):
    """Coordinate-major :func:`nearest_vertex_d2`: kernel 8 on CUDA tensors,
    identical results to kernel B's on the transposed input.

    Args:
      query_T: (3, N) contiguous; verts: (V, 3) float32, same device.
    Returns:
      idx (N,) int32, d2 (N,) float32.
    """
    if os.environ.get("VANERF_KNN_CULL"):
        return nearest_vertex_d2_T_culled(query_T, verts)
    if query_T.device.type == "cpu":
        return nearest_vertex_d2_T_plain(query_T, verts)
    global launches_T
    N = query_T.shape[1]
    _cuda.require(query_T, "query_T", torch.float32, (3, N))
    out = _launch("vt_knn_T", query_T, N, verts)
    launches_T += 1
    return out


# ---------------------------------------------------------------------------
# kernel 9: the landmark-culled search (knn_pallas.py:140-321)
# ---------------------------------------------------------------------------

def _sq3(x: torch.Tensor) -> torch.Tensor:
    """x0*x0 + x1*x1 + x2*x2 over the last axis, in that written order (the
    kernel's)."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] \
        + x[..., 2] * x[..., 2]


def _edge_tiles(x: torch.Tensor, tile: int) -> torch.Tensor:
    """(N, ...) -> (ceil(N / tile), tile, ...) with the last row repeated
    into a ragged last tile (edge replication: a tile's box and the chunk
    boxes are then those of its real rows)."""
    n = x.shape[0]
    t = -(-n // tile)
    if t * tile != n:
        x = x[torch.arange(t * tile, device=x.device).clamp(max=n - 1)]
    return x.reshape(t, tile, *x.shape[1:])


def vertex_chunk_boxes(verts: torch.Tensor,
                       chunk: int = VERT_CHUNK) -> torch.Tensor:
    """Per vertex chunk (C, 10): box min (3), box max (3), box centre (3)
    and the half diagonal (``_knn_cull_lists``, ``knn_pallas.py:173-178``)."""
    vch = _edge_tiles(verts.float(), chunk)
    cmin, cmax = vch.amin(1), vch.amax(1)
    ccen = 0.5 * (cmin + cmax)
    crad = 0.5 * torch.sqrt(_sq3(cmax - cmin))
    return torch.cat([cmin, cmax, ccen, crad[:, None]], -1).contiguous()


def knn_cull_lists(tmin: torch.Tensor, tmax: torch.Tensor,
                   verts: torch.Tensor, chunk: int = VERT_CHUNK):
    """Which vertex chunks each point tile must visit.

    Per tile, ``ub_t = min_c (|farthest box corner - chunk centre| + chunk
    half diagonal)^2`` bounds every tile point's nearest-vertex squared
    distance from above, and per (tile, chunk) the box-to-box gap ``lb``
    bounds the distance to the chunk's vertices from below; a chunk is
    visited when ``lb <= ub_t * (1 + 1e-5) + 1e-12``
    (``_knn_cull_lists``, ``knn_pallas.py:162-198``, the expressions in
    their order).

    Args:
      tmin, tmax: (T, 3) boxes of the point tiles; verts: (V, 3).
    Returns:
      need (T, C) bool, counts (T,) int32 of visited chunks.
    """
    b = vertex_chunk_boxes(verts, chunk)
    cmin, cmax, ccen, crad = b[:, 0:3], b[:, 3:6], b[:, 6:9], b[:, 9]
    far = torch.maximum((ccen[None] - tmin[:, None]).abs(),
                        (ccen[None] - tmax[:, None]).abs())    # (T, C, 3)
    fard = torch.sqrt(_sq3(far)) + crad[None]
    m = fard.amin(1)
    ub_t = m * m
    gap = torch.clamp_min(torch.maximum(cmin[None] - tmax[:, None],
                                        tmin[:, None] - cmax[None]), 0.0)
    lb = _sq3(gap)
    need = lb <= ub_t[:, None] * (1.0 + 1e-5) + 1e-12
    return need, need.sum(1).int()


def nearest_vertex_d2_culled_plain(query: torch.Tensor, verts: torch.Tensor,
                                   visits: bool = False):
    """Plain-PyTorch version of kernel 9: :func:`nearest_vertex_d2_plain`
    with the pairs of unvisited (tile, chunk)s kept out of the minimum.
    Same contract as :func:`nearest_vertex_d2_culled`."""
    query = query.float()
    verts = verts.float()
    N, V = query.shape[0], verts.shape[0]
    if N == 0:
        out = nearest_vertex_d2_plain(query, verts)
        return out + (out[0].new_zeros(0),) if visits else out
    tiles = _edge_tiles(query, CULL_TILE_P)
    need, counts = knn_cull_lists(tiles.amin(1), tiles.amax(1), verts)
    inf = torch.tensor(float("inf"), device=query.device)
    idx, d2 = [], []
    for p0 in range(0, N, 4096):               # whole tiles: 4096 = 16 x 256
        q = query[p0:p0 + 4096]
        d = q[:, None, :] - verts[None]
        dd = _sq3(d)
        tile = torch.arange(p0, p0 + q.shape[0],
                            device=query.device) // CULL_TILE_P
        keep = need[tile].repeat_interleave(VERT_CHUNK, 1)[:, :V]
        m, i = torch.where(keep, dd, inf).min(-1)
        idx.append(i.int())
        d2.append(m)
    out = (torch.cat(idx), torch.cat(d2))
    return out + (counts,) if visits else out


def nearest_vertex_d2_T_culled_plain(query_T: torch.Tensor,
                                     verts: torch.Tensor,
                                     visits: bool = False):
    """Plain-PyTorch version of kernel 9 on (3, N) queries, read through a
    strided (N, 3) view (no copy)."""
    return nearest_vertex_d2_culled_plain(query_T.t(), verts, visits)


def _launch_culled(entry: str, query: torch.Tensor, N: int,
                   verts: torch.Tensor, visits: bool):
    """One launch of kernel 9 (``vt_knn_culled``, query (N, 3), or
    ``vt_knn_T_culled``, query (3, N)); the caller counts it.  The entry
    point fills ``boxes`` with the rows of :func:`vertex_chunk_boxes` by a
    small kernel of its own in front of the search: a dozen tensor ops
    here would cost the call more than the search saves."""
    V = verts.shape[0]
    dev = query.device
    _cuda.require(verts, "verts", torch.float32, (V, 3), dev)
    if not 0 < V <= KNN_MAX_VERTS:
        raise ValueError(f"nearest vertex: {V} vertices; the kernel holds "
                         f"at most {KNN_MAX_VERTS} in shared memory")
    boxes = torch.empty(-(-V // VERT_CHUNK), 10, dtype=torch.float32,
                        device=dev)
    idx = torch.empty(N, dtype=torch.int32, device=dev)
    d2 = torch.empty(N, dtype=torch.float32, device=dev)
    count = (torch.empty(-(-N // CULL_TILE_P), dtype=torch.int32, device=dev)
             if visits else None)
    rc = getattr(_cuda.lib(), entry)(
        query.data_ptr(), N, verts.data_ptr(), V, boxes.data_ptr(),
        boxes.shape[0], idx.data_ptr(), d2.data_ptr(),
        count.data_ptr() if visits else None, _cuda.stream_ptr(dev))
    _cuda.check(rc, entry)
    return (idx, d2, count) if visits else (idx, d2)


def vertex_chunk_boxes_cuda(verts: torch.Tensor) -> torch.Tensor:
    """Kernel 9's chunk-box kernel launched alone (``vt_knn_chunk_boxes``):
    the rows of :func:`vertex_chunk_boxes`, equal bit for bit.  The search's
    entry points launch it themselves in front of every search; this
    wrapper, which no path calls, lets its time be read apart."""
    V = verts.shape[0]
    _cuda.require(verts, "verts", torch.float32, (V, 3))
    if not 0 < V <= KNN_MAX_VERTS:
        raise ValueError(f"chunk boxes: {V} vertices; the kernel takes "
                         f"1 to {KNN_MAX_VERTS}")
    boxes = torch.empty(-(-V // VERT_CHUNK), 10, dtype=torch.float32,
                        device=verts.device)
    rc = _cuda.lib().vt_knn_chunk_boxes(verts.data_ptr(), V, boxes.data_ptr(),
                                        boxes.shape[0],
                                        _cuda.stream_ptr(verts.device))
    _cuda.check(rc, "vt_knn_chunk_boxes")
    return boxes


def nearest_vertex_d2_culled(query: torch.Tensor, verts: torch.Tensor,
                             visits: bool = False):
    """Kernel 9: :func:`nearest_vertex_d2` with landmark culling.  A tile of
    256 consecutive points (in the caller's order) visits only the chunks
    of 128 vertices that :func:`knn_cull_lists` keeps, in ascending order
    with kernel B's arithmetic and strict ``<``: idx and d2 equal B's bit
    for bit.  How much it skips depends on how compact the caller's tiles
    are.

    Args:
      query: (N, 3); verts: (V, 3) float32, same device.
      visits: also return the (ceil(N / 256),) int32 number of chunks each
        tile visited.
    Returns:
      idx (N,) int32, d2 (N,) float32[, visits].
    """
    if query.device.type == "cpu":
        return nearest_vertex_d2_culled_plain(query, verts, visits)
    global culled_launches
    N = query.shape[0]
    _cuda.require(query, "query", torch.float32, (N, 3))
    out = _launch_culled("vt_knn_culled", query, N, verts, visits)
    culled_launches += 1
    return out


def nearest_vertex_d2_T_culled(query_T: torch.Tensor, verts: torch.Tensor,
                               visits: bool = False):
    """Kernel 9 on coordinate-major (3, N) queries: results identical to
    :func:`nearest_vertex_d2_culled` on the transposed input."""
    if query_T.device.type == "cpu":
        return nearest_vertex_d2_T_culled_plain(query_T, verts, visits)
    global culled_launches_T
    N = query_T.shape[1]
    _cuda.require(query_T, "query_T", torch.float32, (3, N))
    out = _launch_culled("vt_knn_T_culled", query_T, N, verts, visits)
    culled_launches_T += 1
    return out


def _take_batched(packed_both: torch.Tensor, idx: torch.Tensor
                  ) -> torch.Tensor:
    """Batched row gather (B, V, C)[B, N] -> (B, N, C), a loop over the
    batch (``knn.py:117-143``): without a graph through kernel 10, which
    has no gradient (the JAX package gates it by ``VANERF_MXU_ROWS``, a
    cost-model switch of the TPU's one-hot product; the CUDA kernel copies
    the same rows faster than the native gather, so the port reads no
    switch); through :func:`take_rows` when the table gradient is wanted
    and fits kernel 13; else the native gather."""
    B, V, C = packed_both.shape
    if not (packed_both.requires_grad and torch.is_grad_enabled()):
        return torch.stack([mxu_row_gather(packed_both[b], idx[b])
                            for b in range(B)])
    if take_rows_route(V, packed_both):
        return torch.stack([take_rows(packed_both[b], idx[b])
                            for b in range(B)])
    return torch.gather(packed_both, 1,
                        idx.long()[..., None].expand(-1, -1, C))


def _packed_both(vert_feat, vert_vis, num_v):
    """Per-vertex rows [feat | vis | feat_toh | vis_toh] (B, V, 2(C+1)): the
    other-hand half is the table rolled by one hand's vertex count."""
    packed = torch.cat([vert_feat, vert_vis.to(vert_feat.dtype)], -1)
    return torch.cat([packed, torch.roll(packed, -num_v, dims=1)], -1)


def knn_gather_1(query: torch.Tensor, verts: torch.Tensor,
                 vert_feat: torch.Tensor, vert_vis: torch.Tensor,
                 num_v: int, nn_idx: torch.Tensor,
                 weight_by_vis: bool = True):
    """K=1 nearest-vertex feature lookup for this hand and the other hand
    (reference ``networks.py:27-41``): the other-hand row is the vertex
    table rolled by one hand's vertex count, read at the same index.

    Args:
      query: (B, N, 3) (unused: the index is precomputed);
      verts: (B, V, 3); vert_feat: (B, V, C); vert_vis: (B, V, 1);
      nn_idx: (B, N) nearest-vertex indices.
    Returns:
      feat (B, N, C), feat_toh (B, N, C), vis (B, N, 1), vis_toh (B, N, 1).
    """
    g2 = _take_batched(_packed_both(vert_feat, vert_vis, num_v), nn_idx)
    C1 = vert_feat.shape[-1] + 1
    g, g_toh = g2[..., :C1], g2[..., C1:]
    f, v = g[..., :-1], g[..., -1:]
    f_toh, v_toh = g_toh[..., :-1], g_toh[..., -1:]
    if weight_by_vis:
        f = f * v
        f_toh = f_toh * v_toh
    return f, f_toh, v, v_toh


def knn_gather_raw(query: torch.Tensor, verts: torch.Tensor,
                   vert_feat: torch.Tensor, vert_vis: torch.Tensor,
                   num_v: int, nn_idx: torch.Tensor):
    """The :func:`knn_gather_1` gather without the split and the visibility
    weighting: the raw rows (B, N, 2(C+1)) laid out as
    [feat_this C | vis_this 1 | feat_toh C | vis_toh 1], which the fused
    query kernel (``ops/fused_mlp.py``) slices and weights itself."""
    return _take_batched(_packed_both(vert_feat, vert_vis, num_v), nn_idx)
