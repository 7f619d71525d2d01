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

B / 8 and 10 take a batch in one launch, as the JAX package ``vmap``s
them: (B, N, 3) or (B, 3, N) points against a (Bv, V, 3) stack of vertex
sets, element e reading set e % Bv (the G tiles of a frame in a tile group
share the frame's vertices), and (B, N) rows of a (Bt, V, C) stack of
tables.  Kernel 9 and kernel 13 (under autograd) keep a loop over the
batch.
"""

from __future__ import annotations

import os

import torch

from . import _cuda
from ._cuda import batch_index
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
    d2 (N,) f32, or batched (B, N, 3) x (Bv, V, 3) -> (B, N), element e
    against vertex set e % Bv.  Difference form dx*dx + dy*dy + dz*dz,
    first index on ties (the kernel's arithmetic and tie-break)."""
    batched = query.dim() == 3
    q3 = (query if batched else query[None]).float()
    v3 = (verts if batched else verts[None]).float()
    v3 = v3[batch_index(q3.shape[0], v3.shape[0], v3.device)]
    idx, d2 = [], []
    for q in torch.split(q3, max(1, 4096 // q3.shape[0]), dim=1):
        d = q[:, :, None, :] - v3[:, None]
        dd = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        m, i = dd.min(-1)
        idx.append(i.int())
        d2.append(m)
    idx, d2 = torch.cat(idx, 1), torch.cat(d2, 1)
    return (idx, d2) if batched else (idx[0], d2[0])


def _launch(entry: str, query: torch.Tensor, verts: torch.Tensor,
            soa: bool):
    """One launch of kernel B (``vt_knn``, query (B, N, 3)) or kernel 8
    (``vt_knn_T``, query (B, 3, N)) against verts (Bv, V, 3), or of one
    element ((N, 3) / (3, N) against (V, 3)); the caller counts it."""
    batched = query.dim() == 3
    lead = query.shape[:1] if batched else ()
    N = query.shape[-1] if soa else query.shape[-2]
    _cuda.require(query, "query_T" if soa else "query", torch.float32,
                  lead + ((3, N) if soa else (N, 3)))
    V = verts.shape[-2]
    vlead = verts.shape[:1] if batched else ()
    _cuda.require(verts, "verts", torch.float32, vlead + (V, 3), query.device)
    if not 0 < V <= KNN_MAX_VERTS:
        raise ValueError(f"nearest vertex: {V} vertices; the kernel holds "
                         f"at most {KNN_MAX_VERTS} in shared memory")
    idx = torch.empty(lead + (N,), dtype=torch.int32, device=query.device)
    d2 = torch.empty(lead + (N,), dtype=torch.float32, device=query.device)
    rc = getattr(_cuda.lib(), entry)(
        query.data_ptr(), N, lead[0] if batched else 1, verts.data_ptr(), V,
        vlead[0] if batched else 1, idx.data_ptr(), d2.data_ptr(),
        _cuda.stream_ptr(query.device))
    _cuda.check(rc, entry)
    return idx, d2


def _culled_each(fn, query: torch.Tensor, verts: torch.Tensor):
    """Kernel 9 over a batch: one search a batch element (its loop is
    kept; ROADMAP.md queue 1)."""
    outs = [fn(query[e], verts[e % verts.shape[0]])
            for e in range(query.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def nearest_vertex_d2(query: torch.Tensor, verts: torch.Tensor):
    """Nearest vertex index + squared distance per query point.

    The squared distance is a certified upper bound on the point-to-mesh
    squared distance (vertices lie on the mesh).  ``VANERF_KNN_CULL`` set to
    any non-empty value takes the culled search, with the same results.

    Args:
      query: (N, 3), or (B, N, 3) for a batch in one launch; verts: (V, 3),
        or (Bv, V, 3) with a batch (element e searches set e % Bv);
        float32, same device.
    Returns:
      idx (N,) int32, d2 (N,) float32; (B, N) with a batch.
    """
    batched = query.dim() == 3
    if os.environ.get("VANERF_KNN_CULL"):
        if batched:
            return _culled_each(nearest_vertex_d2_culled, query, verts)
        return nearest_vertex_d2_culled(query, verts)
    if query.device.type == "cpu":
        return nearest_vertex_d2_plain(query, verts)
    global launches
    out = _launch("vt_knn", query, verts, soa=False)
    launches += 1
    return out


def nearest_vertex_d2_T_plain(query_T: torch.Tensor, verts: torch.Tensor):
    """Plain-PyTorch version of kernel 8: :func:`nearest_vertex_d2_plain`
    read through a strided (N, 3) view of the (3, N) queries (no copy);
    batched (B, 3, N) as that function's batch."""
    return nearest_vertex_d2_plain(query_T.transpose(-1, -2), verts)


def nearest_vertex_d2_T(query_T: torch.Tensor, verts: torch.Tensor):
    """Coordinate-major :func:`nearest_vertex_d2`: kernel 8 on CUDA tensors,
    identical results to kernel B's on the transposed input.

    Args:
      query_T: (3, N) contiguous, or (B, 3, N) for a batch in one launch;
        verts: (V, 3), or (Bv, V, 3) with a batch; float32, same device.
    Returns:
      idx (N,) int32, d2 (N,) float32; (B, N) with a batch.
    """
    batched = query_T.dim() == 3
    if os.environ.get("VANERF_KNN_CULL"):
        if batched:
            return _culled_each(nearest_vertex_d2_T_culled, query_T, verts)
        return nearest_vertex_d2_T_culled(query_T, verts)
    if query_T.device.type == "cpu":
        return nearest_vertex_d2_T_plain(query_T, verts)
    global launches_T
    out = _launch("vt_knn_T", query_T, verts, soa=True)
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
    """Batched row gather (Bt, V, C)[B, N] -> (B, N, C) (``knn.py:117-
    143``), element e reading table e % Bt: without a graph through one
    launch of kernel 10, which has no gradient (the JAX package gates it by
    ``VANERF_MXU_ROWS``, a cost-model switch of the TPU's one-hot product;
    the CUDA kernel copies the same rows faster than the native gather, so
    the port reads no switch); through :func:`take_rows` when the table
    gradient is wanted and fits kernel 13, a loop over the batch; else the
    native gather."""
    Bt, V, C = packed_both.shape
    if not (packed_both.requires_grad and torch.is_grad_enabled()):
        return mxu_row_gather(packed_both, idx)
    B = idx.shape[0]
    if B != Bt:
        packed_both = packed_both[batch_index(B, Bt, packed_both.device)]
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
