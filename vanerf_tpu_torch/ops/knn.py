"""Nearest-vertex search and the K=1 vertex-feature gather (port of
``vanerf_tpu/ops/knn.py`` + ``ops/knn_pallas.py``).

:func:`nearest_vertex_d2` is kernel B (``csrc/knn.cu``) on CUDA tensors
and its plain-PyTorch twin :func:`nearest_vertex_d2_plain` on CPU tensors;
:func:`nearest_vertex_d2_T` is kernel 8, the same search on coordinate-major
(3, N) queries, with :func:`nearest_vertex_d2_T_plain`.
Under a graph the vertex-table gather goes through
:func:`~.onehot_gather.take_rows`, whose table gradient is kernel 13;
without one it goes through kernel 10,
:func:`~.interp_mxu.mxu_row_gather`.
"""

from __future__ import annotations

import torch

from . import _cuda
from .interp_mxu import mxu_row_gather
from .onehot_gather import take_rows, take_rows_route

KNN_MAX_VERTS = 4096        # csrc/knn.cu: the vertex table in shared memory

# launches of kernels B and 8 (plain counters; callers reset them)
launches = 0
launches_T = 0


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
    squared distance (vertices lie on the mesh).

    Args:
      query: (N, 3); verts: (V, 3) float32, same device.
    Returns:
      idx (N,) int32, d2 (N,) float32.
    """
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
    if query_T.device.type == "cpu":
        return nearest_vertex_d2_T_plain(query_T, verts)
    global launches_T
    N = query_T.shape[1]
    _cuda.require(query_T, "query_T", torch.float32, (3, N))
    out = _launch("vt_knn_T", query_T, N, verts)
    launches_T += 1
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
