"""Nearest-vertex search and the K=1 vertex-feature gather (port of
``vanerf_tpu/ops/knn.py`` + ``ops/knn_pallas.py``).

:func:`nearest_vertex_d2` is kernel B (``csrc/knn.cu``) on CUDA tensors
and its plain-PyTorch twin :func:`nearest_vertex_d2_plain` on CPU tensors.
Under a graph the vertex-table gather goes through
:func:`~.onehot_gather.take_rows`, whose table gradient is kernel 13.
"""

from __future__ import annotations

import torch

from . import _cuda
from .onehot_gather import take_rows, take_rows_route

KNN_MAX_VERTS = 4096        # csrc/knn.cu: the vertex table in shared memory

# launches of the CUDA kernel (a plain counter; callers reset it)
launches = 0


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
    N, V = query.shape[0], verts.shape[0]
    _cuda.require(query, "query", torch.float32, (N, 3))
    _cuda.require(verts, "verts", torch.float32, (V, 3), query.device)
    if not 0 < V <= KNN_MAX_VERTS:
        raise ValueError(f"nearest_vertex_d2: {V} vertices; the kernel "
                         f"holds at most {KNN_MAX_VERTS} in shared memory")
    idx = torch.empty(N, dtype=torch.int32, device=query.device)
    d2 = torch.empty(N, dtype=torch.float32, device=query.device)
    rc = _cuda.lib().vt_knn(query.data_ptr(), N, verts.data_ptr(), V,
                            idx.data_ptr(), d2.data_ptr(),
                            _cuda.stream_ptr(query.device))
    _cuda.check(rc, "vt_knn")
    launches += 1
    return idx, d2


def _take_batched(packed_both: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather (B, V, C)[B, N] -> (B, N, C); a loop over the
    batch through :func:`take_rows` when its table gradient is wanted
    (``knn.py:117-143``)."""
    B, V, C = packed_both.shape
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
