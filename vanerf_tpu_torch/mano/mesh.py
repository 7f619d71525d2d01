"""Mesh utilities: edge subdivision, face gathering, vertex normals, port
of ``vanerf_tpu/mano/mesh.py``.

Parity targets: ``edge_subdivide``/``face_vertices``/``vertex_normals``
(reference ``src/mis_utils.py:16-173``) and the trivial
``index_vertices_by_faces`` gather (kaolin).  numpy for the input pipeline,
torch variants for on-device use.
"""

from __future__ import annotations

import numpy as np
import torch


def edge_subdivide(vertices: np.ndarray, faces: np.ndarray):
    """1->4 midpoint triangle subdivision.

    Returns (new_vertices (V+E, 3), new_faces (4F, 3), edges (E, 2)) — the
    new faces only (reference returns f[n_faces:], mis_utils.py:16-93).
    """
    n_faces = faces.shape[0]
    n_vertices = vertices.shape[0]

    edge_map = {}
    edges = []

    def edge_id(a, b):
        key = (min(a, b), max(a, b))
        if key not in edge_map:
            edge_map[key] = len(edges)
            edges.append(key)
        return edge_map[key]

    fab = np.empty(n_faces, np.int64)
    fbc = np.empty(n_faces, np.int64)
    fca = np.empty(n_faces, np.int64)
    for i, (a, b, c) in enumerate(faces):
        fab[i] = edge_id(a, b)
        fbc[i] = edge_id(b, c)
        fca[i] = edge_id(c, a)
    edges = np.asarray(edges, np.int64)

    mid = 0.5 * (vertices[edges[:, 0]] + vertices[edges[:, 1]])
    new_vertices = np.concatenate([vertices, mid], 0)

    ab = n_vertices + fab
    bc = n_vertices + fbc
    ca = n_vertices + fca
    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    new_faces = np.concatenate([
        np.stack([a, ab, ca], 1),
        np.stack([ab, b, bc], 1),
        np.stack([ca, ab, bc], 1),
        np.stack([ca, bc, c], 1)], 0)
    return new_vertices, new_faces.astype(faces.dtype), edges


def face_vertices(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Gather per-face corner attributes: (B, V, C), (F, 3) -> (B, F, 3, C)
    (mis_utils.py:103-...; kaolin index_vertices_by_faces)."""
    return vertices[..., faces.long(), :]


def vertex_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals, normalized.

    Args:
      vertices: (V, 3); faces: (F, 3).
    Returns:
      (V, 3) unit normals.
    """
    faces = faces.long()
    tri = vertices[faces]                                 # (F, 3, 3)
    fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = torch.zeros_like(vertices)
    for k in range(3):
        vn = vn.index_add(0, faces[:, k], fn)
    return vn / (torch.linalg.norm(vn, dim=-1, keepdim=True) + 1e-12)
