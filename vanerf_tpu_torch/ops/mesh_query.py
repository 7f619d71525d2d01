"""Point->mesh queries: distance, winding sign, interpolated visibility
(port of ``vanerf_tpu/ops/mesh_query.py`` + ``ops/mesh_query_pallas.py``).

:func:`point_mesh_query_vis` is kernel A (``csrc/mesh_query.cu``) on CUDA
tensors and its plain-PyTorch twin :func:`point_mesh_query_vis_plain` on
CPU tensors.  Both visit every face (the TPU kernel's AABB culling changes
no result except argmin ties), use the difference-form Ericson distance,
count SIGNED crossings of the fixed ray ``_RAY_D`` for the winding number,
and interpolate the winning face's vertex visibility at the point's
projection onto its plane.
"""

from __future__ import annotations

import torch

from . import _cuda

# fixed generic winding-ray direction (mesh_query_pallas.py:57)
_RAY_D = (0.5773502691896258, 0.7071067811865476, 0.40824829046386296)
# points per far-tier tile: the TPU kernel's tile (mesh_query_pallas TILE_P)
TILE_P = 128
# floats per face in the kernel's table (csrc/mesh_query.cu MQ_STRIDE)
FACE_STRIDE = 22

launches = 0


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def face_table(tri: torch.Tensor, face_vis: torch.Tensor) -> torch.Tensor:
    """Per-face kernel rows (F, 22): corners (9), corner visibility (3) and
    the folded crossing constants pv = d x e2, w2 = e1 x d, n = e1 x e2,
    det = e1 . pv (``_ray_constants_folded``)."""
    tri = tri.float()
    d = torch.tensor(_RAY_D, dtype=torch.float32, device=tri.device)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    db = d.expand_as(e1)
    pv = _cross(db, e2)
    w2 = _cross(e1, db)
    n = _cross(e1, e2)
    det = _dot(e1, pv)
    return torch.cat([tri.reshape(-1, 9), face_vis.float(), pv, w2, n,
                      det[:, None]], -1).contiguous()


def point_triangle_sq_dist(p, a, b, c):
    """Exact squared point-triangle distance (Ericson 5.1.5), broadcasting
    (..., 3) inputs; the arithmetic of the kernel's ``tri_sq_dist``."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    den = torch.where(denom == 0, torch.ones_like(denom), denom)
    v_face = vb / den
    w_face = vc / den
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    eps = torch.tensor(1e-20, dtype=d1.dtype, device=d1.device)
    t_ab = d1 / torch.maximum(d1 - d3, eps)
    t_ac = d2 / torch.maximum(d2 - d6, eps)
    t_bc = (d4 - d3) / torch.maximum((d4 - d3) + (d5 - d6), eps)
    q = a + v_face[..., None] * ab + w_face[..., None] * ac
    q = torch.where(in_bc[..., None], b + t_bc[..., None] * (c - b), q)
    q = torch.where(in_ac[..., None], a + t_ac[..., None] * ac, q)
    q = torch.where(in_ab[..., None], a + t_ab[..., None] * ab, q)
    q = torch.where(in_c[..., None], c, q)
    q = torch.where(in_b[..., None], b, q)
    q = torch.where(in_a[..., None], a, q)
    d = p - q
    return _dot(d, d)


def barycentric_vis(points: torch.Tensor, rows: torch.Tensor):
    """Visibility of each point's winning face, interpolated at the point's
    projection onto the face plane (Heidrich, ``mesh_util.py:321-356``).
    rows: (N, 22) face-table rows of the winners."""
    v0, v1, v2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    u = v1 - v0
    v = v2 - v0
    n = _cross(u, v)
    s = _dot(n, n)
    s = torch.where(s == 0, torch.full_like(s, 1e-6), s)
    w = points - v0
    b2 = _dot(_cross(u, w), n) / s
    b1 = _dot(_cross(w, v), n) / s
    b0 = 1.0 - b1 - b2
    return rows[:, 9] * b0 + rows[:, 10] * b1 + rows[:, 11] * b2


def point_mesh_query_vis_plain(points: torch.Tensor, table: torch.Tensor,
                               ub: torch.Tensor, far=None):
    """Plain-PyTorch twin of kernel A.

    Args:
      points: (N, 3); table: (F, 22) from :func:`face_table`;
      ub: (N,) certified squared-distance upper bounds;
      far: optional (N,) bool — far points skip the distance search
        (d2 := ub, qvis := 0) and keep the exact winding.
    Returns:
      d2 (N,), idx (N,) int32, wind (N,), qvis (N,).
    """
    F = table.shape[0]
    # (chunk, F) temporaries: ~16 MB each on the CPU, ~128 MB on a GPU
    budget = 1 << (22 if points.device.type == "cpu" else 25)
    chunk = max(1, budget // max(F, 1))
    a, b, c = table[:, 0:3], table[:, 3:6], table[:, 6:9]
    pv, w2, nn_, det = (table[:, 12:15], table[:, 15:18], table[:, 18:21],
                        table[:, 21])
    d2s, idxs, winds = [], [], []
    for p in torch.split(points.float(), chunk):
        pp = p[:, None, :]
        dd = point_triangle_sq_dist(pp, a[None], b[None], c[None])
        m, i = dd.min(-1)
        d2s.append(m)
        idxs.append(i)
        q = pp - a[None]
        u = _dot(q, pv[None])
        v = _dot(q, w2[None])
        t = _dot(q, nn_[None])
        hit = ((u * det >= 0) & (v * det >= 0)
               & ((u + v - det) * det <= 0) & (t * det > 0))
        sign = torch.where(det > 0, -1.0, 1.0)
        winds.append(torch.where(hit, sign, 0.0).sum(-1))
    d2 = torch.cat(d2s)
    idx = torch.cat(idxs)
    wind = torch.cat(winds)
    qvis = barycentric_vis(points.float(), table[idx])
    if far is not None:
        d2 = torch.where(far, ub.float(), d2)
        idx = torch.where(far, torch.zeros_like(idx), idx)
        qvis = torch.where(far, torch.zeros_like(qvis), qvis)
    return d2, idx.int(), wind, qvis


def point_mesh_query_vis_cuda(points: torch.Tensor, table: torch.Tensor,
                              ub: torch.Tensor, far=None):
    """Kernel A; same contract as :func:`point_mesh_query_vis_plain`."""
    global launches
    N, F = points.shape[0], table.shape[0]
    dev = points.device
    _cuda.require(points, "points", torch.float32, (N, 3))
    _cuda.require(table, "table", torch.float32, (F, FACE_STRIDE), dev)
    _cuda.require(ub, "ub", torch.float32, (N,), dev)
    far_ptr = None
    if far is not None:
        far = far.to(torch.uint8).contiguous()
        _cuda.require(far, "far", torch.uint8, (N,), dev)
        far_ptr = far.data_ptr()
    d2 = torch.empty(N, dtype=torch.float32, device=dev)
    idx = torch.empty(N, dtype=torch.int32, device=dev)
    wind = torch.empty(N, dtype=torch.float32, device=dev)
    qvis = torch.empty(N, dtype=torch.float32, device=dev)
    rc = _cuda.lib().vt_mesh_query(
        points.data_ptr(), N, table.data_ptr(), F, ub.data_ptr(), far_ptr,
        d2.data_ptr(), idx.data_ptr(), wind.data_ptr(), qvis.data_ptr(),
        _cuda.stream_ptr(dev))
    _cuda.check(rc, "vt_mesh_query")
    launches += 1
    return d2, idx, wind, qvis


def point_mesh_query_vis(points, table, ub, far=None):
    """Kernel A on CUDA tensors, its plain twin on CPU tensors."""
    if points.device.type == "cpu":
        return point_mesh_query_vis_plain(points, table, ub, far)
    return point_mesh_query_vis_cuda(points, table, ub, far)


# ---------------------------------------------------------------------------
# the renderer-facing API (cal_vis_sdf_prepared and its helpers)
# ---------------------------------------------------------------------------

def blocked_order(P: int, S: int, ray_block: int = 16, s_block: int = 8):
    """(ray_block, s_block) of the spatially coherent point tiles (16 rays x
    8 samples = the far tier's 128-point tiles), or None if they do not
    divide (P rays x S samples)."""
    if P % ray_block or S % s_block:
        return None
    return (ray_block, s_block)


def to_blocked(x: torch.Tensor, P: int, S: int, rb: int, sb: int):
    """(N=P*S, ...) ray-major -> blocked tile order (pure relayout)."""
    lead = x.shape[1:]
    x = x.reshape(P // rb, rb, S // sb, sb, *lead).transpose(1, 2)
    return x.reshape(P * S, *lead)


def from_blocked(x: torch.Tensor, P: int, S: int, rb: int, sb: int):
    """Inverse of :func:`to_blocked`."""
    lead = x.shape[1:]
    x = x.reshape(P // rb, S // sb, rb, sb, *lead).transpose(1, 2)
    return x.reshape(P * S, *lead)


def _far_tiles(ub_b: torch.Tensor, far2: float):
    """Per-tile far flags (every point's bound above far2) and their
    per-point broadcast, over TILE_P consecutive points."""
    far_t = ub_b.reshape(-1, TILE_P).amin(1) > far2
    return far_t, far_t.repeat_interleave(TILE_P)


def prepare_culled_mesh(verts: torch.Tensor, faces: torch.Tensor,
                        vert_vis: torch.Tensor) -> dict:
    """Once-per-mesh preparation for :func:`cal_vis_sdf_prepared`: centre
    the mesh (coordinates stay O(hand size)) and build the kernel's face
    table.  verts (V, 3), faces (F, 3), vert_vis (V, 1)."""
    center = 0.5 * (verts.amin(0) + verts.amax(0))
    f = faces.long()
    tri = verts[f] - center                              # (F, 3, 3)
    face_vis = vert_vis[..., 0][f]                       # (F, 3)
    return {"table": face_table(tri, face_vis), "center": center}


def cal_vis_sdf_prepared(mesh: dict, points: torch.Tensor,
                         ub_d2: torch.Tensor, n_samples: int | None = None,
                         far2: float | None = None):
    """SDF + binarised interpolated visibility (+ far mask) per point.

    Args:
      mesh: from :func:`prepare_culled_mesh`.
      points: (N, 3), ray-major (rays x n_samples, sample fastest).
      ub_d2: (N,) nearest-vertex squared distances (certified bounds).
      far2: optional squared far-field threshold: tiles of 128 points in
        the 16-ray x 8-sample blocked order whose every bound exceeds it
        skip the distance search; |sdf| := sqrt(ub + 1e-6), query_vis := 0,
        exact sign.
    Returns:
      sdf (N,), query_vis (N, 1) float 0/1, far (N,) bool or None.
    """
    N = points.shape[0]
    if far2 is not None and N % TILE_P != 0:
        far2 = None
    far = None
    if far2 is not None:
        blocks = None
        if n_samples is not None and N % n_samples == 0:
            blocks = blocked_order(N // n_samples, n_samples)
        if blocks is not None:
            rb, sb = blocks
            P = N // n_samples
            _ft, far_b = _far_tiles(to_blocked(ub_d2, P, n_samples, rb, sb),
                                    far2)
            far = from_blocked(far_b, P, n_samples, rb, sb)
        else:
            _ft, far = _far_tiles(ub_d2, far2)
    pts = (points.float() - mesh["center"]).contiguous()
    d2, _idx, wind, qv = point_mesh_query_vis(
        pts, mesh["table"], ub_d2.float().contiguous(), far)
    dist = torch.sqrt(d2 + 1e-6)
    sign = torch.where(wind > 0.5, -1.0, 1.0)
    qvis = (qv >= 1e-1).to(points.dtype)[:, None]
    return dist * sign, qvis, far
