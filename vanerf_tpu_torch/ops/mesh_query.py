"""Point->mesh queries: distance, winding sign, interpolated visibility
(port of ``vanerf_tpu/ops/mesh_query.py`` + ``ops/mesh_query_pallas.py``).

Each kernel wrapper launches its CUDA kernel on CUDA tensors and takes the
plain-PyTorch version beside it (``*_plain``) on CPU tensors; the tensor's
device decides, there is no ``VANERF_MESH_BACKEND`` switch.

* The renderer's query, :func:`cal_vis_sdf_prepared` and its
  coordinate-major form :func:`cal_vis_sdf_prepared_T`:
  :func:`point_mesh_query_vis` is kernel A (``csrc/mesh_query.cu``) and
  :func:`point_mesh_query_vis_T` kernel 7, the same function on (3, N)
  points.  Both visit every face (the TPU kernel's AABB culling changes no
  result except argmin ties), use the difference-form Ericson distance,
  count SIGNED crossings of the fixed ray ``_RAY_D`` for the winding
  number, take a certified bound for the far tier, and interpolate the
  winning face's vertex visibility at the point's projection onto its
  plane.
* The exact API, :func:`point_mesh_query`, :func:`winding_number`,
  :func:`point_mesh_sdf`, :func:`cal_vis_sdf` and :func:`cal_vis_sdf_fast`
  (the reference's ``cal_vis_sdf_batch``): :func:`point_mesh_query_brute`
  is kernel 5 and :func:`point_mesh_query_vis_brute` kernel 6
  (``csrc/mesh_query_brute.cu``): no bound, no far tier, a closest-face
  output, the winding number by signed ray crossings or by solid angles.
"""

from __future__ import annotations

import math
import os

import torch

from . import _cuda

# fixed generic winding-ray direction (mesh_query_pallas.py:57)
_RAY_D = (0.5773502691896258, 0.7071067811865476, 0.40824829046386296)
# points per far-tier tile: the TPU kernel's tile (mesh_query_pallas TILE_P)
TILE_P = 128
# floats per face in the kernel's table (csrc/mesh_query.cu MQ_STRIDE)
FACE_STRIDE = 22

# launches of kernels A, 7, 5 and 6 (plain counters; callers reset them)
launches = 0
launches_T = 0
brute_launches = 0
vis_brute_launches = 0

# winding methods of kernels 5 and 6 (csrc/mesh_query_brute.cu WIND_*)
_WIND_MODES = {"none": 0, "ray": 1, "solid_angle": 2}


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
    (..., 3) inputs; the arithmetic of the kernels' ``tri_sq_dist``."""
    return _tri_sq_dist_bary(p, a, b, c)[0]


def _tri_sq_dist_bary(p, a, b, c):
    """:func:`point_triangle_sq_dist` plus Ericson's plane barycentrics
    (v, w) of the point's projection (denom == 0 -> 1, unclamped)."""
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
    return _dot(d, d), v_face, w_face


def _solid_angle(p, a, b, c):
    """Van Oosterom-Strackee solid angle of triangle (a, b, c) seen from p
    (``render_utils.py:28-77``, atan2 form), broadcasting (..., 3)."""
    r1 = a - p
    r2 = b - p
    r3 = c - p
    n1 = torch.sqrt(_dot(r1, r1))
    n2 = torch.sqrt(_dot(r2, r2))
    n3 = torch.sqrt(_dot(r3, r3))
    num = _dot(r1, _cross(r2, r3))
    den = (n1 * n2 * n3 + _dot(r1, r2) * n3 + _dot(r1, r3) * n2
           + _dot(r2, r3) * n1)
    return 2.0 * torch.atan2(num, den)


def barycentric_of_projection(points: torch.Tensor,
                              tri: torch.Tensor) -> torch.Tensor:
    """Barycentric weights (1-b1-b2, b1, b2) of each point's projection
    onto its triangle's plane (Heidrich, ``mesh_util.py:321-356``).
    points (N, 3), tri (N, 3, 3) -> (N, 3)."""
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    u = v1 - v0
    v = v2 - v0
    n = _cross(u, v)
    s = _dot(n, n)
    s = torch.where(s == 0, torch.full_like(s, 1e-6), s)
    w = points - v0
    b2 = _dot(_cross(u, w), n) / s
    b1 = _dot(_cross(w, v), n) / s
    return torch.stack([1.0 - b1 - b2, b1, b2], -1)


def barycentric_vis(points: torch.Tensor, rows: torch.Tensor):
    """Visibility of each point's winning face, interpolated at the point's
    projection onto the face plane.  rows: (N, 22) face-table rows of the
    winners."""
    b = barycentric_of_projection(points, rows[:, :9].reshape(-1, 3, 3))
    return rows[:, 9] * b[:, 0] + rows[:, 10] * b[:, 1] + rows[:, 11] * b[:, 2]


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


def _launch_vis(entry: str, points: torch.Tensor, N: int, table, ub, far):
    """One launch of kernel A (``vt_mesh_query``, points (N, 3)) or kernel 7
    (``vt_mesh_query_T``, points (3, N)); the caller counts it."""
    F = table.shape[0]
    dev = points.device
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
    rc = getattr(_cuda.lib(), entry)(
        points.data_ptr(), N, table.data_ptr(), F, ub.data_ptr(), far_ptr,
        d2.data_ptr(), idx.data_ptr(), wind.data_ptr(), qvis.data_ptr(),
        _cuda.stream_ptr(dev))
    _cuda.check(rc, entry)
    return d2, idx, wind, qvis


def point_mesh_query_vis_cuda(points: torch.Tensor, table: torch.Tensor,
                              ub: torch.Tensor, far=None):
    """Kernel A; same contract as :func:`point_mesh_query_vis_plain`."""
    global launches
    N = points.shape[0]
    _cuda.require(points, "points", torch.float32, (N, 3))
    out = _launch_vis("vt_mesh_query", points, N, table, ub, far)
    launches += 1
    return out


def point_mesh_query_vis(points, table, ub, far=None):
    """Kernel A on CUDA tensors, its plain twin on CPU tensors."""
    if points.device.type == "cpu":
        return point_mesh_query_vis_plain(points, table, ub, far)
    return point_mesh_query_vis_cuda(points, table, ub, far)


def point_mesh_query_vis_T_plain(points_T: torch.Tensor, table: torch.Tensor,
                                 ub: torch.Tensor, far=None):
    """Plain-PyTorch version of kernel 7: :func:`point_mesh_query_vis_plain`
    read through a strided (N, 3) view of the (3, N) points (no copy), so
    the arithmetic and its results are kernel A's plain version's."""
    return point_mesh_query_vis_plain(points_T.t(), table, ub, far)


def point_mesh_query_vis_T_cuda(points_T: torch.Tensor, table: torch.Tensor,
                                ub: torch.Tensor, far=None):
    """Kernel 7: kernel A on coordinate-major (3, N) points, results
    identical to A's on the transposed input."""
    global launches_T
    N = points_T.shape[1]
    _cuda.require(points_T, "points_T", torch.float32, (3, N))
    out = _launch_vis("vt_mesh_query_T", points_T, N, table, ub, far)
    launches_T += 1
    return out


def point_mesh_query_vis_T(points_T, table, ub, far=None):
    """Kernel 7 on CUDA tensors, its plain version on CPU tensors.
    points_T (3, N); the rest as :func:`point_mesh_query_vis_plain`."""
    if points_T.device.type == "cpu":
        return point_mesh_query_vis_T_plain(points_T, table, ub, far)
    return point_mesh_query_vis_T_cuda(points_T, table, ub, far)


# ---------------------------------------------------------------------------
# kernels 5 and 6: the exact query over every face
# ---------------------------------------------------------------------------

def brute_face_table(tri: torch.Tensor, face_vis=None) -> torch.Tensor:
    """Per-face rows (F, 22) of kernels 5 and 6: corners (9), corner
    visibility (3, zeros when not given) and the UNFOLDED crossing
    constants pv = d x e2, e1, e2, det = e1 . pv (``_ray_constants``,
    ``mesh_query_pallas.py:593-602``)."""
    tri = tri.float()
    F = tri.shape[0]
    d = torch.tensor(_RAY_D, dtype=torch.float32, device=tri.device)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    pv = _cross(d.expand_as(e2), e2)
    det = _dot(e1, pv)
    vis = (tri.new_zeros(F, 3) if face_vis is None else face_vis.float())
    return torch.cat([tri.reshape(F, 9), vis, pv, e1, e2, det[:, None]],
                     -1).contiguous()


def _brute_plain(points: torch.Tensor, table: torch.Tensor, vis: bool,
                 mode: str):
    """Kernels 5 (``vis`` False) and 6 in plain PyTorch, in chunks of
    points against every face: d2, idx int32, wind, qvis (or None)."""
    wmode = _WIND_MODES[mode]
    points = points.float()
    N, F = points.shape[0], table.shape[0]
    if F == 0 or N == 0:
        zero = points.new_zeros(N)
        return (points.new_full((N,), float("inf")),
                torch.zeros(N, dtype=torch.int32, device=points.device),
                zero, zero.clone() if vis else None)
    budget = 1 << (22 if points.device.type == "cpu" else 25)
    chunk = max(1, budget // F)
    a, b, c = table[:, 0:3], table[:, 3:6], table[:, 6:9]
    pv, e1, e2, det = (table[:, 12:15], table[:, 15:18], table[:, 18:21],
                       table[:, 21])
    ray = torch.tensor(_RAY_D, dtype=torch.float32, device=points.device)
    d2s, idxs, winds, qvs = [], [], [], []
    for p in torch.split(points, chunk):
        pp = p[:, None, :]
        dd, v_f, w_f = _tri_sq_dist_bary(pp, a[None], b[None], c[None])
        m, i = dd.min(-1)
        d2s.append(m)
        idxs.append(i)
        if vis:
            qv = ((1.0 - v_f - w_f) * table[:, 9] + v_f * table[:, 10]
                  + w_f * table[:, 11])
            qvs.append(qv.gather(1, i[:, None])[:, 0])
        if wmode == 1:
            q = pp - a[None]
            u = _dot(q, pv[None])
            qv_ = _cross(q, e1[None])
            v = ray[0] * qv_[..., 0] + ray[1] * qv_[..., 1] \
                + ray[2] * qv_[..., 2]
            t = _dot(e2[None], qv_)
            hit = ((u * det >= 0) & (v * det >= 0)
                   & ((u + v - det) * det <= 0) & (t * det > 0))
            sign = torch.where(det > 0, -1.0, 1.0)
            winds.append(torch.where(hit, sign, 0.0).sum(-1))
        elif wmode == 2:
            omega = _solid_angle(pp, a[None], b[None], c[None])
            winds.append(omega.sum(-1) / (4.0 * math.pi))
        else:
            winds.append(torch.zeros_like(m))
    return (torch.cat(d2s), torch.cat(idxs).int(), torch.cat(winds),
            torch.cat(qvs) if vis else None)


def _brute_cuda(points: torch.Tensor, table: torch.Tensor, vis: bool,
                mode: str):
    """One launch of kernel 5 (``vis`` False) or kernel 6."""
    global brute_launches, vis_brute_launches
    N, F = points.shape[0], table.shape[0]
    dev = points.device
    _cuda.require(points, "points", torch.float32, (N, 3))
    _cuda.require(table, "table", torch.float32, (F, FACE_STRIDE), dev)
    d2 = torch.empty(N, dtype=torch.float32, device=dev)
    idx = torch.empty(N, dtype=torch.int32, device=dev)
    wind = torch.empty(N, dtype=torch.float32, device=dev)
    args = [points.data_ptr(), N, table.data_ptr(), F, _WIND_MODES[mode],
            d2.data_ptr(), idx.data_ptr(), wind.data_ptr()]
    qvis = None
    if vis:
        qvis = torch.empty(N, dtype=torch.float32, device=dev)
        args.append(qvis.data_ptr())
    entry = "vt_mesh_query_vis_brute" if vis else "vt_mesh_query_brute"
    rc = getattr(_cuda.lib(), entry)(*args, _cuda.stream_ptr(dev))
    _cuda.check(rc, entry)
    if vis:
        vis_brute_launches += 1
    else:
        brute_launches += 1
    return d2, idx, wind, qvis


def _brute(points, tri, face_vis, vis: bool, mode: str):
    if mode not in _WIND_MODES:
        raise ValueError(f"winding mode {mode!r}: expected one of "
                         f"{sorted(_WIND_MODES)}")
    table = brute_face_table(tri, face_vis)
    if points.device.type == "cpu":
        return _brute_plain(points, table, vis, mode)
    return _brute_cuda(points.float().contiguous(), table, vis, mode)


def point_mesh_query_brute_plain(points, tri, with_winding: bool = True,
                                 mode: str = "solid_angle"):
    """Plain-PyTorch version of kernel 5 (same contract as
    :func:`point_mesh_query_brute`)."""
    return _brute_plain(points, brute_face_table(tri), False,
                        mode if with_winding else "none")[:3]


def point_mesh_query_brute(points: torch.Tensor, tri: torch.Tensor,
                           with_winding: bool = True,
                           mode: str = "solid_angle"):
    """Kernel 5 on CUDA tensors, its plain version on CPU tensors: exact
    distance, argmin face and winding number over every face.

    Args:
      points: (N, 3); tri: (F, 3, 3) face corners, any N and F;
      mode: 'ray' (signed crossings of the fixed ray, integers) or
        'solid_angle' (Van Oosterom-Strackee atan2 sum / 4 pi);
      with_winding: False returns zeros for the winding.
    Returns:
      sq_dist (N,), face_idx (N,) int32, winding (N,).
    """
    return _brute(points, tri, None, False,
                  mode if with_winding else "none")[:3]


def point_mesh_query_vis_brute_plain(points, tri, face_vis,
                                     mode: str = "solid_angle"):
    """Plain-PyTorch version of kernel 6 (same contract as
    :func:`point_mesh_query_vis_brute`)."""
    return _brute_plain(points, brute_face_table(tri, face_vis), True, mode)


def point_mesh_query_vis_brute(points: torch.Tensor, tri: torch.Tensor,
                               face_vis: torch.Tensor,
                               mode: str = "solid_angle"):
    """Kernel 6 on CUDA tensors, its plain version on CPU tensors: kernel 5
    plus the vertex visibility interpolated on the argmin face with
    Ericson's plane barycentrics (unclamped).

    Args:
      points: (N, 3); tri: (F, 3, 3); face_vis: (F, 3) corner visibility.
    Returns:
      sq_dist (N,), face_idx (N,) int32, winding (N,), query_vis (N,).
    """
    return _brute(points, tri, face_vis, True, mode)


# ---------------------------------------------------------------------------
# the exact mesh-query API (vanerf_tpu/ops/mesh_query.py:128-260)
# ---------------------------------------------------------------------------

def point_mesh_query(points: torch.Tensor, triangles: torch.Tensor,
                     with_winding: bool = True):
    """Exact point->mesh distance, closest-face index and generalized
    winding number (solid angles).  points (N, 3), triangles (F, 3, 3) ->
    sq_dist (N,), face_idx (N,) int32, winding (N,)."""
    return point_mesh_query_brute(points, triangles,
                                  with_winding=with_winding,
                                  mode="solid_angle")


def winding_number(points: torch.Tensor,
                   triangles: torch.Tensor) -> torch.Tensor:
    """Generalized winding number of each point w.r.t. the mesh."""
    return point_mesh_query(points, triangles)[2]


def _signed(d2: torch.Tensor, wind: torch.Tensor) -> torch.Tensor:
    """sqrt(residual + 1e-6) distance, negative inside (winding > 0.5)
    (``mesh_util.py:498-511``)."""
    return torch.sqrt(d2 + 1e-6) * torch.where(wind > 0.5, -1.0, 1.0)


def point_mesh_sdf(verts: torch.Tensor, faces: torch.Tensor,
                   points: torch.Tensor):
    """Signed distance (negative inside) + closest face per query point.
    verts (V, 3), faces (F, 3) int, points (N, 3) -> sdf (N,), face_idx
    (N,) int32."""
    d2, idx, w = point_mesh_query(points, verts[faces.long()])
    return _signed(d2, w), idx


def cal_vis_sdf(verts: torch.Tensor, faces: torch.Tensor,
                points: torch.Tensor, vert_vis: torch.Tensor):
    """SDF + interpolated visibility + closest-face vertex ids per point
    (``cal_vis_sdf_batch``, ``mesh_util.py:498-524``, with the vertex
    visibility passed in): the visibility is interpolated at the point's
    projection onto the closest face's plane.

    Args:
      verts (V, 3); faces (F, 3) int; points (N, 3); vert_vis (V, 1).
    Returns:
      sdf (N,), query_vis (N, 1) float 0/1, closest_face (N, 3) int32.
    """
    sdf, face_idx = point_mesh_sdf(verts, faces, points)
    closest_face = faces.long()[face_idx.long()]             # (N, 3)
    bary = barycentric_of_projection(points, verts[closest_face])
    q_vis = (vert_vis[closest_face][..., 0] * bary).sum(-1)
    query_vis = (q_vis >= 1e-1).to(verts.dtype)[:, None]
    return sdf, query_vis, closest_face.int()


def cal_vis_sdf_fast(verts: torch.Tensor, faces: torch.Tensor,
                     points: torch.Tensor, vert_vis: torch.Tensor):
    """:func:`cal_vis_sdf` without the closest-face output, the visibility
    interpolated inside kernel 6.  ``VANERF_WINDING`` chooses the winding
    method: ``ray`` (default) or ``solid_angle``.
    Returns sdf (N,), query_vis (N, 1)."""
    f = faces.long()
    mode = os.environ.get("VANERF_WINDING", "ray")
    d2, _idx, w, qv = point_mesh_query_vis_brute(
        points, verts[f], vert_vis[..., 0][f],
        mode="ray" if mode == "ray" else "solid_angle")
    return _signed(d2, w), (qv >= 1e-1).to(verts.dtype)[:, None]


# ---------------------------------------------------------------------------
# the renderer-facing API (cal_vis_sdf_prepared, its (3, N) form, helpers)
# ---------------------------------------------------------------------------

def blocked_order(P: int, S: int, ray_block: int | None = None,
                  s_block: int | None = None):
    """(ray_block, s_block) of the spatially coherent point tiles (default
    16 rays x 8 samples = the far tier's 128-point tiles; override with
    ``VANERF_BLOCK_RAYS`` / ``VANERF_BLOCK_SAMPLES``), or None if they do
    not divide (P rays x S samples)."""
    if ray_block is None:
        ray_block = int(os.environ.get("VANERF_BLOCK_RAYS", "16"))
    if s_block is None:
        s_block = int(os.environ.get("VANERF_BLOCK_SAMPLES", "8"))
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


def _to_blocked_ax1(x: torch.Tensor, P: int, S: int, rb: int, sb: int):
    """:func:`to_blocked` along axis 1 of a (C, N=P*S) array."""
    C = x.shape[0]
    return x.reshape(C, P // rb, rb, S // sb, sb).transpose(2, 3) \
        .reshape(C, P * S)


def _from_blocked_ax1(x: torch.Tensor, P: int, S: int, rb: int, sb: int):
    """Inverse of :func:`_to_blocked_ax1`."""
    C = x.shape[0]
    return x.reshape(C, P // rb, S // sb, rb, sb).transpose(2, 3) \
        .reshape(C, P * S)


def blocked2d_order(H: int, W: int, S: int):
    """Optional 2-D pixel blocking, ``VANERF_BLOCK_2D="bh,bw,sb"`` (or
    ``"bhxbwxsb"``): a (bh x bw) pixel block x sb depths is compact in all
    three world dimensions where the 1-D blocking groups a row strip.
    Returns (bh, bw, sb), or None when unset, unparsable or not dividing
    (H, W, S)."""
    spec = os.environ.get("VANERF_BLOCK_2D", "")
    if not spec:
        return None
    try:
        bh, bw, sb = (int(t) for t in spec.replace("x", ",").split(","))
    except ValueError:
        return None
    if H % bh or W % bw or S % sb:
        return None
    return bh, bw, sb


def _to_blocked2d_ax1(x, H, W, S, bh, bw, sb):
    """(C, N=H*W*S) row-major rays -> (bh x bw x sb) tile order."""
    C = x.shape[0]
    x = x.reshape(C, H // bh, bh, W // bw, bw, S // sb, sb)
    return x.permute(0, 1, 3, 5, 2, 4, 6).reshape(C, H * W * S)


def _from_blocked2d_ax1(x, H, W, S, bh, bw, sb):
    """Inverse of :func:`_to_blocked2d_ax1`."""
    C = x.shape[0]
    x = x.reshape(C, H // bh, W // bw, S // sb, bh, bw, sb)
    return x.permute(0, 1, 4, 2, 5, 3, 6).reshape(C, H * W * S)


def _far_tiles(ub_b: torch.Tensor, far2: float):
    """Per-tile far flags (every point's bound above far2) and their
    per-point broadcast, over TILE_P consecutive points."""
    far_t = ub_b.reshape(-1, TILE_P).amin(1) > far2
    return far_t, far_t.repeat_interleave(TILE_P)


def _far_points(ub_d2: torch.Tensor, far2, n_samples, rays_hw=None):
    """The far tier's per-point flags in ray-major order, or None.

    Tiles are TILE_P consecutive points of the blocked order: the 2-D
    pixel blocks when ``VANERF_BLOCK_2D`` is set and ``rays_hw`` fits
    (coordinate-major callers only), else the 1-D ray x sample blocks,
    else the ray-major order itself.  Only the bounds are relayouted, as
    one (1, N) row: the kernels' result for a point does not depend on its
    neighbours, so the points keep their order."""
    N = ub_d2.shape[0]
    if far2 is None or N % TILE_P != 0:
        return None
    if n_samples is not None and N % n_samples == 0:
        S = n_samples
        if rays_hw is not None and rays_hw[0] * rays_hw[1] * S == N:
            b2 = blocked2d_order(rays_hw[0], rays_hw[1], S)
            if b2 is not None:
                far_b = _far_tiles(_to_blocked2d_ax1(
                    ub_d2[None], *rays_hw, S, *b2)[0], far2)[1]
                return _from_blocked2d_ax1(far_b[None], *rays_hw, S, *b2)[0]
        blocks = blocked_order(N // S, S)
        if blocks is not None:
            far_b = _far_tiles(_to_blocked_ax1(
                ub_d2[None], N // S, S, *blocks)[0], far2)[1]
            return _from_blocked_ax1(far_b[None], N // S, S, *blocks)[0]
    return _far_tiles(ub_d2, far2)[1]


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


def _finish_prepared(d2, wind, qv, dtype):
    return _signed(d2, wind), (qv >= 1e-1).to(dtype)[:, None]


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
    far = _far_points(ub_d2, far2, n_samples)
    pts = (points.float() - mesh["center"]).contiguous()
    d2, _idx, wind, qv = point_mesh_query_vis(
        pts, mesh["table"], ub_d2.float().contiguous(), far)
    return (*_finish_prepared(d2, wind, qv, points.dtype), far)


def cal_vis_sdf_prepared_T(mesh: dict, points_T: torch.Tensor,
                           ub_d2: torch.Tensor, n_samples: int | None = None,
                           rays_hw: tuple | None = None,
                           far2: float | None = None):
    """Coordinate-major :func:`cal_vis_sdf_prepared`: (3, N) points go to
    kernel 7 as they are (centred as ``points_T - center[:, None]``; no
    (N, 3) copy is made), with identical results.

    rays_hw: optional (H, W) shape of the ray grid (rays row-major): with
    ``VANERF_BLOCK_2D`` set, the far tier's tiles are the 2-D pixel blocks
    (which points are far depends on the tiling).
    """
    far = _far_points(ub_d2, far2, n_samples, rays_hw)
    pts_T = (points_T.float() - mesh["center"][:, None]).contiguous()
    d2, _idx, wind, qv = point_mesh_query_vis_T(
        pts_T, mesh["table"], ub_d2.float().contiguous(), far)
    return (*_finish_prepared(d2, wind, qv, points_T.dtype), far)


def cal_vis_sdf_cull(verts: torch.Tensor, faces: torch.Tensor,
                     points: torch.Tensor, vert_vis: torch.Tensor,
                     ub_d2: torch.Tensor, n_samples: int | None = None):
    """Single-shot prepare + :func:`cal_vis_sdf_prepared` (no far tier:
    the returned far mask is None)."""
    mesh = prepare_culled_mesh(verts, faces, vert_vis)
    return cal_vis_sdf_prepared(mesh, points, ub_d2, n_samples=n_samples)
