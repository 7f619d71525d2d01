"""Point->mesh queries: distance, winding sign, interpolated visibility
(port of ``vanerf_tpu/ops/mesh_query.py`` + ``ops/mesh_query_pallas.py``).

Each kernel wrapper launches its CUDA kernel on CUDA tensors and takes the
plain-PyTorch version beside it (``*_plain``) on CPU tensors; the tensor's
device decides, there is no ``VANERF_MESH_BACKEND`` switch.

* The renderer's query, :func:`cal_vis_sdf_prepared` and its
  coordinate-major form :func:`cal_vis_sdf_prepared_T`:
  :func:`point_mesh_query_vis_culled` is kernel A (``csrc/mesh_query.cu``)
  and :func:`point_mesh_query_vis_culled_T` kernel 7, the same function on
  (3, N) points.  Both use the difference-form Ericson distance, count
  SIGNED crossings of a fixed ray for the winding number, take a certified
  bound for the far tier, and interpolate the winning face's vertex
  visibility at the point's projection onto its plane.  They cull by branch
  and bound: the faces are Morton-sorted into chunks of 128 with corner
  boxes (:func:`prepare_culled_mesh`), the points fall into tiles of 128
  consecutive points of the blocked order (:func:`tile_geometry`), and a
  tile visits a chunk for the distance only when the box-to-box gap does not
  exceed the tile's largest certified bound, and for the winding only when
  its box swept along the ray can reach the chunk's (:func:`cull_masks`);
  each tile shoots the ray along ``+_RAY_D`` or ``-_RAY_D``, whichever keeps
  fewer chunks.  Inside a chunk the kernel skips the faces whose bounding
  sphere certifies they cannot beat a point's best distance
  (:func:`face_spheres`, :func:`sphere_skip`); the plain version evaluates
  every kept pair, and :func:`culled_work` counts the pairs the kernel
  evaluates.  ``VANERF_MESH_TILE_P`` / ``VANERF_CULL_CHUNK`` change
  the two sizes (:func:`cull_sizes`) and ``VANERF_CULL_EARLY`` the order of
  the distance walk (:func:`early_walk_lists`).
  :func:`point_mesh_query_vis` / :func:`point_mesh_query_vis_T` are the
  same kernels' sweep over every face, the reference the culled kernel is
  held against on the card: no render path calls them.
  A and 7 take a batch in one launch, as the JAX package ``vmap``s them:
  (B, N, 3) or (B, 3, N) points against a stack of prepared meshes
  (:func:`stack_culled_meshes`), element e reading mesh e % Bm (the G
  tiles of a frame in a tile group share the frame's mesh).
* The exact API, :func:`point_mesh_query`, :func:`winding_number`,
  :func:`point_mesh_sdf`, :func:`cal_vis_sdf` and :func:`cal_vis_sdf_fast`
  (the reference's ``cal_vis_sdf_batch``): :func:`point_mesh_query_brute`
  is kernel 5 and :func:`point_mesh_query_vis_brute` kernel 6
  (``csrc/mesh_query_brute.cu``): no bound, no far tier, a closest-face
  output, the winding number by signed ray crossings or by solid angles.
  They skip a face's distance where its sphere certifies it cannot beat a
  point's best so far (the test of kernel A, on the faces as given), with
  results equal to their plain versions, which evaluate every pair;
  :func:`brute_work` counts the pairs the kernels evaluate.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from .. import profiling
from . import _cuda
from ._cuda import batch_index

# fixed generic winding-ray direction (mesh_query_pallas.py:57)
_RAY_D = (0.5773502691896258, 0.7071067811865476, 0.40824829046386296)
# the culled query's default points per tile and faces per chunk
# (mesh_query_pallas TILE_P / CULL_CHUNK); VANERF_MESH_TILE_P and
# VANERF_CULL_CHUNK pick others among the sizes the CUDA body is built for
# (:func:`cull_sizes`), and a tile's two 64-bit visit masks hold MAX_CHUNKS
TILE_P = 128
CULL_CHUNK = 128
TILE_SIZES = (64, 128, 256)
CHUNK_SIZES = (64, 128)
MAX_CHUNKS = 64
# floats per face in the kernel's table (csrc/mesh_query.cu MQ_STRIDE)
FACE_STRIDE = 22
# kernels 5 and 6 (csrc/mesh_query_brute.cu): floats per face row
# (MQB_ROW4 float4s), and the points of a block, MQB_THREADS x MQB_PPT, in
# consecutive runs of 32 a warp's point slot
BRUTE_STRIDE = 28
BRUTE_BLOCK_POINTS = 512

# launches of kernels A and 7 (the culled query), of their sweep over every
# face, and of kernels 5 and 6 (plain counters; callers reset them)
launches = 0
launches_T = 0
unculled_launches = 0
unculled_launches_T = 0
brute_launches = 0
vis_brute_launches = 0

# winding methods of kernels 5 and 6 (csrc/mesh_query_brute.cu WIND_*)
_WIND_MODES = {"none": 0, "ray": 1, "solid_angle": 2}


def cull_sizes() -> tuple[int, int]:
    """(points per tile, faces per chunk) of the culled query A / 7, read at
    call time from ``VANERF_MESH_TILE_P`` and ``VANERF_CULL_CHUNK`` (the JAX
    package reads them at import, ``mesh_query_pallas.py:30``, ``:628``).
    A value the CUDA body is not instantiated for raises."""
    out = []
    for name, default, allowed in (
            ("VANERF_MESH_TILE_P", TILE_P, TILE_SIZES),
            ("VANERF_CULL_CHUNK", CULL_CHUNK, CHUNK_SIZES)):
        raw = os.environ.get(name)
        try:
            val = default if raw is None else int(raw)
        except ValueError:
            val = None
        if val not in allowed:
            raise NotImplementedError(
                f"{name}={raw!r} is not ported to PyTorch (the culled kernel "
                f"is built for {', '.join(map(str, allowed))})")
        out.append(val)
    return out[0], out[1]


def cull_early() -> bool:
    """``VANERF_CULL_EARLY`` (off by default, as in the JAX package's
    ``_cull_lists``): walk a tile's distance chunks in ascending order of
    their box lower bound and stop at the first one above the tile's
    running largest best squared distance."""
    return os.environ.get("VANERF_CULL_EARLY", "0") not in ("", "0")


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
                               ub: torch.Tensor, far=None, cull=None,
                               chunk: int = CULL_CHUNK, walk=None):
    """Plain-PyTorch twin of kernels A and 7, over every face or, with
    ``cull``, over the (tile, chunk) pairs the culling keeps.

    Args:
      points: (N, 3); table: (F, 22) from :func:`face_table`;
      ub: (N,) certified squared-distance upper bounds;
      far: optional (N,) bool — far points skip the distance search
        (d2 := ub, qvis := 0) and keep the exact winding;
      cull: optional (mask (T, C) int32 from :func:`cull_masks`, use_neg
        (T,) bool, tile_of (N,) long): a masked (point, face) pair never
        enters the minimum (bit 0) or the crossing count (bit 1), and a
        tile with ``use_neg`` counts the crossings of the ray along
        ``-_RAY_D``.  A point whose tile visits no chunk reads d2 = inf,
        idx = 0, qvis = 0;
      chunk: faces per chunk of ``cull``'s masks;
      walk: optional early-exit walk of the distance chunks
        (:func:`early_walk_lists`: order, n_d, sorted lb, each (T, C) /
        (T,)): each tile visits its distance chunks in that order and stops
        at the first whose lb exceeds the tile's running largest best d2
        (``lb <= ub_run``, no tolerance); a chunk's faces are taken in
        ascending order with strict ``<`` as the kernel does.
    Returns:
      d2 (N,), idx (N,) int32, wind (N,), qvis (N,).
    """
    F = table.shape[0]
    N = points.shape[0]
    # (chunk, F) temporaries: ~16 MB each on the CPU, ~128 MB on a GPU
    budget = 1 << (22 if points.device.type == "cpu" else 25)
    a, b, c = table[:, 0:3], table[:, 3:6], table[:, 6:9]
    pv, w2, nn_, det = (table[:, 12:15], table[:, 15:18], table[:, 18:21],
                        table[:, 21])
    points = points.float()
    inf = torch.tensor(float("inf"), device=points.device)
    d2s, idxs, winds = [], [], []
    step = max(1, budget // max(F, 1))
    for p0 in range(0, max(N, 1), step):
        pp = points[p0:p0 + step, None, :]
        dd = point_triangle_sq_dist(pp, a[None], b[None], c[None])
        q = pp - a[None]
        u = _dot(q, pv[None])
        v = _dot(q, w2[None])
        t = _dot(q, nn_[None])
        hit = ((u * det >= 0) & (v * det >= 0)
               & ((u + v - det) * det <= 0))
        if cull is None:
            hit = hit & (t * det > 0)
            sign = torch.where(det > 0, -1.0, 1.0)
        else:
            mask, use_neg, tile_of = cull
            tile = tile_of[p0:p0 + step]
            m = mask[tile].repeat_interleave(chunk, 1)[:, :F]
            dd = torch.where((m & 1) != 0, dd, inf)
            s = torch.where(use_neg[tile], -1.0, 1.0)[:, None]
            hit = hit & (s * (t * det) > 0) & ((m & 2) != 0)
            sign = torch.where(det > 0, -s, s)
        if walk is None:
            m_, i = dd.min(-1)
        else:       # each chunk's minimum and its first face
            C = mask.shape[1]
            pad = torch.full((dd.shape[0], C * chunk - F), float("inf"),
                             device=dd.device)
            m_, i = torch.cat([dd, pad], 1).reshape(-1, C, chunk).min(-1)
            i = i + chunk * torch.arange(C, device=dd.device)
        d2s.append(m_)
        idxs.append(i)
        winds.append(torch.where(hit, sign, 0.0).sum(-1))
    d2 = torch.cat(d2s)
    idx = torch.cat(idxs)
    wind = torch.cat(winds)
    if walk is not None:
        d2, idx = _walk_early(d2, idx, *walk, cull[2])
    qvis = barycentric_vis(points, table[idx])
    if cull is not None:
        qvis = torch.where(d2 < inf, qvis, torch.zeros_like(qvis))
    if far is not None:
        d2 = torch.where(far, ub.float(), d2)
        idx = torch.where(far, torch.zeros_like(idx), idx)
        qvis = torch.where(far, torch.zeros_like(qvis), qvis)
    return d2, idx.int(), wind, qvis


def _launch_vis(entry: str, points: torch.Tensor, N: int, table, ub, far):
    """One launch of the sweep over every face (``vt_mesh_query``, points
    (N, 3), or ``vt_mesh_query_T``, points (3, N)); the caller counts it."""
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
    """Kernel A's sweep over every face, with per-point far flags; same
    contract as :func:`point_mesh_query_vis_plain` without ``cull``.  Kept
    beside the culled query for comparisons; no render path calls it."""
    global unculled_launches
    N = points.shape[0]
    _cuda.require(points, "points", torch.float32, (N, 3))
    out = _launch_vis("vt_mesh_query", points, N, table, ub, far)
    unculled_launches += 1
    return out


def point_mesh_query_vis(points, table, ub, far=None):
    """The sweep over every face: :func:`point_mesh_query_vis_cuda` on CUDA
    tensors, its plain twin on CPU tensors."""
    if points.device.type == "cpu":
        return point_mesh_query_vis_plain(points, table, ub, far)
    return point_mesh_query_vis_cuda(points, table, ub, far)


def point_mesh_query_vis_T_plain(points_T: torch.Tensor, table: torch.Tensor,
                                 ub: torch.Tensor, far=None, cull=None):
    """Plain-PyTorch version of kernel 7: :func:`point_mesh_query_vis_plain`
    read through a strided (N, 3) view of the (3, N) points (no copy), so
    the arithmetic and its results are kernel A's plain version's."""
    return point_mesh_query_vis_plain(points_T.t(), table, ub, far, cull)


def point_mesh_query_vis_T_cuda(points_T: torch.Tensor, table: torch.Tensor,
                                ub: torch.Tensor, far=None):
    """Kernel 7's sweep over every face: :func:`point_mesh_query_vis_cuda`
    on coordinate-major (3, N) points, with identical results."""
    global unculled_launches_T
    N = points_T.shape[1]
    _cuda.require(points_T, "points_T", torch.float32, (3, N))
    out = _launch_vis("vt_mesh_query_T", points_T, N, table, ub, far)
    unculled_launches_T += 1
    return out


def point_mesh_query_vis_T(points_T, table, ub, far=None):
    """:func:`point_mesh_query_vis` on (3, N) points: the sweep kernel on
    CUDA tensors, its plain version on CPU tensors."""
    if points_T.device.type == "cpu":
        return point_mesh_query_vis_T_plain(points_T, table, ub, far)
    return point_mesh_query_vis_T_cuda(points_T, table, ub, far)


# ---------------------------------------------------------------------------
# kernels 5 and 6: the exact query over every face
# ---------------------------------------------------------------------------

def brute_face_table(tri: torch.Tensor, face_vis=None) -> torch.Tensor:
    """Per-face rows (F, 28) of kernels 5 and 6: corners (9), corner
    visibility (3, zeros when not given), the UNFOLDED crossing constants
    pv = d x e2, e1, e2, det = e1 . pv (``_ray_constants``,
    ``mesh_query_pallas.py:593-602``), two zeros, and the face's sphere
    (:func:`face_spheres` of the faces as given, uncentred): 112 bytes, so
    that the kernel reads a row in 16-byte loads and stages any number of
    rows by bulk copies."""
    tri = tri.float()
    F = tri.shape[0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    # d x e2 with d's components as Python floats: the products round as
    # with a float32 tensor of d, and no host-to-device copy (which would
    # wait for the card on every call) is made
    dx, dy, dz = _RAY_D
    pv = torch.stack([dy * e2[:, 2] - dz * e2[:, 1],
                      dz * e2[:, 0] - dx * e2[:, 2],
                      dx * e2[:, 1] - dy * e2[:, 0]], -1)
    det = _dot(e1, pv)
    vis = (tri.new_zeros(F, 3) if face_vis is None else face_vis.float())
    return torch.cat([tri.reshape(F, 9), vis, pv, e1, e2, det[:, None],
                      tri.new_zeros(F, 2), face_spheres(tri)],
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
    _cuda.require(table, "table", torch.float32, (F, BRUTE_STRIDE), dev)
    if table.data_ptr() % 16:
        raise ValueError("table: the kernel's bulk copies need a 16-byte "
                         "aligned table")
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


def brute_work(points: torch.Tensor, table: torch.Tensor) -> dict:
    """What kernels 5 and 6 evaluate, in (thread, face) pairs, the ragged
    last block's repeated points included: ``sphere_tests``, every pair;
    ``evaluated``, the faces whose full distance a warp computes (all 32
    lanes of a point slot, when :func:`sphere_skip` keeps the face for any
    lane against that lane's best so far); ``windings``, every pair (a
    crossing test in ray mode, a solid angle in solid-angle mode).  A face
    a lane skips cannot lower its best, so the best before a face is the
    running minimum of the computed distances over the faces before it.
    The same for both kernels and every winding mode."""
    points = points.float()
    N, F = points.shape[0], table.shape[0]
    if N == 0 or F == 0:
        return dict(sphere_tests=0, evaluated=0, windings=0)
    dev = points.device
    n_pad = -(-N // BRUTE_BLOCK_POINTS) * BRUTE_BLOCK_POINTS
    src = torch.arange(n_pad, device=dev).clamp(max=N - 1)
    a, b, c = table[:, 0:3], table[:, 3:6], table[:, 6:9]
    sphere = table[:, 24:28]
    budget = 1 << (22 if dev.type == "cpu" else 25)
    step = max(1, budget // (32 * F)) * 32
    evaluated = 0
    for p0 in range(0, n_pad, step):
        pp = points[src[p0:p0 + step], None, :]
        dd = point_triangle_sq_dist(pp, a[None], b[None], c[None])
        best = torch.cat([torch.full_like(dd[:, :1], float("inf")),
                          dd.cummin(1).values[:, :-1]], 1)
        keep = ~sphere_skip(pp, sphere[None], best)
        evaluated += int(keep.reshape(-1, 32, F).any(1).sum()) * 32
    return dict(sphere_tests=n_pad * F, evaluated=evaluated,
                windings=n_pad * F)


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


def tile_geometry(N: int, n_samples: int | None, rays_hw=None):
    """How the culled query's tiles of points are cut from N ray-major
    points: (H, W, S, bh, bw, sb), the 2-D pixel blocks x sb depths when
    ``VANERF_BLOCK_2D`` is set and ``rays_hw`` fits (coordinate-major
    callers only), else the 1-D blocks of ``bw`` rays x ``sb`` samples
    written as H = bh = 1, or None: tiles of consecutive points, when the
    samples or the blocks do not divide (``mesh_query.py:419-428``,
    ``:481-500``).  A block must hold one tile of ``VANERF_MESH_TILE_P``
    points, as ``blocked_order``'s docstring asks (``mesh_query.py:274``):
    other block sizes raise."""
    if n_samples is None or N % n_samples:
        return None
    S = n_samples
    tile_p = cull_sizes()[0]
    geom = None
    if rays_hw is not None and rays_hw[0] * rays_hw[1] * S == N:
        b2 = blocked2d_order(rays_hw[0], rays_hw[1], S)
        if b2 is not None:
            geom = (rays_hw[0], rays_hw[1], S, *b2)
    if geom is None:
        blocks = blocked_order(N // S, S)
        if blocks is None:
            return None
        geom = (1, N // S, S, 1, blocks[0], blocks[1])
    if geom[3] * geom[4] * geom[5] != tile_p:
        raise ValueError(
            f"blocks of {geom[3]} x {geom[4]} rays x {geom[5]} samples "
            f"(VANERF_BLOCK_2D / VANERF_BLOCK_RAYS, VANERF_BLOCK_SAMPLES) "
            f"do not make one tile of VANERF_MESH_TILE_P={tile_p} points")
    return geom


def tile_order(N: int, tiles, device=None) -> torch.Tensor:
    """(N,) long: the ray-major index of the point at each position of the
    blocked order.  Tile k holds positions [k tile, (k + 1) tile)."""
    ar = torch.arange(N, device=device)
    if tiles is None:
        return ar
    return _to_blocked2d_ax1(ar[None], *tiles)[0]


def tile_boxes(points: torch.Tensor, ub: torch.Tensor, tiles=None,
               far2: float | None = None, tile_p: int = TILE_P):
    """Per tile of the blocked order: the box of its points, the largest
    bound and the far flag (every bound above ``far2``; None without
    ``far2`` or when N is no multiple of ``tile_p``), plus each point's
    tile.
    A ragged last tile is reduced over its real points (the TPU wrapper's
    edge-replicated padding, ``mesh_query_pallas.py:1058-1060``).

    points (N, 3), ub (N,) -> tmin (T, 3), tmax (T, 3), ub_t (T,),
    far_t (T,) bool or None, tile_of (N,) long.
    """
    N = points.shape[0]
    dev = points.device
    T = -(-N // tile_p)
    perm = tile_order(N, tiles, dev)
    pos = torch.arange(T * tile_p, device=dev)
    src = perm[pos.clamp(max=N - 1)] if T * tile_p != N else perm
    p = points[src].reshape(T, tile_p, 3)
    u = ub[src].reshape(T, tile_p)
    far_t = None
    if far2 is not None and N % tile_p == 0:
        far_t = u.amin(1) > far2
    tile_of = torch.empty(N, dtype=torch.long, device=dev)
    tile_of[perm] = pos[:N] // tile_p
    return p.amin(1), p.amax(1), u.amax(1), far_t, tile_of


def face_chunk_boxes(tri: torch.Tensor,
                     chunk: int = CULL_CHUNK) -> torch.Tensor:
    """(C, 6) corner boxes [min | max] of the chunks of ``chunk`` faces; a
    short last chunk's box is that of its real faces (the TPU pads with
    faces at -1e9 instead, ``mesh_query_pallas.py:1017-1020``)."""
    F = tri.shape[0]
    C = -(-F // chunk)
    if C * chunk != F:
        tri = tri[torch.arange(C * chunk,
                               device=tri.device).clamp(max=F - 1)]
    corners = tri.reshape(C, chunk * 3, 3)
    return torch.cat([corners.amin(1), corners.amax(1)], -1).contiguous()


def cull_masks(tmin: torch.Tensor, tmax: torch.Tensor, ub_t: torch.Tensor,
               cbox: torch.Tensor, far_t=None):
    """Which face chunks each point tile visits (``_cull_masks_from_boxes``
    and the far rule of ``_cull_lists``, ``mesh_query_pallas.py:894-977``).

    Distance: chunk kept when the box-to-box gap ``lb`` satisfies ``lb <=
    ub_t (1 + 1e-5) + 1e-12`` and the tile is not far.  Winding: chunk kept
    when the tile box swept along the ray can reach the chunk box, by a
    conservative separating-axis test (per-axis half spaces, the ray axis,
    the three axes d x e_k); each tile takes ``+_RAY_D`` or ``-_RAY_D``,
    whichever keeps fewer chunks.  The expressions are written out in the
    kernel's order, so the kernel's masks equal these.

    Args:
      tmin, tmax (T, 3), ub_t (T,), far_t (T,) bool or None: from
        :func:`tile_boxes`; cbox (C, 6): from :func:`face_chunk_boxes`.
    Returns:
      mask (T, C) int32 (bit 0 distance, bit 1 winding), use_neg (T,) bool,
      lb (T, C).
    """
    cmin, cmax = cbox[None, :, 0:3], cbox[None, :, 3:6]        # (1, C, 3)
    tlo, thi = tmin[:, None], tmax[:, None]                    # (T, 1, 3)
    gap = torch.clamp_min(torch.maximum(cmin - thi, tlo - cmax), 0.0)
    lb = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]
          + gap[..., 2] * gap[..., 2])
    need_d = lb <= ub_t[:, None] * (1.0 + 1e-5) + 1e-12
    if far_t is not None:
        need_d = need_d & ~far_t[:, None]

    d0, d1, d2 = torch.tensor(_RAY_D, dtype=torch.float32).tolist()
    tcen, text = 0.5 * (tlo + thi), 0.5 * (thi - tlo)
    ccen, cext = 0.5 * (cmin + cmax), 0.5 * (cmax - cmin)

    def along_d(v):
        return v[..., 0] * d0 + v[..., 1] * d1 + v[..., 2] * d2

    def cross_axes(v, sign):
        # projections on d x e_k: (0, d2, -d1), (-d2, 0, d0), (d1, -d0, 0);
        # sign -1 gives the extents, on the axes' absolute values
        return (v[..., 1] * d2 - sign * (v[..., 2] * d1),
                v[..., 2] * d0 - sign * (v[..., 0] * d2),
                v[..., 0] * d1 - sign * (v[..., 1] * d0))

    cross_ok = None
    for tp, cp, tr, cr in zip(cross_axes(tcen, 1.0), cross_axes(ccen, 1.0),
                              cross_axes(text, -1.0), cross_axes(cext, -1.0)):
        ok = (tp - cp).abs() <= tr + cr + 1e-7
        cross_ok = ok if cross_ok is None else cross_ok & ok
    t_al, c_al = along_d(tcen), along_d(ccen)
    t_ex, c_ex = along_d(text), along_d(cext)      # |d| = d: all positive
    w_pos = ((cmax >= tlo).all(-1) & (c_al + c_ex >= t_al - t_ex)
             & cross_ok)
    w_neg = ((cmin <= thi).all(-1) & (-c_al + c_ex >= -t_al - t_ex)
             & cross_ok)
    use_neg = w_neg.sum(-1) < w_pos.sum(-1)
    need_w = torch.where(use_neg[:, None], w_neg, w_pos)
    mask = need_d.int() | (need_w.int() << 1)
    return mask, use_neg, lb


def early_walk_lists(mask: torch.Tensor, lb: torch.Tensor):
    """The early-exit walk's distance lists (``_cull_lists`` under
    ``VANERF_CULL_EARLY``, ``mesh_query_pallas.py:970-990``): per tile the
    chunk ids in ascending order of their lower bound ``lb`` (a stable sort:
    equal bounds keep ascending ids; chunks without the distance bit
    follow), the number of distance chunks and the sorted bounds (+inf past
    that number).  mask, lb (T, C) -> order (T, C) long, n_d (T,), lb (T, C).
    The kernel ranks the same keys in shared memory."""
    need_d = (mask & 1) != 0
    key = torch.where(need_d, lb, torch.full_like(lb, float("inf")))
    lb_sorted, order = torch.sort(key, dim=1, stable=True)
    return order, need_d.sum(1), lb_sorted


def _walk_early(cmin: torch.Tensor, carg: torch.Tensor, order, n_d,
                lb_sorted, tile_of):
    """Each tile's points take the chunks of ``order`` one after another
    while ``lb <= ub_run``, the tile's largest best d2 so far (+inf before
    the first chunk); a chunk's minimum replaces a point's best only when
    strictly smaller.  cmin / carg (N, C): each point's minimum over each
    chunk and its first face (+inf off the distance mask)."""
    N = cmin.shape[0]
    T, C = order.shape
    dev = cmin.device
    best = torch.full((N,), float("inf"), device=dev)
    bidx = torch.zeros(N, dtype=carg.dtype, device=dev)
    ub_run = torch.full((T,), float("inf"), device=dev)
    rows = torch.arange(N, device=dev)
    for k in range(C):
        go = (k < n_d) & (lb_sorted[:, k] <= ub_run)
        if not go.any():
            break
        c = order[tile_of, k]
        v = cmin[rows, c]
        take = go[tile_of] & (v < best)
        best = torch.where(take, v, best)
        bidx = torch.where(take, carg[rows, c], bidx)
        run = torch.full((T,), float("-inf"), device=dev).scatter_reduce(
            0, tile_of, best, "amax")
        ub_run = torch.where(go, run, ub_run)
    return best, bidx


def _visits(mask: torch.Tensor) -> torch.Tensor:
    """(T, 2) int32: distance and winding chunks each tile visits."""
    return torch.stack([(mask & 1).sum(1), (mask >> 1).sum(1)], 1).int()


def point_mesh_query_vis_culled_plain(points: torch.Tensor, mesh: dict,
                                      ub: torch.Tensor, tiles=None,
                                      far2: float | None = None,
                                      visits: bool = False):
    """Plain-PyTorch version of the culled kernel A (same contract as
    :func:`point_mesh_query_vis_culled`): the tiles' boxes, the masks of
    :func:`cull_masks`, then :func:`point_mesh_query_vis_plain` over the
    pairs they keep."""
    tile_p, chunk = _sizes_for(mesh)
    points = points.float()
    ub = ub.float()
    tmin, tmax, ub_t, far_t, tile_of = tile_boxes(points, ub, tiles, far2,
                                                  tile_p)
    mask, use_neg, lb = cull_masks(tmin, tmax, ub_t, mesh["cbox"], far_t)
    far = far_t[tile_of] if far_t is not None else None
    walk = early_walk_lists(mask, lb) if cull_early() else None
    out = point_mesh_query_vis_plain(points, mesh["table"], ub, far,
                                     (mask, use_neg, tile_of), chunk,
                                     walk) + (far,)
    return out + (_visits(mask),) if visits else out


def point_mesh_query_vis_culled_T_plain(points_T: torch.Tensor, mesh: dict,
                                        ub: torch.Tensor, tiles=None,
                                        far2: float | None = None,
                                        visits: bool = False):
    """Plain-PyTorch version of the culled kernel 7: the (3, N) points read
    through a strided (N, 3) view (no copy)."""
    return point_mesh_query_vis_culled_plain(points_T.t(), mesh, ub, tiles,
                                             far2, visits)


def _sizes_for(mesh: dict) -> tuple[int, int]:
    """:func:`cull_sizes`, which must agree with the chunk size the mesh
    was prepared with."""
    tile_p, chunk = cull_sizes()
    if mesh["chunk"] != chunk:
        raise ValueError(f"the mesh was prepared in chunks of "
                         f"{mesh['chunk']} faces, VANERF_CULL_CHUNK is "
                         f"{chunk}: prepare it again")
    return tile_p, chunk


def stacked(mesh: dict) -> bool:
    """Whether ``mesh`` is a stack of prepared meshes
    (:func:`stack_culled_meshes`) rather than one."""
    return mesh["table"].dim() == 3


def stack_culled_meshes(meshes) -> dict:
    """One stack of the prepared meshes of :func:`prepare_culled_mesh` (of
    one face list, so F and C are the same for each): table (Bm, F, 22), a
    view into rows of Fp = F rounded up to even (each mesh's rows then
    start on a 16-byte boundary, and a mesh of an odd F has its padding
    row), center (Bm, 3), cbox (Bm, C, 6), sphere (Bm, F, 4), order
    (Bm, F).  :func:`mesh_element` gives mesh m back, bit for bit."""
    F = meshes[0]["table"].shape[0]
    rows = meshes[0]["table"].new_zeros(len(meshes), F + F % 2, FACE_STRIDE)
    rows[:, :F] = torch.stack([m["table"] for m in meshes])
    out = {k: torch.stack([m[k] for m in meshes])
           for k in ("center", "cbox", "sphere", "order")}
    return dict(out, table=rows[:, :F], chunk=meshes[0]["chunk"])


def mesh_element(mesh: dict, m: int) -> dict:
    """Mesh ``m`` of a stack as one prepared mesh (views, no copies; the
    table keeps a padding row behind it in storage where its F is odd)."""
    return {k: (v[m] if torch.is_tensor(v) else v) for k, v in mesh.items()}


def _launch_culled(entry: str, points: torch.Tensor, mesh: dict,
                   ub: torch.Tensor, tiles, far2, visits: bool, soa: bool):
    """One launch of the culled kernel A (``vt_mesh_query_culled``, points
    (B, N, 3)) or 7 (``vt_mesh_query_culled_T``, points (B, 3, N)) against
    a stack of Bm meshes, element e on mesh e % Bm, or of one element
    ((N, 3) / (3, N) points, one mesh); the caller counts it."""
    tile_p, chunk = _sizes_for(mesh)
    table, cbox, sphere = mesh["table"], mesh["cbox"], mesh["sphere"]
    batched = points.dim() == 3
    lead = points.shape[:1] if batched else ()
    mlead = table.shape[:1] if batched else ()
    B, Bm = (lead[0], mlead[0]) if batched else (1, 1)
    N = points.shape[-1] if soa else points.shape[-2]
    F, C = table.shape[-2], cbox.shape[-2]
    dev = points.device
    _cuda.require(points, "points_T" if soa else "points", torch.float32,
                  lead + ((3, N) if soa else (N, 3)))
    if not (table.is_cuda and table.device == dev
            and table.dtype == torch.float32
            and table.shape == mlead + (F, FACE_STRIDE)
            and table.stride()[-2:] == (FACE_STRIDE, 1)):
        raise ValueError("table: (F, 22) float32 rows, or a stack of them, "
                         f"on {dev}")
    # floats between the meshes' tables (one mesh: never read, but what a
    # stack of it would need)
    fstride = (table.stride(0) if Bm > 1
               else -(-(F * FACE_STRIDE + 2) // 4) * 4)
    _cuda.require(cbox, "cbox", torch.float32, mlead + (C, 6), dev)
    _cuda.require(sphere, "sphere", torch.float32, mlead + (F, 4), dev)
    _cuda.require(ub, "ub", torch.float32, lead + (N,), dev)
    if C > MAX_CHUNKS or C != -(-F // chunk):
        raise ValueError(f"culled mesh query: {F} faces make {C} chunks of "
                         f"{chunk}; a tile's visit masks hold {MAX_CHUNKS}")
    # the kernel copies a chunk's rows with 16-byte bulk copies: each
    # mesh's table and spheres start on a 16-byte boundary, and a last chunk
    # of an odd number of faces reads the padding row prepare_culled_mesh
    # (or stack_culled_meshes) keeps behind each table
    pad_end = (table.storage_offset() + (Bm - 1) * fstride
               + F * FACE_STRIDE + 2) * 4
    if (table.data_ptr() % 16 or sphere.data_ptr() % 16 or fstride % 4
            or fstride < F * FACE_STRIDE + (2 if F % chunk % 2 else 0)
            or (F % chunk % 2 and table.untyped_storage().nbytes() < pad_end)):
        raise ValueError("culled mesh query: the face table and spheres "
                         "must come from prepare_culled_mesh")
    with_far = far2 is not None and N % tile_p == 0
    geom = (ctypes.c_int * 6)(*(tiles if tiles is not None else (0,) * 6))
    d2 = torch.empty(lead + (N,), dtype=torch.float32, device=dev)
    idx = torch.empty(lead + (N,), dtype=torch.int32, device=dev)
    wind = torch.empty(lead + (N,), dtype=torch.float32, device=dev)
    qvis = torch.empty(lead + (N,), dtype=torch.float32, device=dev)
    far = (torch.empty(lead + (N,), dtype=torch.bool, device=dev)
           if with_far else None)
    count = (torch.empty(lead + (-(-N // tile_p), 2), dtype=torch.int32,
                         device=dev) if visits else None)
    rc = getattr(_cuda.lib(), entry)(
        points.data_ptr(), N, B, table.data_ptr(), sphere.data_ptr(), F, Bm,
        fstride, cbox.data_ptr(), C, ub.data_ptr(),
        float(far2) if with_far else -1.0, geom, tile_p, chunk,
        int(cull_early()), d2.data_ptr(), idx.data_ptr(), wind.data_ptr(),
        qvis.data_ptr(), far.data_ptr() if with_far else None,
        count.data_ptr() if visits else None, _cuda.stream_ptr(dev))
    _cuda.check(rc, entry)
    out = (d2, idx, wind, qvis, far)
    return out + (count,) if visits else out


def _culled(entry: str, plain, points, mesh, ub, tiles, far2, visits,
            soa: bool):
    """Kernel A / 7 on CUDA points (one launch for a batch), the plain
    version on CPU points (one call a batch element, element e on mesh
    e % Bm)."""
    batched = points.dim() == 3
    if batched != stacked(mesh):
        raise ValueError("batched points take a stack of meshes "
                         "(stack_culled_meshes), single points one mesh")
    if points.device.type != "cpu":
        return _launch_culled(entry, points, mesh, ub, tiles, far2, visits,
                              soa)
    if not batched:
        return plain(points, mesh, ub, tiles, far2, visits)
    Bm = mesh["table"].shape[0]
    outs = [plain(points[e], mesh_element(mesh, e % Bm), ub[e], tiles, far2,
                  visits) for e in range(points.shape[0])]
    return tuple(None if o[0] is None else torch.stack(o)
                 for o in zip(*outs))


def point_mesh_query_vis_culled(points: torch.Tensor, mesh: dict,
                                ub: torch.Tensor, tiles=None,
                                far2: float | None = None,
                                visits: bool = False):
    """Kernel A, the culled query, on CUDA tensors; its plain version on
    CPU tensors.

    Args:
      points: (N, 3) centred points, ray-major, or (B, N, 3) for a batch
        in one launch; mesh: from :func:`prepare_culled_mesh`, or with a
        batch a stack (:func:`stack_culled_meshes`), element e on mesh
        e % Bm; ub: (N,) or (B, N) certified squared-distance
        upper bounds (they drive the culling: a bound below the true
        distance loses faces);
      tiles: from :func:`tile_geometry`, how tiles of points are cut
        from the ray-major order (None: consecutive points).  A block of
        the kernel is a tile and finds its points by index arithmetic: no
        relayouted copy of points or outputs is made;
      far2: optional squared far threshold: a tile whose every bound
        exceeds it skips the distance search (d2 := ub, idx := 0,
        qvis := 0) and keeps its exact winding (off when N is no multiple
        of the tile);
      visits: also return the (T, 2) int32 numbers of distance and winding
        chunks each tile visited.
    The tile and chunk sizes are :func:`cull_sizes`'; under
    ``VANERF_CULL_EARLY`` (:func:`cull_early`) a tile walks its distance
    chunks in ascending order of their lower bound and stops early: d2 is
    the default walk's, idx and qvis may differ where faces tie.  Every
    element of a batch has the same N, so the same tiles and far tier.
    Returns:
      d2 (N,), idx (N,) int32 into the mesh's sorted faces, wind (N,),
      qvis (N,), far (N,) bool or None[, visits]; with a batch each with a
      leading B.
    """
    global launches
    out = _culled("vt_mesh_query_culled", point_mesh_query_vis_culled_plain,
                  points, mesh, ub, tiles, far2, visits, soa=False)
    if points.is_cuda:
        launches += 1
    return out


def point_mesh_query_vis_culled_T(points_T: torch.Tensor, mesh: dict,
                                  ub: torch.Tensor, tiles=None,
                                  far2: float | None = None,
                                  visits: bool = False):
    """Kernel 7: :func:`point_mesh_query_vis_culled` on coordinate-major
    (3, N) points, or (B, 3, N) for a batch, with identical results."""
    global launches_T
    out = _culled("vt_mesh_query_culled_T",
                  point_mesh_query_vis_culled_T_plain, points_T, mesh, ub,
                  tiles, far2, visits, soa=True)
    if points_T.is_cuda:
        launches_T += 1
    return out


def _morton_order(centroids: torch.Tensor) -> torch.Tensor:
    """Morton (z-curve) sort order of 3-D points, 10 bits an axis
    (``mesh_query.py:305-321``): spatially coherent chunks have tight
    boxes.  The codes are built in int64 and masked: not every torch op
    knows uint32 on the CPU."""
    lo = centroids.amin(0)
    hi = centroids.amax(0)
    q = (centroids - lo) / torch.clamp_min(hi - lo, 1e-9) * 1023.0
    q = q.clamp(0, 1023).to(torch.int64)

    def spread(x):  # interleave 10 bits with two zero bits
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return torch.argsort(code, stable=True)


def face_spheres(tri: torch.Tensor) -> torch.Tensor:
    """(F, 4) rows [centre | radius'] of the per-face rejection test of
    the culled kernel and of kernels 5 and 6 (:func:`sphere_skip`; the
    latter's in :func:`brute_face_table`): the centroid, and the largest
    corner distance widened by 1e-4 of itself and 1e-5 of the mesh's
    largest corner norm R, which covers the rounding of the test and of the
    distance it stands in for (``csrc/mesh_query.cu``, the proof there).  A
    sliver (twice its area below 1e-2 of its longest edge squared, zero
    area included) gets an infinite radius and is never skipped: its
    distance's rounding is not bounded by the margins."""
    tri = tri.float()
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    cen = (a + b + c) / 3.0
    dv = tri - cen[:, None]                   # the three corners at once
    rad = _dot(dv, dv).amax(1).sqrt()
    R = tri.reshape(-1, 3).norm(dim=1).amax() if tri.numel() else \
        torch.zeros((), device=tri.device)
    edges = torch.stack([b - a, c - a, c - b], 1)        # ab, ac, bc
    n = _cross(edges[:, 0], edges[:, 1])
    longest = _dot(edges, edges).amax(1)
    sliver = ~(_dot(n, n).sqrt() > 1e-2 * longest)
    rad = rad * (1.0 + 1e-4) + 1e-5 * R
    rad = torch.where(sliver, torch.full_like(rad, float("inf")), rad)
    return torch.cat([cen, rad[:, None]], 1).contiguous()


def sphere_skip(points: torch.Tensor, sphere: torch.Tensor,
                best: torch.Tensor) -> torch.Tensor:
    """The per-face rejection of the culled kernel and of kernels 5 and 6,
    written as the kernels evaluate it: skip face f for a point whose best
    squared distance so far is ``best`` when
    |p - c_f|^2 > (r'_f + sqrt(best) (1 + 1e-4))^2.
    Broadcasting points (..., 3), sphere (..., 4), best (...) -> bool.  It
    never skips a face whose computed ``point_triangle_sq_dist`` lies below
    ``best``, so d2, idx and qvis do not change."""
    sb = torch.sqrt(best) * 1.0001
    dx = points[..., 0] - sphere[..., 0]
    dy = points[..., 1] - sphere[..., 1]
    dz = points[..., 2] - sphere[..., 2]
    e = dx * dx + dy * dy + dz * dz
    t = sphere[..., 3] + sb
    return e > t * t


def culled_work(points: torch.Tensor, mesh: dict, ub: torch.Tensor,
                tiles=None, far2: float | None = None) -> dict:
    """What the culled kernel's default walk evaluates, in (thread, face)
    pairs, a ragged last tile's repeated points included: ``sphere_tests``,
    every face of a tile's distance chunks; ``evaluated``, the faces whose
    full distance a warp computes (all 32 lanes, when :func:`sphere_skip`
    keeps the face for any lane against that lane's best so far);
    ``crossings``, every face of its winding chunks.  A face a lane skips
    cannot lower its best, so the best before a face is the running
    minimum of the computed distances over the distance chunks' faces
    before it in ascending order."""
    tile_p, chunk = _sizes_for(mesh)
    points = points.float()
    ub = ub.float()
    tmin, tmax, ub_t, far_t, _ = tile_boxes(points, ub, tiles, far2, tile_p)
    mask, _use_neg, _lb = cull_masks(tmin, tmax, ub_t, mesh["cbox"], far_t)
    table, sphere = mesh["table"], mesh["sphere"]
    F, N = table.shape[0], points.shape[0]
    T = mask.shape[0]
    dev = points.device
    face_d = (mask & 1).bool().repeat_interleave(chunk, 1)[:, :F]   # (T, F)
    face_w = (mask & 2).bool().repeat_interleave(chunk, 1)[:, :F]
    perm = tile_order(N, tiles, dev)
    src = perm[torch.arange(T * tile_p, device=dev).clamp(max=N - 1)]
    a, b, c = table[:, 0:3], table[:, 3:6], table[:, 6:9]
    budget = 1 << (22 if dev.type == "cpu" else 25)
    tiles_step = max(1, budget // max(F * tile_p, 1))
    evaluated = 0
    for t0 in range(0, T, tiles_step):
        m = face_d[t0:t0 + tiles_step].repeat_interleave(tile_p, 0)
        pp = points[src[t0 * tile_p:(t0 + tiles_step) * tile_p], None, :]
        dd = torch.where(m, point_triangle_sq_dist(pp, a[None], b[None],
                                                   c[None]),
                         torch.tensor(float("inf"), device=dev))
        best = torch.cat([torch.full_like(dd[:, :1], float("inf")),
                          dd.cummin(1).values[:, :-1]], 1)
        keep = m & ~sphere_skip(pp, sphere[None], best)
        evaluated += int(keep.reshape(-1, 32, F).any(1).sum()) * 32
    return dict(sphere_tests=int(face_d.sum()) * tile_p, evaluated=evaluated,
                crossings=int(face_w.sum()) * tile_p)


def prepare_culled_mesh(verts: torch.Tensor, faces: torch.Tensor,
                        vert_vis: torch.Tensor) -> dict:
    """Once-per-mesh preparation for :func:`cal_vis_sdf_prepared`: centre
    the mesh (coordinates stay O(hand size)), Morton-sort the faces by
    centroid so that chunks of faces are compact (the closest face's index
    is not used downstream), and build the kernel's face table (a padding
    row kept behind it in storage for the kernel's 16-byte bulk copies),
    the per-face spheres and the chunks' boxes, in chunks of
    ``VANERF_CULL_CHUNK`` faces (:func:`cull_sizes`).  verts (V, 3), faces
    (F, 3), vert_vis (V, 1)."""
    chunk = cull_sizes()[1]
    center = 0.5 * (verts.amin(0) + verts.amax(0))
    f = faces.long()
    tri = verts[f] - center                              # (F, 3, 3)
    order = _morton_order(tri.mean(1))
    tri = tri[order]
    face_vis = vert_vis[..., 0][f[order]]                # (F, 3)
    table = face_table(tri, face_vis)
    table = torch.cat([table, torch.zeros_like(table[:1])])[:-1]
    return {"table": table, "center": center,
            "cbox": face_chunk_boxes(tri.float(), chunk),
            "sphere": face_spheres(tri), "order": order, "chunk": chunk}


def _finish_prepared(d2, wind, qv, dtype):
    return _signed(d2, wind), (qv >= 1e-1).to(dtype)[..., None]


def _count_visits(visits: torch.Tensor, mesh: dict) -> None:
    """The counters ``a_pairs_visited`` (distance chunks the tiles visited)
    and ``a_pairs`` (tiles x chunks) of one culled query's (..., T, 2)
    visits."""
    d = visits[..., 0]
    profiling.count("a_pairs", d.numel() * mesh["cbox"].shape[-2])
    profiling.count_device("a_pairs_visited", d.sum())


def _culled_query(fn, pts, mesh, ub, tiles, far2):
    """Kernel A / 7 (``fn``) for the prepared callers: the tiles' visits
    are asked for, and counted, only while a profiler records (the
    kernel's visits pointer stays null otherwise)."""
    if not profiling.recording():
        return fn(pts, mesh, ub, tiles, far2)
    *out, visits = fn(pts, mesh, ub, tiles, far2, visits=True)
    _count_visits(visits, mesh)
    return tuple(out)


def _centers(mesh: dict, B: int) -> torch.Tensor:
    """(B, 3): the centre of each batch element's mesh of a stack."""
    c = mesh["center"]
    return c[batch_index(B, c.shape[0], c.device)]


def cal_vis_sdf_prepared(mesh: dict, points: torch.Tensor,
                         ub_d2: torch.Tensor, n_samples: int | None = None,
                         far2: float | None = None):
    """SDF + binarised interpolated visibility (+ far mask) per point, by
    the culled query.

    Args:
      mesh: from :func:`prepare_culled_mesh`, or a stack
        (:func:`stack_culled_meshes`) for batched points.
      points: (N, 3), ray-major (rays x n_samples, sample fastest), or
        (B, N, 3) for a batch in one launch, element e on mesh e % Bm.
      ub_d2: (N,) / (B, N) nearest-vertex squared distances (certified
        bounds).
      n_samples: samples per ray: the tiles are then 16 rays x 8 samples
        (``VANERF_BLOCK_RAYS`` / ``VANERF_BLOCK_SAMPLES``), compact in all
        three dimensions, which is what the culling feeds on.
      far2: optional squared far-field threshold: tiles whose every bound
        exceeds it skip the distance search; |sdf| := sqrt(ub + 1e-6),
        query_vis := 0, exact sign.
    Returns:
      sdf (N,), query_vis (N, 1) float 0/1, far (N,) bool or None; with a
      batch each with a leading B.
    """
    tiles = tile_geometry(points.shape[-2], n_samples)
    center = (_centers(mesh, points.shape[0])[:, None] if points.dim() == 3
              else mesh["center"])
    pts = (points.float() - center).contiguous()
    d2, _idx, wind, qv, far = _culled_query(
        point_mesh_query_vis_culled, pts, mesh, ub_d2.float().contiguous(),
        tiles, far2)
    return (*_finish_prepared(d2, wind, qv, points.dtype), far)


def cal_vis_sdf_prepared_T(mesh: dict, points_T: torch.Tensor,
                           ub_d2: torch.Tensor, n_samples: int | None = None,
                           rays_hw: tuple | None = None,
                           far2: float | None = None):
    """Coordinate-major :func:`cal_vis_sdf_prepared`: (3, N) points go to
    kernel 7 as they are (centred as ``points_T - center[:, None]``; no
    (N, 3) copy is made), with identical results.

    rays_hw: optional (H, W) shape of the ray grid (rays row-major): with
    ``VANERF_BLOCK_2D`` set, the tiles are the 2-D pixel blocks (which
    points are far depends on the tiling).  Batched: (B, 3, N) points on a
    stack of meshes, as :func:`cal_vis_sdf_prepared`.
    """
    tiles = tile_geometry(points_T.shape[-1], n_samples, rays_hw)
    center = (_centers(mesh, points_T.shape[0])[:, :, None]
              if points_T.dim() == 3 else mesh["center"][:, None])
    pts_T = (points_T.float() - center).contiguous()
    d2, _idx, wind, qv, far = _culled_query(
        point_mesh_query_vis_culled_T, pts_T, mesh,
        ub_d2.float().contiguous(), tiles, far2)
    return (*_finish_prepared(d2, wind, qv, points_T.dtype), far)


def cal_vis_sdf_cull(verts: torch.Tensor, faces: torch.Tensor,
                     points: torch.Tensor, vert_vis: torch.Tensor,
                     ub_d2: torch.Tensor, n_samples: int | None = None):
    """Single-shot prepare + :func:`cal_vis_sdf_prepared` (no far tier:
    the returned far mask is None)."""
    mesh = prepare_culled_mesh(verts, faces, vert_vis)
    return cal_vis_sdf_prepared(mesh, points, ub_d2, n_samples=n_samples)
