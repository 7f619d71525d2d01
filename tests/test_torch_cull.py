"""The port's culled queries against the JAX package, on the CPU: kernel 9
(the landmark-culled nearest-vertex search, ``VANERF_KNN_CULL``) and the
branch-and-bound culling of kernels A and 7.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode) and the port's plain versions, which CPU tensors take.
Tolerances: the visited (tile, chunk) sets, their counts and the per-tile
ray direction are held EQUAL to ``_knn_cull_lists`` and to ``_cull_masks``
+ ``_cull_lists``; kernel 9's plain version equals kernel B's bit for bit
and the JAX culled kernel in the index, in d2 to rtol 1e-6 (XLA contracts
dx*dx + dy*dy + dz*dz into fused multiply-adds on the CPU, as
``tests/test_pallas_kernels.py:383`` records for B); the culled mesh query
equals the port's sweep over the same sorted table bit for bit, and the JAX
culled kernel as ``tests/test_pallas_kernels.py:111`` and ``:403`` hold it:
d2 rtol 1e-4 / atol 1e-8 (its closed forms |p|^2 - 2 p.a + |a|^2 round to a
few ulps of |p|^2 ~ 1e-2, which shows on points that touch the surface; the
tolerance ``tests/test_torch_mesh_api.py`` holds the other Pallas mesh kernels
to), winding equal, the chosen face reaching the minimum, the interpolated
visibility rtol 1e-3 / atol 1e-4 where the same face wins.

The tests marked ``cuda`` build the kernels and hold them against their
plain versions on the card; run them there with ``--noconftest``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

import torch_port_helpers as h
from oracles import make_icosphere
from vanerf_tpu_torch.ops import knn as t_knn
from vanerf_tpu_torch.ops import mesh_query as t_mq


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def A(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# fixtures: numpy inputs from seeds
# ---------------------------------------------------------------------------

def _clustered():
    """The clustered case of ``tests/test_pallas_kernels.py:335``: two
    index-coherent vertex clusters and four tight point tiles."""
    rng = np.random.default_rng(3)
    h0 = rng.normal(size=(779, 3)).astype(np.float32) * 40.0
    h1 = rng.normal(size=(779, 3)).astype(np.float32) * 40.0 + 300.0
    verts = np.concatenate([h0[np.argsort(h0[:, 0])],
                            h1[np.argsort(h1[:, 0])]])
    centers = np.array([[0, 0, 0], [300, 300, 300], [150, 150, 150],
                        [-80, 40, 10]], np.float32)
    pts = (centers[:, None] + rng.normal(size=(4, 256, 3)) * 15.0
           ).reshape(-1, 3).astype(np.float32)
    return verts, pts


def _ray_points(H, W, S, spread=2.2, t0=0.45, t1=0.75):
    """Ray-major points (H x W rays, S depths from t0 to t1) over the
    fixture hands; the rays of the right half and of the lower rows pass
    far from them."""
    verts = h.synthetic_batch()[0]["verts"][0]
    lo, hi = verts.min(0), verts.max(0)
    ys, xs = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    tgt = np.stack([lo[0] + xs * (hi[0] - lo[0]) * spread,
                    lo[1] + ys * (hi[1] - lo[1]) * spread,
                    np.full_like(xs, 0.5 * (lo[2] + hi[2]))], -1)
    o = np.array([0.0, 0.0, 0.6], np.float32)
    d = tgt.reshape(-1, 3) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t = np.linspace(t0, t1, S)
    return (o + d[:, None] * t[None, :, None]).reshape(-1, 3) \
        .astype(np.float32)


def _hands(seed=6):
    batch, faces = h.synthetic_batch()
    verts = batch["verts"][0]
    vis = (np.random.RandomState(seed).rand(len(verts), 1) > 0.4) \
        .astype(np.float32)
    return verts, faces, vis


def _jax_knn_lists(pts, verts):
    """(need (T, C) bool, counts (T,)) from ``_knn_cull_lists`` on the
    edge-padded tiles."""
    from vanerf_tpu.ops import knn_pallas as kp
    pad = (-len(pts)) % kp.TILE_P
    tiles = np.pad(pts, ((0, pad), (0, 0)), mode="edge") \
        .reshape(-1, kp.TILE_P, 3)
    vt = np.pad(verts.T, ((0, 0), (0, (-len(verts)) % kp.VERT_CHUNK)),
                mode="edge")
    C = vt.shape[1] // kp.VERT_CHUNK
    rows = A(kp._knn_cull_lists(jnp.asarray(tiles.min(1)),
                                jnp.asarray(tiles.max(1)), jnp.asarray(vt),
                                kp.VERT_CHUNK)).reshape(-1, 128)
    need = np.zeros((rows.shape[0], C), bool)
    for t, row in enumerate(rows):
        ids = row[:row[127]]
        assert (np.diff(ids) > 0).all(), "ascending"
        need[t, ids] = True
    return need, rows[:, 127], tiles


# ---------------------------------------------------------------------------
# kernel 9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["clustered", "ray_patch"])
def test_knn_cull_lists_match_jax(case):
    if case == "clustered":
        verts, pts = _clustered()
    else:       # a ray-major patch: 4 rays x 64 samples a tile, long boxes
        verts = h.synthetic_batch()[0]["verts"][0]
        pts = _ray_points(4, 8, 64)
    need_j, counts_j, tiles = _jax_knn_lists(pts, verts)
    need_t, counts_t = t_knn.knn_cull_lists(T(tiles.min(1)), T(tiles.max(1)),
                                            T(verts))
    np.testing.assert_array_equal(need_t.numpy(), need_j)
    np.testing.assert_array_equal(counts_t.numpy(), counts_j)
    assert counts_t.dtype == torch.int32 and (counts_t > 0).all()
    if case == "clustered":
        assert counts_t.sum() < 0.7 * need_t.numel(), counts_t


@pytest.mark.parametrize("n", [1024, 1000, 100])
@pytest.mark.parametrize("layout", ["N3", "3N"])
def test_knn_culled_plain_equals_kernel_b_and_jax(layout, n):
    from vanerf_tpu.ops import knn_pallas as kp
    verts, pts = _clustered()
    pts = pts[:n]
    idx_b, d2_b = t_knn.nearest_vertex_d2_plain(T(pts), T(verts))
    if layout == "N3":
        idx_t, d2_t, visits = t_knn.nearest_vertex_d2_culled(
            T(pts), T(verts), visits=True)
        idx_j, d2_j = kp.nearest_vertex_d2_pallas_culled(
            jnp.asarray(pts), jnp.asarray(verts), interpret=True)
    else:
        idx_t, d2_t, visits = t_knn.nearest_vertex_d2_T_culled(
            T(pts.T), T(verts), visits=True)
        idx_j, d2_j = kp.nearest_vertex_d2_pallas_T_culled(
            jnp.asarray(pts.T), jnp.asarray(verts), interpret=True)
    assert idx_t.dtype == torch.int32 and d2_t.dtype == torch.float32
    assert torch.equal(idx_t, idx_b) and torch.equal(d2_t, d2_b)
    np.testing.assert_array_equal(idx_t.numpy(), A(idx_j))
    np.testing.assert_allclose(d2_t.numpy(), A(d2_j), rtol=1e-6, atol=1e-9)
    # the visits are those of the lists, and the tiles really cull
    _, counts_j, _ = _jax_knn_lists(pts, verts)
    np.testing.assert_array_equal(visits.numpy(), counts_j)
    assert visits.shape == (-(-n // 256),)
    assert visits.sum() < visits.numel() * 13


@pytest.mark.parametrize("n,v", [(1, 1), (63, 127), (257, 129),
                                 (1000, 1284), (1, 1284), (1000, 1),
                                 (63, 129), (257, 127)])
@pytest.mark.parametrize("layout", ["N3", "3N"])
def test_knn_culled_plain_at_ragged_sizes_matches_jax(layout, n, v):
    """Kernel 9's plain version where N is no multiple of the 256-point
    tile (one point, less than a tile, a tile and one) and V no multiple of
    the 128-vertex chunk (one vertex, a chunk less or more one, the
    fixture's 1,284): the visits equal ``_knn_cull_lists``, idx JAX's
    ``_culled_common`` in interpret mode and kernel B's, d2 kernel B's bit
    for bit and JAX's to rtol 1e-6."""
    from vanerf_tpu.ops import knn_pallas as kp
    verts, pts = _clustered()
    verts, pts = verts[:v], pts[::-1][:n].copy()
    idx_b, d2_b = t_knn.nearest_vertex_d2_plain(T(pts), T(verts))
    if layout == "N3":
        idx_t, d2_t, visits = t_knn.nearest_vertex_d2_culled(
            T(pts), T(verts), visits=True)
        idx_j, d2_j = kp.nearest_vertex_d2_pallas_culled(
            jnp.asarray(pts), jnp.asarray(verts), interpret=True)
    else:
        idx_t, d2_t, visits = t_knn.nearest_vertex_d2_T_culled(
            T(pts.T), T(verts), visits=True)
        idx_j, d2_j = kp.nearest_vertex_d2_pallas_T_culled(
            jnp.asarray(pts.T), jnp.asarray(verts), interpret=True)
    assert torch.equal(idx_t, idx_b) and torch.equal(d2_t, d2_b)
    np.testing.assert_array_equal(idx_t.numpy(), A(idx_j))
    np.testing.assert_allclose(d2_t.numpy(), A(d2_j), rtol=1e-6, atol=1e-9)
    _, counts_j, _ = _jax_knn_lists(pts, verts)
    np.testing.assert_array_equal(visits.numpy(), counts_j)
    assert visits.shape == (-(-n // 256),)
    assert (visits >= 1).all() and (visits <= -(-v // 128)).all()


def test_knn_culled_on_a_ray_patch_of_the_fixture():
    """Ray-major tiles (4 rays x 64 samples) cull little but stay exact."""
    verts = h.synthetic_batch()[0]["verts"][0]
    pts = _ray_points(4, 8, 64)
    want = t_knn.nearest_vertex_d2_plain(T(pts), T(verts))
    got = t_knn.nearest_vertex_d2_culled(T(pts), T(verts))
    got_T = t_knn.nearest_vertex_d2_T_culled(T(pts.T), T(verts))
    for g in (got, got_T):
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
    empty = t_knn.nearest_vertex_d2_culled(torch.zeros(0, 3), T(verts),
                                           visits=True)
    assert [t.shape[0] for t in empty] == [0, 0, 0]


@pytest.mark.parametrize("value,culled", [("1", True), ("0", True),
                                          ("", False), (None, False)])
def test_knn_cull_switch_is_read_at_call_time(value, culled, monkeypatch):
    """Any non-empty VANERF_KNN_CULL takes kernel 9's route, in both
    layouts (``vanerf_tpu/ops/knn.py:34``, ``:74``)."""
    if value is None:
        monkeypatch.delenv("VANERF_KNN_CULL", raising=False)
    else:
        monkeypatch.setenv("VANERF_KNN_CULL", value)
    calls = []
    for name in ("nearest_vertex_d2_culled", "nearest_vertex_d2_T_culled"):
        real = getattr(t_knn, name)
        monkeypatch.setattr(
            t_knn, name,
            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    verts, pts = _clustered()
    a = t_knn.nearest_vertex_d2(T(pts), T(verts))
    b = t_knn.nearest_vertex_d2_T(T(pts.T), T(verts))
    assert calls == (["nearest_vertex_d2_culled",
                      "nearest_vertex_d2_T_culled"] if culled else [])
    want = t_knn.nearest_vertex_d2_plain(T(pts), T(verts))
    for got in (a, b):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# kernels A and 7: the sorted faces, the tiles, the masks
# ---------------------------------------------------------------------------

def test_morton_order_matches_jax():
    from vanerf_tpu.ops.mesh_query import _morton_order
    verts, faces, _ = _hands()
    cen = verts[faces].mean(1)
    for c in (cen, np.random.RandomState(1).randn(500, 3).astype(np.float32),
              np.tile(cen[:1], (7, 1))):            # all equal: stable order
        got = t_mq._morton_order(T(c)).numpy()
        np.testing.assert_array_equal(got, A(_morton_order(jnp.asarray(c))))
    assert sorted(got.tolist()) == list(range(7))


def test_prepare_culled_mesh_sorts_faces_and_boxes_chunks():
    verts, faces, vis = _hands()
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    order = mesh["order"].numpy()
    assert sorted(order.tolist()) == list(range(len(faces)))
    assert (order != np.arange(len(faces))).any()
    center = mesh["center"].numpy()
    tri = (verts[faces] - center)[order]
    want = t_mq.face_table(T(tri), T(vis[:, 0][faces][order]))
    assert torch.equal(mesh["table"], want)
    C = -(-len(faces) // t_mq.CULL_CHUNK)
    assert mesh["cbox"].shape == (C, 6)
    for c in range(C):
        corners = tri[c * 128:(c + 1) * 128].reshape(-1, 3)
        np.testing.assert_array_equal(mesh["cbox"][c, :3].numpy(),
                                      corners.min(0))
        np.testing.assert_array_equal(mesh["cbox"][c, 3:].numpy(),
                                      corners.max(0))
    # the sorted chunks' boxes are no larger than the mesh order's
    unsorted = t_mq.face_chunk_boxes(T(verts[faces] - center))

    def volume(b):
        return (b[:, 3:] - b[:, :3]).prod(1).mean()

    assert volume(mesh["cbox"]) < volume(unsorted)


def test_tile_order_is_the_blocked_relayout(monkeypatch):
    from vanerf_tpu.ops import mesh_query as jmq
    P, S = 64, 16
    N = P * S
    tiles = t_mq.tile_geometry(N, S)
    assert tiles == (1, P, S, 1, 16, 8)
    want = A(jmq.to_blocked(jnp.arange(N), P, S, 16, 8))
    np.testing.assert_array_equal(t_mq.tile_order(N, tiles).numpy(), want)
    # the 2-D pixel blocks, for coordinate-major callers only
    monkeypatch.setenv("VANERF_BLOCK_2D", "4,4,8")
    assert t_mq.tile_geometry(N, S) == tiles
    t2 = t_mq.tile_geometry(N, S, rays_hw=(8, 8))
    assert t2 == (8, 8, S, 4, 4, 8)
    want = A(jmq._to_blocked2d_ax1(jnp.arange(N)[None], 8, 8, S, 4, 4, 8))[0]
    np.testing.assert_array_equal(t_mq.tile_order(N, t2).numpy(), want)
    # no tiles: samples or blocks that do not divide
    assert t_mq.tile_geometry(N, None) is None
    assert t_mq.tile_geometry(N, 7) is None
    assert t_mq.tile_geometry(24 * 8, 8) is None          # 24 rays % 16
    np.testing.assert_array_equal(t_mq.tile_order(5, None).numpy(),
                                  np.arange(5))
    monkeypatch.setenv("VANERF_BLOCK_RAYS", "32")
    monkeypatch.setenv("VANERF_BLOCK_SAMPLES", "4")
    assert t_mq.tile_geometry(N, S) == (1, P, S, 1, 32, 4)


def _jax_side(verts, faces, vis, pts_c_blocked, ub_blocked, order, far2,
              transposed=False, lists=False):
    """The JAX masks, lists and culled kernel on blocked, centred points
    over the faces in ``order``; returns (need_d, need_w, use_neg, lb,
    outputs in blocked order)[, the (T, 128) list rows and the (T, 128)
    sorted-bound rows of ``_cull_lists``]."""
    import vanerf_tpu.ops.mesh_query_pallas as mqp
    from vanerf_tpu.ops.mesh_query import _far_tiles
    tri = verts[faces]
    center = 0.5 * (verts.min(0) + verts.max(0))
    tri = (tri - center)[order]
    fv = vis[:, 0][faces][order]
    prep = mqp.prepare_mesh_ray(jnp.asarray(tri), jnp.asarray(fv))
    pts_j, ub_j = jnp.asarray(pts_c_blocked), jnp.asarray(ub_blocked)
    mask, use_neg, lb = mqp._cull_masks(pts_j, ub_j, prep["tri9"])
    far_t = _far_tiles(ub_j, far2)[0] if far2 is not None else None
    n_chunks = prep["tri9"].shape[1] // mqp.CULL_CHUNK
    maskf, lbf, _early = mqp._cull_lists(mask, use_neg, lb, n_chunks, far_t)
    rows = A(maskf).reshape(-1, 128)
    need_d = np.zeros((rows.shape[0], n_chunks), bool)
    need_w = np.zeros_like(need_d)
    for t, row in enumerate(rows):
        need_d[t, row[:row[126]]] = True
        need_w[t, row[64:64 + row[125]]] = True
    if transposed:
        out = mqp.point_mesh_query_vis_culled_T(
            pts_j.T, None, None, ub_j, prep=prep, far_t=far_t, interpret=True)
    else:
        out = mqp.point_mesh_query_vis_culled(
            pts_j, None, None, ub_j, prep=prep, far_t=far_t, interpret=True)
    res = (need_d, need_w, rows[:, 127].astype(bool), A(lb),
           [A(o) for o in out])
    return res + (rows, A(lbf).reshape(-1, 128)) if lists else res


def _assert_reaches_minimum(idx, pts_c, table, d2_ref):
    rows = table[idx.long()]
    d_at = t_mq.point_triangle_sq_dist(pts_c, rows[:, 0:3], rows[:, 3:6],
                                       rows[:, 6:9])
    np.testing.assert_allclose(d_at.numpy(), d2_ref, rtol=1e-3, atol=1e-8)


@pytest.mark.parametrize("far2", [None, 0.02 ** 2])
@pytest.mark.parametrize("tiling", ["1d", "2d", "consecutive"])
def test_culled_query_matches_jax(tiling, far2, monkeypatch):
    """Masks, direction flags and outputs of the culled query's plain
    version against ``_cull_masks`` + ``_cull_lists`` and the culled Pallas
    kernel in interpret mode, in 1-D tiles (kernel A), in VANERF_BLOCK_2D
    tiles (kernel 7) and in tiles of consecutive points."""
    from vanerf_tpu.ops import mesh_query as jmq
    H, W, S = 16, 32, 16
    verts, faces, vis = _hands()
    assert len(faces) % t_mq.CULL_CHUNK == 0     # else the TPU pads a chunk
    pts = _ray_points(H, W, S, 1.6, 0.52, 0.68)
    N = len(pts)
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    _, ub = t_knn.nearest_vertex_d2(T(pts), T(verts))
    pts_c = T(pts) - mesh["center"]
    if tiling == "2d":
        monkeypatch.setenv("VANERF_BLOCK_2D", "4,4,8")
        tiles = t_mq.tile_geometry(N, S, rays_hw=(H, W))
        assert tiles == (H, W, S, 4, 4, 8)
    elif tiling == "1d":
        tiles = t_mq.tile_geometry(N, S)
    else:
        tiles = None
    perm = t_mq.tile_order(N, tiles)
    # -- the masks --
    tmin, tmax, ub_t, far_t, tile_of = t_mq.tile_boxes(pts_c, ub, tiles, far2)
    assert (far_t is None) == (far2 is None)
    mask, use_neg, lb = t_mq.cull_masks(tmin, tmax, ub_t, mesh["cbox"], far_t)
    need_d, need_w, neg_j, lb_j, out_j = _jax_side(
        verts, faces, vis, pts_c[perm].numpy(), ub[perm].numpy(),
        mesh["order"].numpy(), far2, transposed=tiling == "2d")
    np.testing.assert_array_equal((mask & 1).bool().numpy(), need_d)
    np.testing.assert_array_equal((mask & 2).bool().numpy(), need_w)
    np.testing.assert_array_equal(use_neg.numpy(), neg_j)
    np.testing.assert_array_equal(lb.numpy(), lb_j)
    np.testing.assert_array_equal(tile_of[perm].numpy(),
                                  np.arange(N) // t_mq.TILE_P)
    assert 0 < use_neg.float().mean() < 1, "both ray directions"
    # (five chunks of a fifth of the hands each: the winding test culls,
    # the distance test hardly does without the far tier)
    assert need_w.mean() < 0.6 and (far2 is None or need_d.mean() < 0.7)
    if far2 is not None:
        assert 0 < far_t.float().mean() < 1, "both tiers"
        assert not need_d[far_t.numpy()].any()
    # -- the outputs --
    fn = (t_mq.point_mesh_query_vis_culled_T if tiling == "2d"
          else t_mq.point_mesh_query_vis_culled)
    arg = pts_c.t().contiguous() if tiling == "2d" else pts_c.contiguous()
    d2, idx, wind, qvis, far, visits = fn(arg, mesh, ub, tiles, far2,
                                          visits=True)
    np.testing.assert_array_equal(visits.numpy()[:, 0], need_d.sum(1))
    np.testing.assert_array_equal(visits.numpy()[:, 1], need_w.sum(1))
    d2_j, idx_j, w_j, qv_j = out_j                         # blocked order
    p = perm.numpy()
    np.testing.assert_allclose(d2.numpy()[p], d2_j, rtol=1e-4, atol=1e-8)
    np.testing.assert_array_equal(wind.numpy()[p], w_j)
    same = idx.numpy()[p] == idx_j
    # most rays pass the hands at a distance, where the closest point is a
    # vertex and the faces around it tie: to the bit in the port (the first
    # wins), to rounding in the TPU kernel's expanded forms
    assert same.mean() > 0.7
    np.testing.assert_allclose(qvis.numpy()[p][same], qv_j[same], rtol=1e-3,
                               atol=1e-4)
    if far2 is None:
        assert far is None
        _assert_reaches_minimum(idx, pts_c, mesh["table"], d2.numpy())
    else:
        # the rule of tests/test_pallas_kernels.py:403
        exp = far_t[tile_of]
        assert torch.equal(far, exp) and far.dtype == torch.bool
        assert torch.equal(d2[far], ub[far]) and not qvis[far].any()
        assert not idx[far].any()
    # -- and the sweep over every face of the same sorted table --
    b = t_mq.point_mesh_query_vis_plain(pts_c, mesh["table"], ub, far)
    assert torch.equal(d2, b[0]) and torch.equal(idx, b[1])
    assert torch.equal(qvis, b[3])
    # winding: equal on the +d tiles; along -d a ray grazing an edge may
    # count differently (none does on this fixture), the sign never
    assert torch.equal(wind, b[2])
    # d2 does not depend on the face order (kernel A before the sort)
    u = t_mq.point_mesh_query_vis_plain(
        pts_c, mesh["table"][torch.argsort(mesh["order"])], ub, far)
    assert torch.equal(d2, u[0]) and torch.equal(wind, u[2])


def _cleared_jax_culled():
    """The JAX culled kernels read VANERF_CULL_EARLY, TILE_P and CULL_CHUNK
    when they are traced: drop their compiled versions around a change."""
    import vanerf_tpu.ops.mesh_query_pallas as mqp
    mqp.point_mesh_query_vis_culled.clear_cache()
    mqp.point_mesh_query_vis_culled_T.clear_cache()


def _culled_case(tiling, monkeypatch, S=16, H=16, W=32, blocks=None):
    """The fixture hands, ray-major points, their bounds and tiles."""
    verts, faces, vis = _hands()
    pts = _ray_points(H, W, S, 1.6, 0.52, 0.68)
    N = len(pts)
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    _, ub = t_knn.nearest_vertex_d2(T(pts), T(verts))
    pts_c = T(pts) - mesh["center"]
    if tiling == "2d":
        monkeypatch.setenv("VANERF_BLOCK_2D", blocks or "4,4,8")
        tiles = t_mq.tile_geometry(N, S, rays_hw=(H, W))
    elif tiling == "1d":
        if blocks:
            monkeypatch.setenv("VANERF_BLOCK_RAYS", blocks)
        tiles = t_mq.tile_geometry(N, S)
    else:
        tiles = None
    fn = (t_mq.point_mesh_query_vis_culled_T if tiling == "2d"
          else t_mq.point_mesh_query_vis_culled)
    arg = pts_c.t().contiguous() if tiling == "2d" else pts_c.contiguous()
    return (verts, faces, vis), mesh, ub, pts_c, tiles, fn, arg


@pytest.mark.parametrize("far2", [None, 0.02 ** 2])
@pytest.mark.parametrize("tiling", ["1d", "2d", "consecutive"])
def test_culled_query_early_exit_matches_jax(tiling, far2, monkeypatch):
    """VANERF_CULL_EARLY: the lists of the plain early walk (distance chunks
    by ascending lower bound, stable) against ``_cull_lists(early=True)``,
    its outputs against the culled Pallas kernel's early-exit loop in
    interpret mode (tolerances of test_culled_query_matches_jax), and its
    d2 and winding equal to the default walk's bit for bit (idx and qvis
    may differ where two faces tie)."""
    hands, mesh, ub, pts_c, tiles, fn, arg = _culled_case(tiling,
                                                          monkeypatch)
    N = pts_c.shape[0]
    perm = t_mq.tile_order(N, tiles)
    default = fn(arg, mesh, ub, tiles, far2, visits=True)
    monkeypatch.setenv("VANERF_CULL_EARLY", "1")
    tmin, tmax, ub_t, far_t, _tile_of = t_mq.tile_boxes(pts_c, ub, tiles,
                                                        far2)
    mask, _use_neg, lb = t_mq.cull_masks(tmin, tmax, ub_t, mesh["cbox"],
                                         far_t)
    order, n_d, lb_sorted = t_mq.early_walk_lists(mask, lb)
    _cleared_jax_culled()
    try:
        need_d, _nw, _neg, _lb, out_j, rows, lbf = _jax_side(
            *hands, pts_c[perm].numpy(), ub[perm].numpy(),
            mesh["order"].numpy(), far2, transposed=tiling == "2d",
            lists=True)
    finally:
        _cleared_jax_culled()
    C = mask.shape[1]
    np.testing.assert_array_equal(n_d.numpy(), rows[:, 126])
    for t in range(rows.shape[0]):
        np.testing.assert_array_equal(order[t, :n_d[t]].numpy(),
                                      rows[t, :rows[t, 126]])
    np.testing.assert_array_equal(lb_sorted.numpy(), lbf[:, :C])
    assert (n_d > 1).any(), "tiles with a walk to order"
    got = fn(arg, mesh, ub, tiles, far2, visits=True)
    assert torch.equal(got[0], default[0]) and torch.equal(got[2], default[2])
    assert torch.equal(got[5], default[5]), "visits count the masks"
    assert (got[4] is None) == (far2 is None)
    same = got[1] == default[1]
    assert same.float().mean() > 0.9
    assert torch.equal(got[3][same], default[3][same])
    near = ~got[4] if got[4] is not None else torch.ones_like(same)
    _assert_reaches_minimum(got[1][near], pts_c[near], mesh["table"],
                            got[0][near].numpy())
    d2_j, idx_j, w_j, qv_j = out_j
    p = perm.numpy()
    np.testing.assert_allclose(got[0].numpy()[p], d2_j, rtol=1e-4, atol=1e-8)
    np.testing.assert_array_equal(got[2].numpy()[p], w_j)
    same_j = got[1].numpy()[p] == idx_j
    assert same_j.mean() > 0.7
    np.testing.assert_allclose(got[3].numpy()[p][same_j], qv_j[same_j],
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("tile_p,chunk,tiling,blocks", [
    (64, 128, "1d", "8"), (256, 128, "2d", "4,8,8"), (128, 64, "1d", None)])
def test_culled_query_tile_and_chunk_sizes_match_jax(tile_p, chunk, tiling,
                                                     blocks, monkeypatch):
    """VANERF_MESH_TILE_P / VANERF_CULL_CHUNK at values besides 128: the
    masks, lists and outputs against the JAX package with its TILE_P /
    CULL_CHUNK set alike (far tier on), and equal to the sweep."""
    import vanerf_tpu.ops.mesh_query_pallas as mqp
    monkeypatch.setenv("VANERF_MESH_TILE_P", str(tile_p))
    monkeypatch.setenv("VANERF_CULL_CHUNK", str(chunk))
    monkeypatch.setattr(mqp, "TILE_P", tile_p)
    monkeypatch.setattr(mqp, "CULL_CHUNK", chunk)
    far2 = 0.02 ** 2
    hands, mesh, ub, pts_c, tiles, fn, arg = _culled_case(
        tiling, monkeypatch, blocks=blocks)
    assert tiles[3] * tiles[4] * tiles[5] == tile_p
    n_chunks = -(-len(hands[1]) // chunk)
    assert mesh["chunk"] == chunk and mesh["cbox"].shape[0] == n_chunks
    N = pts_c.shape[0]
    perm = t_mq.tile_order(N, tiles)
    tmin, tmax, ub_t, far_t, tile_of = t_mq.tile_boxes(pts_c, ub, tiles,
                                                       far2, tile_p)
    mask, use_neg, lb = t_mq.cull_masks(tmin, tmax, ub_t, mesh["cbox"],
                                        far_t)
    _cleared_jax_culled()
    try:
        need_d, need_w, neg_j, lb_j, out_j = _jax_side(
            *hands, pts_c[perm].numpy(), ub[perm].numpy(),
            mesh["order"].numpy(), far2, transposed=tiling == "2d")
    finally:
        _cleared_jax_culled()
    assert need_d.shape == (N // tile_p, n_chunks)
    np.testing.assert_array_equal((mask & 1).bool().numpy(), need_d)
    np.testing.assert_array_equal((mask & 2).bool().numpy(), need_w)
    np.testing.assert_array_equal(use_neg.numpy(), neg_j)
    np.testing.assert_array_equal(lb.numpy(), lb_j)
    assert 0 < far_t.float().mean() < 1, "both tiers"
    d2, idx, wind, qvis, far, visits = fn(arg, mesh, ub, tiles, far2,
                                          visits=True)
    assert visits.shape == (N // tile_p, 2)
    np.testing.assert_array_equal(visits.numpy()[:, 0], need_d.sum(1))
    np.testing.assert_array_equal(visits.numpy()[:, 1], need_w.sum(1))
    assert torch.equal(far, far_t[tile_of])
    d2_j, idx_j, w_j, qv_j = out_j
    p = perm.numpy()
    np.testing.assert_allclose(d2.numpy()[p], d2_j, rtol=1e-4, atol=1e-8)
    np.testing.assert_array_equal(wind.numpy()[p], w_j)
    same = idx.numpy()[p] == idx_j
    assert same.mean() > 0.7
    np.testing.assert_allclose(qvis.numpy()[p][same], qv_j[same], rtol=1e-3,
                               atol=1e-4)
    b = t_mq.point_mesh_query_vis_plain(pts_c, mesh["table"], ub, far)
    for k in (0, 1, 2, 3):
        assert torch.equal((d2, idx, wind, qvis)[k], b[k]), k


def test_cull_sizes_refuse_other_values(monkeypatch):
    """The sizes the CUDA body is built for, read at call time; a mesh
    prepared in other chunks than the switch now names is refused."""
    assert t_mq.cull_sizes() == (128, 128)
    verts, faces, vis = _hands()
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    for name, bad in (("VANERF_MESH_TILE_P", "100"),
                      ("VANERF_CULL_CHUNK", "32"),
                      ("VANERF_CULL_CHUNK", "x")):
        with monkeypatch.context() as m:
            m.setenv(name, bad)
            with pytest.raises(NotImplementedError, match=name):
                t_mq.cull_sizes()
    monkeypatch.setenv("VANERF_CULL_CHUNK", "64")
    with pytest.raises(ValueError, match="prepare it again"):
        t_mq.point_mesh_query_vis_culled(torch.zeros(128, 3), mesh,
                                         torch.ones(128))
    monkeypatch.setenv("VANERF_MESH_TILE_P", "64")
    with pytest.raises(ValueError, match="VANERF_MESH_TILE_P=64"):
        t_mq.tile_geometry(64 * 16, 16)               # 16 x 8 blocks


# ---------------------------------------------------------------------------
# the per-face rejection of the culled kernel: its plain mirror never skips
# a face whose computed distance lies below the point's best
# ---------------------------------------------------------------------------

_unit = st.floats(-1.0, 1.0, allow_nan=False, width=32)
_xyz = st.tuples(_unit, _unit, _unit)


@settings(max_examples=400, deadline=None, database=None)
@given(corners=st.tuples(_xyz, _xyz, _xyz), p=_xyz, off=_xyz,
       kind=st.sampled_from(["random", "collinear", "point", "on_vertex",
                             "on_edge", "above"]),
       t=st.floats(0.0, 1.0, width=32),
       scale=st.sampled_from([1e-4, 1e-2, 1.0, 1e2, 1e4]),
       offset=st.sampled_from([0.0, 1.0, 30.0]),
       reach=st.sampled_from([1e-3, 1.0, 10.0]),
       others=st.integers(0, 2))
def test_face_sphere_bound_never_exceeds_the_distance(
        corners, p, off, kind, t, scale, offset, reach, others):
    """``sphere_skip`` (the kernel's per-face test, the same expressions)
    against ``point_triangle_sq_dist``: for any best above a face's computed
    squared distance the face is kept, on random faces and on degenerate
    ones (zero area, a single point, a point on a vertex or an edge, tiny
    and huge scales, far from the origin)."""
    a, b, c = (np.array(v, np.float32) for v in corners)
    if kind == "collinear":
        c = a + np.float32(t) * (b - a)
    elif kind == "point":
        b = c = a
    tri = (np.stack([a, b, c]) + np.array(off, np.float32) * offset) * scale
    tri = tri.astype(np.float32)
    q = np.array(p, np.float32) * reach * scale + tri.mean(0)
    if kind == "on_vertex":
        q = tri[0].copy()
    elif kind == "on_edge":
        q = tri[0] + np.float32(t) * (tri[1] - tri[0])
    elif kind == "above":
        n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
        q = tri.mean(0) + np.float32(reach * 1e-3) * n
    # the mesh's scale R from this face and a few others around it
    rs = np.random.RandomState(others)
    extra = (tri[None] + rs.randn(others, 3, 3).astype(np.float32)
             * scale).astype(np.float32)
    tris = torch.from_numpy(np.concatenate([tri[None], extra]))
    sph = t_mq.face_spheres(tris)[0]
    pt = torch.from_numpy(q.astype(np.float32))
    tt = torch.from_numpy(tri)
    d = t_mq.point_triangle_sq_dist(pt, tt[0], tt[1], tt[2])
    assert torch.isfinite(d)
    above = torch.nextafter(d, torch.tensor(float("inf")))
    for best in (above, above * 1.5, d * 4.0 + 1e-30):
        assert not t_mq.sphere_skip(pt, sph, best), (d, best, sph)


def test_face_sphere_skips_far_faces():
    """The test is not vacuous: a face far from a point with a small best
    is skipped, the same face near it is kept, and a sliver never is."""
    tri = torch.tensor([[[0.0, 0.0, 0.0], [0.01, 0.0, 0.0],
                         [0.0, 0.01, 0.0]],
                        [[0.0, 0.0, 0.1], [0.01, 0.0, 0.1],
                         [0.02, 1e-6, 0.1]]])
    sph = t_mq.face_spheres(tri)
    assert torch.isfinite(sph[0, 3]) and torch.isinf(sph[1, 3])
    best = torch.tensor(1e-6)
    assert t_mq.sphere_skip(torch.tensor([0.5, 0.0, 0.0]), sph[0], best)
    assert not t_mq.sphere_skip(torch.tensor([0.005, 0.002, 0.0005]),
                                sph[0], best)
    assert not t_mq.sphere_skip(torch.tensor([0.5, 0.0, 0.0]), sph[1], best)


def _spread_mesh():
    """Twelve small spheres in a row (3,840 faces in 30 chunks)."""
    parts, faces, off = [], [], 0
    for k in range(12):
        v, f = make_icosphere(subdiv=2, radius=0.02,
                              center=(0.08 * k, 0.01 * (k % 3), 0.0))
        parts.append(v)
        faces.append(f + off)
        off += len(v)
    verts = np.concatenate(parts).astype(np.float32)
    faces = np.concatenate(faces).astype(np.int64)
    vis = (np.random.RandomState(4).rand(len(verts), 1) > 0.4) \
        .astype(np.float32)
    return verts, faces, vis


def _warp_walk_evaluations(pts_c, mesh, ub, tiles, far2):
    """The culled kernel's default walk played face by face: the threads
    of a tile in the blocked order, 32 to a warp; a warp evaluates a face of
    its tile's distance chunks when any lane's sphere test keeps it, and
    each of its lanes then takes the distance when strictly below its
    best.  Returns the (thread, face) evaluations."""
    tile_p, chunk = t_mq.cull_sizes()
    tmin, tmax, ub_t, far_t, _ = t_mq.tile_boxes(pts_c, ub, tiles, far2,
                                                 tile_p)
    mask, _, _ = t_mq.cull_masks(tmin, tmax, ub_t, mesh["cbox"], far_t)
    N = pts_c.shape[0]
    perm = t_mq.tile_order(N, tiles)
    p = pts_c[perm[torch.arange(mask.shape[0] * tile_p).clamp(max=N - 1)]]
    table, sph = mesh["table"], mesh["sphere"]
    best = torch.full((p.shape[0],), float("inf"))
    count = 0
    for f in range(table.shape[0]):
        on = ((mask[:, f // chunk] & 1) != 0).repeat_interleave(tile_p)
        keep = on & ~t_mq.sphere_skip(p, sph[f], best)
        warp = keep.reshape(-1, 32).any(1).repeat_interleave(32)
        count += int(warp.sum())
        row = table[f]
        d = t_mq.point_triangle_sq_dist(p, row[0:3], row[3:6], row[6:9])
        best = torch.where(warp & (d < best), d, best)
    return count


@pytest.mark.parametrize("case", ["hands_1d_far", "spread_ragged"])
def test_culled_work_counts_the_warps_evaluations(case, monkeypatch):
    """``culled_work`` (the count of full distance evaluations behind the
    culled kernel's operation bound) against the walk played face by face:
    the same count, below the sphere tests (the test skips faces) and
    above zero; the sphere tests and crossings are the masks' faces."""
    if case == "hands_1d_far":
        verts, faces, vis = _hands()
        H, W, S = 8, 16, 8
        pts = _ray_points(H, W, S)
        tiles, far2 = t_mq.tile_geometry(len(pts), S), 0.02 ** 2
        assert tiles is not None
    else:
        verts, faces, vis = _spread_mesh()
        cen = np.array([[0.08 * k, 0.0, 0.0] for k in (1, 4, 7, 10)],
                       np.float32)
        rs = np.random.RandomState(5)
        pts = (cen[:, None] + (rs.rand(4, 128, 3) - 0.5) * 0.05) \
            .reshape(-1, 3)[:500].astype(np.float32)
        tiles, far2 = None, None
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    _, ub = t_knn.nearest_vertex_d2(T(pts), T(verts))
    pts_c = (T(pts) - mesh["center"]).contiguous()
    work = t_mq.culled_work(pts_c, mesh, ub, tiles, far2)
    assert work["evaluated"] == _warp_walk_evaluations(pts_c, mesh, ub,
                                                       tiles, far2)
    assert 0 < work["evaluated"] < work["sphere_tests"]
    tile_p, chunk = t_mq.cull_sizes()
    tmin, tmax, ub_t, far_t, _ = t_mq.tile_boxes(pts_c, ub, tiles, far2)
    mask, _, _ = t_mq.cull_masks(tmin, tmax, ub_t, mesh["cbox"], far_t)
    F = len(faces)
    sizes = torch.full((mask.shape[1],), chunk)
    sizes[-1] = F - chunk * (mask.shape[1] - 1)
    assert work["sphere_tests"] == int(((mask & 1) * sizes).sum()) * tile_p
    assert work["crossings"] == int(((mask >> 1) * sizes).sum()) * tile_p


def test_culled_query_ragged_points_and_short_last_chunk(monkeypatch):
    """N no multiple of 128 (the far tier is then off, as in the JAX
    wrapper) and F no multiple of 128 (the last chunk's box is that of its
    real faces): equal to the sweep over every face."""
    v1, f1 = make_icosphere(subdiv=2, radius=0.05, center=(-0.03, 0, 0))
    v2, f2 = make_icosphere(subdiv=1, radius=0.05, center=(0.03, 0.01, 0))
    verts = np.concatenate([v1, v2]).astype(np.float32)
    faces = np.concatenate([f1, f2 + len(v1)]).astype(np.int64)
    assert len(faces) == 400                  # 3 chunks and 16 faces
    rs = np.random.RandomState(2)
    vis = (rs.rand(len(verts), 1) > 0.4).astype(np.float32)
    pts = (rs.rand(240, 3) * 0.3 - 0.15).astype(np.float32)
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces), T(vis))
    assert mesh["cbox"].shape[0] == 4 and mesh["cbox"].abs().max() < 1.0
    _, ub = t_knn.nearest_vertex_d2(T(pts), T(verts))
    pts_c = (T(pts) - mesh["center"]).contiguous()
    # blocks of 4 rays x 4 samples do not make a tile of 128 points: the
    # renderer-facing tile_geometry refuses them, the query takes them
    monkeypatch.setenv("VANERF_BLOCK_RAYS", "4")
    monkeypatch.setenv("VANERF_BLOCK_SAMPLES", "4")
    with pytest.raises(ValueError, match="VANERF_MESH_TILE_P=128"):
        t_mq.tile_geometry(240, 12)
    blocked = (1, 20, 12, 1, 4, 4)
    for tiles in (None, blocked):
        got = t_mq.point_mesh_query_vis_culled(pts_c, mesh, ub, tiles,
                                               far2=1e-4, visits=True)
        assert got[4] is None and got[5].shape == (2, 2)
        want = t_mq.point_mesh_query_vis_plain(pts_c, mesh["table"], ub)
        for g, w in zip(got[:4], want):
            assert torch.equal(g, w)
        got_T = t_mq.point_mesh_query_vis_culled_T(
            pts_c.t().contiguous(), mesh, ub, tiles)
        for g, w in zip(got_T[:4], want):
            assert torch.equal(g, w)


def test_culled_query_skips_chunks_on_a_spread_mesh():
    """Twelve small spheres in a row (30 chunks): a tile of points around
    one of them skips a third of the chunks and more, and still equals the
    sweep over every face."""
    verts, faces, vis = _spread_mesh()
    rs = np.random.RandomState(4)
    rs.rand(len(verts), 1)                    # _spread_mesh's vis draws
    # 16 rays x 8 samples a tile, each tile around one sphere
    cen = np.array([[0.08 * k, 0.0, 0.0] for k in (1, 4, 7, 10)], np.float32)
    pts = (cen[:, None] + (rs.rand(4, 128, 3) - 0.5) * 0.05).reshape(-1, 3) \
        .astype(np.float32)
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces), T(vis))
    assert mesh["cbox"].shape[0] == 30
    _, ub = t_knn.nearest_vertex_d2(T(pts), T(verts))
    pts_c = (T(pts) - mesh["center"]).contiguous()
    got = t_mq.point_mesh_query_vis_culled(pts_c, mesh, ub, visits=True)
    want = t_mq.point_mesh_query_vis_plain(pts_c, mesh["table"], ub)
    for g, w in zip(got[:4], want):
        assert torch.equal(g, w)
    assert 0.02 < (got[2] > 0.5).float().mean() < 0.9, "inside and outside"
    visits = got[5]
    # (the Morton code scales each axis to its own extent, so on this long
    # thin mesh a chunk spans several spheres)
    assert (visits[:, 0] >= 1).all() and visits[:, 0].max() <= 20, visits
    assert visits[:, 1].max() <= 20, visits


def test_culled_query_with_no_chunk_in_reach():
    """A bound below the true distance loses every chunk: d2 = inf, idx 0,
    qvis 0, as the TPU kernel's initial values."""
    verts, faces, vis = _hands()
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    pts_c = torch.full((128, 3), 5.0)
    d2, idx, wind, qvis, far = t_mq.point_mesh_query_vis_culled(
        pts_c, mesh, torch.zeros(128))
    assert torch.isinf(d2).all() and not idx.any() and not qvis.any()
    assert far is None and not wind.any()


def test_cal_vis_sdf_prepared_runs_the_culled_query(monkeypatch):
    """The renderer-facing functions pass the tile geometry on; the far
    mask and the values equal the sweep's with per-point flags."""
    H, W, S = 8, 16, 8
    verts, faces, vis = _hands()
    pts = _ray_points(H, W, S)
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    _, ub = t_knn.nearest_vertex_d2(T(pts), T(verts))
    seen = []
    for name in ("point_mesh_query_vis_culled",
                 "point_mesh_query_vis_culled_T"):
        real = getattr(t_mq, name)
        monkeypatch.setattr(
            t_mq, name, lambda *a, _r=real, **k: seen.append(a[3:]) or
            _r(*a, **k))
    far2 = 0.02 ** 2
    sdf, qv, far = t_mq.cal_vis_sdf_prepared(mesh, T(pts), ub, n_samples=S,
                                             far2=far2)
    monkeypatch.setenv("VANERF_BLOCK_2D", "4,4,8")
    sdf_T, qv_T, far_T = t_mq.cal_vis_sdf_prepared_T(
        mesh, T(pts.T), ub, n_samples=S, rays_hw=(H, W), far2=far2)
    assert seen == [((1, H * W, S, 1, 16, 8), far2),
                    ((H, W, S, 4, 4, 8), far2)]
    assert (far != far_T).any(), "the tilings mark other points"
    pts_c = T(pts) - mesh["center"]
    for s_, q_, f_ in ((sdf, qv, far), (sdf_T, qv_T, far_T)):
        d2, _i, w, qvis = t_mq.point_mesh_query_vis_plain(
            pts_c, mesh["table"], ub, f_)
        want = t_mq._finish_prepared(d2, w, qvis, torch.float32)
        assert torch.equal(s_, want[0]) and torch.equal(q_, want[1])


# ---------------------------------------------------------------------------
# the render under VANERF_KNN_CULL against JAX (the exact equality with the
# default render is in tests/test_torch_render.py)
# ---------------------------------------------------------------------------

def test_knn_cull_render_matches_jax(monkeypatch):
    """The port under VANERF_KNN_CULL=1 against JAX under the same switch.
    The JAX package reads it only on its Pallas path, so the JAX side runs
    under VANERF_MESH_BACKEND=pallas with the culled nearest-vertex kernel
    and the culled mesh query in interpret mode (the frame's encode and
    vertex visibility are handed in, so the Pallas rasterizer is not
    reached).  That path sorts the faces as the port does, so the mesh
    goes in as the fixture gives it."""
    import jax
    import test_torch_render as render_tests
    from vanerf_tpu import renderer as jr
    import vanerf_tpu.ops.knn_pallas as kp
    import vanerf_tpu.ops.mesh_query_pallas as mqp
    monkeypatch.setenv("VANERF_FAR_TAU", "0.02")
    monkeypatch.setenv("VANERF_KNN_CULL", "1")
    g, _ = h.converted_params()
    batch, _ = h.synthetic_batch()
    grids = render_tests._centre_and_corner_grid()
    from vanerf_tpu_torch import renderer as tr
    pm, tb = h.port_model(), h.torch_batch(batch)
    with torch.no_grad():
        cached_t = tr.encode_frame(pm, tb)
    out_t = tr.render_patch(pm, tb, grids=T(grids), out_h=8, out_w=4,
                            sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F,
                            cached=cached_t)
    jm, jb = h.jax_model(), render_tests._jbatch(batch)
    fg, ft = jm.apply(g, jb["src_img"], method=jm.encode)
    seen = []
    monkeypatch.setenv("VANERF_MESH_BACKEND", "pallas")
    for mod, name in ((kp, "nearest_vertex_d2_pallas_culled"),
                      (mqp, "point_mesh_query_vis_culled")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _r=real, _n=name, **k: seen.append(_n) or
            _r(*a, **{**k, "interpret": True}))
    out_j = jr.render_patch(
        jm, g, jb, rng=jax.random.PRNGKey(0), grids=jnp.asarray(grids),
        out_h=8, out_w=4, sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F,
        fine=True, uniform=True, training=False, n_views=1, sdf_chunk=64,
        compute_vis_map=False,
        cached=(fg, ft, jnp.asarray(cached_t[2].numpy())))
    assert seen == ["nearest_vertex_d2_pallas_culled",
                    "point_mesh_query_vis_culled"] * 2
    render_tests._compare(out_j, out_t)
    assert out_t["alpha_fine"].max() > 0.2


# ---------------------------------------------------------------------------
# on the card: the four new entry points against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("v", [1558, 1, 127, 129, 1284])
@pytest.mark.parametrize("n", [4096, 4000, 77, 1, 63, 257])
def test_knn_culled_kernels_match_plain_and_b(cuda, n, v):
    verts, pts = _clustered()
    verts = verts[:v]
    pts = np.tile(pts, (4, 1))[:n]
    q, v = T(pts).to(cuda), T(verts).to(cuda)
    q_T = q.t().contiguous()
    n9, n9t = t_knn.culled_launches, t_knn.culled_launches_T
    idx, d2, visits = t_knn.nearest_vertex_d2_culled(q, v, visits=True)
    idx_T, d2_T, visits_T = t_knn.nearest_vertex_d2_T_culled(q_T, v,
                                                             visits=True)
    torch.cuda.synchronize()
    assert t_knn.culled_launches == n9 + 1
    assert t_knn.culled_launches_T == n9t + 1
    idx_b, d2_b = t_knn.nearest_vertex_d2(q, v)
    idx_p, d2_p, visits_p = t_knn.nearest_vertex_d2_culled_plain(
        q, v, visits=True)
    for i_, d_, c_ in ((idx, d2, visits), (idx_T, d2_T, visits_T)):
        assert torch.equal(i_, idx_b) and torch.equal(d_, d2_b)
        assert torch.equal(i_, idx_p) and torch.equal(d_, d2_p)
        assert torch.equal(c_, visits_p)
    # the clustered case culls (13 chunks); every V stays within its chunks
    assert visits.float().mean() < (13 if v.shape[0] == 1558 else
                                    -(-v.shape[0] // 128) + 1)
    assert torch.equal(t_knn.vertex_chunk_boxes_cuda(v),
                       t_knn.vertex_chunk_boxes(v))
    with pytest.raises(ValueError):
        t_knn.nearest_vertex_d2_T_culled(q, v)         # (N, 3) is refused


@pytest.mark.cuda
@pytest.mark.parametrize("far2", [None, 0.02 ** 2])
@pytest.mark.parametrize("tiling", ["1d", "2d", "consecutive"])
def test_culled_mesh_kernels_match_plain_and_sweep(cuda, tiling, far2,
                                                   monkeypatch):
    H, W, S = 16, 16, 16
    verts, faces, vis = _hands()
    pts = T(_ray_points(H, W, S)).to(cuda)
    N = pts.shape[0]
    mesh = t_mq.prepare_culled_mesh(T(verts).to(cuda),
                                    T(faces).long().to(cuda),
                                    T(vis).to(cuda))
    _, ub = t_knn.nearest_vertex_d2(pts, T(verts).to(cuda))
    pts_c = (pts - mesh["center"]).contiguous()
    if tiling == "2d":
        monkeypatch.setenv("VANERF_BLOCK_2D", "4,4,8")
    tiles = {"1d": lambda: t_mq.tile_geometry(N, S),
             "2d": lambda: t_mq.tile_geometry(N, S, rays_hw=(H, W)),
             "consecutive": lambda: None}[tiling]()
    nA, n7 = t_mq.launches, t_mq.launches_T
    got = t_mq.point_mesh_query_vis_culled(pts_c, mesh, ub, tiles, far2,
                                           visits=True)
    got_T = t_mq.point_mesh_query_vis_culled_T(pts_c.t().contiguous(), mesh,
                                               ub, tiles, far2, visits=True)
    torch.cuda.synchronize()
    assert t_mq.launches == nA + 1 and t_mq.launches_T == n7 + 1
    want = t_mq.point_mesh_query_vis_culled_plain(pts_c, mesh, ub, tiles,
                                                  far2, visits=True)
    for g in (got, got_T):
        for a, b in zip(g, want):
            assert (a is None and b is None) or torch.equal(a, b)
    # the sweep over every face of the same table, per-point far flags
    sweep = t_mq.point_mesh_query_vis_cuda(pts_c, mesh["table"], ub, got[4])
    for k in (0, 1, 3):
        assert torch.equal(got[k], sweep[k]), k
    assert (got[2] != sweep[2]).float().mean() <= 1e-4     # grazes along -d
    # ragged N: the far tier off, still equal
    g = t_mq.point_mesh_query_vis_culled(pts_c[:1000].contiguous(), mesh,
                                         ub[:1000].contiguous(), None, far2)
    w = t_mq.point_mesh_query_vis_culled_plain(pts_c[:1000], mesh, ub[:1000],
                                               None, far2)
    assert g[4] is None and w[4] is None
    for a, b in zip(g[:4], w[:4]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("early,tile_p,chunk", [
    (1, 128, 128), (0, 64, 128), (0, 256, 128), (0, 128, 64), (1, 64, 64),
    (1, 256, 64)])
def test_culled_mesh_kernels_at_each_size_and_under_early(
        cuda, early, tile_p, chunk, monkeypatch):
    """A and 7 at every instantiated tile and chunk size and under
    VANERF_CULL_EARLY, on 639 faces (a last chunk of an odd count: its bulk
    copy reads the table's padding row): equal to the plain version bit for
    bit; d2 equal to the sweep's and, under the early exit, to the default
    walk's; idx and qvis to the sweep's off the early exit."""
    H, W, S = 16, 16, 16
    verts, faces, vis = _hands()
    faces = faces[:-1]
    monkeypatch.setenv("VANERF_MESH_TILE_P", str(tile_p))
    monkeypatch.setenv("VANERF_CULL_CHUNK", str(chunk))
    monkeypatch.setenv("VANERF_BLOCK_RAYS", str(tile_p // 8))
    pts = T(_ray_points(H, W, S)).to(cuda)
    N = pts.shape[0]
    mesh = t_mq.prepare_culled_mesh(T(verts).to(cuda),
                                    T(faces).long().to(cuda),
                                    T(vis).to(cuda))
    assert len(faces) % chunk % 2 == 1
    _, ub = t_knn.nearest_vertex_d2(pts, T(verts).to(cuda))
    pts_c = (pts - mesh["center"]).contiguous()
    tiles = t_mq.tile_geometry(N, S)
    far2 = 0.02 ** 2
    default = t_mq.point_mesh_query_vis_culled(pts_c, mesh, ub, tiles, far2)
    monkeypatch.setenv("VANERF_CULL_EARLY", str(early))
    got = t_mq.point_mesh_query_vis_culled(pts_c, mesh, ub, tiles, far2,
                                           visits=True)
    got_T = t_mq.point_mesh_query_vis_culled_T(pts_c.t().contiguous(), mesh,
                                               ub, tiles, far2, visits=True)
    torch.cuda.synchronize()
    want = t_mq.point_mesh_query_vis_culled_plain(pts_c, mesh, ub, tiles,
                                                  far2, visits=True)
    for g in (got, got_T):
        for a, b in zip(g, want):
            assert torch.equal(a, b)
    assert got[5].shape == (N // tile_p, 2)
    sweep = t_mq.point_mesh_query_vis_cuda(pts_c, mesh["table"], ub, got[4])
    assert torch.equal(got[0], sweep[0]) and torch.equal(got[0], default[0])
    if not early:
        assert torch.equal(got[1], sweep[1]) and torch.equal(got[3], sweep[3])
    assert (got[2] != sweep[2]).float().mean() <= 1e-4     # grazes along -d
