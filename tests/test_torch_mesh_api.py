"""The port's exact mesh-query API (kernels 5 and 6) and its
coordinate-major queries (kernels 7 and 8) against the JAX package, on the
CPU.

The same numpy inputs go through the JAX function and its counterpart in
``vanerf_tpu_torch.ops``.  The JAX Pallas kernels run in interpret mode at
small sizes (N not a multiple of the TPU's 128-point tile, F not a multiple
of its 512-face chunk); on CPU tensors every port wrapper takes its plain
version.  Tolerances, as ``tests/test_pallas_kernels.py`` has them: d2 rtol
1e-4 / atol 1e-8; the chosen face reaches the minimum (argmin ties aside);
ray winding equal as integers; solid-angle winding atol 2e-3 against the
TPU kernel's polynomial atan2 and 1e-5 against the XLA atan2; interpolated
visibility rtol 1e-4 / atol 1e-5 where the argmin faces agree; binarised
visibility against ``cal_vis_sdf`` on at least 97% of the points (the two
interpolate with different barycentrics off the face's interior).

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
from oracles import make_icosphere, winding_number_oracle
from vanerf_tpu_torch import ops as t_ops
from vanerf_tpu_torch.ops import knn as t_knn
from vanerf_tpu_torch.ops import mesh_query as t_mq

N_PTS = 200            # 2 TPU tiles, the second ragged


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def A(x):
    return np.asarray(x)


def _hands(seed=6):
    """The two-hand fixture mesh (640 faces), a random vertex visibility and
    points around and inside the hands."""
    batch, faces = h.synthetic_batch()
    verts = batch["verts"][0]
    rs = np.random.RandomState(seed)
    vis = (rs.rand(len(verts), 1) > 0.4).astype(np.float32)
    pts = h.two_hand_points(N_PTS, seed=seed + 1)
    return verts, faces, vis, pts


def _two_spheres(r=0.05, dx=0.03):
    v1, f1 = make_icosphere(subdiv=1, radius=r, center=(-dx, 0, 0))
    v2, f2 = make_icosphere(subdiv=1, radius=r, center=(dx, 0.01, 0))
    verts = np.concatenate([v1, v2]).astype(np.float32)
    faces = np.concatenate([f1, f2 + len(v1)]).astype(np.int32)
    return verts, faces


def _assert_reaches_minimum(idx_t, pts, tri, d2_ref):
    """The chosen face achieves the reference minimum (ties aside)."""
    t = tri[A(idx_t)]
    d_at = t_mq.point_triangle_sq_dist(T(pts), T(t[:, 0]), T(t[:, 1]),
                                       T(t[:, 2]))
    np.testing.assert_allclose(d_at.numpy(), A(d2_ref), rtol=1e-3, atol=1e-8)


# ---------------------------------------------------------------------------
# kernel 5 — distance + argmin + winding over every face
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ray", "solid_angle", "none"])
def test_brute_plain_matches_pallas_interpret(mode):
    from vanerf_tpu.ops.mesh_query_pallas import point_mesh_query_pallas
    verts, faces, _, pts = _hands()
    tri = verts[faces]
    assert len(pts) % 128 and len(tri) % 512
    kw = (dict(with_winding=False) if mode == "none" else dict(mode=mode))
    d2_j, idx_j, w_j = point_mesh_query_pallas(
        jnp.asarray(pts), jnp.asarray(tri), interpret=True, **kw)
    d2_t, idx_t, w_t = t_mq.point_mesh_query_brute(T(pts), T(tri), **kw)
    assert idx_t.dtype == torch.int32 and d2_t.dtype == torch.float32
    np.testing.assert_allclose(d2_t.numpy(), A(d2_j), rtol=1e-4, atol=1e-8)
    _assert_reaches_minimum(idx_t, pts, tri, d2_j)
    # shared edges and vertices tie to the last bit; rounding picks the face
    assert (idx_t.numpy() == A(idx_j)).mean() > 0.9
    if mode == "ray":
        np.testing.assert_array_equal(w_t.numpy(), A(w_j))
        np.testing.assert_array_equal(w_t.numpy(), np.round(w_t.numpy()))
        assert 0.05 < (w_t.numpy() > 0.5).mean() < 0.95
    elif mode == "solid_angle":
        np.testing.assert_allclose(w_t.numpy(), A(w_j), atol=2e-3)
    else:
        assert not w_t.any() and not A(w_j).any()


def test_brute_plain_matches_xla_point_mesh_query():
    from vanerf_tpu.ops.mesh_query import point_mesh_query
    verts, faces, _, pts = _hands(seed=8)
    tri = verts[faces]
    d2_j, idx_j, w_j = point_mesh_query(jnp.asarray(pts), jnp.asarray(tri),
                                        chunk=64)
    d2_t, idx_t, w_t = t_mq.point_mesh_query(T(pts), T(tri))
    np.testing.assert_allclose(d2_t.numpy(), A(d2_j), rtol=1e-4, atol=1e-8)
    _assert_reaches_minimum(idx_t, pts, tri, d2_j)
    # the same atan2 formula on both sides: only the sum's order differs
    np.testing.assert_allclose(w_t.numpy(), A(w_j), atol=1e-5)
    d2_n, idx_n, w_n = t_mq.point_mesh_query(T(pts), T(tri),
                                             with_winding=False)
    assert torch.equal(d2_n, d2_t) and torch.equal(idx_n, idx_t)
    assert not w_n.any()


def test_ray_crossing_counts_equal_kernel_a():
    """The unfolded crossing test of kernels 5-6 counts what kernel A's
    folded one counts on the same points."""
    verts, faces, vis, pts = _hands(seed=10)
    tri = verts[faces]
    _, _, w5 = t_mq.point_mesh_query_brute_plain(T(pts), T(tri), mode="ray")
    table = t_mq.face_table(T(tri), T(vis[:, 0][faces]))
    ub = torch.zeros(len(pts))
    d2_a, idx_a, w_a, _ = t_mq.point_mesh_query_vis_plain(T(pts), table, ub)
    np.testing.assert_array_equal(w5.numpy(), w_a.numpy())
    d2_5, idx_5, _ = t_mq.point_mesh_query_brute_plain(
        T(pts), T(tri), with_winding=False)
    assert torch.equal(d2_5, d2_a) and torch.equal(idx_5, idx_a)


def test_brute_handles_empty_inputs():
    verts, faces, vis, pts = _hands()
    tri = T(verts[faces])
    d2, idx, w, qv = t_mq.point_mesh_query_vis_brute(
        torch.zeros(0, 3), tri, T(vis[:, 0][faces]), mode="ray")
    assert d2.shape == idx.shape == w.shape == qv.shape == (0,)
    d2, idx, w = t_mq.point_mesh_query_brute(T(pts), torch.zeros(0, 3, 3))
    assert torch.isinf(d2).all() and not idx.any() and not w.any()
    with pytest.raises(ValueError):
        t_mq.point_mesh_query_brute(T(pts), tri, mode="parity")


# ---------------------------------------------------------------------------
# kernel 6 — kernel 5 + the argmin face's interpolated visibility
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ray", "solid_angle"])
def test_vis_brute_plain_matches_pallas_interpret(mode):
    from vanerf_tpu.ops.mesh_query_pallas import point_mesh_query_vis_pallas
    verts, faces, _, pts = _hands(seed=12)
    tri = verts[faces]
    fv = np.random.RandomState(13).rand(len(tri), 3).astype(np.float32)
    d2_j, idx_j, w_j, qv_j = point_mesh_query_vis_pallas(
        jnp.asarray(pts), jnp.asarray(tri), jnp.asarray(fv), interpret=True,
        mode=mode)
    d2_t, idx_t, w_t, qv_t = t_mq.point_mesh_query_vis_brute(
        T(pts), T(tri), T(fv), mode=mode)
    np.testing.assert_allclose(d2_t.numpy(), A(d2_j), rtol=1e-4, atol=1e-8)
    _assert_reaches_minimum(idx_t, pts, tri, d2_j)
    if mode == "ray":
        np.testing.assert_array_equal(w_t.numpy(), A(w_j))
    else:
        np.testing.assert_allclose(w_t.numpy(), A(w_j), atol=2e-3)
    same = idx_t.numpy() == A(idx_j)
    assert same.mean() > 0.9
    np.testing.assert_allclose(qv_t.numpy()[same], A(qv_j)[same], rtol=1e-4,
                               atol=1e-5)
    # kernel 6 is kernel 5 plus the visibility
    d2_5, idx_5, w_5 = t_mq.point_mesh_query_brute(T(pts), T(tri), mode=mode)
    assert torch.equal(d2_5, d2_t) and torch.equal(idx_5, idx_t)
    assert torch.equal(w_5, w_t)


def test_vis_brute_binarised_matches_cal_vis_sdf():
    from vanerf_tpu.ops.mesh_query import cal_vis_sdf
    verts, faces, vis, pts = _hands(seed=14)
    sdf_j, qvis_j, _ = cal_vis_sdf(jnp.asarray(verts), jnp.asarray(faces),
                                   jnp.asarray(pts), jnp.asarray(vis),
                                   chunk=64)
    d2, _, w, qv = t_mq.point_mesh_query_vis_brute(
        T(pts), T(verts[faces]), T(vis[:, 0][faces]))
    sdf_t = np.sqrt(d2.numpy() + 1e-6) * np.where(w.numpy() > 0.5, -1., 1.)
    np.testing.assert_allclose(sdf_t, A(sdf_j), rtol=1e-4, atol=1e-6)
    agree = ((qv.numpy() >= 0.1) == (A(qvis_j)[:, 0] > 0.5)).mean()
    assert agree >= 0.97, agree


# ---------------------------------------------------------------------------
# the public API
# ---------------------------------------------------------------------------

def test_ops_exports_match_the_jax_package():
    for name in ("point_mesh_sdf", "cal_vis_sdf", "barycentric_of_projection",
                 "winding_number"):
        assert getattr(t_ops, name) is getattr(t_mq, name)
    for name in ("point_mesh_query", "cal_vis_sdf_fast", "cal_vis_sdf_cull",
                 "cal_vis_sdf_prepared_T", "blocked2d_order"):
        assert callable(getattr(t_mq, name))


def test_winding_number_matches_oracle_and_jax():
    from vanerf_tpu.ops.mesh_query import winding_number
    verts, faces = make_icosphere(subdiv=1)
    verts = verts.astype(np.float32)
    rs = np.random.RandomState(15)
    inside = rs.randn(20, 3).astype(np.float32)
    inside = inside / np.linalg.norm(inside, axis=1, keepdims=True) * 0.5
    pts = np.concatenate([inside, inside * 4.0], 0)
    tri = verts[faces]
    w_t = t_mq.winding_number(T(pts), T(tri)).numpy()
    w_j = A(winding_number(jnp.asarray(pts), jnp.asarray(tri), chunk=16))
    assert np.all(w_t[:20] > 0.9) and np.all(np.abs(w_t[20:]) < 0.1)
    np.testing.assert_allclose(w_t, w_j, atol=1e-5)
    for i in (0, 5, 25, 35):
        assert abs(w_t[i] - winding_number_oracle(pts[i], verts, faces)) \
            < 1e-3


def test_point_mesh_sdf_sign_and_value_on_a_sphere():
    from vanerf_tpu.ops.mesh_query import point_mesh_sdf
    verts, faces = make_icosphere(subdiv=2)
    verts = verts.astype(np.float32)
    pts = np.random.RandomState(16).randn(64, 3).astype(np.float32)
    r = np.linalg.norm(pts, axis=1)
    sdf_t, idx_t = t_mq.point_mesh_sdf(T(verts), T(faces), T(pts))
    np.testing.assert_allclose(sdf_t.numpy(), r - 1.0, atol=0.02)
    assert idx_t.min() >= 0 and idx_t.max() < faces.shape[0]
    sdf_j, _ = point_mesh_sdf(jnp.asarray(verts), jnp.asarray(faces),
                              jnp.asarray(pts), chunk=32)
    np.testing.assert_allclose(sdf_t.numpy(), A(sdf_j), rtol=1e-4, atol=1e-6)


def test_point_mesh_sdf_two_component_interpenetration():
    """A point inside BOTH of two overlapping spheres reads inside (winding
    ~2), the interpenetrating-hands case."""
    from vanerf_tpu.ops.mesh_query import point_mesh_sdf
    verts, faces = _two_spheres(r=1.0, dx=0.3)
    pts = np.array([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]], np.float32)
    sdf_t, _ = t_mq.point_mesh_sdf(T(verts), T(faces), T(pts))
    assert float(sdf_t[0]) < 0.0 < float(sdf_t[1])
    sdf_j, _ = point_mesh_sdf(jnp.asarray(verts), jnp.asarray(faces),
                              jnp.asarray(pts), chunk=2)
    np.testing.assert_allclose(sdf_t.numpy(), A(sdf_j), rtol=1e-4, atol=1e-6)
    w = t_mq.winding_number(T(pts), T(verts[faces])).numpy()
    np.testing.assert_allclose(w, [2.0, 0.0], atol=1e-3)


def test_barycentric_of_projection_matches_jax():
    from vanerf_tpu.ops.mesh_query import barycentric_of_projection
    rs = np.random.RandomState(17)
    tris = rs.randn(30, 3, 3).astype(np.float32)
    wts = rs.rand(30, 3).astype(np.float32)
    wts = wts / wts.sum(1, keepdims=True)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    pts = (np.einsum("nk,nkd->nd", wts, tris) + 0.37 * n).astype(np.float32)
    got = t_mq.barycentric_of_projection(T(pts), T(tris)).numpy()
    np.testing.assert_allclose(got, wts, rtol=2e-3, atol=2e-3)
    want = A(barycentric_of_projection(jnp.asarray(pts), jnp.asarray(tris)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cal_vis_sdf_matches_jax():
    from vanerf_tpu.ops.mesh_query import cal_vis_sdf
    verts, faces, vis, pts = _hands(seed=18)
    sdf_j, qvis_j, cf_j = cal_vis_sdf(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(pts),
        jnp.asarray(vis), chunk=64)
    sdf_t, qvis_t, cf_t = t_mq.cal_vis_sdf(T(verts), T(faces), T(pts), T(vis))
    assert qvis_t.shape == (N_PTS, 1) and cf_t.shape == (N_PTS, 3)
    assert cf_t.dtype == torch.int32
    np.testing.assert_array_equal(sdf_t.numpy() < 0, A(sdf_j) < 0)
    np.testing.assert_allclose(sdf_t.numpy(), A(sdf_j), rtol=1e-4, atol=1e-6)
    same = (cf_t.numpy() == A(cf_j)).all(1)     # else a distance tie
    assert same.mean() > 0.9
    np.testing.assert_array_equal(qvis_t.numpy()[same], A(qvis_j)[same])
    assert set(np.unique(qvis_t.numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("winding", ["ray", "solid_angle"])
def test_cal_vis_sdf_fast_matches_jax(winding, monkeypatch):
    """``cal_vis_sdf_fast`` under VANERF_WINDING against the JAX function on
    its Pallas path (kernel 6 in interpret mode)."""
    from vanerf_tpu.ops import mesh_query as jmq
    import vanerf_tpu.ops.mesh_query_pallas as mqp
    verts, faces, vis, pts = _hands(seed=20)
    monkeypatch.setenv("VANERF_WINDING", winding)
    monkeypatch.setenv("VANERF_MESH_BACKEND", "pallas")
    orig = mqp.point_mesh_query_vis_pallas
    seen = []

    def interp(*a, **k):
        seen.append(k.get("mode"))
        return orig(*a, **{**k, "interpret": True})

    monkeypatch.setattr(mqp, "point_mesh_query_vis_pallas", interp)
    sdf_j, qvis_j = jmq.cal_vis_sdf_fast(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(pts),
        jnp.asarray(vis))
    assert seen == [winding]
    sdf_t, qvis_t = t_mq.cal_vis_sdf_fast(T(verts), T(faces), T(pts), T(vis))
    assert qvis_t.shape == (N_PTS, 1)
    np.testing.assert_array_equal(sdf_t.numpy() < 0, A(sdf_j) < 0)
    np.testing.assert_allclose(sdf_t.numpy(), A(sdf_j), rtol=1e-4, atol=1e-6)
    assert (qvis_t.numpy() == A(qvis_j)).mean() >= 0.97
    # and against the closest-face formulation
    sdf_c, qvis_c, _ = t_mq.cal_vis_sdf(T(verts), T(faces), T(pts), T(vis))
    np.testing.assert_allclose(sdf_t.numpy(), sdf_c.numpy(), rtol=1e-4,
                               atol=1e-6)
    assert (qvis_t == qvis_c).float().mean() >= 0.97


def test_cal_vis_sdf_cull_equals_prepared():
    verts, faces, vis, pts = _hands(seed=22)
    _, ub = t_knn.nearest_vertex_d2(T(pts), T(verts))
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    want = t_mq.cal_vis_sdf_prepared(mesh, T(pts), ub, n_samples=8)
    got = t_mq.cal_vis_sdf_cull(T(verts), T(faces).long(), T(pts), T(vis),
                                ub, n_samples=8)
    assert got[2] is None and want[2] is None
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the culled query and the exact API agree on the mesh prior
    sdf_e, qvis_e = t_mq.cal_vis_sdf_fast(T(verts), T(faces), T(pts), T(vis))
    np.testing.assert_array_equal(got[0].numpy() < 0, sdf_e.numpy() < 0)
    np.testing.assert_allclose(got[0].numpy(), sdf_e.numpy(), rtol=1e-4,
                               atol=1e-6)
    assert (got[1] == qvis_e).float().mean() >= 0.97


# ---------------------------------------------------------------------------
# kernels 7 and 8 — coordinate-major (3, N) input
# ---------------------------------------------------------------------------

def test_mesh_query_T_plain_bit_equal_to_kernel_a_plain():
    verts, faces, vis, pts = _hands(seed=24)
    pts = h.two_hand_points(256, seed=25)
    table = t_mq.face_table(T(verts[faces]), T(vis[:, 0][faces]))
    _, ub = t_knn.nearest_vertex_d2(T(pts), T(verts))
    far = torch.arange(256) % 3 == 0
    pts_T = T(pts.T)
    assert pts_T.is_contiguous() and pts_T.shape == (3, 256)
    for f in (None, far):
        want = t_mq.point_mesh_query_vis(T(pts), table, ub, f)
        got = t_mq.point_mesh_query_vis_T(pts_T, table, ub, f)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_nearest_vertex_T_bit_equal_to_kernel_b_plain():
    from vanerf_tpu.ops.knn_pallas import nearest_vertex_d2_pallas_T
    rs = np.random.RandomState(26)
    verts = (rs.randn(779, 3) * 100).astype(np.float32)
    pts = (rs.randn(1000, 3) * 120).astype(np.float32)
    idx_b, d2_b = t_knn.nearest_vertex_d2(T(pts), T(verts))
    idx_t, d2_t = t_knn.nearest_vertex_d2_T(T(pts.T), T(verts))
    assert idx_t.dtype == torch.int32 and d2_t.dtype == torch.float32
    assert torch.equal(idx_t, idx_b) and torch.equal(d2_t, d2_b)
    idx_j, d2_j = nearest_vertex_d2_pallas_T(jnp.asarray(pts.T),
                                             jnp.asarray(verts),
                                             interpret=True)
    np.testing.assert_array_equal(idx_t.numpy(), A(idx_j))
    np.testing.assert_allclose(d2_t.numpy(), A(d2_j), rtol=1e-6, atol=1e-9)


def test_nearest_vertex_T_matches_jax_dispatch():
    from vanerf_tpu.ops.knn import nearest_vertex_d2_T
    verts, _, _, _ = _hands()
    pts = h.two_hand_points(512, seed=27)
    idx_j, d2_j = nearest_vertex_d2_T(jnp.asarray(pts.T), jnp.asarray(verts))
    idx_t, d2_t = t_knn.nearest_vertex_d2_T(T(pts.T), T(verts))
    np.testing.assert_array_equal(idx_t.numpy(), A(idx_j))
    np.testing.assert_allclose(d2_t.numpy(), A(d2_j), rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# relayouts and the far tier's tiles
# ---------------------------------------------------------------------------

def test_blocked_ax1_relayouts_match_jax():
    from vanerf_tpu.ops import mesh_query as jmq
    P, S = 64, 16
    x = np.random.RandomState(28).randn(3, P * S).astype(np.float32)
    xb = t_mq._to_blocked_ax1(T(x), P, S, 16, 8)
    np.testing.assert_array_equal(
        xb.numpy(), A(jmq._to_blocked_ax1(jnp.asarray(x), P, S, 16, 8)))
    np.testing.assert_array_equal(
        t_mq._from_blocked_ax1(xb, P, S, 16, 8).numpy(), x)
    np.testing.assert_array_equal(
        A(jmq._from_blocked_ax1(jnp.asarray(xb.numpy()), P, S, 16, 8)), x)
    # along axis 1 it is to_blocked of each row: first tile = 16 rays x 8
    np.testing.assert_array_equal(
        xb.numpy()[:, :128].reshape(3, 16, 8),
        x.reshape(3, P, S)[:, :16, :8])
    np.testing.assert_array_equal(
        xb[1].numpy(), t_mq.to_blocked(T(x[1]), P, S, 16, 8).numpy())


def test_blocked2d_ax1_relayouts_match_jax():
    from vanerf_tpu.ops import mesh_query as jmq
    H, W, S = 8, 16, 8
    x = np.random.RandomState(29).randn(3, H * W * S).astype(np.float32)
    xb = t_mq._to_blocked2d_ax1(T(x), H, W, S, 4, 4, 8)
    np.testing.assert_array_equal(
        xb.numpy(),
        A(jmq._to_blocked2d_ax1(jnp.asarray(x), H, W, S, 4, 4, 8)))
    np.testing.assert_array_equal(
        t_mq._from_blocked2d_ax1(xb, H, W, S, 4, 4, 8).numpy(), x)
    np.testing.assert_array_equal(
        A(jmq._from_blocked2d_ax1(jnp.asarray(xb.numpy()), H, W, S, 4, 4,
                                  8)), x)
    # first tile = the (4 x 4) pixel block x 8 depths, row-major
    np.testing.assert_array_equal(
        xb.numpy()[:, :128].reshape(3, 4, 4, 8),
        x.reshape(3, H, W, S)[:, :4, :4, :8])


@pytest.mark.parametrize("spec,want", [
    ("4,4,8", (4, 4, 8)), ("4x4x8", (4, 4, 8)), ("", None),
    ("garbage", None), ("4,4", None), ("3,4,8", None), ("4,4,5", None)])
def test_blocked2d_order_parsing(spec, want, monkeypatch):
    from vanerf_tpu.ops import mesh_query as jmq
    monkeypatch.setenv("VANERF_BLOCK_2D", spec)
    assert t_mq.blocked2d_order(8, 16, 8) == want
    assert jmq.blocked2d_order(8, 16, 8) == want


def test_blocked_order_reads_the_block_switches(monkeypatch):
    from vanerf_tpu.ops import mesh_query as jmq
    assert t_mq.blocked_order(64, 8) == (16, 8)
    monkeypatch.setenv("VANERF_BLOCK_RAYS", "32")
    monkeypatch.setenv("VANERF_BLOCK_SAMPLES", "4")
    assert t_mq.blocked_order(64, 8) == jmq.blocked_order(64, 8) == (32, 4)
    assert t_mq.blocked_order(48, 8) is None
    assert t_mq.blocked_order(64, 8, 16, 8) == (16, 8)


def _ray_points(H, W, S, seed=30):
    """Ray-structured points (H x W rays, S depths) over the fixture hands:
    the rays of the right half and of the lower rows pass far from them,
    so whole rows are far (1-D tiles) and whole right-hand pixel blocks."""
    verts, faces, vis, _ = _hands(seed=seed)
    lo, hi = verts.min(0), verts.max(0)
    ys, xs = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    tgt = np.stack([lo[0] + xs * (hi[0] - lo[0]) * 2.2,
                    lo[1] + ys * (hi[1] - lo[1]) * 2.2,
                    np.full_like(xs, 0.5 * (lo[2] + hi[2]))], -1)
    o = np.array([0.0, 0.0, 0.6], np.float32)
    d = tgt.reshape(-1, 3) - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t = np.linspace(0.45, 0.75, S)
    pts = (o + d[:, None] * t[None, :, None]).reshape(-1, 3)
    return verts, faces, vis, pts.astype(np.float32)


@pytest.mark.parametrize("far2", [None, 0.02 ** 2])
def test_prepared_T_equals_prepared_bit_for_bit(far2):
    H, W, S = 8, 16, 8
    verts, faces, vis, pts = _ray_points(H, W, S)
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    idx_a, ub = t_knn.nearest_vertex_d2(T(pts), T(verts))
    idx_b, ub_T = t_knn.nearest_vertex_d2_T(T(pts.T), T(verts))
    assert torch.equal(ub, ub_T) and torch.equal(idx_a, idx_b)
    want = t_mq.cal_vis_sdf_prepared(mesh, T(pts), ub, n_samples=S,
                                     far2=far2)
    got = t_mq.cal_vis_sdf_prepared_T(mesh, T(pts.T), ub, n_samples=S,
                                      rays_hw=(H, W), far2=far2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if far2 is None:
        assert got[2] is None and want[2] is None
    else:
        assert torch.equal(got[2], want[2])
        assert 0 < got[2].float().mean() < 1, "exercise both tiers"
        assert (got[1][got[2]] == 0).all()


def test_prepared_T_block2d_far_mask_matches_jax_pallas(monkeypatch):
    """Under VANERF_BLOCK_2D the far tier's 128-point tiles are 4x4 pixel
    blocks x 8 depths: the far mask equals the JAX Pallas path's (kernel 7
    in interpret mode) and differs from the 1-D tiling's."""
    from vanerf_tpu.ops import mesh_query as jmq
    from vanerf_tpu.ops.knn import nearest_vertex_d2
    import vanerf_tpu.ops.mesh_query_pallas as mqp
    H, W, S = 8, 16, 8
    verts, faces, vis, pts = _ray_points(H, W, S)
    far2 = 0.02 ** 2
    _, ub_j = nearest_vertex_d2(jnp.asarray(pts), jnp.asarray(verts))
    _, ub_t = t_knn.nearest_vertex_d2_T(T(pts.T), T(verts))
    np.testing.assert_array_equal(ub_t.numpy(), A(ub_j))

    monkeypatch.setenv("VANERF_MESH_BACKEND", "pallas")
    orig_T = mqp.point_mesh_query_vis_culled_T
    monkeypatch.setattr(
        mqp, "point_mesh_query_vis_culled_T",
        lambda *a, **k: orig_T(*a, **{**k, "interpret": True}))
    mesh_j = jmq.prepare_culled_mesh(jnp.asarray(verts), jnp.asarray(faces),
                                     jnp.asarray(vis))
    mesh_t = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    kw = dict(n_samples=S, rays_hw=(H, W), far2=far2)
    far = {}
    for spec in ("", "4,4,8"):
        monkeypatch.setenv("VANERF_BLOCK_2D", spec)
        sdf_j, qv_j, far_j = jmq.cal_vis_sdf_prepared_T(
            mesh_j, jnp.asarray(pts.T), ub_j, **kw)
        sdf_t, qv_t, far_t = t_mq.cal_vis_sdf_prepared_T(
            mesh_t, T(pts.T), ub_t, **kw)
        np.testing.assert_array_equal(far_t.numpy(), A(far_j))
        np.testing.assert_array_equal(sdf_t.numpy() < 0, A(sdf_j) < 0)
        np.testing.assert_allclose(sdf_t.numpy(), A(sdf_j), rtol=1e-4,
                                   atol=1e-6)
        # (the visibility is not compared: away from the hands the closest
        # point is a vertex, its faces tie, and the JAX path's Morton face
        # order breaks the tie for another face than the port's mesh order)
        assert not qv_t.numpy()[far_t.numpy()].any()
        assert not A(qv_j)[A(far_j)].any()
        far[spec] = far_t.numpy()
    assert 0 < far["4,4,8"].mean() < 1
    assert (far[""] != far["4,4,8"]).any(), "the tilings mark other points"
    # the 2-D tiles: a far flag is constant over a 4x4 pixel block x 8 depths
    blocks = far["4,4,8"].reshape(H // 4, 4, W // 4, 4, S)
    assert (blocks.min((1, 3, 4)) == blocks.max((1, 3, 4))).all()
    # without rays_hw the switch is not read
    got = t_mq.cal_vis_sdf_prepared_T(mesh_t, T(pts.T), ub_t, n_samples=S,
                                      far2=far2)
    np.testing.assert_array_equal(got[2].numpy(), far[""])


# ---------------------------------------------------------------------------
# kernels 5 and 6: the per-face skip, played face by face
# ---------------------------------------------------------------------------

def _brute_skip_walk(points, table):
    """Kernels 5 / 6's walk played face by face: the points padded to whole
    blocks of 512 with the last point repeated, 32 consecutive points to a
    warp's slot; the slot evaluates a face's distance when ``sphere_skip``
    (the sphere in the table's last four columns) keeps it for any of its
    lanes against that lane's best so far, and each lane then takes the
    distance when strictly below its best.  Returns d2, idx, qvis and the
    (thread, face) evaluations."""
    N, F = points.shape[0], table.shape[0]
    n_pad = -(-N // t_mq.BRUTE_BLOCK_POINTS) * t_mq.BRUTE_BLOCK_POINTS
    p = points[torch.arange(n_pad).clamp(max=N - 1)]
    best = torch.full((n_pad,), float("inf"))
    idx = torch.zeros(n_pad, dtype=torch.int32)
    qvis = torch.zeros(n_pad)
    count = 0
    for f in range(F):
        row = table[f]
        keep = ~t_mq.sphere_skip(p, row[24:28], best)
        warp = keep.reshape(-1, 32).any(1).repeat_interleave(32)
        count += int(warp.sum())
        d, v, w = t_mq._tri_sq_dist_bary(p, row[0:3], row[3:6], row[6:9])
        upd = warp & (d < best)
        best = torch.where(upd, d, best)
        idx = torch.where(upd, torch.tensor(f, dtype=torch.int32), idx)
        qv = (1.0 - v - w) * row[9] + v * row[10] + w * row[11]
        qvis = torch.where(upd, qv, qvis)
    return best[:N], idx[:N], qvis[:N], count


def _skip_case(case):
    """(points (N, 3), triangles (F, 3, 3), corner visibility (F, 3)) of one
    seeded case: the hands centred on the origin, translated 1e2 and 1e3
    from it, with slivers between their faces, and points on their shared
    edges and vertices; N and F are no multiple of the kernel's block and
    chunk."""
    verts, faces, vis, _ = _hands(seed=40)
    rs = np.random.RandomState(41)
    verts = verts - 0.5 * (verts.min(0) + verts.max(0))
    tri = verts[faces]
    fv = rs.rand(len(faces), 3).astype(np.float32)
    lo, hi = verts.min(0) - 0.03, verts.max(0) + 0.03
    pts = (lo + rs.rand(700, 3) * (hi - lo)).astype(np.float32)
    if case == "slivers":
        a, b = tri[::7, 0], tri[::7, 1]
        t = rs.rand(len(a), 1).astype(np.float32)
        sl = np.stack([
            np.stack([a, b, a + t * (b - a)], 1),           # collinear
            np.stack([a, a, a], 1),                         # a point
            np.stack([a, b, b + np.float32(1e-7)], 1),      # a needle
        ], 1).reshape(-1, 3, 3)
        tri = np.concatenate([tri, sl])
        perm = rs.permutation(len(tri))
        tri = tri[perm]
        fv = rs.rand(len(tri), 3).astype(np.float32)
        pts = np.concatenate([pts, sl[::5, 2] + np.float32(1e-4)])
    elif case == "shared":
        e = verts[faces[:, [0, 1]]].mean(1)
        pts = np.concatenate([verts[::2], e[::3], pts[:100]])
    elif case.startswith("offset"):
        off = np.array([1.0, -0.6, 0.4], np.float32) * float(case[6:])
        tri = tri + off
        pts = pts + off
    return (T(pts.astype(np.float32)), T(tri.astype(np.float32)), T(fv))


SKIP_CASES = ["centred", "offset1e2", "offset1e3", "slivers", "shared"]


@pytest.mark.parametrize("case", SKIP_CASES)
def test_brute_skip_walk_equals_plain(case):
    """The kernels' walk with the per-face skip equals the plain version,
    which evaluates every pair, bit for bit in d2, idx and qvis, on meshes
    centred and far from the origin, with slivers, and with points on
    shared edges and vertices (exact ties); the skip is not vacuous."""
    pts, tri, fv = _skip_case(case)
    table = t_mq.brute_face_table(tri, fv)
    assert table.shape == (len(tri), t_mq.BRUTE_STRIDE)
    d2, idx, qv, count = _brute_skip_walk(pts, table)
    want = t_mq._brute_plain(pts, table, True, "none")
    assert torch.equal(d2, want[0])
    assert torch.equal(idx, want[1])
    assert torch.equal(qv, want[3])
    n_pad = -(-len(pts) // t_mq.BRUTE_BLOCK_POINTS) * t_mq.BRUTE_BLOCK_POINTS
    share = count / (n_pad * len(tri))
    # (random points: a warp's 32 lanes seldom agree; 1e3 from the origin
    # the margin 1e-5 R outgrows the faces, and slivers are never skipped)
    assert 0 < share < (0.7 if case in ("offset1e3", "slivers") else 0.55), \
        share
    if case == "slivers":       # a sliver's sphere is infinite: never skipped
        sph = table[:, 24:28]
        assert torch.isinf(sph[:, 3]).sum() >= len(tri) - len(pts)
    if case == "shared":        # the points on edges and vertices tie
        assert (d2 == 0).sum() > 100


@pytest.mark.parametrize("case", ["centred", "offset1e3", "slivers"])
def test_brute_work_counts_the_warps_evaluations(case):
    """``brute_work`` (the count behind kernels 5 / 6's work bound) against
    the walk played face by face: the same evaluations, every pair a
    sphere test and a winding term, the ragged last block's repeated
    points included."""
    pts, tri, fv = _skip_case(case)
    table = t_mq.brute_face_table(tri, fv)
    work = t_mq.brute_work(pts, table)
    assert work["evaluated"] == _brute_skip_walk(pts, table)[3]
    n_pad = -(-len(pts) // t_mq.BRUTE_BLOCK_POINTS) * t_mq.BRUTE_BLOCK_POINTS
    assert work["sphere_tests"] == work["windings"] == n_pad * len(tri)
    assert 0 < work["evaluated"] < work["sphere_tests"]
    assert t_mq.brute_work(pts[:0], table) == dict(
        sphere_tests=0, evaluated=0, windings=0)


_xyz = st.tuples(*[st.floats(-1.0, 1.0, width=32)] * 3)


@settings(max_examples=300, deadline=None, database=None)
@given(corners=st.tuples(_xyz, _xyz, _xyz), p=_xyz, off=_xyz,
       kind=st.sampled_from(["random", "collinear", "on_vertex", "on_edge",
                             "above"]),
       t=st.floats(0.0, 1.0, width=32),
       scale=st.sampled_from([1e-3, 1e-2, 1.0, 30.0]),
       offset=st.sampled_from([0.0, 1e2, 1e3, -1e3]),
       reach=st.sampled_from([1e-3, 1.0, 10.0]))
def test_brute_sphere_skip_keeps_faces_far_from_the_origin(
        corners, p, off, kind, t, scale, offset, reach):
    """The spheres ``brute_face_table`` stores for kernels 5 / 6, on faces
    as the public API hands them (uncentred, up to 1e3 from the origin with
    a size down to 1e-3): for any best above a face's computed squared
    distance the face is kept (``sphere_skip``), on random faces and on
    degenerate ones, for points near and far."""
    a, b, c = (np.array(v, np.float32) for v in corners)
    if kind == "collinear":
        c = a + np.float32(t) * (b - a)
    shift = np.array(off, np.float32) * np.float32(offset)
    tri = (np.stack([a, b, c]) * np.float32(scale) + shift).astype(
        np.float32)
    q = (np.array(p, np.float32) * np.float32(reach * scale)
         + tri.mean(0)).astype(np.float32)
    if kind == "on_vertex":
        q = tri[0].copy()
    elif kind == "on_edge":
        q = (tri[0] + np.float32(t) * (tri[1] - tri[0])).astype(np.float32)
    elif kind == "above":
        n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
        q = (tri.mean(0) + np.float32(reach * 1e-3) * n).astype(np.float32)
    table = t_mq.brute_face_table(T(tri[None]))
    pt = T(q)
    tt = T(tri)
    d = t_mq.point_triangle_sq_dist(pt, tt[0], tt[1], tt[2])
    assert torch.isfinite(d)
    above = torch.nextafter(d, torch.tensor(float("inf")))
    for best in (above, above * 1.5, d * 4.0 + 1e-30):
        assert not t_mq.sphere_skip(pt, table[0, 24:28], best), (d, best)


# ---------------------------------------------------------------------------
# on the card: kernels 5-8 against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_case(cuda, n=5000):
    from vanerf_tpu_torch.data.synthetic import two_hand_mesh
    verts, faces, _ = two_hand_mesh(0, 2)
    rs = np.random.RandomState(31)
    fv = T(rs.rand(len(faces), 3).astype(np.float32)).to(cuda)
    tri = T(verts[faces]).to(cuda)
    pts = T(h.two_hand_points(n, seed=32)).to(cuda)
    return T(verts).to(cuda), tri, fv, pts


# a mesh translated from the origin (the public API does not centre it),
# and ragged point and face counts: the kernels' blocks hold 512 points,
# their staging chunks 128 faces
OFFSETS = [0.0, 1e2, 1e3]
RAGGED = ((0, None), (7, 0), (129, 129), (1, 1), (511, 127), (513, 257),
          (1000, 640))


def _offset(x, offset):
    return x + torch.tensor([1.0, -0.6, 0.4], device=x.device) * offset


@pytest.mark.cuda
@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("mode", ["none", "ray", "solid_angle"])
def test_brute_kernel_matches_plain(cuda, mode, offset):
    _, tri, _, pts = _cuda_case(cuda)
    tri, pts = _offset(tri, offset), _offset(pts, offset)
    kw = (dict(with_winding=False) if mode == "none" else dict(mode=mode))
    n0 = t_mq.brute_launches
    got = t_mq.point_mesh_query_brute(pts, tri, **kw)
    torch.cuda.synchronize()
    assert t_mq.brute_launches == n0 + 1
    want = t_mq.point_mesh_query_brute_plain(pts, tri, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if mode == "solid_angle":
        assert (got[2] - want[2]).abs().max() <= 1e-5
    else:
        assert torch.equal(got[2], want[2])
    for n, f in RAGGED:
        g = t_mq.point_mesh_query_brute(pts[:n], tri[:f], **kw)
        w = t_mq.point_mesh_query_brute_plain(pts[:n], tri[:f], **kw)
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
        if mode != "solid_angle":
            assert torch.equal(g[2], w[2])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("mode", ["ray", "solid_angle"])
def test_vis_brute_kernel_matches_plain(cuda, mode, offset):
    _, tri, fv, pts = _cuda_case(cuda)
    tri, pts = _offset(tri, offset), _offset(pts, offset)
    n0 = t_mq.vis_brute_launches
    got = t_mq.point_mesh_query_vis_brute(pts, tri, fv, mode=mode)
    torch.cuda.synchronize()
    assert t_mq.vis_brute_launches == n0 + 1
    want = t_mq.point_mesh_query_vis_brute_plain(pts, tri, fv, mode=mode)
    for k in (0, 1, 3):
        assert torch.equal(got[k], want[k]), k
    if mode == "solid_angle":
        assert (got[2] - want[2]).abs().max() <= 1e-5
    else:
        assert torch.equal(got[2], want[2])
    for n, f in RAGGED:
        g = t_mq.point_mesh_query_vis_brute(pts[:n], tri[:f], fv[:f],
                                            mode=mode)
        w = t_mq.point_mesh_query_vis_brute_plain(pts[:n], tri[:f], fv[:f],
                                                  mode=mode)
        for k in (0, 1, 3):
            assert torch.equal(g[k], w[k]), (n, f, k)
        if mode == "ray":
            assert torch.equal(g[2], w[2])


@pytest.mark.cuda
def test_T_kernels_bit_equal_to_a_and_b(cuda):
    verts, tri, fv, pts = _cuda_case(cuda, n=4096)
    pts_T = pts.t().contiguous()
    n7, n8 = t_mq.unculled_launches_T, t_knn.launches_T
    idx_b, ub = t_knn.nearest_vertex_d2(pts, verts)
    idx_8, ub_8 = t_knn.nearest_vertex_d2_T(pts_T, verts)
    assert torch.equal(idx_8, idx_b) and torch.equal(ub_8, ub)
    table = t_mq.face_table(tri, fv)
    far = torch.arange(4096, device=cuda) % 3 == 0
    for f in (None, far):
        a = t_mq.point_mesh_query_vis(pts, table, ub, f)
        b = t_mq.point_mesh_query_vis_T(pts_T, table, ub, f)
        c = t_mq.point_mesh_query_vis_T_plain(pts_T, table, ub, f)
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y) and torch.equal(y, z)
    torch.cuda.synchronize()
    assert t_mq.unculled_launches_T == n7 + 2
    assert t_knn.launches_T == n8 + 1
    with pytest.raises(ValueError):
        t_knn.nearest_vertex_d2_T(pts, verts)          # (N, 3) is refused
