"""Port ops (vanerf_tpu_torch.ops) against the JAX ops, on the CPU.

The kernel modules are checked through their plain-PyTorch twins (what a
wrapper runs on a CPU tensor) against the JAX function as the JAX
package's own CPU tests run it: the XLA path, and the Pallas kernel in
interpret mode where that is cheap.  Tolerances:
  * plain tensor ops: rtol 1e-5 (same f32 formulas, other summation order);
  * indices equal except exact ties — a differing index must reach the same
    minimum;
  * sdf rtol 1e-4 / atol 1e-6, identical inside/outside (solid-angle
    winding in JAX vs signed ray crossings in the port agree off grazes);
  * binarised visibility agrees on >= 97% of points (argmin ties between
    faces sharing the closest edge or vertex pick different planes);
  * sampler atol 1e-6 (hat-weight sum vs lerp: rounding only).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_helpers as h
from vanerf_tpu_torch.ops import composite as t_comp
from vanerf_tpu_torch.ops import grid_sample as t_gs
from vanerf_tpu_torch.ops import interp_mxu as t_interp
from vanerf_tpu_torch.ops import knn as t_knn
from vanerf_tpu_torch.ops import mesh_query as t_mq
from vanerf_tpu_torch.ops import rasterize as t_rast
from vanerf_tpu_torch.ops import ray as t_ray
from vanerf_tpu_torch.ops import sampling as t_samp


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def A(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# plain tensor ops
# ---------------------------------------------------------------------------

def test_pixel_grid_rays_and_bbox():
    from vanerf_tpu.ops import ray as j_ray
    batch, _ = h.synthetic_batch()
    rs = np.random.RandomState(0)
    grids = rs.uniform(-60.0, 90.0, size=(1, 64, 2)).astype(np.float32)
    outs_j = j_ray.pixel_grid_rays(jnp.asarray(grids),
                                   jnp.asarray(batch["tar_k"]),
                                   jnp.asarray(batch["tar_rt"]),
                                   batch["znear"], batch["zfar"])
    outs_t = t_ray.pixel_grid_rays(T(grids), T(batch["tar_k"]),
                                   T(batch["tar_rt"]), batch["znear"],
                                   batch["zfar"])
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_allclose(b.numpy(), A(a), rtol=1e-5, atol=1e-6)
    box_j = j_ray.ray_bbox_intersection(jnp.asarray(batch["bounds"]),
                                        outs_j[0], outs_j[1])
    box_t = t_ray.ray_bbox_intersection(T(batch["bounds"]), outs_t[0],
                                        outs_t[1])
    np.testing.assert_array_equal(box_t[2].numpy(), A(box_j[2]))
    assert box_t[2].any() and not box_t[2].all()
    for a, b in zip(box_j[:2], box_t[:2]):
        np.testing.assert_allclose(b.numpy(), A(a), rtol=1e-5, atol=1e-6)


def test_stratified_and_importance_sample():
    from vanerf_tpu.ops import sampling as j_samp
    rs = np.random.RandomState(1)
    zn = (0.5 + 0.1 * rs.rand(2, 16, 1)).astype(np.float32)
    zf = (zn + 0.3 + 0.1 * rs.rand(2, 16, 1)).astype(np.float32)
    z_j = j_samp.stratified_sample(jnp.asarray(zn), jnp.asarray(zf), 8,
                                   uniform=True)
    z_t = t_samp.stratified_sample(T(zn), T(zf), 8)
    np.testing.assert_allclose(z_t.numpy(), A(z_j), rtol=1e-5, atol=1e-6)
    contrib = rs.rand(2, 16, 6).astype(np.float32)
    contrib[0, 0] = 0.0                              # degenerate-bin guard
    z_mid = 0.5 * (A(z_j)[..., 1:] + A(z_j)[..., :-1])
    new_j = j_samp.importance_sample(jnp.asarray(contrib),
                                     jnp.asarray(z_mid), 8, uniform=True)
    new_t = t_samp.importance_sample(T(contrib), T(z_mid), 8)
    np.testing.assert_allclose(new_t.numpy(), A(new_j), rtol=1e-5,
                               atol=1e-6)


def test_rgba2out_and_sdf_activation():
    from vanerf_tpu.ops import composite as j_comp
    rs = np.random.RandomState(2)
    B, N, D = 2, 9, 8
    rad = rs.randn(B, N, D).astype(np.float32) * 0.05
    sdf = rs.randn(B, N, D).astype(np.float32) * 0.01
    rgb = rs.rand(B, N, D, 3).astype(np.float32)
    z = np.sort(0.5 + rs.rand(B, N, D), -1).astype(np.float32)
    qs = rs.randn(B, N, D).astype(np.float32) * 0.02
    beta = np.array([0.01], np.float32)
    outs_j = j_comp.rgba2out(*[jnp.asarray(x) for x in
                               (rad, sdf, rgb, z, qs, beta)])
    outs_t = t_comp.rgba2out(*[T(x) for x in (rad, sdf, rgb, z, qs, beta)])
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_allclose(b.numpy(), A(a), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        t_comp.sdf_activation(T(rad), T(np.array([1e-3], np.float32))),
        A(j_comp.sdf_activation(jnp.asarray(rad), jnp.float32(1e-3))),
        rtol=1e-5, atol=1e-6)


def _uv(rs, n):
    """Interiors, borders, out-of-range and exact knots."""
    uv = rs.uniform(-1.15, 1.15, size=(n, 2)).astype(np.float32)
    uv[: n // 8] = np.sign(uv[: n // 8])
    uv[n // 8: n // 4, 0] = 1.0
    k = n // 4
    uv[k: k + n // 8] = np.round(uv[k: k + n // 8] * 8) / 8.0
    return uv


@pytest.mark.parametrize("hwc", [(32, 32, 64), (16, 8, 5), (128, 128, 8)])
def test_grid_sample_matches_jax(hwc):
    from vanerf_tpu.ops.grid_sample import feat_sample_nhwc, grid_sample_2d
    rs = np.random.RandomState(3)
    feat = rs.randn(*hwc).astype(np.float32)
    uv = _uv(rs, 600)
    np.testing.assert_allclose(
        t_gs.grid_sample_2d(T(feat), T(uv)).numpy(),
        A(grid_sample_2d(jnp.asarray(feat), jnp.asarray(uv))),
        rtol=1e-5, atol=1e-6)
    fb, ub = feat[None].repeat(2, 0), np.stack([uv, uv[::-1]])
    np.testing.assert_allclose(
        t_gs.feat_sample_nhwc(T(fb), T(ub)).numpy(),
        A(feat_sample_nhwc(jnp.asarray(fb), jnp.asarray(ub))),
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# kernel B — nearest vertex
# ---------------------------------------------------------------------------

def _check_nearest(idx_t, d2_t, idx_j, d2_j, q, v):
    idx_t, idx_j = idx_t.numpy(), A(idx_j)
    np.testing.assert_allclose(d2_t.numpy(), A(d2_j), rtol=1e-6, atol=1e-12)
    diff = idx_t != idx_j
    # a differing index must be an exact tie: same squared distance
    d_alt = ((q[diff] - v[idx_t[diff]]) ** 2).sum(-1)
    np.testing.assert_allclose(d_alt, A(d2_j)[diff], rtol=1e-6)
    assert diff.mean() < 0.01


@pytest.mark.parametrize("path", ["xla", "pallas_interpret"])
def test_nearest_vertex_plain_matches_jax(path):
    from vanerf_tpu.ops.knn import nearest_vertex_d2
    from vanerf_tpu.ops.knn_pallas import nearest_vertex_d2_pallas
    q = h.two_hand_points(1024, seed=4)
    v = h.synthetic_batch()[0]["verts"][0]
    if path == "xla":
        idx_j, d2_j = nearest_vertex_d2(jnp.asarray(q), jnp.asarray(v))
    else:
        idx_j, d2_j = nearest_vertex_d2_pallas(jnp.asarray(q),
                                               jnp.asarray(v),
                                               interpret=True)
    idx_t, d2_t = t_knn.nearest_vertex_d2(T(q), T(v))
    assert idx_t.dtype == torch.int32 and d2_t.dtype == torch.float32
    _check_nearest(idx_t, d2_t, idx_j, d2_j, q, v)


def test_knn_gather_matches_jax():
    from vanerf_tpu.ops.knn import knn_gather_1
    rs = np.random.RandomState(5)
    B, N, V, C = 2, 50, 2 * 20, 7
    q = rs.randn(B, N, 3).astype(np.float32)
    verts = rs.randn(B, V, 3).astype(np.float32)
    feat = rs.randn(B, V, C).astype(np.float32)
    vis = (rs.rand(B, V, 1) > 0.5).astype(np.float32)
    idx = rs.randint(0, V, size=(B, N)).astype(np.int32)
    outs_j = knn_gather_1(jnp.asarray(q), jnp.asarray(verts),
                          jnp.asarray(feat), jnp.asarray(vis), V // 2,
                          nn_idx=jnp.asarray(idx))
    outs_t = t_knn.knn_gather_1(T(q), T(verts), T(feat), T(vis), V // 2,
                                T(idx))
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_array_equal(b.numpy(), A(a))


# ---------------------------------------------------------------------------
# kernel C — rasterizer
# ---------------------------------------------------------------------------

def _fixture_projection(size):
    batch, faces = h.synthetic_batch()
    verts = batch["verts"][0]
    krt = batch["src_krt"][0]
    vh = verts @ krt[:3, :3].T + krt[:3, 3]
    xy01 = vh[:, :2] / (vh[:, 2:3] + 1e-8) / (h.W - 1.0)
    z01 = (vh[:, 2:3] - 0.5) / (1.4 - 0.5)
    return (xy01 * (size - 1.0)).astype(np.float32), \
        z01[:, 0].astype(np.float32), faces, xy01.astype(np.float32), \
        z01.astype(np.float32)


@pytest.mark.parametrize("path", ["xla", "pallas_interpret"])
def test_rasterize_plain_matches_jax(path):
    from vanerf_tpu.ops.rasterize import rasterize_zbuffer
    from vanerf_tpu.ops.rasterize_pallas import rasterize_zbuffer_pallas
    xy, z, faces, _, _ = _fixture_projection(32)
    args = (jnp.asarray(xy), jnp.asarray(z), jnp.asarray(faces))
    if path == "xla":
        f_j, b_j, z_j = rasterize_zbuffer(*args, 32, 32)
    else:
        f_j, b_j, z_j = rasterize_zbuffer_pallas(*args, 32, 32,
                                                 interpret=True)
    f_t, b_t, z_t = t_rast.rasterize_zbuffer(T(xy), T(z), T(faces), 32, 32)
    f_t, f_j = f_t.numpy(), A(f_j)
    assert (f_t >= 0).sum() > 50                     # the hands are hit
    np.testing.assert_array_equal(f_t >= 0, f_j >= 0)
    np.testing.assert_allclose(z_t.numpy(), A(z_j), rtol=1e-6, atol=1e-7)
    same = f_t == f_j                   # else a z tie (equal zbuf above)
    assert same.mean() > 0.99
    np.testing.assert_allclose(b_t.numpy()[same], A(b_j)[same], rtol=1e-5,
                               atol=1e-6)


def test_vertex_visibility_matches_jax():
    from vanerf_tpu.ops.rasterize import vertex_visibility
    _, _, faces, xy01, z01 = _fixture_projection(256)
    vis_j = vertex_visibility(jnp.asarray(xy01), jnp.asarray(z01),
                              jnp.asarray(faces), size=64)
    vis_t = t_rast.vertex_visibility(T(xy01), T(z01), T(faces), size=64)
    assert vis_t.shape == (xy01.shape[0], 1)
    np.testing.assert_array_equal(vis_t.numpy(), A(vis_j))
    assert 0 < vis_t.mean() < 1


# ---------------------------------------------------------------------------
# kernel A — point -> mesh query
# ---------------------------------------------------------------------------

def _mesh_setup(seed=6):
    batch, faces = h.synthetic_batch()
    verts = batch["verts"][0]
    rs = np.random.RandomState(seed)
    vis = (rs.rand(len(verts), 1) > 0.4).astype(np.float32)
    return verts, faces, vis


def _check_mesh_query(sdf_t, qvis_t, sdf_j, qvis_j):
    sdf_t, sdf_j = sdf_t.numpy(), A(sdf_j)
    np.testing.assert_array_equal(sdf_t < 0, sdf_j < 0)
    np.testing.assert_allclose(sdf_t, sdf_j, rtol=1e-4, atol=1e-6)
    agree = (qvis_t.numpy() == A(qvis_j)).mean()
    assert agree >= 0.97, agree


def test_mesh_query_plain_matches_cal_vis_sdf():
    from vanerf_tpu.ops.mesh_query import cal_vis_sdf, point_mesh_query
    verts, faces, vis = _mesh_setup()
    pts = h.two_hand_points(1024, seed=7)
    sdf_j, qvis_j, _ = cal_vis_sdf(jnp.asarray(verts), jnp.asarray(faces),
                                   jnp.asarray(pts), jnp.asarray(vis),
                                   chunk=256)
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    _, d2v = t_knn.nearest_vertex_d2(T(pts), T(verts))
    sdf_t, qvis_t, far = t_mq.cal_vis_sdf_prepared(mesh, T(pts), d2v)
    assert far is None
    _check_mesh_query(sdf_t, qvis_t, sdf_j, qvis_j)
    assert 0.05 < (sdf_t.numpy() < 0).mean() < 0.95

    # the chosen face reaches the JAX minimum (argmin ties aside)
    d2_j, _, _ = point_mesh_query(jnp.asarray(pts),
                                  jnp.asarray(verts[faces]), chunk=256)
    d2_t, idx_t, wind, _ = t_mq.point_mesh_query_vis_plain(
        T(pts) - mesh["center"], mesh["table"], d2v)
    # the table's faces are Morton-sorted: idx counts in that order
    tri = verts[faces][mesh["order"].numpy()][idx_t.numpy()]
    d_at = t_mq.point_triangle_sq_dist(T(pts), T(tri[:, 0]), T(tri[:, 1]),
                                       T(tri[:, 2]))
    np.testing.assert_allclose(d_at.numpy(), A(d2_j), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(d2_t.numpy(), A(d2_j), rtol=1e-4, atol=1e-9)
    # signed crossing counts are integers (the mirrored left hand of the
    # fixture winds negatively: -1 inside it, read as outside by both)
    np.testing.assert_array_equal(wind.numpy(), np.round(wind.numpy()))


def test_mesh_query_far_tier_matches_jax(monkeypatch):
    """cal_vis_sdf_prepared with far2 on ray-structured points (16-ray x
    8-sample tiles): far tiles take the nearest-vertex bound and qvis 0,
    with the exact sign, exactly as the JAX rule.  The JAX side runs its
    culled Pallas path (interpret mode), which sorts the faces as the port
    does: its CPU fallback keeps the mesh order, and where the closest
    point is a vertex the faces around it tie exactly, so the face order
    decides whose plane the visibility is interpolated on."""
    from vanerf_tpu.ops.knn import nearest_vertex_d2
    from vanerf_tpu.ops.mesh_query import (cal_vis_sdf_prepared,
                                           prepare_culled_mesh)
    import vanerf_tpu.ops.mesh_query_pallas as mqp
    verts, faces, vis = _mesh_setup(seed=8)
    rs = np.random.RandomState(9)
    P, S = 64, 8
    lo, hi = verts.min(0), verts.max(0)
    o = np.array([0.0, 0.0, 0.6], np.float32)
    tgt = lo - 0.05 + rs.rand(P, 3) * (hi - lo + 0.1)
    tgt[P // 2:, 1] += 0.60              # these rays pass far from the hands
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    t = np.linspace(0.45, 0.75, S)
    pts = (o + d[:, None] * t[None, :, None]).reshape(-1, 3)
    pts = pts.astype(np.float32)
    _, ub_j = nearest_vertex_d2(jnp.asarray(pts), jnp.asarray(verts))
    far2 = 0.02 ** 2
    monkeypatch.setenv("VANERF_MESH_BACKEND", "pallas")
    orig = mqp.point_mesh_query_vis_culled
    monkeypatch.setattr(
        mqp, "point_mesh_query_vis_culled",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    mesh_j = prepare_culled_mesh(jnp.asarray(verts), jnp.asarray(faces),
                                 jnp.asarray(vis))
    sdf_j, qvis_j, far_j = cal_vis_sdf_prepared(mesh_j, jnp.asarray(pts),
                                                ub_j, n_samples=S, chunk=256,
                                                far2=far2)
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(), T(vis))
    _, ub_t = t_knn.nearest_vertex_d2(T(pts), T(verts))
    sdf_t, qvis_t, far_t = t_mq.cal_vis_sdf_prepared(mesh, T(pts), ub_t,
                                                     n_samples=S, far2=far2)
    np.testing.assert_array_equal(far_t.numpy(), A(far_j))
    assert 0 < far_t.float().mean() < 1, "exercise both tiers"
    _check_mesh_query(sdf_t, qvis_t, sdf_j, qvis_j)
    assert (qvis_t.numpy()[far_t.numpy()] == 0).all()


def test_blocked_order_round_trip():
    from vanerf_tpu.ops.mesh_query import from_blocked, to_blocked
    x = np.arange(64 * 8 * 2, dtype=np.float32).reshape(-1, 2)
    b_t = t_mq.to_blocked(T(x), 64, 8, 16, 8)
    np.testing.assert_array_equal(b_t.numpy(),
                                  A(to_blocked(jnp.asarray(x), 64, 8, 16, 8)))
    np.testing.assert_array_equal(
        t_mq.from_blocked(b_t, 64, 8, 16, 8).numpy(), x)
    np.testing.assert_array_equal(
        A(from_blocked(jnp.asarray(b_t.numpy()), 64, 8, 16, 8)), x)
    assert t_mq.blocked_order(64, 8) == (16, 8)
    assert t_mq.blocked_order(10, 8) is None


def test_interpenetrating_point_reads_winding_two():
    """A point inside both of two overlapping spheres is inside (signed
    crossings sum to 2) — the interpenetrating-hands case."""
    from oracles import make_icosphere
    from vanerf_tpu.ops.mesh_query import point_mesh_sdf
    v1, f1 = make_icosphere(subdiv=1, center=(-0.3, 0, 0))
    v2, f2 = make_icosphere(subdiv=1, center=(0.3, 0, 0))
    verts = np.concatenate([v1, v2], 0).astype(np.float32)
    faces = np.concatenate([f1, f2 + len(v1)], 0).astype(np.int32)
    pts = np.array([[0.0, 0.01, 0.02], [5.0, 0, 0], [-0.8, 0.05, 0.0]],
                   np.float32)
    mesh = t_mq.prepare_culled_mesh(T(verts), T(faces).long(),
                                    torch.ones(len(verts), 1))
    _, ub = t_knn.nearest_vertex_d2(T(pts), T(verts))
    _, _, wind, _ = t_mq.point_mesh_query_vis_plain(
        T(pts) - mesh["center"], mesh["table"], ub)
    np.testing.assert_array_equal(wind.numpy(), [2.0, 0.0, 1.0])
    sdf_t, _, _ = t_mq.cal_vis_sdf_prepared(mesh, T(pts), ub)
    sdf_j, _ = point_mesh_sdf(jnp.asarray(verts), jnp.asarray(faces),
                              jnp.asarray(pts), chunk=3)
    np.testing.assert_allclose(sdf_t.numpy(), A(sdf_j), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.slow
def test_mesh_query_plain_matches_culled_pallas_interpret():
    """The TPU's culled kernel in interpret mode vs the port's plain twin
    (same mesh, same nearest-vertex bounds)."""
    from vanerf_tpu.ops.mesh_query_pallas import (
        point_mesh_query_vis_culled, prepare_mesh_ray)
    verts, faces, vis = _mesh_setup(seed=10)
    pts = h.two_hand_points(256, seed=11)
    _, ub = t_knn.nearest_vertex_d2(T(pts), T(verts))
    tri = verts[faces]
    prep = prepare_mesh_ray(jnp.asarray(tri), jnp.asarray(vis[:, 0][faces]))
    d2_j, _, w_j, qv_j = point_mesh_query_vis_culled(
        jnp.asarray(pts), None, None, jnp.asarray(ub.numpy()),
        interpret=True, prep=prep)
    table = t_mq.face_table(T(tri), T(vis[:, 0][faces]))
    d2_t, _, w_t, qv_t = t_mq.point_mesh_query_vis_plain(T(pts), table, ub)
    np.testing.assert_allclose(d2_t.numpy(), A(d2_j), rtol=1e-4, atol=1e-9)
    np.testing.assert_array_equal(w_t.numpy() > 0.5, A(w_j) > 0.5)
    agree = ((qv_t.numpy() >= 0.1) == (A(qv_j) >= 0.1)).mean()
    assert agree >= 0.97, agree


# ---------------------------------------------------------------------------
# kernel D — small-map sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hwc", [(32, 32, 64), (64, 64, 16)])
def test_interp_plain_matches_jax(hwc):
    from vanerf_tpu.ops.grid_sample import grid_sample_2d
    from vanerf_tpu.ops.interp_mxu import interp_mxu_viable, mxu_grid_sample
    H, W, C = hwc
    assert t_interp.interp_mxu_viable(H, W) == interp_mxu_viable(H, W)
    assert t_interp.interp_mxu_viable(H, W)
    rs = np.random.RandomState(12)
    feat = rs.randn(H, W, C).astype(np.float32)
    uv = _uv(rs, 512)
    got = t_interp.mxu_grid_sample(T(feat), T(uv)).numpy()
    np.testing.assert_allclose(
        got, A(grid_sample_2d(jnp.asarray(feat), jnp.asarray(uv))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got, A(mxu_grid_sample(jnp.asarray(feat), jnp.asarray(uv),
                               interpret=True)), rtol=0, atol=1e-6)
    assert not t_interp.interp_mxu_viable(128, 128)
