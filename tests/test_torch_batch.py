"""The batched serving path of the port against the JAX package, on the CPU:
``render_full_image(tile_group=G)`` (G stride offsets folded into one
``render_patch`` batch, element t B + b rendering frame b), ``render_patch``
on two different frames, the batched plain versions of kernels B / 8,
A / 7, D and 10, the coarse-only training render (``dr_kwargs.fine=false``)
and the benchmark entry point ``vanerf_tpu_torch.bench`` at a tiny size.

The fixture is ``torch_port_helpers``' (32^2 images, the subdiv=2 two-hand
mesh, 8 + 8 samples, the small-width model with converted weights); the
full images run at level 2 (four 16x16-ray tiles), so that G takes 1, 2
and 4.  Tolerances, each with its reason:
  * the port's frames against the JAX package's: those of
    ``tests/test_torch_render.py::test_render_full_image_matches_jax``
    (faces in Morton order, rtol 1e-3 / atol 1e-4; 1% of the colour pixels
    may leave it, by < 0.02);
  * the port's G = 2 / 4 frames against its G = 1 frame: rtol 1e-5 / atol
    1e-6 (the per-point network's products run at another batch size);
  * ``render_patch`` on two frames against the JAX package's, element by
    element: ``test_torch_render``'s ``_compare``; the JAX side runs its
    Pallas path in interpret mode there, which sorts the faces of each
    frame as the port does (one face order cannot be Morton order for two
    frames);
  * the batched plain kernels against their per-element calls: equal to
    the bit;
  * the coarse-only training render's G reconstruction losses against
    JAX's: rtol 1e-4 (``tests/test_torch_train.py``'s losses).

The tests marked ``cuda`` hold each batched CUDA kernel bit-equal to its
per-element launches on the card; they import no JAX (``-m cuda
--noconftest`` on a GPU machine) and skip here.
"""

import json

import numpy as np
import pytest
import torch

import torch_port_helpers as h
from vanerf_tpu_torch import bench, ops
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.data.synthetic import two_hand_mesh
from vanerf_tpu_torch.ops import interp_mxu, knn, mesh_query

LEVEL = 2
BF = torch.bfloat16


def T(x):
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def _jbatch(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def two_frames():
    """The fixture's frames 0 and 1 (numpy): two different meshes and
    cameras."""
    from vanerf_tpu_torch.data import make_synthetic_batch
    batch, _faces, num_v = make_synthetic_batch(
        batch_size=2, H=h.H, W=h.W, subdiv=2, device="cpu")
    assert num_v == h.NUM_V
    assert not np.array_equal(batch["verts"][0], batch["verts"][1])
    return batch


@pytest.fixture(scope="module")
def model():
    return h.port_model()


# ---------------------------------------------------------------------------
# render_full_image(tile_group=G)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 2, 4])
def test_render_full_image_tile_group_matches_jax(G, model):
    from vanerf_tpu import renderer as jr
    g, _ = h.converted_params()
    batch = h.morton_sorted(h.synthetic_batch()[0])
    out_j = jr.render_full_image(h.jax_model(), g, _jbatch(batch),
                                 level=LEVEL, sample_per_ray_c=h.S_C,
                                 sample_per_ray_f=h.S_F, sdf_chunk=64,
                                 tile_group=G)
    out_t = tr.render_full_image(model, h.torch_batch(batch), level=LEVEL,
                                 sample_per_ray_c=h.S_C,
                                 sample_per_ray_f=h.S_F, tile_group=G)
    for k in ("alpha", "alpha_fine"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    for k in ("tex_fg", "tex_fg_fine"):
        a, b = out_t[k].numpy(), np.asarray(out_j[k])
        assert a.shape == b.shape == (1, h.H, h.W, 3)
        bad = ~np.isclose(a, b, rtol=1e-3, atol=1e-4).all(-1)
        assert bad.mean() <= 0.01, (k, bad.sum())
        assert np.abs(a - b).max() < 0.02, k
    m = np.asarray(out_j["alpha_fine"]) > 1e-2
    assert m.any()
    np.testing.assert_allclose(out_t["depth_fine"].numpy()[m],
                               np.asarray(out_j["depth_fine"])[m],
                               rtol=1e-3, atol=2e-4)
    for k in ("tar_img", "img_in", "input_mask"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]))


@pytest.mark.parametrize("G", [2, 4])
def test_tile_group_frames_equal_g1_on_two_frames(G, model, two_frames):
    """Two frames at once: each G frame within rtol 1e-5 / atol 1e-6 of
    the G = 1 frame, with the same keys and shapes, frame by frame; one
    render_patch call a group, and the two frames' images differ."""
    batch = h.torch_batch(two_frames)
    kw = dict(level=LEVEL, sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F)
    want = tr.render_full_image(model, batch, **kw)
    calls = []
    real = tr.render_patch
    try:
        tr.render_patch = lambda *a, **k: calls.append(
            k["grids"].shape[0]) or real(*a, **k)
        got = tr.render_full_image(model, batch, tile_group=G, **kw)
    finally:
        tr.render_patch = real
    assert calls == [2 * G] * (4 // G)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if v.is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            assert torch.equal(got[k], v), k
    assert want["tex_fg_fine"].shape == (2, h.H, h.W, 3)
    assert (want["tex_fg_fine"][0] - want["tex_fg_fine"][1]).abs().max() > 1e-2


def test_tile_group_refusals(model, two_frames):
    batch = h.torch_batch(h.synthetic_batch()[0])
    kw = dict(level=LEVEL, sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F)
    with pytest.raises(ValueError, match="divide"):
        tr.render_full_image(model, batch, tile_group=3, **kw)
    from types import SimpleNamespace
    with pytest.raises(ValueError, match="split"):   # 2 tiles over 4 ranks
        tr.render_full_image(model, batch, tile_group=2,
                             mesh=SimpleNamespace(size=4, rank=0), **kw)
    with pytest.raises(ValueError, match="frames"):
        tr.render_patch(model, h.torch_batch(two_frames),
                        grids=torch.zeros(3, 4, 2), out_h=2, out_w=2,
                        sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F)


# ---------------------------------------------------------------------------
# render_patch on two different frames
# ---------------------------------------------------------------------------

def test_render_patch_two_frames_matches_jax(monkeypatch, model, two_frames):
    """B = 2 different frames in one render_patch, element by element
    against the JAX package's B = 2 render on its Pallas path (the nearest
    vertex and the culled query in interpret mode: that path sorts each
    frame's faces as the port does); one batched search and one batched
    query a pass on the port's side."""
    import jax
    import jax.numpy as jnp
    import test_torch_render as render_tests
    import vanerf_tpu.ops.knn_pallas as kp
    import vanerf_tpu.ops.mesh_query_pallas as mqp
    from vanerf_tpu import renderer as jr
    monkeypatch.setenv("VANERF_FAR_TAU", "0.02")
    g, _ = h.converted_params()
    grids = np.concatenate([h.center_grid()] * 2)
    tb = h.torch_batch(two_frames)
    calls = {"knn": [], "query": []}
    real_knn, real_q = tr.nearest_vertex_d2, tr.cal_vis_sdf_prepared
    monkeypatch.setattr(tr, "nearest_vertex_d2", lambda p, v: calls[
        "knn"].append(tuple(p.shape)) or real_knn(p, v))
    monkeypatch.setattr(tr, "cal_vis_sdf_prepared", lambda m, p, *a, **k:
                        calls["query"].append(tuple(p.shape))
                        or real_q(m, p, *a, **k))
    with torch.no_grad():
        cached_t = tr.encode_frame(model, tb)
    out_t = tr.render_patch(model, tb, grids=T(grids), out_h=h.OUT,
                            out_w=h.OUT, sample_per_ray_c=h.S_C,
                            sample_per_ray_f=h.S_F, cached=cached_t,
                            compute_vis_map=False)
    n = h.OUT * h.OUT * h.S_C
    assert calls == {"knn": [(2, n, 3)] * 2, "query": [(2, n, 3)] * 2}
    jm, jb = h.jax_model(), _jbatch(two_frames)
    fg, ft = jm.apply(g, jb["src_img"], method=jm.encode)
    monkeypatch.setenv("VANERF_MESH_BACKEND", "pallas")
    seen = []
    for mod, name in ((kp, "nearest_vertex_d2_pallas"),
                      (mqp, "point_mesh_query_vis_culled")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _r=real, _n=name, **k: seen.append(_n) or
            _r(*a, **{**k, "interpret": True}))
    out_j = jr.render_patch(
        jm, g, jb, rng=jax.random.PRNGKey(0), grids=jnp.asarray(grids),
        out_h=h.OUT, out_w=h.OUT, sample_per_ray_c=h.S_C,
        sample_per_ray_f=h.S_F, fine=True, uniform=True, training=False,
        n_views=1, sdf_chunk=64, compute_vis_map=False,
        cached=(fg, ft, jnp.asarray(cached_t[2].numpy())))
    assert set(seen) == {"nearest_vertex_d2_pallas",
                         "point_mesh_query_vis_culled"}
    for e in range(2):
        render_tests._compare(
            {k: v[e:e + 1] for k, v in out_j.items() if k != "vert_vis"},
            {k: v[e:e + 1] for k, v in out_t.items() if k != "vert_vis"})
    assert (out_t["tex_fg_fine"][0] - out_t["tex_fg_fine"][1]).abs().max() \
        > 1e-2


# ---------------------------------------------------------------------------
# the batched plain versions: equal to their per-element calls
# ---------------------------------------------------------------------------

def _inputs(G: int = 2, n: int = 700, seed: int = 0):
    """Two frames' meshes (frames 0 and 1 of the fixture, their own
    vertex visibility), and G x 2 elements of points around each frame's
    hands, element e of frame e % 2."""
    rs = np.random.RandomState(seed)
    frames = [two_hand_mesh(f, 2) for f in (0, 1)]
    verts = torch.stack([T(fr[0].astype(np.float32)) for fr in frames])
    faces = T(frames[0][1].astype(np.int64))
    vis = T((rs.rand(2, verts.shape[1], 1) > 0.4).astype(np.float32))
    pts = []
    for e in range(2 * G):
        v = verts[e % 2].numpy()
        lo, hi = v.min(0) - 0.02, v.max(0) + 0.02
        pts.append(lo + rs.rand(n, 3) * (hi - lo))
    return verts, faces, vis, T(np.stack(pts).astype(np.float32))


@pytest.mark.parametrize("layout", ["points", "coords"])
def test_batched_nearest_vertex_plain_equals_per_element(layout):
    verts, _faces, _vis, pts = _inputs()
    fn = knn.nearest_vertex_d2 if layout == "points" else \
        knn.nearest_vertex_d2_T
    q = pts if layout == "points" else pts.transpose(1, 2).contiguous()
    idx, d2 = fn(q, verts)
    assert idx.shape == d2.shape == pts.shape[:2]
    for e in range(pts.shape[0]):
        i_e, d_e = fn(q[e], verts[e % 2])
        assert torch.equal(idx[e], i_e) and torch.equal(d2[e], d_e), e
    # element 1 reads frame 1's vertices, not frame 0's
    assert not torch.equal(idx[1], fn(q[1], verts[0])[0])


@pytest.mark.parametrize("layout", ["points", "coords"])
@pytest.mark.parametrize("far", [False, True])
def test_batched_mesh_query_plain_equals_per_element(layout, far):
    verts, faces, vis, pts = _inputs(n=512)
    meshes = mesh_query.stack_culled_meshes([
        mesh_query.prepare_culled_mesh(verts[f], faces, vis[f])
        for f in range(2)])
    for f in range(2):
        one = mesh_query.prepare_culled_mesh(verts[f], faces, vis[f])
        for k, v in mesh_query.mesh_element(meshes, f).items():
            assert (v == one[k]) if not torch.is_tensor(v) \
                else torch.equal(v, one[k]), k
    ub = knn.nearest_vertex_d2(pts, verts)[1]
    far2 = 0.02 ** 2 if far else None
    if layout == "points":
        sdf, qv, fm = mesh_query.cal_vis_sdf_prepared(meshes, pts, ub,
                                                      n_samples=8, far2=far2)
    else:
        sdf, qv, fm = mesh_query.cal_vis_sdf_prepared_T(
            meshes, pts.transpose(1, 2).contiguous(), ub, n_samples=8,
            far2=far2)
    assert sdf.shape == pts.shape[:2] and qv.shape == pts.shape[:2] + (1,)
    assert (fm is not None) == far
    for e in range(pts.shape[0]):
        m = mesh_query.mesh_element(meshes, e % 2)
        if layout == "points":
            s_e, q_e, f_e = mesh_query.cal_vis_sdf_prepared(
                m, pts[e], ub[e], n_samples=8, far2=far2)
        else:
            s_e, q_e, f_e = mesh_query.cal_vis_sdf_prepared_T(
                m, pts[e].t().contiguous(), ub[e], n_samples=8, far2=far2)
        assert torch.equal(sdf[e], s_e) and torch.equal(qv[e], q_e), e
        assert f_e is None if not far else torch.equal(fm[e], f_e)
    m0 = mesh_query.mesh_element(meshes, 0)
    assert not torch.equal(
        sdf[1], mesh_query.cal_vis_sdf_prepared(m0, pts[1], ub[1],
                                                n_samples=8)[0])


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_batched_interp_and_row_gather_plain_equal_per_element(dtype):
    rs = np.random.RandomState(3)
    maps = T(rs.randn(2, 16, 16, 12).astype(np.float32)).to(dtype)
    uv = T((rs.rand(4, 300, 2) * 2.4 - 1.2).astype(np.float32))
    got = interp_mxu.mxu_grid_sample(maps, uv)
    assert got.shape == (4, 300, 12) and got.dtype == dtype
    for e in range(4):
        assert torch.equal(got[e], interp_mxu.mxu_grid_sample(maps[e % 2],
                                                              uv[e])), e
    table = T(rs.randn(2, 50, 7).astype(np.float32)).to(dtype)
    idx = T(rs.randint(0, 50, size=(4, 300)).astype(np.int32))
    for bm in (2, 4):            # the frame's table, or the element's own
        tbl = table if bm == 2 else torch.cat([table, table.flip(0)])
        rows = interp_mxu.mxu_row_gather(tbl, idx)
        assert rows.shape == (4, 300, 7) and rows.dtype == dtype
        for e in range(4):
            assert torch.equal(rows[e], tbl[e % bm][idx[e].long()]), e


def test_batched_feature_sampler_equals_per_element():
    """The gather sampler over a batch of elements on the frames' maps:
    the arithmetic of grid_sample_2d element by element."""
    from vanerf_tpu_torch.ops.grid_sample import (feat_sample_nhwc,
                                                  grid_sample_2d)
    rs = np.random.RandomState(4)
    maps = T(rs.randn(2, 16, 12, 5).astype(np.float32))
    uv = T((rs.rand(6, 200, 2) * 2.4 - 1.2).astype(np.float32))
    got = feat_sample_nhwc(maps, uv)
    for e in range(6):
        assert torch.equal(got[e], grid_sample_2d(maps[e % 2], uv[e])), e


# ---------------------------------------------------------------------------
# dr_kwargs.fine=false
# ---------------------------------------------------------------------------

def test_coarse_only_training_render_matches_jax(monkeypatch):
    """The train step's render with ``dr_kwargs.fine=false`` (coarse pass
    only, no 'tex_cal_fine') and its G reconstruction losses against the
    JAX package's ``_generator_outputs`` + ``compute_error`` with the same
    draws; the port's whole GAN step then runs (its discriminator judges
    the coarse image: the JAX step reads 'tex_fg_fine' and stops)."""
    import jax
    import test_torch_train as tt
    from vanerf_tpu import losses as jl
    from vanerf_tpu.training.train_step import _generator_outputs
    from vanerf_tpu_torch import losses as tl
    from vanerf_tpu_torch.models import DiscriminatorVis
    from vanerf_tpu_torch.training import (create_train_state,
                                           generator_outputs,
                                           make_train_step)
    from vanerf_tpu_torch.weights import disc_from_jax_params
    monkeypatch.setenv("VANERF_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("VANERF_FAR_TAU", "0")
    monkeypatch.setenv("VANERF_ONEHOT_BN", "16")
    cfg = tt._train_cfg(False)
    cfg["models"]["VANeRF"]["dr_kwargs"]["fine"] = False
    lambdas = cfg["models"]["VANeRF"].get("lambdas", {})
    g, _ = h.converted_params()
    jb = tt._jbatch()
    vgg_j, vgg_t = tt._vgg_pair()
    key = jax.random.PRNGKey(5)
    with jax.default_matmul_precision("highest"):
        out_j = jax.jit(lambda p, b, k: _generator_outputs(
            h.jax_model(), p, b, k, cfg, 1))(g, jb, key)
        loss_j, err_j = jl.compute_error(out_j, lambdas, vgg_j)
    assert "tex_fg_fine" not in out_j
    model = h.port_model()
    draws = tt._jax_draws(key, jb)
    batch = h.torch_batch(h.synthetic_batch()[0])
    out_t = generator_outputs(model, batch, cfg, draws=draws)
    assert "tex_cal_fine" not in out_t and "tex_fg_fine" not in out_t
    loss_t, err_t = tl.compute_error(out_t, lambdas, vgg_t)
    assert set(err_t) == set(err_j)
    for k in err_j:
        np.testing.assert_allclose(float(err_t[k]), float(err_j[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    disc = DiscriminatorVis()
    disc.load_state_dict(disc_from_jax_params(tt._disc_params()),
                         strict=True)
    st = create_train_state(model, disc, cfg, steps_per_epoch=10)
    logs = make_train_step(model, disc, cfg, vgg_t)(
        st, batch, draws={"g": draws, "d": draws})
    assert all(torch.isfinite(v).all() for v in logs.values())
    assert "train/e_pix_l1" not in logs or "train/e_pix_c" in logs


# ---------------------------------------------------------------------------
# the benchmark entry point at a tiny size
# ---------------------------------------------------------------------------

def _tiny():
    cfg = h.small_cfg()
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = 8
    m["dr_kwargs"]["sample_per_ray_c"] = m["dr_kwargs"]["sample_per_ray_f"] \
        = 4
    return cfg, bench.Shapes(H=h.H, W=h.W, subdiv=1, patch=4, s_c=4, s_f=4,
                             group=2, level=2)


@pytest.mark.parametrize("mode", ["serve", "train"])
def test_bench_prints_one_json_line_on_cpu(mode, monkeypatch, capsys):
    """``python3 -m vanerf_tpu_torch.bench [--train] --device cpu`` through
    its functions at a tiny size: one JSON line, last, with the metric, the
    medians and ranges, the device and the sample count of bench.py:128
    (patch^2 x (S_c + S_c + S_f) a patch)."""
    cfg, shapes = _tiny()
    real = bench.run
    monkeypatch.setattr(bench, "run", lambda *a: real(*a, cfg=cfg,
                                                      shapes=shapes))
    argv = ["--device", "cpu", "--rounds", "2"]
    argv += ["--train"] if mode == "train" else ["--tile-group", "2"]
    ops.reset_launches()
    with torch.no_grad():       # the train mode turns gradients on itself
        assert bench.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    assert res["device"] == "cpu" and res["power_limit"] is None
    assert res["rounds"] == 2 and res["peak_bytes"] is None
    assert not any(ops.launch_counts().values())
    if mode == "serve":
        assert res["metric"] == "ray_samples_per_sec"
        assert res["samples_per_group"] == 4 * 4 * (4 + 4 + 4) * 2
        assert res["min"] <= res["value"] <= res["max"]
        assert res["tile_group"] == 2
        for k in ("ms_per_frame", "ms_per_frame_min", "ms_per_frame_max",
                  "group_ms", "frame_device_busy_ms", "group_device_ops"):
            assert k in res, k
        assert res["frame_device_busy_ms"] is None   # not measured on a CPU
    else:
        assert res["metric"] == "train_step_ms"
        assert res["min"] <= res["value"] <= res["max"]
        for k in ("single_render_ms", "single_render_ms_min",
                  "single_render_ms_max", "step_device_busy_ms"):
            assert k in res, k


def test_device_activity_takes_the_union_of_device_intervals():
    """The busy time the entry point (and tools_torch/_profile.py) reads:
    the union of the device operations' intervals, less the GPU mirror of
    a host annotation, which spans the gaps between kernels."""
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType

    def ev(name, device, start, end):
        return NS(name=name, device_type=device,
                  time_range=NS(start=start, end=end))

    events = [ev("k1", DeviceType.CUDA, 0.0, 10.0),
              ev("k2", DeviceType.CUDA, 5.0, 12.0),
              ev("k3", DeviceType.CUDA, 20.0, 25.0),
              ev("Optimizer.step", DeviceType.CPU, 0.0, 30.0),
              ev("Optimizer.step", DeviceType.CUDA, 0.0, 30.0)]
    ops, busy_us, span_us = bench.device_activity(NS(events=lambda: events))
    assert [e.name for e in ops] == ["k1", "k2", "k3"]
    assert busy_us == 17.0 and span_us == 25.0


def test_bench_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(device="cuda")


# ---------------------------------------------------------------------------
# on the card: each batched kernel against its per-element launches
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batched_kernels_equal_per_element_launches(cuda):
    """B / 8, A / 7 (far tier on), D and 10 in both dtypes: one launch over
    two frames x 2 tiles equals the per-element launches to the bit."""
    verts, faces, vis, pts = (t.to(cuda) for t in _inputs(n=4096))
    n0 = ops.launch_counts()
    idx, d2 = knn.nearest_vertex_d2(pts, verts)
    idx_t, d2_t = knn.nearest_vertex_d2_T(pts.transpose(1, 2).contiguous(),
                                          verts)
    meshes = tr.prepare_frame_meshes({"verts": verts, "faces": faces}, vis)
    got = mesh_query.cal_vis_sdf_prepared(meshes, pts, d2, n_samples=8,
                                          far2=0.02 ** 2)
    got_t = mesh_query.cal_vis_sdf_prepared_T(
        meshes, pts.transpose(1, 2).contiguous(), d2, n_samples=8,
        far2=0.02 ** 2)
    n1 = ops.launch_counts()
    for k in ("knn", "knn_T", "mesh_query", "mesh_query_T"):
        assert n1[k] == n0[k] + 1, k
    assert torch.equal(idx, idx_t) and torch.equal(d2, d2_t)
    for a, b in zip(got, got_t):
        assert torch.equal(a, b)
    for e in range(pts.shape[0]):
        i_e, d_e = knn.nearest_vertex_d2(pts[e], verts[e % 2])
        assert torch.equal(i_e, idx[e]) and torch.equal(d_e, d2[e])
        one = mesh_query.cal_vis_sdf_prepared(
            mesh_query.mesh_element(meshes, e % 2), pts[e], d2[e],
            n_samples=8, far2=0.02 ** 2)
        for a, b in zip(one, got):
            assert torch.equal(a, b[e])
    rs = np.random.RandomState(5)
    for dt in (torch.float32, BF):
        maps = T(rs.randn(2, 32, 32, 64).astype(np.float32)).to(cuda, dt)
        uv = T((rs.rand(4, 5000, 2) * 2.4 - 1.2).astype(np.float32)).to(cuda)
        table = T(rs.randn(2, 1284, 204).astype(np.float32)).to(cuda, dt)
        out = interp_mxu.mxu_grid_sample(maps, uv)
        rows = interp_mxu.mxu_row_gather(table, idx)
        for e in range(4):
            assert torch.equal(out[e], interp_mxu.mxu_grid_sample(
                maps[e % 2], uv[e]))
            assert torch.equal(rows[e], interp_mxu.mxu_row_gather(
                table[e % 2], idx[e]))
        assert torch.equal(out.cpu(), interp_mxu.interp_plain(maps.cpu(),
                                                              uv.cpu()))
