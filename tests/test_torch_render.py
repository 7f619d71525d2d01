"""The port's serving slice (vanerf_tpu_torch.renderer) against the JAX
renderer, on the CPU, with the same weights and fixture.

Tolerances as ``tests/test_fullchain_parity.py:145-155``: rtol 1e-3 /
atol 1e-4 on tex_fg* and alpha*, depth and sdf only where alpha > 1e-2
(the /acc normalisation amplifies noise on empty rays).  The full image
allows up to 1% of pixels outside that colour tolerance: the port centres
the mesh before its distance query (as the JAX package does on a TPU) and
the JAX CPU path does not, so where two faces tie for the closest point
(a shared edge) rounding can pick the other face, whose plane projection
interpolates another visibility.  The port also Morton-sorts the faces for
its culled query (as the JAX package does on a TPU, and its CPU path does
not); among faces that tie exactly (a closest point on a vertex) the first
in table order wins, so the comparisons with the JAX CPU path feed both
packages the faces already in that order
(``torch_port_helpers.morton_sorted``) and keep the tolerance above on
every pixel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers as h
from vanerf_tpu_torch import renderer as tr


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _jbatch(batch):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def _compare(out_j, out_t, keys_fine=True):
    for k in ("tex_fg", "alpha") + (("tex_fg_fine", "alpha_fine")
                                    if keys_fine else ()):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    for k, acck in (("depth", "alpha"), ("depth_fine", "alpha_fine"),
                    ("sdf", "alpha_fine")):
        m = np.asarray(out_j[acck]) > 1e-2
        assert m.any()
        np.testing.assert_allclose(out_t[k].numpy()[m],
                                   np.asarray(out_j[k])[m], rtol=1e-3,
                                   atol=2e-4, err_msg=k)


def _centre_and_corner_grid():
    """16 rays at the image centre (on the hands) + 16 at a corner (far
    from them): two 16-ray far-tier tiles, one of each kind."""
    c = h.center_grid()[0]
    y, x = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    corner = np.stack([x, y], -1).reshape(-1, 2).astype(np.float32)
    return np.concatenate([c, corner], 0)[None]


@pytest.mark.parametrize("far_tau", ["0", "0.02"])
def test_render_patch_matches_jax(far_tau, monkeypatch):
    from vanerf_tpu import renderer as jr
    monkeypatch.setenv("VANERF_FAR_TAU", far_tau)
    g, _ = h.converted_params()
    batch = h.morton_sorted(h.synthetic_batch()[0])
    grids = _centre_and_corner_grid()
    out_j = jr.render_patch(
        h.jax_model(), g, _jbatch(batch), rng=jax.random.PRNGKey(0),
        grids=jnp.asarray(grids), out_h=8, out_w=4, sample_per_ray_c=h.S_C,
        sample_per_ray_f=h.S_F, fine=True, uniform=True, training=False,
        n_views=1, sdf_chunk=64, compute_vis_map=False)

    far_seen = []
    real = tr.cal_vis_sdf_prepared

    def spy(*a, **kw):
        out = real(*a, **kw)
        far_seen.append(out[2])
        return out

    monkeypatch.setattr(tr, "cal_vis_sdf_prepared", spy)
    out_t = tr.render_patch(h.port_model(), h.torch_batch(batch),
                            grids=T(grids), out_h=8, out_w=4,
                            sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F)
    _compare(out_j, out_t)
    np.testing.assert_array_equal(out_t["vert_vis"].numpy(),
                                  np.asarray(out_j["vert_vis"]))
    np.testing.assert_array_equal(out_t["tar_img"].numpy(),
                                  np.asarray(out_j["tar_img"]))
    assert out_t["alpha_fine"].max() > 0.2, "rays missed the fixture mesh"
    if far_tau == "0":
        assert all(f is None for f in far_seen)
    else:
        # both passes ran the far tier with one far and one near tile
        assert len(far_seen) == 2
        for f in far_seen:
            tiles = f.reshape(2, -1)  # (rays 0-15 | rays 16-31) x samples
            assert not tiles[0].any() and tiles[1].all()


def test_render_full_image_matches_jax():
    from vanerf_tpu import renderer as jr
    g, _ = h.converted_params()
    batch = h.morton_sorted(h.synthetic_batch()[0])
    out_j = jr.render_full_image(h.jax_model(), g, _jbatch(batch), level=3,
                                 sample_per_ray_c=h.S_C,
                                 sample_per_ray_f=h.S_F, sdf_chunk=64)
    out_t = tr.render_full_image(h.port_model(), h.torch_batch(batch),
                                 level=3, sample_per_ray_c=h.S_C,
                                 sample_per_ray_f=h.S_F)
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
    np.testing.assert_allclose(out_t["depth_fine"].numpy()[m],
                               np.asarray(out_j["depth_fine"])[m],
                               rtol=1e-3, atol=2e-4)
    for k in ("tar_img", "img_in", "input_mask"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]))


def test_make_synthetic_batch_matches_jax():
    from vanerf_tpu_torch.data import make_synthetic_batch
    batch_j, faces_j = h.synthetic_batch()
    batch_t, faces_t, num_v = make_synthetic_batch(batch_size=1, H=h.H,
                                                   W=h.W, subdiv=2,
                                                   device="cpu")
    assert num_v == h.NUM_V
    np.testing.assert_array_equal(faces_t, faces_j)
    assert set(batch_t) == set(batch_j)
    for k in batch_j:
        a, b = np.asarray(batch_t[k]), np.asarray(batch_j[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=k)


def test_grids_and_unshuffle_match_jax():
    from vanerf_tpu import renderer as jr
    g_j = jr.strided_grid(2, 32, 32, 3, jnp.asarray([[1, 2], [3, 0]]))
    g_t = tr.strided_grid(2, 32, 32, 3, [[1, 2], [3, 0]])
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    rs = np.random.RandomState(0)
    tiles = [rs.rand(1, 3, 3, 2).astype(np.float32) for _ in range(4)]
    np.testing.assert_array_equal(
        tr._unshuffle([T(t) for t in tiles], 2).numpy(),
        np.asarray(jr._unshuffle([jnp.asarray(t) for t in tiles], 2)))
    img = rs.rand(2, 5, 6, 3).astype(np.float32)
    idx = rs.randint(0, 30, size=(2, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tr.gather_pixels(T(img), T(idx), 2, 2).numpy(),
        np.asarray(jr.gather_pixels(jnp.asarray(img), jnp.asarray(idx), 2,
                                    2)))


def test_mask_centered_grid_centres_on_foreground():
    batch, _ = h.synthetic_batch()
    mask = T(batch["tar_mask"][..., 0])
    gen = torch.Generator().manual_seed(3)
    grids = tr.mask_centered_grid(gen, mask, 8, 8)
    assert grids.shape == (1, 64, 2)
    assert grids.min() >= 0 and grids[..., 0].max() <= h.W - 1
    centre = grids[0, 4 * 8 + 4].long()
    assert mask[0, centre[1], centre[0]] > 0
    again = tr.mask_centered_grid(torch.Generator().manual_seed(3), mask,
                                  8, 8)
    assert torch.equal(grids, again)


def test_unported_render_options_raise():
    """Two source views render (``tests/test_torch_views.py``); a device
    mesh, the one render option still not ported, raises."""
    model = h.port_model()
    batch = h.torch_batch(h.synthetic_batch()[0])
    with pytest.raises(NotImplementedError):
        tr.render_full_image(model, batch, level=3, sample_per_ray_c=4,
                             sample_per_ray_f=4, mesh=object())
    with pytest.raises(NotImplementedError):
        tr.plan_tile_group(16, 4, mesh=object())


def test_render_patch_training_builds_a_graph():
    """training=True renders with gradients (eval keeps no_grad): the
    output requires grad and a backward reaches the encoder weights."""
    model = h.port_model()
    batch = h.torch_batch(h.synthetic_batch()[0])
    kw = dict(grids=T(h.center_grid()), out_h=4, out_w=4,
              sample_per_ray_c=4, sample_per_ray_f=4)
    assert not tr.render_patch(model, batch, **kw)["tex_fg_fine"] \
        .requires_grad
    out = tr.render_patch(model, batch, **kw, training=True,
                          compute_vis_map=True, rand_noise_std=0.01,
                          generator=torch.Generator().manual_seed(0))
    assert out["tex_fg_fine"].requires_grad
    assert out["vis_img"].shape == (1, 4, 4, 1)
    out["tex_fg_fine"].sum().backward()
    for w in (model.geo_encoder.conv1.weight,
              model.tex_encoder.layers[1].weight, model.sigmoid_beta):
        assert w.grad is not None and w.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the coordinate-major render: VANERF_SOA_POINTS=1/2 (kernels 7 and 8)
# ---------------------------------------------------------------------------

def _render_port(grids, out_h, out_w, **kw):
    return tr.render_patch(h.port_model(), h.torch_batch(
        h.synthetic_batch()[0]), grids=T(grids), out_h=out_h, out_w=out_w,
        sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F, **kw)


def _assert_outputs_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if torch.is_tensor(v):
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("far_tau", ["0", "0.02"])
@pytest.mark.parametrize("mode", ["1", "2"])
def test_soa_render_equals_mode0_exactly(mode, far_tau, monkeypatch):
    """Coordinate-major points change no output bit: o + d*z rounds alike
    in either layout and kernels 7 / 8 are A / B on the transposed input."""
    monkeypatch.setenv("VANERF_FAR_TAU", far_tau)
    grids = _centre_and_corner_grid()
    want = _render_port(grids, 8, 4)
    monkeypatch.setenv("VANERF_SOA_POINTS", mode)
    seen = {"T": 0, "far": []}
    real_T, real_knn = tr.cal_vis_sdf_prepared_T, tr.nearest_vertex_d2_T

    def spy(mesh, points_T, *a, **kw):
        # the batch's (B, 3, N) points, one call a pass
        assert points_T.shape[1] == 3 and points_T.is_contiguous()
        assert kw["rays_hw"] == (8, 4)
        out = real_T(mesh, points_T, *a, **kw)
        seen["far"].append(out[2])
        return out

    def spy_knn(q, v):
        seen["T"] += 1
        return real_knn(q, v)

    monkeypatch.setattr(tr, "cal_vis_sdf_prepared_T", spy)
    monkeypatch.setattr(tr, "nearest_vertex_d2_T", spy_knn)
    monkeypatch.setattr(tr, "cal_vis_sdf_prepared", None)   # not reached
    monkeypatch.setattr(tr, "nearest_vertex_d2", None)
    got = _render_port(grids, 8, 4)
    _assert_outputs_equal(got, want)
    assert seen["T"] == 2 and len(seen["far"]) == 2
    assert want["alpha_fine"].max() > 0.2, "rays missed the fixture mesh"
    if far_tau == "0":
        assert all(f is None for f in seen["far"])
    else:
        for f in seen["far"]:
            tiles = f.reshape(2, -1)
            assert not tiles[0].any() and tiles[1].all()


@pytest.mark.parametrize("mode", ["1", "2"])
def test_soa_render_matches_jax(mode, monkeypatch):
    """The port under VANERF_SOA_POINTS against JAX under the same switch
    (far tier on), to the tolerance of the mode-0 comparison above."""
    from vanerf_tpu import renderer as jr
    monkeypatch.setenv("VANERF_FAR_TAU", "0.02")
    monkeypatch.setenv("VANERF_SOA_POINTS", mode)
    g, _ = h.converted_params()
    batch, _ = h.synthetic_batch()
    grids = _centre_and_corner_grid()
    out_j = jr.render_patch(
        h.jax_model(), g, _jbatch(batch), rng=jax.random.PRNGKey(0),
        grids=jnp.asarray(grids), out_h=8, out_w=4, sample_per_ray_c=h.S_C,
        sample_per_ray_f=h.S_F, fine=True, uniform=True, training=False,
        n_views=1, sdf_chunk=64, compute_vis_map=False)
    out_t = _render_port(grids, 8, 4)
    _compare(out_j, out_t)
    assert out_t["alpha_fine"].max() > 0.2


def test_soa_unparsable_value_is_mode_1(monkeypatch):
    grids = h.center_grid()
    monkeypatch.setenv("VANERF_SOA_POINTS", "1")
    want = _render_port(grids, 4, 4)
    calls = []
    real = tr.cal_vis_sdf_prepared_T
    monkeypatch.setattr(tr, "cal_vis_sdf_prepared_T",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for raw, mode in (("yes", 1), ("0.5", 1), ("2", 2), ("", 0), ("0", 0)):
        monkeypatch.setenv("VANERF_SOA_POINTS", raw)
        assert tr.soa_points_mode() == mode
    monkeypatch.setenv("VANERF_SOA_POINTS", "yes")
    _assert_outputs_equal(_render_port(grids, 4, 4), want)
    assert len(calls) == 2


def test_soa_switches_the_serving_tiers_off(monkeypatch):
    """As in the JAX package: under the SoA layout a configured FAR_SKIP /
    FAR_NET / FAR_TNET tier is off, not an error, at one source view and
    at two."""
    grids = h.center_grid()
    monkeypatch.setenv("VANERF_SOA_POINTS", "1")
    want = _render_port(grids, 4, 4)
    batch2 = h.torch_batch(h.synthetic_batch_views(2))
    kw2 = dict(grids=T(grids), out_h=4, out_w=4, sample_per_ray_c=h.S_C,
               sample_per_ray_f=h.S_F, n_views=2)
    model = h.port_model()
    want2 = tr.render_patch(model, batch2, **kw2)
    for env in ("VANERF_FAR_SKIP", "VANERF_FAR_NET", "VANERF_FAR_TNET"):
        monkeypatch.setenv(env, "0.5")
        _assert_outputs_equal(_render_port(grids, 4, 4), want)
        _assert_outputs_equal(tr.render_patch(model, batch2, **kw2), want2)
        monkeypatch.delenv(env)


@pytest.mark.parametrize("mode", ["1", "2"])
def test_soa_with_fused_mlp_equals_mode0(mode, monkeypatch):
    """SoA composes with VANERF_FUSED_MLP=2 (the far tier off, the fused
    query's plain version on the CPU): every output equals mode 0's."""
    monkeypatch.setenv("VANERF_FUSED_MLP", "2")
    grids = h.center_grid()
    want = _render_port(grids, 4, 4)
    monkeypatch.setenv("VANERF_SOA_POINTS", mode)
    _assert_outputs_equal(_render_port(grids, 4, 4), want)


@pytest.mark.parametrize("fused_train", ["0", "2"])
def test_soa_training_render_equals_mode0(fused_train, monkeypatch):
    """A training render with fed draws (jitter, importance uniforms,
    radiance noise): every output and an L1 loss equal mode 0's under
    VANERF_SOA_POINTS=1 and =2, also under VANERF_FUSED_TRAIN; the weight
    gradients agree to rounding (two identical CPU runs repeat them no
    closer: the gathers' backward sums in a thread-dependent order)."""
    monkeypatch.setenv("VANERF_FUSED_TRAIN", fused_train)
    rs = np.random.RandomState(11)
    P = 16
    draws = {"u_c": rs.rand(1, P, h.S_C).astype(np.float32),
             "u_f": rs.rand(1, P, h.S_F).astype(np.float32),
             "noise_c": rs.randn(1, P * h.S_C, 1).astype(np.float32),
             "noise_f": rs.randn(1, P * h.S_F, 1).astype(np.float32)}
    res = {}
    for mode in ("0", "1", "2"):
        monkeypatch.setenv("VANERF_SOA_POINTS", mode)
        model = h.port_model()
        out = tr.render_patch(
            model, h.torch_batch(h.synthetic_batch()[0]),
            grids=T(h.center_grid()), out_h=4, out_w=4,
            sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F, training=True,
            compute_vis_map=True, rand_noise_std=0.01, draws=draws)
        loss = (out["tex_fg_fine"] - out["tar_img"]).abs().mean() \
            + (out["tex_fg"] - out["tar_img"]).abs().mean()
        loss.backward()
        res[mode] = (out, loss.detach(),
                     model.geo_encoder.conv1.weight.grad.clone(),
                     model.sigmoid_beta.grad.clone())
    assert res["0"][0]["tex_fg_fine"].requires_grad
    assert res["0"][2].abs().sum() > 0
    for mode in ("1", "2"):
        _assert_outputs_equal(
            {k: v.detach() if torch.is_tensor(v) else v
             for k, v in res[mode][0].items()},
            {k: v.detach() if torch.is_tensor(v) else v
             for k, v in res["0"][0].items()})
        assert torch.equal(res[mode][1], res["0"][1])
        for a, b in zip(res[mode][2:], res["0"][2:]):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-5 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# VANERF_KNN_CULL: kernel 9 in place of kernel B
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("soa", ["0", "1"])
def test_knn_cull_render_equals_default_exactly(soa, monkeypatch):
    """Kernel 9 returns kernel B's index and distance bit for bit, so the
    render under VANERF_KNN_CULL=1 equals the default render in every
    output, in both point layouts; two culled searches a patch."""
    from vanerf_tpu_torch.ops import knn as t_knn
    monkeypatch.setenv("VANERF_SOA_POINTS", soa)
    grids = _centre_and_corner_grid()
    want = _render_port(grids, 8, 4)
    monkeypatch.setenv("VANERF_KNN_CULL", "1")
    name = ("nearest_vertex_d2_T_culled" if soa == "1"
            else "nearest_vertex_d2_culled")
    calls = []
    real = getattr(t_knn, name)
    monkeypatch.setattr(t_knn, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _assert_outputs_equal(_render_port(grids, 8, 4), want)
    assert len(calls) == 2
    assert want["alpha_fine"].max() > 0.2, "rays missed the fixture mesh"


def test_full_image_prepares_the_mesh_once(monkeypatch):
    """``render_full_image`` sorts the faces and builds the chunk boxes once
    a frame, beside the encode, and every tile reads that mesh; a lone
    ``render_patch`` prepares its own, with the same result."""
    batch = h.torch_batch(h.synthetic_batch()[0])
    model = h.port_model()
    calls = []
    real = tr.prepare_culled_mesh
    monkeypatch.setattr(tr, "prepare_culled_mesh",
                        lambda *a: calls.append(1) or real(*a))
    out = tr.render_full_image(model, batch, level=3, sample_per_ray_c=h.S_C,
                               sample_per_ray_f=h.S_F)
    assert len(calls) == 1 and out["tex_fg_fine"].shape == (1, h.H, h.W, 3)
    with torch.no_grad():
        cached = tr.encode_frame(model, batch)
    kw = dict(grids=T(h.center_grid()), out_h=4, out_w=4,
              sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F)
    del calls[:]
    want = tr.render_patch(model, batch, cached=cached, **kw)
    assert len(calls) == 1
    ahead = tuple(cached) + (tr.prepare_frame_meshes(batch, cached[2]),)
    del calls[:]
    _assert_outputs_equal(tr.render_patch(model, batch, cached=ahead, **kw),
                          want)
    assert not calls
