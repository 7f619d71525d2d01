"""The port's serving slice (vanerf_tpu_torch.renderer) against the JAX
renderer, on the CPU, with the same weights and fixture.

Tolerances as ``tests/test_fullchain_parity.py:145-155``: rtol 1e-3 /
atol 1e-4 on tex_fg* and alpha*, depth and sdf only where alpha > 1e-2
(the /acc normalisation amplifies noise on empty rays).  The full image
allows up to 1% of pixels outside that colour tolerance: the port centres
the mesh before its distance query (as the JAX package does on a TPU) and
the JAX CPU path does not, so where two faces tie for the closest point
(a shared edge) rounding can pick the other face, whose plane projection
interpolates another visibility.
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
    batch, _ = h.synthetic_batch()
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
    batch, _ = h.synthetic_batch()
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
                                                   W=h.W, subdiv=2)
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


def test_unported_render_options_raise(monkeypatch):
    model = h.port_model()
    batch = h.torch_batch(h.synthetic_batch()[0])
    grids = T(h.center_grid())
    kw = dict(grids=grids, out_h=4, out_w=4, sample_per_ray_c=4,
              sample_per_ray_f=4)
    with pytest.raises(NotImplementedError):
        tr.render_patch(model, batch, **kw, n_views=2)
    for env in ("VANERF_FAR_SKIP", "VANERF_FAR_NET", "VANERF_FAR_TNET",
                "VANERF_SOA_POINTS"):
        monkeypatch.setenv(env, "0.5")
        with pytest.raises(NotImplementedError):
            tr.render_patch(model, batch, **kw)
        monkeypatch.delenv(env)


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
