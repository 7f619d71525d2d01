"""Two source views (``dataset.num_input_view = 2``): the port's
``VANeRF.query``, eval and training ``render_patch``, ``render_full_image``
and the GAN step at ``n_views=2`` against the JAX package, on the CPU, with
the same weights, the fixture batch of ``tests/test_fullchain_parity.py``
(``num_input_view=2``, 32^2, subdiv 2) and the same random draws.

On the JAX side everything runs in float32 at the highest matmul precision
with the far-field tier off (``VANERF_COMPUTE_DTYPE=float32``,
``jax.default_matmul_precision("highest")``, ``VANERF_FAR_TAU=0``).

Tolerances, each with its reason:
  * ``view_dropout_mask``: equal (the same comparisons and a stable sort);
  * the query: rtol 1e-4 / atol 1e-5 max|ref| (float32 on both sides,
    other summation orders; ``tests/test_torch_render.py``);
  * the eval render: rtol 1e-3 / atol 1e-4 on ``tex_fg*`` / ``alpha*``,
    depth and sdf where alpha > 1e-2 at atol 2e-4 (the /acc normalisation
    amplifies noise on empty rays; ``tests/test_torch_render.py``);
  * the training render and the GAN step: as ``tests/test_torch_train.py``
    (losses rtol 1e-4, each gradient to a relative norm error of 1e-3, the
    texture path 5e-2: its instance norms see 2x2 maps at 32^2 and amplify
    float32 rounding).  At two views the IBR head blends the views'
    colours, whose logit gradients are differences of nearly equal
    colours, and the texture fusion's global-context branch feeds both
    views' tables: in the GAN step, where each package encodes the images
    itself, the amplified rounding reaches ``mlp_tex.*``,
    ``tex_vis_fusion.fconv_gt.*`` and ``tex_vis_fusion.fconv4.*`` (up to
    1.3e-2 here), which are held with the texture path.  On one set of
    feature maps (:func:`test_query_grads_two_views_match_jax`) every
    gradient, those included, is held to 1e-3 (they agree to 1e-4), and in
    float64 from the encode through the blend
    (:func:`test_blend_path_grads_two_views_match_jax_f64`) to 1e-6;
  * ``tile_group`` 4 against 1, and ``VANERF_IBR_V1_SHORTCUT=0`` against
    the shortcut at one view: equal to the bit (the same arithmetic in
    another batch layout; a softmax over one view is exactly 1).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers as h
from test_torch_train import TEX_PATH, _capture, _disc_params, _rel, _vgg_pair
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.models import DiscriminatorVis
from vanerf_tpu_torch.models.vanerf import view_dropout_mask
from vanerf_tpu_torch.weights import disc_from_jax_params, from_jax_params

V = 2
OUT = 8                       # 8x8 training rays: VGG's three pools need 8
# the tensors the two-view GAN step holds with the texture path (module note)
BLEND_PATH = TEX_PATH + ("mlp_tex.", "tex_vis_fusion.fconv_gt.",
                         "tex_vis_fusion.fconv4.")


def T(x):
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def A(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


@pytest.fixture
def exact(monkeypatch):
    monkeypatch.setenv("VANERF_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("VANERF_FAR_TAU", "0")
    monkeypatch.setenv("VANERF_ONEHOT_BN", "16")
    with jax.default_matmul_precision("highest"):
        yield monkeypatch


def _jbatch(batch):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def _models(cfg_edit=None):
    """(JAX model, flax params, port model) with the same weights; the
    config optionally edited (both sides read it)."""
    from vanerf_tpu.models import VANeRF as JVANeRF
    from vanerf_tpu_torch.models import VANeRF
    cfg = h.small_cfg()
    if cfg_edit:
        cfg_edit(cfg["models"]["VANeRF"])
    g, _ = h.converted_params()
    port = VANeRF.from_config(cfg, num_v=h.NUM_V, image_hw=(h.H, h.W))
    port.load_state_dict(from_jax_params(g), strict=True)
    return JVANeRF.from_config(cfg, num_v=h.NUM_V), g, port.eval()


def _jax_dropout_uniforms(key, B, n_views):
    """The uniforms ``vanerf_tpu.models.vanerf.view_dropout_mask(key, B,
    n_views)`` compares and sorts: (u_keep, u_perm)."""
    k1, k2 = jax.random.split(key)
    return (A(jax.random.uniform(k1, (B, n_views - 1, 1, 1))),
            A(jax.random.uniform(k2, (B, n_views, 1, 1))))


def _key_keeping_one_view():
    """The first key whose JAX dropout mask keeps one view of the two."""
    return next(jax.random.PRNGKey(s) for s in range(64)
                if _jax_dropout_uniforms(jax.random.PRNGKey(s), 1, V)[0]
                [0, 0, 0, 0] <= 0.5)


# ---------------------------------------------------------------------------
# view_dropout_mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_views", [2, 3])
def test_view_dropout_mask_matches_jax(n_views):
    """On JAX's uniforms the port's mask equals JAX's, key by key; equal
    scores keep the view order (a stable argsort, as ``jnp.argsort``)."""
    from vanerf_tpu.models.vanerf import view_dropout_mask as j_mask
    B = 3
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        u_keep, u_perm = _jax_dropout_uniforms(key, B, n_views)
        got = view_dropout_mask(B, n_views, T(u_keep), T(u_perm))
        assert got.shape == (B, n_views, 1, 1) and got.dtype == torch.float32
        np.testing.assert_array_equal(A(got), A(j_mask(key, B, n_views)))
    u_keep = np.array([0.9, 0.1][:n_views - 1] * B, np.float32).reshape(
        B, n_views - 1, 1, 1)
    ties = view_dropout_mask(B, n_views, T(u_keep),
                             torch.full((B, n_views, 1, 1), 0.5))
    order = A(jnp.argsort(jnp.full((B, n_views, 1, 1), 0.5), axis=1))
    np.testing.assert_array_equal(order[:, :, 0, 0],
                                  np.tile(np.arange(n_views), (B, 1)))
    want = np.concatenate([np.ones((B, 1, 1, 1), np.float32),
                           (u_keep > 0.5).astype(np.float32)], 1)
    np.testing.assert_array_equal(A(ties), want)


def test_view_dropout_mask_law():
    """Drawn from a generator: one view always kept, per view and per batch
    element; at two views P[both] = 1/2 and P[only view i] = 1/4 each (the
    law ``tests/test_fullchain_parity.py`` holds JAX's mask to)."""
    n = 4000
    gen = torch.Generator().manual_seed(0)
    m = view_dropout_mask(n, 2, generator=gen).reshape(n, 2).numpy()
    assert set(np.unique(m)) <= {0.0, 1.0} and (m.sum(1) >= 1).all()
    p_both = (m.sum(1) == 2).mean()
    p_v0 = ((m[:, 0] == 1) & (m[:, 1] == 0)).mean()
    p_v1 = ((m[:, 0] == 0) & (m[:, 1] == 1)).mean()
    assert abs(p_both - 0.5) < 0.04 and abs(p_v0 - 0.25) < 0.04 \
        and abs(p_v1 - 0.25) < 0.04, (p_both, p_v0, p_v1)
    m3 = view_dropout_mask(500, 3, generator=gen).reshape(500, 3)
    assert (m3.sum(1) >= 1).all()


# ---------------------------------------------------------------------------
# VANeRF.query at two views
# ---------------------------------------------------------------------------

def _query_inputs(batch):
    from vanerf_tpu.ops.knn import nearest_vertex_d2
    rs = np.random.RandomState(9)
    N = 128
    pts = h.two_hand_points(N, seed=10)[None]
    view = rs.randn(1, N, 3).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    vv = (rs.rand(1, 2 * h.NUM_V, 1) > 0.3).astype(np.float32)
    qv = (rs.rand(1, N, 1) > 0.5).astype(np.float32)
    qs = (rs.randn(1, N, 1) * 0.01).astype(np.float32)
    far = rs.rand(1, N, 1) > 0.5
    nn_idx = np.asarray(nearest_vertex_d2(
        jnp.asarray(pts[0]), jnp.asarray(batch["verts"][0]))[0])[None]
    cam = {"KRT": batch["src_krt"], "extrin": batch["src_extrin"],
           "width": h.W, "height": h.H, "znear": batch["znear"],
           "zfar": batch["zfar"]}
    return dict(pts=pts, view=view, vv=vv, qv=qv, qs=qs, far=far,
                nn_idx=nn_idx, cam=cam)


def _queries(jm, g, port, batch, n_views, far=False, training=False,
             dropout_key=None, S=8):
    """(port (out, valid), JAX (out, valid)) of one query on the JAX
    encoder's maps; ``dropout_key``: the JAX query's dropout key, whose
    mask the port takes as ``view_mask``."""
    q = _query_inputs(batch)
    fg, ft = jm.apply(g, jnp.asarray(batch["src_img"]), method=jm.encode)
    far_mask = q["far"] if far else None
    out_j = jm.apply(
        g, jnp.asarray(q["pts"]), jnp.asarray(q["view"]),
        {k: jnp.asarray(v) for k, v in q["cam"].items()}, fg, ft,
        jnp.asarray(batch["src_img"]), jnp.asarray(batch["src_mask"]),
        jnp.asarray(batch["verts"]), jnp.asarray(q["vv"]),
        jnp.asarray(q["qv"]), jnp.asarray(q["qs"]),
        jnp.asarray(batch["kpt3d"]), S, n_views, training,
        dropout_rng=dropout_key, nn_idx=jnp.asarray(q["nn_idx"]),
        far_mask=None if far_mask is None else jnp.asarray(far_mask),
        method=jm.query)
    view_mask = None
    if dropout_key is not None:
        view_mask = view_dropout_mask(
            1, n_views, *map(T, _jax_dropout_uniforms(dropout_key, 1,
                                                      n_views)))
    cam_t = {k: (T(v) if isinstance(v, np.ndarray) else v)
             for k, v in q["cam"].items()}
    with torch.no_grad():
        out_t = port.query(
            T(q["pts"]), T(q["view"]), cam_t, [T(f) for f in fg], T(ft),
            T(batch["src_img"]), T(batch["src_mask"]), T(batch["verts"]),
            T(q["vv"]), T(q["qv"]), T(q["qs"]), T(batch["kpt3d"]), S,
            n_views, training=training, nn_idx=T(q["nn_idx"]),
            far_mask=None if far_mask is None else T(far_mask),
            view_mask=view_mask)
    return out_t, out_j, view_mask


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(A(t), j, rtol=1e-4,
                               atol=1e-5 * float(np.abs(j).max()))


@pytest.mark.parametrize("case", ["eval", "far", "dropout"])
def test_query_two_views_matches_jax(case, exact):
    """The query at two views, eval (with and without the far mask) and
    under training with a view-dropout mask that drops one view (the JAX
    query's own key, its uniforms handed to the port)."""
    jm, g, port = _models()
    batch = h.synthetic_batch_views(V)
    key = None
    if case == "dropout":
        key = _key_keeping_one_view()
    (out_t, valid_t), (out_j, valid_j), view_mask = _queries(
        jm, g, port, batch, V, far=case == "far",
        training=case == "dropout", dropout_key=key)
    if view_mask is not None:
        assert float(view_mask.sum()) == 1.0
    assert out_t.shape == (1, 128, 5)
    np.testing.assert_array_equal(A(valid_t), np.asarray(valid_j))
    assert 0 < A(valid_t).mean() < 1
    _close(out_t, out_j)


def test_disable_fg_mask_two_views_matches_jax(exact):
    """``disable_fg_mask``: a point counts where every view projects it
    inside the image, whatever the foreground masks say; more points count
    than with the masks."""
    jm, g, port = _models(lambda m: m.update(disable_fg_mask=True))
    assert port.disable_fg_mask
    batch = h.synthetic_batch_views(V)
    (out_t, valid_t), (out_j, valid_j), _ = _queries(jm, g, port, batch, V)
    np.testing.assert_array_equal(A(valid_t), np.asarray(valid_j))
    _close(out_t, out_j)
    _, g2, port_fg = _models()
    (_, valid_fg), _, _ = _queries(jm, g2, port_fg, batch, V)
    assert A(valid_t).sum() > A(valid_fg).sum()


def test_query_grads_two_views_match_jax(exact):
    """The training query's gradients at two views on the JAX encoder's
    maps (one set of maps for both): every parameter's gradient of a
    weighted sum of the outputs within a relative norm error of 1e-3, the
    IBR head's (``mlp_tex``, skipped at one view) among them and non-zero;
    under a dropout mask that keeps one view the head's blend is the kept
    view's and its gradient vanishes on both sides."""
    jm, g, port = _models()
    batch = h.synthetic_batch_views(V)
    q = _query_inputs(batch)
    w = np.random.RandomState(4).randn(1, 128, 5).astype(np.float32)
    fg, ft = jm.apply(g, jnp.asarray(batch["src_img"]), method=jm.encode)
    cam_t = {k: (T(v) if isinstance(v, np.ndarray) else v)
             for k, v in q["cam"].items()}
    one = _key_keeping_one_view()
    for key in (None, one):
        def j_loss(p):
            out, _ = jm.apply(
                p, jnp.asarray(q["pts"]), jnp.asarray(q["view"]),
                {k: jnp.asarray(v) for k, v in q["cam"].items()}, fg, ft,
                jnp.asarray(batch["src_img"]),
                jnp.asarray(batch["src_mask"]), jnp.asarray(batch["verts"]),
                jnp.asarray(q["vv"]), jnp.asarray(q["qv"]),
                jnp.asarray(q["qs"]), jnp.asarray(batch["kpt3d"]), 8, V,
                True, dropout_rng=key, nn_idx=jnp.asarray(q["nn_idx"]),
                method=jm.query)
            return (out * jnp.asarray(w)).sum()

        loss_j, g_j = jax.value_and_grad(j_loss)(g)
        g_j = from_jax_params(jax.tree.map(np.asarray, g_j))
        view_mask = None if key is None else view_dropout_mask(
            1, V, *map(T, _jax_dropout_uniforms(key, 1, V)))
        port.zero_grad()
        out_t, _ = port.query(
            T(q["pts"]), T(q["view"]), cam_t, [T(f) for f in fg], T(ft),
            T(batch["src_img"]), T(batch["src_mask"]), T(batch["verts"]),
            T(q["vv"]), T(q["qv"]), T(q["qs"]), T(batch["kpt3d"]), 8, V,
            training=True, nn_idx=T(q["nn_idx"]), view_mask=view_mask)
        loss_t = (out_t * T(w)).sum()
        loss_t.backward()
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
        total = np.sqrt(sum(float((v.numpy() ** 2).sum())
                            for v in g_j.values()))
        ibr = []
        for n, p in port.named_parameters():
            gt = (np.zeros(p.shape) if p.grad is None
                  else p.grad.numpy())
            gj = g_j[n].numpy().reshape(p.shape)
            if n.startswith("mlp_tex."):
                ibr.append((np.linalg.norm(gt), np.linalg.norm(gj)))
            if np.linalg.norm(gj) < 1e-6 * total:
                assert np.linalg.norm(gt) < 1e-6 * total, n
                continue
            assert _rel(gt, gj) <= 1e-3, (n, _rel(gt, gj))
        ibr_t, ibr_j = (np.sqrt(sum(pair[i] ** 2 for pair in ibr))
                        for i in (0, 1))
        if key is None:
            assert ibr_t > 1e-5 * total and ibr_j > 1e-5 * total
        else:
            assert ibr_t < 1e-6 * total and ibr_j < 1e-6 * total


class _Float64Pins:
    """``jax.numpy`` with ``float32`` read as ``float64``: handed to
    ``vanerf_tpu.models.ibr`` for one test, it widens that module's float32
    pins (the anisotropy weights and the softmax blend) as the port's head
    widens its own to the model's dtype."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_blend_path_grads_two_views_match_jax_f64(monkeypatch):
    """The float64 certificate of the GAN step's loose bound: the encode
    and the training query at two views, through the IBR blend, in float64
    on both sides (compute dtype float64, the blend's float32 pins widened),
    from one set of weights.  The gradients of the groups the two-view GAN
    step holds at 5e-2 (``mlp_tex.*``, ``tex_vis_fusion.fconv_gt.*``,
    ``tex_vis_fusion.fconv4.*``), each tensor to a relative norm error of
    1e-6 (the step's measure), so that bound covers float32 rounding, not
    a fault.  The reference passes through ``from_jax_params``, which
    rounds it to float32 (~3e-8 of a tensor's norm; up to ~2.5e-7 seen);
    the two structurally zero gradients (the last logit bias and
    ``ani_al`` in front of a softmax over views, ~1e-16) are only held
    below 1e-9 of the largest."""
    import vanerf_tpu.models.ibr as jibr
    import vanerf_tpu_torch.models.vanerf as pv
    monkeypatch.setenv("VANERF_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("VANERF_FAR_TAU", "0")
    jm, g, port = _models()
    jm = jm.clone(compute_dtype="float64")
    monkeypatch.setattr(jibr, "jnp", _Float64Pins())
    monkeypatch.setitem(pv.COMPUTE_DTYPES, "float64", torch.float64)
    port = port.double()
    port.compute_dtype = "float64"
    batch = h.synthetic_batch_views(V)
    q = _query_inputs(batch)
    w = np.random.RandomState(4).randn(1, 128, 5)

    def f64(x):
        return (x.astype(np.float64) if isinstance(x, np.ndarray)
                and x.dtype == np.float32 else x)

    args = [f64(x) for x in (q["pts"], q["view"], batch["src_img"],
                             batch["src_mask"], batch["verts"], q["vv"],
                             q["qv"], q["qs"], batch["kpt3d"])]
    cam = {k: f64(v) for k, v in q["cam"].items()}
    with jax.enable_x64(True):
        g64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                           g)

        def j_loss(p):
            pts, view, img, mask, verts, vv, qv, qs, kpt = map(jnp.asarray,
                                                               args)
            fg, ft = jm.apply(p, img, method=jm.encode)
            out, _ = jm.apply(
                p, pts, view, {k: jnp.asarray(v) if isinstance(
                    v, np.ndarray) else v for k, v in cam.items()}, fg, ft,
                img, mask, verts, vv, qv, qs, kpt, 8, V, True,
                dropout_rng=None, nn_idx=jnp.asarray(q["nn_idx"]),
                method=jm.query)
            return (out * jnp.asarray(w)).sum()

        loss_j, g_j = jax.jit(jax.value_and_grad(j_loss))(g64)
        g_j = from_jax_params(jax.tree.map(
            lambda a: np.asarray(a, np.float64), g_j))
    pts, view, img, mask, verts, vv, qv, qs, kpt = map(T, args)
    fg, ft = port.encode(img)
    out_t, _ = port.query(
        pts, view, {k: T(v) if isinstance(v, np.ndarray) else v
                    for k, v in cam.items()}, fg, ft, img, mask, verts, vv,
        qv, qs, kpt, 8, V, training=True, nn_idx=T(q["nn_idx"]))
    assert out_t.dtype == torch.float64
    loss_t = (out_t * T(w)).sum()
    loss_t.backward()
    # JAX casts the query's output to float32 (models/vanerf.py:533)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    pairs = [(n, p.grad.numpy(), g_j[n].numpy().reshape(p.shape))
             for n, p in port.named_parameters()
             if n.startswith(BLEND_PATH[len(TEX_PATH):])]
    scale = max(np.linalg.norm(ref) for _, _, ref in pairs)
    held = 0
    for n, got, ref in pairs:
        if np.linalg.norm(ref) < 1e-9 * scale:
            assert np.linalg.norm(got) < 1e-9 * scale, n
            continue
        assert _rel(got, ref) <= 1e-6, (n, _rel(got, ref))
        held += 1
    assert held == len(pairs) - 2 and held > 30


def test_ibr_head_at_one_view_equals_the_shortcut(monkeypatch):
    """``VANERF_IBR_V1_SHORTCUT=0`` runs the IBR head at one view: its
    softmax over one view is exactly 1, so the query equals the shortcut's
    to the bit, and the head did run."""
    _, _, port = _models()
    batch, _ = h.synthetic_batch()
    q = _query_inputs(batch)
    cam_t = {k: (T(v) if isinstance(v, np.ndarray) else v)
             for k, v in q["cam"].items()}
    calls = []
    port.mlp_tex.register_forward_hook(lambda *a: calls.append(1))

    def run():
        with torch.no_grad():
            fg, ft = port.encode(T(batch["src_img"]))
            return port.query(
                T(q["pts"]), T(q["view"]), cam_t, fg, ft,
                T(batch["src_img"]), T(batch["src_mask"]),
                T(batch["verts"]), T(q["vv"]), T(q["qv"]), T(q["qs"]),
                T(batch["kpt3d"]), 8, nn_idx=T(q["nn_idx"]))

    want = run()
    assert not calls
    monkeypatch.setenv("VANERF_IBR_V1_SHORTCUT", "0")
    got = run()
    assert calls
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# render_patch / render_full_image at two views
# ---------------------------------------------------------------------------

def test_eval_render_patch_two_views_matches_jax(exact):
    """The eval render at two views: every output within the render
    tolerance; the vertex visibility is the first view's and the context
    patches come from it."""
    from vanerf_tpu import renderer as jr
    jm, g, port = _models()
    batch = h.morton_sorted(h.synthetic_batch_views(V))
    grids = h.center_grid()
    out_j = jr.render_patch(
        jm, g, _jbatch(batch), rng=jax.random.PRNGKey(0),
        grids=jnp.asarray(grids), out_h=h.OUT, out_w=h.OUT,
        sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F, fine=True,
        uniform=True, training=False, n_views=V, sdf_chunk=64,
        compute_vis_map=True)
    out_t = tr.render_patch(port, h.torch_batch(batch), grids=T(grids),
                            out_h=h.OUT, out_w=h.OUT, sample_per_ray_c=h.S_C,
                            sample_per_ray_f=h.S_F, n_views=V)
    for k in ("tex_fg", "alpha", "tex_fg_fine", "alpha_fine"):
        np.testing.assert_allclose(A(out_t[k]), np.asarray(out_j[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    for k, acck in (("depth", "alpha"), ("depth_fine", "alpha_fine"),
                    ("sdf", "alpha_fine")):
        m = np.asarray(out_j[acck]) > 1e-2
        assert m.any()
        np.testing.assert_allclose(A(out_t[k])[m], np.asarray(out_j[k])[m],
                                   rtol=1e-3, atol=2e-4, err_msg=k)
    for k in ("vert_vis", "vis_img", "vis_img_all", "img_in", "input_mask",
              "tar_img"):
        np.testing.assert_array_equal(A(out_t[k]), np.asarray(out_j[k]),
                                      err_msg=k)
    assert out_t["img_in"].shape == (1, h.OUT, h.OUT, 3)
    assert out_t["alpha_fine"].max() > 0.2, "rays missed the fixture mesh"


def test_full_image_tile_group_two_views_is_its_elements():
    """``render_full_image(n_views=2)`` at ``tile_group`` 4 over two frames:
    element g Bf + f, view v reads map (e V + v) mod (Bf V) = f V + v in
    place, so every output equals the ``tile_group`` 1 render to the bit;
    the two frames differ."""
    from vanerf_tpu.data.synthetic import make_synthetic_batch
    batch, _, _ = make_synthetic_batch(batch_size=2, H=h.H, W=h.W, subdiv=2,
                                       num_input_view=V)
    assert batch["src_img"].shape[0] == 2 * V
    tb = h.torch_batch(batch)
    port = h.port_model()
    kw = dict(level=3, sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F,
              n_views=V)
    want = tr.render_full_image(port, tb, tile_group=1, **kw)
    got = tr.render_full_image(port, tb, tile_group=4, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert not torch.equal(want["tex_fg_fine"][0], want["tex_fg_fine"][1])
    assert want["alpha_fine"].max() > 0.2


def test_tiers_at_two_views_follow_jax(monkeypatch):
    """As in the JAX package: at two views FAR_NET and FAR_TNET are off
    (the frame equals the default one to the bit), FAR_SKIP stays on and
    FAR_SKIP=1 keeps every sample (equal to the bit)."""
    port = h.port_model()
    tb = h.torch_batch(h.synthetic_batch_views(V))
    kw = dict(grids=T(h.center_grid()), out_h=h.OUT, out_w=h.OUT,
              sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F, n_views=V)
    want = tr.render_patch(port, tb, **kw)
    for env, val in (("VANERF_FAR_NET", "0.5"), ("VANERF_FAR_TNET", "0.5"),
                     ("VANERF_FAR_SKIP", "1")):
        monkeypatch.setenv(env, val)
        got = tr.render_patch(port, tb, **kw)
        monkeypatch.delenv(env)
        for k, v in want.items():
            assert torch.equal(got[k], v), (env, k)
    monkeypatch.setenv("VANERF_FAR_SKIP", "0.5")
    assert not torch.equal(tr.render_patch(port, tb, **kw)["tex_fg_fine"],
                           want["tex_fg_fine"])


# ---------------------------------------------------------------------------
# training: the render with its dropout, and the GAN step
# ---------------------------------------------------------------------------

def _train_cfg():
    cfg = h.small_cfg()
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = OUT
    m["dr_kwargs"]["sample_per_ray_c"] = h.S_C
    m["dr_kwargs"]["sample_per_ray_f"] = h.S_F
    cfg["training"]["reference_faithful_gan"] = False
    cfg["dataset"]["num_input_view"] = V
    return cfg


def _jax_draws(key, jb):
    """The draws of JAX's ``_generator_outputs`` / ``render_patch`` at two
    views for ``key``: the grid, then of split(render key, 4) the jitter,
    the coarse noise and (from fold_in(., 1)) the coarse pass's dropout,
    the importance uniforms, the fine noise and the fine dropout."""
    from vanerf_tpu import renderer as jr
    B, P = 1, OUT * OUT
    kgrid, krender = jax.random.split(key)
    r = jax.random.split(krender, 4)
    d = {"grids": A(jr.mask_centered_grid(kgrid, jb["tar_mask"][..., 0],
                                          OUT, OUT)),
         "u_c": A(jax.random.uniform(r[0], (B, P, h.S_C))),
         "noise_c": A(jax.random.normal(r[1], (B, P * h.S_C, 1))),
         "u_f": A(jax.random.uniform(r[2], (B, P, h.S_F))),
         "noise_f": A(jax.random.normal(r[3], (B, P * h.S_F, 1)))}
    for tag, k in (("c", r[1]), ("f", r[3])):
        d[f"drop_keep_{tag}"], d[f"drop_perm_{tag}"] = \
            _jax_dropout_uniforms(jax.random.fold_in(k, 1), B, V)
    return d


def _dropped(d, tag):
    """Views the pass's mask keeps (from the draws)."""
    return float(view_dropout_mask(1, V, T(d[f"drop_keep_{tag}"]),
                                   T(d[f"drop_perm_{tag}"])).sum())


def _key_dropping_one_pass():
    """A key whose coarse pass keeps one view and fine pass both (the
    render then runs both kinds of mask)."""
    for s in range(64):
        key = jax.random.PRNGKey(s)
        _, krender = jax.random.split(key)
        r = jax.random.split(krender, 4)
        keep = [_jax_dropout_uniforms(jax.random.fold_in(k, 1), 1, V)[0]
                [0, 0, 0, 0] > 0.5 for k in (r[1], r[3])]
        if keep == [False, True]:
            return key
    raise AssertionError("no such key below 64")


def test_training_render_two_views_matches_jax(exact):
    """The training render at two views with JAX's draws fed in, the view
    dropout included (one pass keeps one view, the other both): the render
    tolerance on every output, and the dropout moved the coarse pass."""
    from vanerf_tpu import renderer as jr
    jm, g, port = _models()
    key = _key_dropping_one_pass()
    batch = h.morton_sorted(h.synthetic_batch_views(V))
    jb = _jbatch(batch)
    dr = _jax_draws(key, jb)
    assert _dropped(dr, "c") == 1 and _dropped(dr, "f") == 2
    _, krender = jax.random.split(key)
    kw = dict(out_h=OUT, out_w=OUT, sample_per_ray_c=h.S_C,
              sample_per_ray_f=h.S_F, fine=True, uniform=False,
              rand_noise_std=0.01, training=True, n_views=V)
    out_j = jax.jit(lambda p, b, k, gr: jr.render_patch(
        jm, p, b, rng=k, grids=gr, sdf_chunk=64, **kw))(
        g, jb, krender, jnp.asarray(dr["grids"]))
    tb = h.torch_batch(batch)
    out_t = tr.render_patch(port, tb, grids=T(dr["grids"]),
                            compute_vis_map=True, draws=dr, **kw)
    assert out_t["tex_fg_fine"].requires_grad
    for k in ("alpha", "alpha_fine", "tex_fg", "tex_fg_fine"):
        np.testing.assert_allclose(A(out_t[k]), np.asarray(out_j[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    m = np.asarray(out_j["alpha_fine"]) > 1e-2
    assert m.any() and out_t["alpha_fine"].max() > 0.2
    np.testing.assert_allclose(A(out_t["depth_fine"])[m],
                               np.asarray(out_j["depth_fine"])[m],
                               rtol=1e-3, atol=2e-4)
    for k in ("vis_img", "vis_img_all", "tar_img", "tar_alpha", "img_in",
              "input_mask"):
        np.testing.assert_array_equal(A(out_t[k]), np.asarray(out_j[k]),
                                      err_msg=k)
    # the same draws with both views kept change the coarse colour
    kept = dict(dr, drop_keep_c=np.ones_like(dr["drop_keep_c"]))
    out_k = tr.render_patch(port, tb, grids=T(dr["grids"]),
                            compute_vis_map=True, draws=kept, **kw)
    assert not torch.equal(out_k["tex_fg"], out_t["tex_fg"])


def test_train_step_two_views_matches_jax(exact):
    """One single-render GAN step at two views (``make_train_step(...,
    n_views=2)``) with JAX's draws: losses and every parameter's gradient
    (the bounds of the module note), and the IBR head (``mlp_tex``, skipped
    at one view) has a non-zero gradient on both sides, which Adam
    applies to every one of its tensors."""
    import optax
    from vanerf_tpu.models import DiscriminatorVis as JDisc
    from vanerf_tpu.training.train_step import (TrainState,
                                                make_lr_schedule,
                                                make_train_step as j_make)
    from vanerf_tpu_torch.training import (create_train_state,
                                           make_train_step)
    cfg = _train_cfg()
    jm, g, model = _models()
    d = _disc_params()
    batch = h.morton_sorted(h.synthetic_batch_views(V))
    jb = _jbatch(batch)
    vgg_j, vgg_t = _vgg_pair()
    sched = make_lr_schedule(cfg["training"]["lr"], 10)
    tx_g = optax.chain(_capture(), optax.adam(sched))
    tx_d = optax.chain(_capture(), optax.adam(sched))
    state = TrainState(g, d, tx_g.init(g), tx_d.init(d),
                       jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(3)
    new, logs_j = jax.jit(j_make(jm, JDisc(), tx_g, tx_d, cfg, vgg_j,
                                 n_views=V))(state, jb, rng)
    rg, rd = jax.random.split(rng)
    draws = {"g": _jax_draws(rg, jb), "d": _jax_draws(rd, jb)}

    np_tree = lambda t: jax.tree.map(np.asarray, t)        # noqa: E731
    disc = DiscriminatorVis()
    disc.load_state_dict(disc_from_jax_params(d), strict=True)
    st = create_train_state(model, disc, cfg, steps_per_epoch=10)
    seen = {}
    orig = st.opt_g.step

    def hooked(grads):
        seen["g"] = grads
        orig(grads)
        seen["g_post"] = {k: v.clone() for k, v in model.state_dict().items()}
    st.opt_g.step = hooked
    before_t = {k: v.clone() for k, v in model.state_dict().items()}
    logs_t = make_train_step(model, disc, cfg, vgg_t, n_views=V)(
        st, h.torch_batch(batch), draws=draws)

    assert set(logs_t) == set(logs_j)
    for k in logs_j:
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    grads_j = from_jax_params(np_tree(new.opt_g[0]))
    names = [n for n, _ in model.named_parameters()]
    total = np.sqrt(sum(float((grads_j[n].numpy() ** 2).sum())
                        for n in names))
    ibr = 0.0
    for n, p, gt in zip(names, st.opt_g.params, seen["g"]):
        gj = grads_j[n].numpy().reshape(p.shape)
        gt = np.zeros(p.shape) if gt is None else gt.numpy()
        if n.startswith("mlp_tex."):
            ibr += float((gt ** 2).sum())
        if np.linalg.norm(gj) < 1e-6 * total:
            assert np.linalg.norm(gt) < 1e-6 * total, n
            continue
        # 5e-2: float32 rounding, amplified (float64 agrees to 1e-6:
        # test_blend_path_grads_two_views_match_jax_f64)
        loose = n.startswith(BLEND_PATH)
        assert _rel(gt, gj) <= (5e-2 if loose else 1e-3), (n, _rel(gt, gj))
    ibr_j = sum(float((grads_j[n].numpy() ** 2).sum()) for n in names
                if n.startswith("mlp_tex."))
    assert ibr > 0 and ibr_j > 0
    moved = [n for n in names if n.startswith("mlp_tex.")
             and not torch.equal(seen["g_post"][n], before_t[n])]
    assert len(moved) == len([n for n in names if n.startswith("mlp_tex.")])


# ---------------------------------------------------------------------------
# the entry point on a two-view config
# ---------------------------------------------------------------------------

def test_cli_two_views_fits_validates_and_tests(tmp_path, capsys,
                                                monkeypatch):
    """``python -m vanerf_tpu_torch.train`` (``main`` in process) on the
    entry-point tests' tiny config with ``dataset.num_input_view: 2``,
    written beside the run: one epoch of ``fit`` (two steps, ``val_fn`` on
    one frame after the second) and then ``--run_val`` on its checkpoint, every query at two
    views; the report's psnr / ssim / mse finite."""
    import json
    import yaml
    from test_torch_entry import tiny_cli_cfg
    from vanerf_tpu_torch import train
    from vanerf_tpu_torch.models import VANeRF
    monkeypatch.setenv("VANERF_FAR_TAU", "0")
    cfg = tiny_cli_cfg(str(tmp_path / "out"))
    cfg["dataset"]["num_input_view"] = V
    cfg["training"]["pl_cfg"] = {"val_check_interval": 1.0}
    cfg["dataset"].setdefault("val_cfg", {})["max_len"] = 1
    path = tmp_path / "two_views.json"
    path.write_text(json.dumps(cfg))
    seen = []
    real = VANeRF.query

    def spy(self, *a, **k):
        seen.append(a[13] if len(a) > 13 else k.get("n_views", 1))
        return real(self, *a, **k)

    monkeypatch.setattr(VANeRF, "query", spy)
    args = ["--config", str(path), "--synthetic_data", "--device", "cpu"]
    state = train.main(args)
    assert state.step == 2 and "Training done at step 2" in \
        capsys.readouterr().out
    save_dir = tmp_path / "out" / "vanerf"
    with open(save_dir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert any("val_total_loss" in r for r in recs)
    assert all(np.isfinite(r["val_total_loss"]) for r in recs
               if "val_total_loss" in r)
    train.main(args + ["--run_val", "--model_ckpt", str(save_dir / "ckpts")])
    names = [n for n in os.listdir(save_dir) if n.endswith(".yml")]
    assert len(names) == 1
    with open(save_dir / names[0]) as f:
        rep = yaml.safe_load(f)
    for k in ("psnr", "ssim", "mse"):
        assert np.isfinite(rep[k]), k
    assert seen and set(seen) == {V}
