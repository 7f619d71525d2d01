"""The port's training slice (take_rows and its scatter backward, the
training render, discriminator, losses and the GAN train step) against the
JAX package, on the CPU, with the same weights and the same random draws.

On the JAX side everything runs in float32 at the highest matmul precision
with the far-field tier off (``VANERF_COMPUTE_DTYPE=float32``,
``jax.default_matmul_precision("highest")``, ``VANERF_FAR_TAU=0``).  On
the port side every small-table gather whose gradient is wanted goes
through ``take_rows``, so its backward runs the kernel's plain twin (the
JAX package takes its one-hot route only on a TPU; its native gather
gives the reference gradient).

Tolerances, each with its reason:
  * gathered values: exact (the forward is the same gather);
  * table gradients: rtol 1e-5 / atol 1e-6 (sums in another order);
  * losses: rtol 1e-4 (f32 on both sides, other summation orders);
  * gradients: per-tensor relative norm error <= 1e-3.  The texture path
    (``tex_encoder.*`` and the global-context convs
    ``tex_vis_fusion.fconv3.*`` that read its map) is held at 5e-2 in
    float32: at the 32^2 test image its instance norms see 2x2 maps and
    amplify f32 rounding (``tests/test_torch_models.py``), and
    ``test_texture_path_grads_match_flax_f64`` holds the same gradients at
    rtol 1e-6 in float64.  A gradient that is structurally zero (a conv
    bias in front of an instance norm) is rounding noise in both
    packages: both norms must stay below 1e-6 of the total;
  * post-Adam parameters: the update p_new - p_old per tensor to 1e-3 on
    the elements whose JAX gradient exceeds max(1e-6, 0.1 * its rms).
    Adam's first step is lr * g / (|g| + eps), about lr * sign(g), so an
    element whose gradient is near zero steps +-lr with a sign that
    rounding decides in each package; the texture path's updates are held
    through its gradients instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers as h
from vanerf_tpu_torch import losses as tl
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.models import DiscriminatorVis
from vanerf_tpu_torch.models import discriminator as tdisc
from vanerf_tpu_torch.ops import onehot_gather as tog
from vanerf_tpu_torch.ops import rasterize as t_rast
from vanerf_tpu_torch.ops import sampling as t_samp
from vanerf_tpu_torch.ops.grid_sample import grid_sample_2d
from vanerf_tpu_torch.ops.knn import knn_gather_1
from vanerf_tpu_torch.ops.sorting import sort_by_key
from vanerf_tpu_torch.weights import (disc_from_jax_params, from_jax_params,
                                      vgg_from_jax_params)

OUT = 8                       # 8x8 training rays: VGG's three pools need 8
TEX_PATH = ("tex_encoder.", "tex_vis_fusion.fconv3.")


def T(x):
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def A(x):
    return np.asarray(x)


@pytest.fixture
def exact(monkeypatch):
    """f32 / highest precision / far tier off on the JAX side, whose
    interpret-mode take_rows scatters in blocks of 16 rows."""
    monkeypatch.setenv("VANERF_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("VANERF_FAR_TAU", "0")
    monkeypatch.setenv("VANERF_ONEHOT_BN", "16")
    with jax.default_matmul_precision("highest"):
        yield


def _rel(t, j):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    n = np.linalg.norm(j)
    return np.linalg.norm(t - j) / n if n > 0 else np.linalg.norm(t)


# ---------------------------------------------------------------------------
# take_rows (kernel 13's plain twin on the CPU)
# ---------------------------------------------------------------------------

def test_onehot_policy_matches_jax_thresholds(monkeypatch):
    """The port routes a gather through take_rows when the table gradient
    is wanted and the kernel holds the table, whatever the JAX package's
    switches say (they bound its MXU one-hot product, not this kernel)."""
    monkeypatch.setenv("VANERF_ONEHOT_SCATTER", "0")
    monkeypatch.setenv("VANERF_ONEHOT_MAX_T", "64")
    monkeypatch.setenv("VANERF_ONEHOT_BN", "1024")
    leaf = torch.zeros(3, requires_grad=True)
    assert tog.take_rows_route(tog.SCATTER_MAX_T, leaf)
    assert tog.take_rows_route(1, leaf * 2.0)
    assert not tog.take_rows_route(tog.SCATTER_MAX_T + 1, leaf)
    assert not tog.take_rows_route(1024, torch.zeros(3))
    assert not tog.take_rows_route(1024, leaf.double())
    with torch.no_grad():
        assert not tog.take_rows_route(1024, leaf)


@pytest.mark.parametrize("n", [200, 256])
def test_take_rows_matches_jax(n, exact):
    """Forward equals the native gather; the table gradient equals
    jax.grad of the native gather and of the JAX take_rows (its Pallas
    scatter kernel in interpret mode, VANERF_ONEHOT_BN=16)."""
    from vanerf_tpu.ops.onehot_gather import take_rows as j_take_rows
    rs = np.random.RandomState(n)
    t_rows, c = 37, 12
    table = rs.randn(t_rows, c).astype(np.float32)
    # skewed indices: a few rows take most of the points
    idx = np.minimum(rs.geometric(0.15, n) - 1, t_rows - 1).astype(np.int32)
    w = rs.randn(n, c).astype(np.float32)

    def j_loss(fn):
        return lambda tb: (fn(tb) * jnp.asarray(w)).sum()

    g_native = jax.grad(j_loss(lambda tb: tb[jnp.asarray(idx)]))(
        jnp.asarray(table))
    g_pallas = jax.grad(j_loss(lambda tb: j_take_rows(
        tb, jnp.asarray(idx), interpret=True)))(jnp.asarray(table))

    tt = T(table).requires_grad_(True)
    out = tog.take_rows(tt, T(idx))
    np.testing.assert_array_equal(out.detach().numpy(), table[idx])
    (out * T(w)).sum().backward()
    for ref in (g_native, g_pallas):
        np.testing.assert_allclose(tt.grad.numpy(), A(ref), rtol=1e-5,
                                   atol=1e-6)
    assert tog.launches == 0
    np.testing.assert_allclose(
        tog.onehot_scatter_plain(T(w), T(idx), t_rows).numpy(),
        A(g_native), rtol=1e-5, atol=1e-6)


def test_grid_sample_grad_through_take_rows_matches_jax(exact, monkeypatch):
    from vanerf_tpu.ops.grid_sample import grid_sample_2d as j_gs
    rs = np.random.RandomState(11)
    feat = rs.randn(8, 16, 5).astype(np.float32)
    uv = rs.uniform(-1.1, 1.1, (300, 2)).astype(np.float32)
    w = rs.randn(300, 5).astype(np.float32)
    val_j, g_j = jax.value_and_grad(
        lambda f: (j_gs(f, jnp.asarray(uv)) * jnp.asarray(w)).sum())(
        jnp.asarray(feat))
    calls = []
    real = tog.onehot_scatter_plain
    monkeypatch.setattr(tog, "onehot_scatter_plain",
                        lambda *a: calls.append(a[2]) or real(*a))
    ft = T(feat).requires_grad_(True)
    loss = (grid_sample_2d(ft, T(uv)) * T(w)).sum()
    loss.backward()
    assert calls == [8 * 16]            # the packed (H*W, 4C) table
    np.testing.assert_allclose(loss.item(), float(val_j), rtol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), A(g_j), rtol=1e-5, atol=1e-5)


def test_knn_gather_grad_through_take_rows_matches_jax(exact, monkeypatch):
    from vanerf_tpu.ops.knn import knn_gather_1 as j_knn
    rs = np.random.RandomState(12)
    B, N, V, C = 2, 160, 2 * 20, 7
    verts = rs.randn(B, V, 3).astype(np.float32)
    feat = rs.randn(B, V, C).astype(np.float32)
    vis = (rs.rand(B, V, 1) > 0.5).astype(np.float32)
    idx = rs.randint(0, V, size=(B, N)).astype(np.int32)
    ws = [rs.randn(B, N, k).astype(np.float32) for k in (C, C, 1, 1)]

    def j_loss(f):
        outs = j_knn(jnp.zeros((B, N, 3)), jnp.asarray(verts), f,
                     jnp.asarray(vis), V // 2, nn_idx=jnp.asarray(idx))
        return sum((o * jnp.asarray(w)).sum() for o, w in zip(outs, ws))

    g_j = jax.grad(j_loss)(jnp.asarray(feat))
    calls = []
    real = tog.onehot_scatter_plain
    monkeypatch.setattr(tog, "onehot_scatter_plain",
                        lambda *a: calls.append(a[2]) or real(*a))
    ft = T(feat).requires_grad_(True)
    outs = knn_gather_1(torch.zeros(B, N, 3), T(verts), ft, T(vis), V // 2,
                        T(idx))
    sum((o * T(w)).sum() for o, w in zip(outs, ws)).backward()
    assert calls == [V, V]              # one scatter per batch element
    np.testing.assert_allclose(ft.grad.numpy(), A(g_j), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# sampling, sorting, the GT visibility map
# ---------------------------------------------------------------------------

def test_sort_by_key_grad_matches_jax():
    from vanerf_tpu.ops.sorting import sort_by_key as j_sort
    rs = np.random.RandomState(13)
    key = rs.rand(3, 4, 10).astype(np.float32)
    key[0, 0, 3] = key[0, 0, 7]                      # a tie: stable order
    pays = [rs.randn(3, 4, 10).astype(np.float32) for _ in range(2)]
    ws = [rs.randn(3, 4, 10).astype(np.float32) for _ in range(3)]

    def j_loss(k, p0, p1):
        outs = j_sort(k, p0, p1)
        return sum((o * jnp.asarray(w)).sum() for o, w in zip(outs, ws))

    g_j = jax.grad(j_loss, argnums=(0, 1, 2))(
        *[jnp.asarray(x) for x in [key] + pays])
    ins = [T(x).requires_grad_(True) for x in [key] + pays]
    outs = sort_by_key(*ins)
    for o, oj in zip(outs, j_sort(*[jnp.asarray(x) for x in [key] + pays])):
        np.testing.assert_array_equal(o.detach().numpy(), A(oj))
    sum((o * T(w)).sum() for o, w in zip(outs, ws)).backward()
    for t, j in zip(ins, g_j):
        np.testing.assert_array_equal(t.grad.numpy(), A(j))


def test_jittered_sampling_matches_jax():
    from vanerf_tpu.ops import sampling as j_samp
    rs = np.random.RandomState(14)
    zn = (0.5 + 0.1 * rs.rand(2, 16, 1)).astype(np.float32)
    zf = (zn + 0.3 + 0.1 * rs.rand(2, 16, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    z_j = j_samp.stratified_sample(jnp.asarray(zn), jnp.asarray(zf), 8,
                                   rng=k1)
    u1 = A(jax.random.uniform(k1, (2, 16, 8)))
    z_t = t_samp.stratified_sample(T(zn), T(zf), 8, T(u1))
    np.testing.assert_allclose(z_t.numpy(), A(z_j), rtol=1e-6, atol=1e-7)
    contrib = rs.rand(2, 16, 6).astype(np.float32)
    z_mid = 0.5 * (A(z_j)[..., 1:] + A(z_j)[..., :-1])
    new_j = j_samp.importance_sample(jnp.asarray(contrib),
                                     jnp.asarray(z_mid), 8, rng=k2)
    u2 = A(jax.random.uniform(k2, (2, 16, 8)))
    new_t = t_samp.importance_sample(T(contrib), T(z_mid), 8, T(u2))
    np.testing.assert_allclose(new_t.numpy(), A(new_j), rtol=1e-5,
                               atol=1e-6)


def test_render_vis_map_matches_jax():
    from vanerf_tpu.ops.rasterize import render_vis_map as j_vis
    batch, faces = h.synthetic_batch()
    verts = batch["verts"][0]
    vis = (np.random.RandomState(15).rand(len(verts), 1) > 0.4) \
        .astype(np.float32)
    k, rt = batch["tar_k"][0], batch["tar_rt"][0]
    rgb_j, map_j = j_vis(jnp.asarray(verts), jnp.asarray(faces),
                         jnp.asarray(vis), jnp.asarray(k), jnp.asarray(rt),
                         h.H, h.W)
    rgb_t, map_t = t_rast.render_vis_map(T(verts), T(faces), T(vis), T(k),
                                         T(rt), h.H, h.W)
    assert map_t.shape == (1, h.H, h.W) and rgb_t.shape == (3, h.H, h.W)
    m_t, m_j = map_t.numpy(), A(map_j)
    assert (m_t == 0).sum() > 20 and (m_t == 1).sum() > 20
    # a pixel may flip only where the interpolated visibility sits on the
    # 0.392 threshold (barycentrics rounded in another order)
    near = np.abs(A(rgb_j)[0] - 0.392) < 1e-5
    np.testing.assert_array_equal(m_t[0][~near], m_j[0][~near])
    np.testing.assert_allclose(rgb_t.numpy(), A(rgb_j), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# discriminator and losses
# ---------------------------------------------------------------------------

def _disc_params():
    from convert_reference_ckpt import convert_discriminator
    _, sd = h.converted_params()
    return {"params": convert_discriminator(sd)}


def test_discriminator_losses_and_r1_match_jax():
    from vanerf_tpu.models import discriminator as jd
    d = _disc_params()
    rs = np.random.RandomState(16)
    imgs = [rs.rand(2, 16, 16, 3).astype(np.float32) for _ in range(4)]
    vis_gt = (rs.rand(2, 16, 16, 1) > 0.3).astype(np.float32)
    disc_j = jd.DiscriminatorVis()

    def j_fn(params, real):
        real_p, real_v = disc_j.apply(params, *[jnp.asarray(x)
                                                for x in imgs[:3]], real)
        fake_p, fake_v = disc_j.apply(params, *[jnp.asarray(x)
                                                for x in imgs])
        r1 = jd.d_r1_loss(disc_j.apply, params,
                          *[jnp.asarray(x) for x in imgs[:3]], real)
        loss = (jd.d_logistic_loss(real_p, fake_p) + r1
                + jd.bce_loss(fake_v, jnp.asarray(vis_gt)).mean()
                + jd.g_nonsaturating_loss(fake_p))
        return loss, (real_p, real_v, r1)

    real = rs.rand(2, 16, 16, 3).astype(np.float32)
    (loss_j, (rp_j, rv_j, r1_j)), g_j = jax.value_and_grad(
        j_fn, has_aux=True)(d, jnp.asarray(real))

    disc = DiscriminatorVis()
    disc.load_state_dict(disc_from_jax_params(d), strict=True)
    real_t = T(real).requires_grad_(True)
    real_p, real_v = disc(*[T(x) for x in imgs[:3]], real_t)
    fake_p, fake_v = disc(*[T(x) for x in imgs])
    assert real_p.shape == (2, 1) and real_v.shape == (2, 16, 16, 1)
    r1 = tdisc.d_r1_loss(real_p, real_t)
    loss = (tdisc.d_logistic_loss(real_p, fake_p) + r1
            + tdisc.bce_loss(fake_v, T(vis_gt)).mean()
            + tdisc.g_nonsaturating_loss(fake_p))
    np.testing.assert_allclose(real_p.detach().numpy(), A(rp_j), rtol=1e-5)
    np.testing.assert_allclose(real_v.detach().numpy(), A(rv_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(r1.item(), float(r1_j), rtol=1e-4)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    loss.backward()
    g_t = disc_from_jax_params(jax.tree.map(np.asarray, g_j))
    for name, p in disc.named_parameters():
        assert _rel(p.grad.numpy(), g_t[name].numpy()) <= 1e-4, name


def test_bce_clips_like_jax():
    from vanerf_tpu.models.discriminator import bce_loss as j_bce
    p = np.array([0.0, 1e-9, 0.3, 1.0 - 1e-9, 1.0], np.float32)
    t = np.array([1.0, 0.0, 0.5, 1.0, 0.0], np.float32)
    np.testing.assert_allclose(tdisc.bce_loss(T(p), T(t)).numpy(),
                               A(j_bce(jnp.asarray(p), jnp.asarray(t))),
                               rtol=1e-6)


def _vgg_pair():
    from vanerf_tpu import losses as jl
    vgg_j = jl.VGGLoss(dummy_hw=8)
    return vgg_j, tl.VGGLoss(vgg_from_jax_params(vgg_j.params))


def test_vgg_loss_ssim_and_compute_error_match_jax(exact, tmp_path,
                                                   monkeypatch):
    from vanerf_tpu import losses as jl
    vgg_j, vgg_t = _vgg_pair()
    rs = np.random.RandomState(17)
    x = rs.rand(2, 16, 16, 3).astype(np.float32)
    y = rs.rand(2, 16, 16, 3).astype(np.float32)
    val_j, g_j = jax.value_and_grad(
        lambda a: vgg_j(a, jnp.asarray(y)))(jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    val_t = vgg_t(xt, T(y))
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-5)
    assert _rel(xt.grad.numpy(), A(g_j)) <= 1e-4
    assert not any(p.requires_grad for p in vgg_t.parameters())

    np.testing.assert_allclose(tl.ssim(T(x), T(y)).numpy(),
                               A(jl.ssim(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl.psnr(T(x), T(y)).item(),
                               float(jl.psnr(jnp.asarray(x),
                                             jnp.asarray(y))), rtol=1e-6)

    out = {"tex_cal": x, "tex_cal_fine": rs.rand(2, 16, 16, 3)
           .astype(np.float32), "tar_img": y,
           "alpha": rs.rand(2, 16, 16).astype(np.float32),
           "alpha_fine": rs.rand(2, 16, 16).astype(np.float32),
           "tar_alpha": (rs.rand(2, 16, 16, 1) > 0.5).astype(np.float32)}
    lambdas = dict(h.small_cfg()["models"]["VANeRF"]["lambdas"],
                   lambda_mloss=0.5, lambda_ssim=0.3, lambda_lp=0.2,
                   lambda_l2=0.1, lambda_l1top20=0.4)
    loss_j, err_j = jl.compute_error({k: jnp.asarray(v)
                                      for k, v in out.items()}, lambdas,
                                     vgg_j)
    loss_t, err_t = tl.compute_error({k: T(v) for k, v in out.items()},
                                     lambdas, vgg_t)
    assert list(err_t) == list(err_j)
    for k in err_j:
        np.testing.assert_allclose(float(err_t[k]), float(err_j[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)

    # the VANERF_VGG19_NPZ file of tools/convert_vgg.py loads as-is
    from convert_vgg import convert_vgg_sd
    from vanerf_tpu_torch.losses import VGG_LAYERS
    vgg_sd = {}
    for i, name in VGG_LAYERS.items():
        p = vgg_j.params["params"][name]
        vgg_sd[f"features.{i}.weight"] = np.transpose(A(p["kernel"]),
                                                      (3, 2, 0, 1))
        vgg_sd[f"features.{i}.bias"] = A(p["bias"])
    np.savez(tmp_path / "vgg.npz", **convert_vgg_sd(vgg_sd))
    monkeypatch.setenv("VANERF_VGG19_NPZ", str(tmp_path / "vgg.npz"))
    from_npz = tl.VGGLoss()
    assert from_npz.pretrained
    for k, v in vgg_t.state_dict().items():
        assert torch.equal(from_npz.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# the training render
# ---------------------------------------------------------------------------

def _train_cfg(faithful=True):
    cfg = h.small_cfg()
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = OUT
    m["dr_kwargs"]["sample_per_ray_c"] = h.S_C
    m["dr_kwargs"]["sample_per_ray_f"] = h.S_F
    cfg["training"]["reference_faithful_gan"] = faithful
    return cfg


def _jbatch():
    batch, _ = h.synthetic_batch()
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def _jax_draws(key, jb):
    """The draws of the JAX ``_generator_outputs`` / ``render_patch`` for
    ``key``: the grid, then split(render key, 4) for the stratified
    jitter, coarse noise, importance uniforms and fine noise."""
    from vanerf_tpu import renderer as jr
    B, P = 1, OUT * OUT
    kgrid, krender = jax.random.split(key)
    r = jax.random.split(krender, 4)
    return {"grids": A(jr.mask_centered_grid(kgrid, jb["tar_mask"][..., 0],
                                             OUT, OUT)),
            "u_c": A(jax.random.uniform(r[0], (B, P, h.S_C))),
            "noise_c": A(jax.random.normal(r[1], (B, P * h.S_C, 1))),
            "u_f": A(jax.random.uniform(r[2], (B, P, h.S_F))),
            "noise_f": A(jax.random.normal(r[3], (B, P * h.S_F, 1)))}


def test_render_patch_training_matches_jax(exact):
    from vanerf_tpu import renderer as jr
    g, _ = h.converted_params()
    jb = _jbatch()
    key = jax.random.PRNGKey(21)
    dr = _jax_draws(key, jb)
    kgrid, krender = jax.random.split(key)
    jm = h.jax_model()
    out_j = jax.jit(lambda p, b, k, gr: jr.render_patch(
        jm, p, b, rng=k, grids=gr, out_h=OUT, out_w=OUT,
        sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F, fine=True,
        uniform=False, rand_noise_std=0.01, training=True, n_views=1,
        sdf_chunk=64))(g, jb, krender, jnp.asarray(dr["grids"]))
    out_t = tr.render_patch(
        h.port_model(), h.torch_batch(h.synthetic_batch()[0]),
        grids=T(dr["grids"]), out_h=OUT, out_w=OUT, sample_per_ray_c=h.S_C,
        sample_per_ray_f=h.S_F, training=True, compute_vis_map=True,
        rand_noise_std=0.01, draws=dr)
    assert out_t["tex_fg_fine"].requires_grad
    for k in ("alpha", "alpha_fine"):
        np.testing.assert_allclose(out_t[k].detach().numpy(), A(out_j[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    # colour: XLA rounds some sample points 1 ulp away from the port's; a
    # point on a face edge can then interpolate another face's visibility
    # (the tie of tests/test_torch_render.py), so 2 of the 64 pixels may
    # leave the tolerance (this grid has one such sample)
    for k in ("tex_fg", "tex_fg_fine"):
        a, b = out_t[k].detach().numpy(), A(out_j[k])
        bad = ~np.isclose(a, b, rtol=1e-3, atol=1e-4).all(-1)
        assert bad.sum() <= 2 and np.abs(a - b).max() < 0.02, (k, bad.sum())
    m = A(out_j["alpha_fine"]) > 1e-2
    assert m.any() and out_t["alpha_fine"].max() > 0.2
    np.testing.assert_allclose(out_t["depth_fine"].detach().numpy()[m],
                               A(out_j["depth_fine"])[m], rtol=1e-3,
                               atol=2e-4)
    for k in ("vis_img", "vis_img_all", "tar_img", "tar_alpha", "img_in",
              "input_mask", "input_densepose", "tar_densepose"):
        np.testing.assert_array_equal(out_t[k].numpy(), A(out_j[k]),
                                      err_msg=k)
    assert 0 < out_t["vis_img_all"].mean() < 1


def test_texture_path_grads_match_flax_f64():
    """The encoders and the texture fusion's vertex table (the global-
    context convs included) in float64 on both sides: the gradients the
    f32 train-step test holds loosely on the texture path are right."""
    g, _ = h.converted_params()
    jm = h.jax_model()
    batch, _ = h.synthetic_batch()
    rs = np.random.RandomState(18)
    img = batch["src_img"].astype(np.float64)
    vert_xy = rs.uniform(-1, 1, (1, 2 * h.NUM_V, 2))
    with jax.enable_x64(True):
        g64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                           g)
        fg, ft = jm.apply(g64, jnp.asarray(img), method=jm.encode)
        ws = [rs.randn(*np.shape(x)) for x in (fg[0], fg[1], ft)]
        w_tab = rs.randn(1, 2 * h.NUM_V, 29)

        def j_loss(params):
            fg, ft = jm.apply(params, jnp.asarray(img), method=jm.encode)
            tab = jm.apply(params, ft, jnp.asarray(img),
                           jnp.asarray(vert_xy),
                           method=lambda m, *a: m.tex_vis_fusion
                           .vertex_table(*a))
            return (sum((x * jnp.asarray(w)).sum()
                        for x, w in zip((fg[0], fg[1], ft), ws))
                    + (tab * jnp.asarray(w_tab)).sum())

        val_j, g_j = jax.jit(jax.value_and_grad(j_loss))(g64)
        g_j = from_jax_params(jax.tree.map(
            lambda a: np.asarray(a, np.float64), g_j))
    model = h.port_model().double()
    (fg0, fg1), ft_t = model.encode(T(img))
    tab = model.tex_vis_fusion.vertex_table(ft_t, T(img), T(vert_xy))
    loss = (sum((x * T(w)).sum() for x, w in zip((fg0, fg1, ft_t), ws))
            + (tab * T(w_tab)).sum())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(val_j), rtol=1e-9)
    pairs = [(name, p.grad.numpy(), g_j[name].numpy().reshape(p.shape))
             for name, p in model.named_parameters()
             if p.grad is not None and name.startswith(
                 TEX_PATH + ("geo_encoder.", "tex_vis_fusion."))]
    assert len(pairs) > 100
    # atol: the structurally zero gradients (conv biases in front of
    # instance norms) are f64 rounding noise, ~1e-12
    scale = max(np.abs(ref).max() for _, _, ref in pairs)
    for name, got, ref in pairs:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9 * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# optimizers and the whole GAN step
# ---------------------------------------------------------------------------

def test_adam_schedule_matches_optax():
    """Adam, the step-counted MultiStepLR and gradient accumulation against
    optax.MultiSteps(adam(piecewise_constant_schedule))."""
    import optax
    from vanerf_tpu.training.train_step import make_lr_schedule
    from vanerf_tpu_torch.training import AdamSchedule
    rs = np.random.RandomState(19)
    p0 = rs.randn(5).astype(np.float32)
    grads = [rs.randn(5).astype(np.float32) for _ in range(12)]
    for k in (1, 2):
        tx = optax.adam(make_lr_schedule(0.1, 1))
        if k > 1:
            tx = optax.MultiSteps(tx, every_k_schedule=k)
        pj, st = jnp.asarray(p0), None
        st = tx.init(pj)
        pt = torch.nn.Parameter(T(p0))
        opt = AdamSchedule([pt], 0.1, 1, every_k=k)
        for gr in grads:
            upd, st = tx.update(jnp.asarray(gr), st, pj)
            pj = optax.apply_updates(pj, upd)
            opt.step([T(gr)])
            np.testing.assert_allclose(pt.detach().numpy(), A(pj),
                                       rtol=1e-5, atol=1e-6)
        # 12 calls = 12 / k updates, past the 2, 5 and 10 milestones
        assert opt.sched.last_epoch == 12 // k


def _capture():
    """An optax transformation that keeps the incoming gradients as its
    state and passes them on unchanged."""
    import optax
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))


@pytest.mark.parametrize("faithful", [
    # the faithful JAX step compiles two renders: over a minute on one CPU
    pytest.param(True, marks=pytest.mark.slow), False])
def test_train_step_matches_jax(faithful, exact):
    """One G step and one D step: losses, gradients and post-Adam
    parameters against ``make_train_step`` with the JAX draws fed in.  In
    the faithful mode the port's D render runs through the JAX package's
    post-Adam generator, so that the D step is compared on the same patch
    (the bounds of the module note hold for the G update itself)."""
    import optax
    from vanerf_tpu.models import DiscriminatorVis as JDisc
    from vanerf_tpu.training.train_step import (TrainState,
                                                make_lr_schedule,
                                                make_train_step as j_make)
    from vanerf_tpu_torch.training import (create_train_state,
                                           make_train_step)
    cfg = _train_cfg(faithful)
    g, _ = h.converted_params()
    d = _disc_params()
    jb = _jbatch()
    vgg_j, vgg_t = _vgg_pair()
    sched = make_lr_schedule(cfg["training"]["lr"], 10)
    tx_g = optax.chain(_capture(), optax.adam(sched))
    tx_d = optax.chain(_capture(), optax.adam(sched))
    state = TrainState(g, d, tx_g.init(g), tx_d.init(d),
                       jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(3)
    new, logs_j = jax.jit(j_make(h.jax_model(), JDisc(), tx_g, tx_d, cfg,
                                 vgg_j))(state, jb, rng)
    rg, rd = jax.random.split(rng)
    draws = {"g": _jax_draws(rg, jb), "d": _jax_draws(rd, jb)}

    np_tree = lambda t: jax.tree.map(np.asarray, t)        # noqa: E731
    model = h.port_model()
    disc = DiscriminatorVis()
    disc.load_state_dict(disc_from_jax_params(d), strict=True)
    st = create_train_state(model, disc, cfg, steps_per_epoch=10)
    jg_post = from_jax_params(np_tree(new.params_g))
    seen = {}
    for tag, opt in (("g", st.opt_g), ("d", st.opt_d)):
        def hooked(grads, orig=opt.step, tag=tag):
            seen[tag] = grads
            orig(grads)
            if tag == "g":
                seen["g_post"] = {k: v.clone()
                                  for k, v in model.state_dict().items()}
                if faithful:
                    model.load_state_dict(jg_post)
        opt.step = hooked
    logs_t = make_train_step(model, disc, cfg, vgg_t)(
        st, h.torch_batch(h.synthetic_batch()[0]), draws=draws)

    assert set(logs_t) == set(logs_j)
    for k in logs_j:
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)

    for tag, mod, conv, p0, p1, post_t in (
            ("g", model, from_jax_params, g, new.params_g, seen["g_post"]),
            ("d", disc, disc_from_jax_params, d, new.params_d,
             None)):
        grads_j = conv(np_tree((new.opt_g if tag == "g" else new.opt_d)[0]))
        before, after = conv(np_tree(p0)), conv(np_tree(p1))
        post_t = post_t if post_t is not None else mod.state_dict()
        names = [n for n, _ in mod.named_parameters()]
        params = (st.opt_g if tag == "g" else st.opt_d).params
        total = np.sqrt(sum(float((grads_j[n].numpy() ** 2).sum())
                            for n in names))
        for n, p, gt in zip(names, params, seen[tag]):
            gj = grads_j[n].numpy().reshape(p.shape)
            gt = np.zeros(p.shape) if gt is None else gt.numpy()
            tex = n.startswith(TEX_PATH)
            if np.linalg.norm(gj) < 1e-6 * total:
                assert np.linalg.norm(gt) < 1e-6 * total, n
                continue
            assert _rel(gt, gj) <= (5e-2 if tex else 1e-3), (n, _rel(gt, gj))
            if tex:
                continue
            upd_j = (after[n].numpy() - before[n].numpy()).reshape(-1)
            upd_t = (post_t[n].numpy().reshape(-1)
                     - before[n].numpy().reshape(-1))
            a = np.abs(gj.reshape(-1))
            sel = a >= max(1e-6, 0.1 * np.sqrt((a ** 2).mean()))
            assert _rel(upd_t[sel], upd_j[sel]) <= 1e-3, n
