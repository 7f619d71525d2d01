"""Port modules (vanerf_tpu_torch.models) against the flax modules, on the
CPU, with the same weights: a torch reference replica converted to flax
(``convert_state_dict``) and back to the port (``from_jax_params``).

Tolerance rtol 1e-4 / atol 1e-5 (f32 on both sides; convolutions and
matmuls sum in other orders).  The bicubic upsample inside the hourglass
uses the JAX package's exact separable matrix in both packages.

The texture encoder (instance norms behind every conv, four residual
blocks) amplifies f32 rounding: each package alone is ~3e-5 away from its
own float64 result at these random weights.  There the architecture is
held at rtol 1e-4 / atol 1e-5 in float64 on both sides, and the float32
outputs at rtol 1e-3 / atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers as h
from vanerf_tpu_torch import models as tm
from vanerf_tpu_torch.weights import from_jax_params

RTOL, ATOL = 1e-4, 1e-5


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                        tree)


@pytest.fixture(scope="module")
def params():
    g, sd = h.converted_params()
    return g["params"], sd


@pytest.fixture(scope="module")
def port():
    return h.port_model()


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_from_jax_params_fills_every_key(params):
    g, _ = params
    model = tm.VANeRF.from_config(h.small_cfg(), num_v=h.NUM_V,
                                  image_hw=(h.H, h.W))
    sd = from_jax_params({"params": g})
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    model.load_state_dict(sd, strict=True)


def test_from_jax_params_inverts_convert_state_dict(params):
    """replica state_dict -> convert_state_dict -> from_jax_params returns
    the replica's own tensors under the same (reference) key names."""
    g, sd_ref = params
    sd = from_jax_params(g)
    for k, v in sd.items():
        ref = sd_ref[f"model.{k}"]
        assert ref.shape == tuple(v.shape), k
        np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def test_hgfilter_matches_flax(params, port):
    from vanerf_tpu.models.blocks import HGFilter
    x = np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32) * 2 - 1
    coarse_j, fine_j = HGFilter(n_stack=1, n_downsample=2, out_ch=64).apply(
        {"params": params[0]["geo_encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        coarse_t, fine_t = port.geo_encoder(T(x))
    assert coarse_t.shape == (1, 8, 8, 64) and fine_t.shape == (1, 32, 32, 8)
    close(coarse_t, coarse_j)
    close(fine_t, fine_j)


def test_upsample2_bicubic_matches_jax():
    from vanerf_tpu.models.blocks import upsample2_bicubic
    from vanerf_tpu_torch.models.blocks import upsample2_bicubic as up_t
    x = np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32)
    got = up_t(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, upsample2_bicubic(jnp.asarray(x)), rtol=1e-5, atol=1e-6)


def test_resblk_encoder_matches_flax(params, port):
    from vanerf_tpu.models.blocks import ResBlkEncoder
    cfg = h.small_cfg()["models"]["VANeRF"]["tex_args"]
    x = np.random.RandomState(2).rand(1, 16, 16, 3).astype(np.float32) * 2 - 1
    mod = ResBlkEncoder(out_ch=cfg["out_ch"], ngf=cfg["ngf"],
                        n_downsample=cfg["n_downsample"],
                        n_blocks=cfg["n_blocks"],
                        n_upsample=cfg["n_upsample"])
    out_j = mod.apply({"params": params[0]["tex_encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        out_t = port.tex_encoder(T(x))
    assert out_t.shape == (1, 8, 8, 8)
    close(out_t, out_j, rtol=1e-3, atol=1e-4)
    with jax.enable_x64(True):
        out_j64 = mod.apply({"params": f64(params[0]["tex_encoder"])},
                            jnp.asarray(x.astype(np.float64)))
    with torch.no_grad():
        out_t64 = h.port_model().double().tex_encoder(T(x).double())
    close(out_t64, out_j64)


def test_encode_matches_flax(port):
    g, _ = h.converted_params()
    batch, _ = h.synthetic_batch()
    jm = h.jax_model()
    fg_j, ft_j = jm.apply(g, jnp.asarray(batch["src_img"]),
                          method=jm.encode)
    with torch.no_grad():
        fg_t, ft_t = port.encode(T(batch["src_img"]))
    for a, b in zip(fg_t + [ft_t], list(fg_j) + [ft_j]):
        assert tuple(a.shape) == tuple(np.shape(b))
        close(a, b, rtol=1e-3, atol=1e-4)
    with jax.enable_x64(True):
        fg_j, ft_j = jm.apply(f64(g), jnp.asarray(
            batch["src_img"].astype(np.float64)), method=jm.encode)
    with torch.no_grad():
        fg_t, ft_t = h.port_model().double().encode(
            T(batch["src_img"]).double())
    for a, b in zip(fg_t + [ft_t], list(fg_j) + [ft_j]):
        close(a, b)


# ---------------------------------------------------------------------------
# per-point networks
# ---------------------------------------------------------------------------

def test_mlp_unet_fusion_matches_flax(params, port):
    from vanerf_tpu.models.mlp import MLPUNetFusion
    cfg = h.small_cfg()["models"]["VANeRF"]["mlp_geo_args"]
    n_dims1 = [7 * 42] + list(cfg["n_dims1"][1:])
    rs = np.random.RandomState(3)
    B, V, N = 1, 1, 13
    x = rs.randn(B, V, N, n_dims1[0]).astype(np.float32)
    feats = [rs.randn(B, V, N, c).astype(np.float32)
             for c in cfg["skip_dims"]]
    a = (rs.rand(B, V, N, 1) > 0.3).astype(np.float32)
    w = rs.rand(B, V, N, 1).astype(np.float32) * a
    outs_j = MLPUNetFusion(n_dims1, cfg["n_dims2"], cfg["skip_dims"],
                           cfg["skip_layers"],
                           pool_types=cfg["pool_types"]).apply(
        {"params": params[0]["mlp_geo"]}, jnp.asarray(x),
        [jnp.asarray(f) for f in feats], jnp.asarray(a), jnp.asarray(w))
    with torch.no_grad():
        outs_t = port.mlp_geo(T(x), [T(f) for f in feats], T(a), T(w))
    for a_t, a_j in zip(outs_t, outs_j):
        close(a_t.float(), np.asarray(a_j).astype(np.float32))


def test_spatial_encoder_rel_z_decay_matches_jax():
    from vanerf_tpu.models.spatial import SpatialEncoder
    sp = h.small_cfg()["models"]["VANeRF"]["sp_args"]
    batch, _ = h.synthetic_batch()
    v = h.two_hand_points(40, seed=5)[None]
    extrin = batch["src_extrin"]
    kpt = batch["kpt3d"]
    kw = dict(sp_level=sp["sp_level"], sp_type=sp["sp_type"],
              scale=sp["scale"], n_kpt=sp["n_kpt"], sigma=sp["sigma"])
    y_j = SpatialEncoder(**kw)(v=jnp.asarray(v), pts=jnp.asarray(v),
                               z=jnp.zeros((1, 40, 1)),
                               xy=jnp.zeros((1, 40, 2)),
                               extrin=jnp.asarray(extrin),
                               kpt3d=jnp.asarray(kpt))
    enc = tm.SpatialEncoder(**kw)
    y_t = enc(v=T(v), extrin=T(extrin), kpt3d=T(kpt))
    assert y_t.shape == (1, 40, enc.get_dim()) == (1, 40, 294)
    close(y_t, y_j, rtol=1e-5, atol=1e-6)
    # the nine other types are held by tests/test_torch_variants.py; an
    # unknown one raises at the call, as in JAX
    with pytest.raises(ValueError, match="unknown sp_type"):
        tm.SpatialEncoder(sp_type="rel_bogus")(v=T(v), extrin=T(extrin),
                                               kpt3d=T(kpt))


def _fusion_inputs(seed, N=17, V2=2 * h.NUM_V):
    rs = np.random.RandomState(seed)
    return dict(
        vert_xy=(rs.rand(1, V2, 2) * 2 - 1).astype(np.float32),
        fg0=rs.randn(1, 4, 4, 64).astype(np.float32),
        fg1=rs.randn(1, 32, 32, 8).astype(np.float32),
        fs0=rs.randn(1, N, 64).astype(np.float32),
        fs1=rs.randn(1, N, 8).astype(np.float32),
        vert=rs.randn(1, V2, 3).astype(np.float32),
        v=rs.randn(1, N, 3).astype(np.float32),
        vert_vis=(rs.rand(1, V2, 1) > 0.5).astype(np.float32),
        query_vis=(rs.rand(1, N, 1) > 0.5).astype(np.float32),
        query_sdf=(rs.randn(1, N, 1) * 0.01).astype(np.float32),
        ft1=rs.randn(1, 8, 8, 8).astype(np.float32),
        img=rs.rand(1, 32, 32, 3).astype(np.float32),
        ft_xy=rs.randn(1, N, 8).astype(np.float32),
        img_xy=rs.rand(1, N, 3).astype(np.float32),
        latent=rs.randn(1, N, 24).astype(np.float32))


def test_geo_vis_fusion_matches_flax(params, port):
    from vanerf_tpu.models.fusion import GeoVisFusion
    d = _fusion_inputs(6)
    outs_j = GeoVisFusion(num_v=h.NUM_V).apply(
        {"params": params[0]["geo_vis_fusion"]}, jnp.asarray(d["vert_xy"]),
        [jnp.asarray(d["fg0"]), jnp.asarray(d["fg1"])],
        [jnp.asarray(d["fs0"]), jnp.asarray(d["fs1"])],
        jnp.asarray(d["vert"]), jnp.asarray(d["v"]),
        jnp.asarray(d["vert_vis"]), jnp.asarray(d["query_vis"]),
        jnp.asarray(d["query_sdf"]))
    with torch.no_grad():
        outs_t = port.geo_vis_fusion(
            T(d["vert_xy"]), [T(d["fg0"]), T(d["fg1"])],
            [T(d["fs0"]), T(d["fs1"])], T(d["vert"]), T(d["v"]),
            T(d["vert_vis"]), T(d["query_vis"]), T(d["query_sdf"]))
    for a, b in zip(outs_t, outs_j):
        close(a, b)


def test_tex_vis_fusion_matches_flax(params, port):
    from vanerf_tpu.models.fusion import TexVisFusion
    d = _fusion_inputs(7)
    out_j = TexVisFusion(num_v=h.NUM_V).apply(
        {"params": params[0]["tex_vis_fusion"]}, jnp.asarray(d["vert_xy"]),
        jnp.asarray(d["ft1"]), jnp.asarray(d["ft_xy"]),
        jnp.asarray(d["vert"]), jnp.asarray(d["v"]),
        jnp.asarray(d["vert_vis"]), jnp.asarray(d["query_vis"]),
        jnp.asarray(d["img_xy"]), jnp.asarray(d["img"]),
        jnp.asarray(d["latent"]))
    with torch.no_grad():
        out_t = port.tex_vis_fusion(
            T(d["vert_xy"]), T(d["ft1"]), T(d["ft_xy"]), T(d["vert"]),
            T(d["v"]), T(d["vert_vis"]), T(d["query_vis"]), T(d["img_xy"]),
            T(d["img"]), T(d["latent"]))
    assert out_t.shape == (1, 17, 40)
    close(out_t, out_j)


def test_ibr_head_matches_flax(params, port):
    from vanerf_tpu.models.ibr import IBRRenderingHead
    rs = np.random.RandomState(8)
    R, S, V = 5, 4, 2
    feats = rs.randn(R, S, V, 40).astype(np.float32)
    diffs = rs.randn(R, S, V, 4).astype(np.float32)
    mask = (rs.rand(R, S, V, 1) > 0.2).astype(np.float32)
    out_j = IBRRenderingHead().apply({"params": params[0]["mlp_tex"]},
                                     jnp.asarray(feats), jnp.asarray(diffs),
                                     jnp.asarray(mask))
    with torch.no_grad():
        out_t = port.mlp_tex(T(feats), T(diffs), T(mask))
    close(out_t, out_j)


def test_query_matches_flax(port):
    """VANeRF.query on rendered-patch points with the same mesh priors and
    nearest-vertex ids on both sides (with and without the far mask)."""
    from vanerf_tpu.ops.knn import nearest_vertex_d2
    g, _ = h.converted_params()
    jm = h.jax_model()
    batch, _ = h.synthetic_batch()
    rs = np.random.RandomState(9)
    N, S = 128, 8
    pts = h.two_hand_points(N, seed=10)[None]
    view = rs.randn(1, N, 3).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    vv = (rs.rand(1, 2 * h.NUM_V, 1) > 0.3).astype(np.float32)
    qv = (rs.rand(1, N, 1) > 0.5).astype(np.float32)
    qs = (rs.randn(1, N, 1) * 0.01).astype(np.float32)
    far = rs.rand(1, N, 1) > 0.5
    nn_idx = np.asarray(nearest_vertex_d2(jnp.asarray(pts[0]),
                                          jnp.asarray(batch["verts"][0]))[0])
    fg_j, ft_j = jm.apply(g, jnp.asarray(batch["src_img"]), method=jm.encode)
    cam = {"KRT": batch["src_krt"], "extrin": batch["src_extrin"],
           "width": h.W, "height": h.H, "znear": batch["znear"],
           "zfar": batch["zfar"]}
    for far_mask in (None, far):
        out_j, valid_j = jm.apply(
            g, jnp.asarray(pts), jnp.asarray(view),
            {k: jnp.asarray(v) for k, v in cam.items()}, fg_j, ft_j,
            jnp.asarray(batch["src_img"]), jnp.asarray(batch["src_mask"]),
            jnp.asarray(batch["verts"]), jnp.asarray(vv), jnp.asarray(qv),
            jnp.asarray(qs), jnp.asarray(batch["kpt3d"]), S, 1, False,
            nn_idx=jnp.asarray(nn_idx[None]),
            far_mask=None if far_mask is None else jnp.asarray(far_mask),
            method=jm.query)
        cam_t = {k: (T(v) if isinstance(v, np.ndarray) else v)
                 for k, v in cam.items()}
        with torch.no_grad():
            out_t, valid_t = port.query(
                T(pts), T(view), cam_t, [T(f) for f in fg_j], T(ft_j),
                T(batch["src_img"]), T(batch["src_mask"]), T(batch["verts"]),
                T(vv), T(qv), T(qs), T(batch["kpt3d"]), S,
                nn_idx=T(nn_idx[None]),
                far_mask=None if far_mask is None else T(far_mask))
        assert out_t.shape == (1, N, 5)
        assert 0 < valid_t.mean() < 1
        close(valid_t, valid_j)
        close(out_t, out_j)


def test_unported_options_raise(monkeypatch):
    """The options this test once refused build and run now: ``sp_conv``
    (the dense voxel branch, against JAX in tests/test_torch_voxel.py),
    the other sp_types, VANERF_TWO_RES / VANERF_PE_DIRECT and the MLP /
    norm options (tests/test_torch_variants.py); VANERF_REMAT_QUERY is
    read in training only (as JAX reads it), so it changes nothing here."""
    from vanerf_tpu_torch.models.voxel_fusion import (GeoVisFusionSP,
                                                      TexVisFusionSP)
    cfg = h.small_cfg()
    cfg["models"]["VANeRF"]["sp_conv"] = True
    m = tm.VANeRF.from_config(cfg, num_v=h.NUM_V, image_hw=(h.H, h.W))
    assert m.sp_conv and m.voxel_grid == (64, 64, 64) and not m.fused_ok
    assert isinstance(m.geo_vis_fusion, GeoVisFusionSP)
    assert isinstance(m.tex_vis_fusion, TexVisFusionSP)
    from vanerf_tpu_torch.models.vanerf import _check_env
    from vanerf_tpu_torch.renderer import remat_query_mode
    for env in ("VANERF_TWO_RES", "VANERF_PE_DIRECT", "VANERF_REMAT_QUERY"):
        monkeypatch.setenv(env, "1")
        _check_env()
    assert remat_query_mode(training=False) == 0
    assert remat_query_mode(training=True) == 1


def test_query_skips_kernel_d_under_training(port, monkeypatch):
    """Kernel D has no gradient: a training query, or any query under an
    autograd graph, samples the small maps with the gather path (as JAX,
    ``models/vanerf.py:304-324``); only a no-grad eval query takes it."""
    from vanerf_tpu_torch.models import vanerf as tv
    batch = h.torch_batch(h.synthetic_batch()[0])
    calls = []
    real = tv.interp_sample_nhwc
    monkeypatch.setattr(tv, "interp_sample_nhwc",
                        lambda f, xy: calls.append(f.shape) or real(f, xy))
    rs = np.random.RandomState(20)
    N = 16
    pts = T(h.two_hand_points(N, seed=21)[None])
    cam = {"KRT": batch["src_krt"], "extrin": batch["src_extrin"],
           "width": h.W, "height": h.H, "znear": batch["znear"],
           "zfar": batch["zfar"]}
    fg, ft = port.encode(batch["src_img"])
    args = (pts, T(rs.randn(1, N, 3).astype(np.float32)), cam, fg, ft,
            batch["src_img"], batch["src_mask"], batch["verts"],
            torch.ones(1, 2 * h.NUM_V, 1), torch.ones(1, N, 1),
            torch.zeros(1, N, 1), batch["kpt3d"], 8)
    with torch.no_grad():
        out_eval, _ = port.query(*args)
    assert len(calls) == 1              # the 16^2 fine geometry map
    out_train, _ = port.query(*args, training=True)
    out_graph, _ = port.query(*args)
    assert len(calls) == 1
    assert out_train.requires_grad and out_graph.requires_grad
    close(out_train, out_eval.numpy())


@pytest.mark.parametrize("hw", [(64, 64), (256, 256), (7, 5)])
def test_adaptive_avg_pool_matches_torch_and_jax(hw):
    """The global context's 3x3 pool as slice means (a backward without
    atomics): torch's bins, values as ``nn.AdaptiveAvgPool2d`` and the JAX
    package's ``adaptive_avg_pool`` to float32 rounding, and the same
    gradient as torch's."""
    from vanerf_tpu.models.fusion import adaptive_avg_pool
    from vanerf_tpu_torch.models.fusion import AdaptiveAvgPool2d
    rs = np.random.RandomState(sum(hw))
    x = rs.randn(2, 5, *hw).astype(np.float32)
    g = rs.randn(2, 5, 3, 3).astype(np.float32)
    res = []
    for pool in (AdaptiveAvgPool2d(3), torch.nn.AdaptiveAvgPool2d(3)):
        xt = T(x).requires_grad_(True)
        y = pool(xt)
        (gx,) = torch.autograd.grad(y, xt, T(g))
        res.append((y, gx))
    (y, gx), (y_ref, gx_ref) = res
    close(y, y_ref.detach(), rtol=1e-6, atol=1e-7)
    close(gx, gx_ref, rtol=1e-6, atol=1e-7)
    want = adaptive_avg_pool(jnp.asarray(x.transpose(0, 2, 3, 1)), 3)
    close(y.permute(0, 2, 3, 1), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("p", [1, 3])
def test_replication_pad_matches_torch(p):
    """The texture encoder's replication padding as expanded edge slices (a
    backward without atomics): equal to ``nn.ReplicationPad2d`` to the bit,
    its gradient to float32 rounding (the border sums in another order)."""
    from vanerf_tpu_torch.models.blocks import ReplicationPad2d
    rs = np.random.RandomState(p)
    x = rs.randn(2, 3, 9, 6).astype(np.float32)
    res = []
    for pad in (ReplicationPad2d(p), torch.nn.ReplicationPad2d(p)):
        xt = T(x).requires_grad_(True)
        y = pad(xt)
        g = T(rs.randn(*y.shape).astype(np.float32)) if not res else res[0][2]
        (gx,) = torch.autograd.grad(y, xt, g)
        res.append((y, gx, g))
    (y, gx, _), (y_ref, gx_ref, _) = res
    assert torch.equal(y, y_ref)
    close(gx, gx_ref, rtol=1e-6, atol=1e-6)
