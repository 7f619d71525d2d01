"""The model's config variants against the JAX package on the CPU, and the
bfloat16 fused kernels' body at widths other than ``configs/vanerf.json``'s.

* the spatial encoder: all ten ``sp_type``s at V = 1 and 2, with
  ``VANERF_PE_DIRECT`` off and on, against ``vanerf_tpu.models.spatial.
  SpatialEncoder``: in float64 on both sides to rtol 1e-12 (the same
  operations in the same order), and in float32 to rtol 1e-6 / atol 4e-6
  (XLA's 3-term matrix products round the transformed points an ulp apart
  from torch's, which the octaves multiply by up to pi 2^L; sin / cos of
  the two libraries a few ulps apart); ``get_dim`` and the errors of an
  unknown type and of a model-space type without ``model_T``;
* ``VANeRF.query`` for ``rel_cxyz`` (the widest encoding), ``mxyz`` with a
  ``model_T``, ``ixyz``, and the geometry MLP with ``nl_layer: elu`` and
  ``pool_types: [max, mean, var]`` beside a texture encoder with
  ``norm: group`` (and ``none``), at rtol 1e-4 / atol 1e-5 (float32 on
  both sides, ``tests/test_torch_models.py``);
* the encode and the training query's gradients in float64 on both sides
  (``mxyz``, ``rel_cxyz``, and elu / max pooling / group norm), every
  parameter to 1e-6: the certificate of the variants' training path;
* an eval ``render_patch`` and a single-render GAN step for ``mxyz`` with
  a ``batch["model_T"]``, at the bounds of ``tests/test_torch_render.py``
  and, for the step's losses, ``tests/test_torch_train.py`` (its
  gradients to 1e-2, the texture path 5e-2: see that test);
* ``VANERF_TWO_RES=1`` on a texture map coarser than the fine geometry map
  (``tex_args.n_upsample: 1``): the sampler against JAX's under the same
  switch, and against the port's own two samplers within the ~1 ulp of
  ``vanerf_tpu/ops/grid_sample.py:125-128``; the query and an eval render
  against JAX under the switch;
* ``VANERF_REMAT_QUERY=1/2``: a single-render GAN step's losses equal to
  the bit, and its gradients equal, to the step without the switch (on
  one thread: the CPU convolutions' weight gradients sum in a thread-
  dependent order);
* the fused gate: under ``VANERF_FUSED_MLP=2`` a config whose network the
  fused kernels do not hold (``nl_layer: elu``; ``sp_type: rel_cxyz``)
  runs the unfused query, equal to JAX's unfused output, and launches no
  fused kernel;
* kernels 11 / 12 in bfloat16 at a width other than ``BF16_DIMS``: the
  weights packed for the mma.sync body (``csrc/fused_mlp.cu``, BF =
  true), every fragment address checked as that body reads it.

Weights: the converted replica of ``torch_port_helpers``, with the layers a
variant reshapes (the first geometry layer, the head's first layer, the
texture encoder's norms and upsampling) drawn from a numpy seed and given
to both packages.
"""

import contextlib
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers as h
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.models import spatial as ts
from vanerf_tpu_torch.ops import fused_mlp as tf
from vanerf_tpu_torch.weights import from_jax_params

SP_TYPES = ["z", "ixyz", "cxyz", "mxyz", "wxyz", "rel_z", "rel_z_decay",
            "rel_cxyz", "rel_wxyz", "rel_mxyz"]
RTOL, ATOL = 1e-4, 1e-5


def T(x):
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def A(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture
def exact(monkeypatch):
    monkeypatch.setenv("VANERF_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("VANERF_FAR_TAU", "0")
    monkeypatch.setenv("VANERF_ONEHOT_BN", "16")
    with jax.default_matmul_precision("highest"):
        yield monkeypatch


# ---------------------------------------------------------------------------
# the spatial encoder
# ---------------------------------------------------------------------------

def _encoder_inputs(sp_type, n_view):
    rng = np.random.default_rng(SP_TYPES.index(sp_type) * 10 + n_view)
    B, N, K = 2, 13, 5
    BV = B * n_view
    f32 = np.float32
    pts = rng.uniform(-1, 1, (B, N, 3)).astype(f32)
    extrin = np.tile(np.eye(4, dtype=f32), (BV, 1, 1))
    extrin[:, :3, :] += 0.1 * rng.standard_normal((BV, 3, 4)).astype(f32)
    model_T = np.tile(np.eye(4, dtype=f32), (B, 1, 1))
    model_T[:, :3, :] += 0.1 * rng.standard_normal((B, 3, 4)).astype(f32)
    return dict(v=np.repeat(pts, n_view, 0), pts=pts,
                z=rng.uniform(0, 1, (BV, N, 1)).astype(f32),
                xy=rng.uniform(0, 1, (BV, N, 2)).astype(f32), extrin=extrin,
                kpt3d=rng.uniform(-1, 1, (B, K, 3)).astype(f32),
                n_view=n_view, model_T=model_T)


ENC_KW = dict(sp_level=3, scale=0.7, n_kpt=5, sigma=0.4,
              center=(0.1, -0.2, 0.3))


@pytest.mark.parametrize("pe_direct", ["0", "1"])
@pytest.mark.parametrize("n_view", [1, 2])
@pytest.mark.parametrize("sp_type", SP_TYPES)
def test_spatial_encoder_matches_jax(sp_type, n_view, pe_direct):
    from vanerf_tpu.models.spatial import SpatialEncoder as JEnc
    x = _encoder_inputs(sp_type, n_view)
    enc_j = JEnc(sp_type=sp_type, **ENC_KW)
    enc_t = ts.SpatialEncoder(sp_type=sp_type, **ENC_KW)

    def both(dt):
        out_j = enc_j(**{k: (jnp.asarray(v.astype(dt))
                             if isinstance(v, np.ndarray) else v)
                         for k, v in x.items()})
        if isinstance(out_j, (list, tuple)):
            out_j = jnp.concatenate(out_j, -1)
        out_t = enc_t(**{k: (T(v.astype(dt)) if isinstance(v, np.ndarray)
                             else v) for k, v in x.items()})
        assert out_t.dtype == torch.from_numpy(np.zeros(1, dt)).dtype
        assert tuple(out_t.shape) == tuple(out_j.shape)
        return A(out_t), A(out_j)

    with _env(VANERF_PE_DIRECT=pe_direct):
        got, want = both(np.float32)
        with jax.enable_x64(True):
            got64, want64 = both(np.float64)
    assert enc_t.get_dim() == enc_j.get_dim() == got.shape[-1]
    np.testing.assert_allclose(got64, want64, rtol=1e-12, atol=1e-12,
                               err_msg=f"{sp_type} V={n_view} float64")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=4e-6,
                               err_msg=f"{sp_type} V={n_view}")


def test_pe_direct_is_another_formula():
    """VANERF_PE_DIRECT=1 changes the octaves' rounding, not their values:
    the two forms differ by float32 rounding only, and do differ."""
    x = T(np.linspace(-3, 3, 1001, dtype=np.float32)[:, None])
    rec = ts.position_embedding(x, 4)
    with _env(VANERF_PE_DIRECT="1"):
        direct = ts.position_embedding(x, 4)
    assert not torch.equal(rec, direct)
    np.testing.assert_allclose(A(rec), A(direct), atol=2e-5)


@pytest.mark.parametrize("sp_type", ["bogus", "mxyz", "rel_mxyz"])
def test_spatial_encoder_errors_match_jax(sp_type):
    """An unknown type, and a model-space type without model_T, raise
    ValueError in both packages (vanerf_tpu/models/spatial.py:161-163,
    :177-179)."""
    from vanerf_tpu.models.spatial import SpatialEncoder as JEnc
    x = _encoder_inputs("mxyz", 1)
    x["model_T"] = None
    match = "unknown sp_type" if sp_type == "bogus" else "model_T"
    with pytest.raises(ValueError, match=match):
        JEnc(sp_type=sp_type, **ENC_KW)(
            **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in x.items()})
    with pytest.raises(ValueError, match=match):
        ts.SpatialEncoder(sp_type=sp_type, **ENC_KW)(
            **{k: (T(v) if isinstance(v, np.ndarray) else v)
               for k, v in x.items()})
    assert (ts.SpatialEncoder(sp_type=sp_type, **ENC_KW).get_dim()
            == JEnc(sp_type=sp_type, **ENC_KW).get_dim())


def test_rel_z_decay_unchanged():
    """The shipped type is the earlier port's expression, op for op: equal
    to the bit to it written out again."""
    x = _encoder_inputs("rel_z_decay", 2)
    enc = ts.SpatialEncoder(sp_type="rel_z_decay", **ENC_KW)
    got = enc(**{k: (T(v) if isinstance(v, np.ndarray) else v)
                 for k, v in x.items()})
    v, extrin = T(x["v"]), T(x["extrin"])
    kpt = T(x["kpt3d"]).repeat_interleave(2, 0)
    R = extrin[:, :3, :3].transpose(-1, -2)
    t = extrin[:, None, :3, 3]
    cxyz, kptxyz = v @ R + t, kpt @ R + t
    dz = 0.7 * (cxyz[:, :, None, 2:3] - kptxyz[:, None, :, 2:3])
    dxyz = cxyz[:, :, None] - kptxyz[:, None, :]
    w = torch.exp(-(dxyz ** 2).sum(-1, keepdim=True) / (2.0 * 0.4 ** 2))
    want = ts.position_embedding(dz.reshape(*dz.shape[:2], -1), 3,
                                 weight=w.reshape(*w.shape[:2], -1))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# variant models: the converted replica, reshaped layers drawn from a seed
# ---------------------------------------------------------------------------

def _fresh(rs, *shape, scale=None):
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return (rs.standard_normal(shape) * s).astype(np.float32)


def variant(edit=None, seed=11):
    """(cfg, flax params) of the small config edited by ``edit`` (on
    ``models.VANeRF``), with the converted replica's weights where their
    shapes hold and seeded draws where the variant reshapes a layer."""
    from vanerf_tpu.models.spatial import SpatialEncoder as JEnc
    cfg = h.small_cfg()
    m = cfg["models"]["VANeRF"]
    if edit:
        edit(m)
    g0, _ = h.converted_params()
    p = copy.deepcopy(jax.tree.map(np.asarray, g0["params"]))
    rs = np.random.RandomState(seed)
    sp, mg, tx = m["sp_args"], m["mlp_geo_args"], m["tex_args"]
    enc_dim = JEnc(sp_level=sp["sp_level"], sp_type=sp["sp_type"],
                   n_kpt=sp["n_kpt"]).get_dim()
    l0 = p["mlp_geo"]["layers1"]["l0"]
    if l0["v"].shape[0] != enc_dim + mg["skip_dims"][0]:
        l0["v"] = _fresh(rs, enc_dim + mg["skip_dims"][0], l0["v"].shape[1])
    h0 = p["mlp_geo"]["layers2"]["l0"]
    pooled = len(mg["pool_types"]) * mg["n_dims1"][-1]
    if h0["v"].shape[0] != pooled:
        h0["v"] = _fresh(rs, pooled, h0["v"].shape[1])
        gc = p["ibr_compress_gfeat"]
        gc["kernel"] = _fresh(rs, pooled, gc["kernel"].shape[1])
    te = p["tex_encoder"]
    n_down, n_up = tx["n_downsample"], tx["n_upsample"]
    if n_up != 2:
        for u in range(n_up, 2):
            te.pop(f"up{u}")
        ch = te[f"up{n_up - 1}"]["kernel"].shape[2] if n_up else \
            te[f"Conv_{n_down}"]["kernel"].shape[3]
        last = f"Conv_{n_down + 1}"
        te[last] = {"kernel": _fresh(rs, 7, 7, ch, tx["out_ch"]),
                    "bias": np.zeros(tx["out_ch"], np.float32)}
        hw = (h.H >> m["ds_tex"] >> n_down) << n_up
        f3 = p["tex_vis_fusion"]["fconv3"]
        for k in ("ln0_scale", "ln1_scale"):
            f3[k] = np.ones((hw, hw, 1), np.float32)
        for k in ("ln0_bias", "ln1_bias"):
            f3[k] = _fresh(rs, hw, hw, 1, scale=0.1)
    if tx.get("norm", "instance") == "group":
        def gn(q, name, ch):
            q[name] = {"scale": 1.0 + _fresh(rs, ch, scale=0.1),
                       "bias": _fresh(rs, ch, scale=0.1)}
        gn(te, "GroupNorm_0", te["Conv_0"]["kernel"].shape[3])
        for i in range(n_down):
            gn(te, f"GroupNorm_{i + 1}",
               te[f"Conv_{i + 1}"]["kernel"].shape[3])
        for name, q in te.items():
            if name.startswith("ResBlk_"):
                c = q["Conv_0"]["kernel"].shape[3]
                gn(q, "GroupNorm_0", c)
                gn(q, "GroupNorm_1", c)
        for u in range(n_up):
            gn(te, f"GroupNorm_{n_down + 1 + u}",
               te[f"up{u}"]["kernel"].shape[2])
    return cfg, {"params": p}


def models(cfg, g):
    """(JAX model, port model) of ``cfg`` carrying the params ``g``."""
    from vanerf_tpu.models import VANeRF as JVANeRF
    from vanerf_tpu_torch.models import VANeRF
    port = VANeRF.from_config(cfg, num_v=h.NUM_V, image_hw=(h.H, h.W))
    port.load_state_dict(from_jax_params(g), strict=True)
    return JVANeRF.from_config(cfg, num_v=h.NUM_V), port.eval()


def _set(path, value):
    def edit(m):
        d = m
        for k in path[:-1]:
            d = d[k]
        d[path[-1]] = value
    return edit


def _edits(*edits):
    def edit(m):
        for e in edits:
            e(m)
    return edit


MODEL_T = np.array([[[0.8, -0.6, 0.0, 0.05], [0.6, 0.8, 0.0, -0.02],
                     [0.0, 0.0, 1.0, 0.3], [0.0, 0.0, 0.0, 1.0]]],
                   np.float32)

QUERY_CASES = {
    "rel_cxyz": _set(("sp_args", "sp_type"), "rel_cxyz"),
    "mxyz": _set(("sp_args", "sp_type"), "mxyz"),
    "ixyz": _set(("sp_args", "sp_type"), "ixyz"),
    "elu_max_group": _edits(_set(("mlp_geo_args", "nl_layer"), "elu"),
                            _set(("mlp_geo_args", "pool_types"),
                                 ["max", "mean", "var"]),
                            _set(("tex_args", "norm"), "group")),
}


def _query_pair(jm, g, port, batch, S=8, model_T=None, **kw):
    """(port (out, valid), JAX (out, valid)) of one eval query on the JAX
    encoder's maps (tests/test_torch_views.py::_queries at one view)."""
    from vanerf_tpu.ops.knn import nearest_vertex_d2
    rs = np.random.RandomState(9)
    N = 128
    pts = h.two_hand_points(N, seed=10)[None]
    view = rs.randn(1, N, 3).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    vv = (rs.rand(1, 2 * h.NUM_V, 1) > 0.3).astype(np.float32)
    qv = (rs.rand(1, N, 1) > 0.5).astype(np.float32)
    qs = (rs.randn(1, N, 1) * 0.01).astype(np.float32)
    nn_idx = np.asarray(nearest_vertex_d2(
        jnp.asarray(pts[0]), jnp.asarray(batch["verts"][0]))[0])[None]
    cam = {"KRT": batch["src_krt"], "extrin": batch["src_extrin"],
           "width": h.W, "height": h.H, "znear": batch["znear"],
           "zfar": batch["zfar"]}
    fg, ft = jm.apply(g, jnp.asarray(batch["src_img"]), method=jm.encode)
    out_j = jm.apply(
        g, jnp.asarray(pts), jnp.asarray(view),
        {k: jnp.asarray(v) for k, v in cam.items()}, fg, ft,
        jnp.asarray(batch["src_img"]), jnp.asarray(batch["src_mask"]),
        jnp.asarray(batch["verts"]), jnp.asarray(vv), jnp.asarray(qv),
        jnp.asarray(qs), jnp.asarray(batch["kpt3d"]), S, 1, False,
        nn_idx=jnp.asarray(nn_idx),
        model_T=None if model_T is None else jnp.asarray(model_T),
        method=jm.query, **kw)
    cam_t = {k: (T(v) if isinstance(v, np.ndarray) else v)
             for k, v in cam.items()}
    with torch.no_grad():
        out_t = port.query(
            T(pts), T(view), cam_t, [T(f) for f in fg], T(ft),
            T(batch["src_img"]), T(batch["src_mask"]), T(batch["verts"]),
            T(vv), T(qv), T(qs), T(batch["kpt3d"]), S, nn_idx=T(nn_idx),
            model_T=None if model_T is None else T(model_T))
    return out_t, out_j


@pytest.mark.parametrize("case", list(QUERY_CASES))
def test_query_variant_matches_jax(case, exact):
    """VANeRF.query of the variant against JAX's on JAX's maps; the
    texture encoder's maps too where the variant changes its norm."""
    cfg, g = variant(QUERY_CASES[case])
    jm, port = models(cfg, g)
    batch, _ = h.synthetic_batch()
    (out_t, valid_t), (out_j, valid_j) = _query_pair(
        jm, g, port, batch, model_T=MODEL_T if case == "mxyz" else None)
    assert 0 < A(valid_t).mean() < 1
    np.testing.assert_array_equal(A(valid_t), A(valid_j))
    np.testing.assert_allclose(A(out_t), A(out_j), rtol=RTOL,
                               atol=ATOL * np.abs(A(out_j)).max())
    if case == "elu_max_group":
        fg_j, ft_j = jm.apply(g, jnp.asarray(batch["src_img"]),
                              method=jm.encode)
        with torch.no_grad():
            fg_t, ft_t = port.encode(T(batch["src_img"]))
        np.testing.assert_allclose(A(ft_t), A(ft_j), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("norm", ["group", "none"])
def test_tex_encoder_norms_match_flax(norm):
    """The texture encoder with group and no norms against flax's, in
    float64 on both sides (the module note of tests/test_torch_models.py:
    float32 rounding is amplified by the stacked norms at random
    weights)."""
    from vanerf_tpu.models.blocks import ResBlkEncoder as JEnc
    from vanerf_tpu_torch.models.blocks import ResBlkEncoder
    cfg, g = variant(_set(("tex_args", "norm"), norm))
    tx = cfg["models"]["VANeRF"]["tex_args"]
    kw = dict(out_ch=tx["out_ch"], ngf=tx["ngf"],
              n_downsample=tx["n_downsample"], n_blocks=tx["n_blocks"],
              n_upsample=tx["n_upsample"], norm=norm)
    p = g["params"]["tex_encoder"]
    port = ResBlkEncoder(**kw)
    sd = {k[len("tex_encoder."):]: v for k, v in from_jax_params(g).items()
          if k.startswith("tex_encoder.")}
    port.load_state_dict(sd, strict=True)
    x = np.random.RandomState(4).rand(1, 16, 16, 3).astype(np.float64)
    with jax.enable_x64(True):
        want = JEnc(**kw).apply(
            {"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                    p)}, jnp.asarray(2 * x - 1))
    with torch.no_grad():
        got = port.double()(T(2 * x - 1))
    np.testing.assert_allclose(A(got), A(want), rtol=1e-6, atol=1e-7)
    n_norms = sum(isinstance(mod, torch.nn.GroupNorm)
                  for mod in port.modules())
    assert n_norms == (0 if norm == "none" else
                       1 + tx["n_downsample"] + 2 * tx["n_blocks"]
                       + tx["n_upsample"])


@pytest.mark.parametrize("name", ["leakyrelu", "elu", "tanh", "sigmoid",
                                  "relu", "softplus", "none"])
def test_activations_match_jax(name):
    """get_nl's nonlinearities against the JAX package's, float32."""
    from vanerf_tpu.models.mlp import get_nl as j_nl
    from vanerf_tpu_torch.models.mlp import get_nl
    x = np.linspace(-3, 3, 4001, dtype=np.float32)
    fj, ft = j_nl(name), get_nl(name)
    if name == "none":
        assert fj is None and ft is None
        return
    np.testing.assert_allclose(A(ft(T(x))), A(fj(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pools", [("max",), ("max", "mean", "var"),
                                   ("mean", "max")])
def test_pool_views_matches_jax(pools):
    """View pooling with "max", first in the concat order as in JAX."""
    from vanerf_tpu.models.mlp import pool_views as j_pool
    from vanerf_tpu_torch.models.mlp import pool_views
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 7, 5).astype(np.float32)
    a = (rs.rand(2, 3, 7, 1) > 0.3).astype(np.float32)
    w = rs.rand(2, 3, 7, 1).astype(np.float32) * a
    got, valid = pool_views(T(x), T(a), T(w), pools)
    want, valid_j = j_pool(jnp.asarray(x), jnp.asarray(a), jnp.asarray(w),
                           pools)
    np.testing.assert_array_equal(A(valid), A(valid_j))
    np.testing.assert_allclose(A(got), A(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["mxyz", "rel_cxyz", "elu_max_group"])
def test_variant_grads_match_jax_f64(case, monkeypatch):
    """The float64 certificate of the variants' training path: the encode
    and the training query (one view) in float64 on both sides, from one
    set of weights, every parameter's gradient of a weighted sum of the
    outputs to a relative norm error of 1e-6 (the reference passes through
    ``from_jax_params``, which rounds it to float32: ~3e-8 of a tensor's
    norm).  In float32 the texture encoder's instance / group norms
    amplify rounding (tests/test_torch_models.py), which the GAN step
    below carries into every gradient; here nothing is left but the two
    libraries' float64 rounding."""
    import vanerf_tpu_torch.models.vanerf as pv
    from vanerf_tpu.ops.knn import nearest_vertex_d2
    from test_torch_train import _rel
    monkeypatch.setenv("VANERF_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("VANERF_FAR_TAU", "0")
    cfg, g = variant(QUERY_CASES[case])
    jm, port = models(cfg, g)
    jm = jm.clone(compute_dtype="float64")
    monkeypatch.setitem(pv.COMPUTE_DTYPES, "float64", torch.float64)
    port = port.double().train()
    port.compute_dtype = "float64"
    batch, _ = h.synthetic_batch()
    rs = np.random.RandomState(9)
    N = 128
    pts = h.two_hand_points(N, seed=10)[None].astype(np.float64)
    view = rs.randn(1, N, 3)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    vv = (rs.rand(1, 2 * h.NUM_V, 1) > 0.3).astype(np.float64)
    qv = (rs.rand(1, N, 1) > 0.5).astype(np.float64)
    qs = rs.randn(1, N, 1) * 0.01
    nn_idx = np.asarray(nearest_vertex_d2(
        jnp.asarray(pts[0], jnp.float32),
        jnp.asarray(batch["verts"][0]))[0])[None]
    w = np.random.RandomState(4).randn(1, N, 5)

    def f64(x):
        return (x.astype(np.float64) if isinstance(x, np.ndarray)
                and x.dtype == np.float32 else x)

    args = [f64(x) for x in (pts, view, batch["src_img"], batch["src_mask"],
                             batch["verts"], vv, qv, qs, batch["kpt3d"],
                             MODEL_T)]
    cam = {k: f64(batch[v]) if isinstance(v, str) else v for k, v in (
        ("KRT", "src_krt"), ("extrin", "src_extrin"), ("width", h.W),
        ("height", h.H), ("znear", "znear"), ("zfar", "zfar"))}
    with jax.enable_x64(True):
        g64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                           g)

        def j_loss(p):
            pts, view, img, mask, verts, vv, qv, qs, kpt, mT = map(
                jnp.asarray, args)
            fg, ft = jm.apply(p, img, method=jm.encode)
            out, _ = jm.apply(
                p, pts, view, {k: jnp.asarray(v) for k, v in cam.items()},
                fg, ft, img, mask, verts, vv, qv, qs, kpt, 8, 1, True,
                nn_idx=jnp.asarray(nn_idx), model_T=mT, method=jm.query)
            return (out * jnp.asarray(w)).sum()

        loss_j, g_j = jax.jit(jax.value_and_grad(j_loss))(g64)
        g_j = from_jax_params(jax.tree.map(
            lambda a: np.asarray(a, np.float64), g_j))
    pts, view, img, mask, verts, vv, qv, qs, kpt, mT = map(T, args)
    fg, ft = port.encode(img)
    out_t, _ = port.query(
        pts, view, {k: T(v) if isinstance(v, np.ndarray) else v
                    for k, v in cam.items()}, fg, ft, img, mask, verts, vv,
        qv, qs, kpt, 8, training=True, nn_idx=T(nn_idx), model_T=mT)
    assert out_t.dtype == torch.float64
    loss_t = (out_t * T(w)).sum()
    loss_t.backward()
    # JAX casts the query's output to float32 (models/vanerf.py:533)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    pairs = [(n, p.grad, g_j[n].numpy().reshape(p.shape))
             for n, p in port.named_parameters()]
    scale = max(np.linalg.norm(ref) for _, _, ref in pairs)
    held = 0
    for n, got, ref in pairs:
        got = np.zeros(ref.shape) if got is None else got.numpy()
        if np.linalg.norm(ref) < 1e-9 * scale:
            assert np.linalg.norm(got) < 1e-9 * scale, n
            continue
        assert _rel(got, ref) <= 1e-6, (n, _rel(got, ref))
        held += 1
    assert held > 60


# ---------------------------------------------------------------------------
# renders and a GAN step of a non-default sp_type (mxyz with model_T)
# ---------------------------------------------------------------------------

def _mxyz_batch():
    batch, _ = h.synthetic_batch()
    return h.morton_sorted(dict(batch, model_T=MODEL_T))


def test_render_patch_mxyz_matches_jax(exact):
    """Eval render_patch of an mxyz model with the batch's model_T
    forwarded into every query, against JAX's (tests/test_torch_render.py's
    bounds: rtol 1e-3 / atol 1e-4 on colour and alpha, depth where alpha
    > 1e-2)."""
    from vanerf_tpu import renderer as jr
    cfg, g = variant(QUERY_CASES["mxyz"])
    jm, port = models(cfg, g)
    batch = _mxyz_batch()
    grid = h.center_grid()
    kw = dict(out_h=h.OUT, out_w=h.OUT, sample_per_ray_c=h.S_C,
              sample_per_ray_f=h.S_F)
    out_j = jr.render_patch(
        jm, g, {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                for k, v in batch.items()}, rng=jax.random.PRNGKey(0),
        grids=jnp.asarray(grid), training=False, sdf_chunk=64, **kw)
    out_t = tr.render_patch(port, h.torch_batch(batch), grids=T(grid),
                            compute_vis_map=False, **kw)
    no_T = tr.render_patch(port, h.torch_batch(dict(batch, model_T=np.eye(
        4, dtype=np.float32)[None])), grids=T(grid), compute_vis_map=False,
        **kw)
    assert not torch.equal(no_T["tex_fg_fine"], out_t["tex_fg_fine"])
    for k in ("tex_fg", "alpha", "tex_fg_fine", "alpha_fine"):
        np.testing.assert_allclose(A(out_t[k]), A(out_j[k]), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    m = A(out_j["alpha_fine"]) > 1e-2
    np.testing.assert_allclose(A(out_t["depth_fine"])[m],
                               A(out_j["depth_fine"])[m], rtol=1e-3,
                               atol=2e-4)
    with pytest.raises(ValueError, match="model_T"):
        b = h.torch_batch(batch)
        b.pop("model_T")
        tr.render_patch(port, b, grids=T(grid), compute_vis_map=False, **kw)


def _train_cfg(cfg):
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = 8
    m["dr_kwargs"]["sample_per_ray_c"] = h.S_C
    m["dr_kwargs"]["sample_per_ray_f"] = h.S_F
    cfg["training"]["reference_faithful_gan"] = False
    return cfg


def _port_step(cfg, g, batch, draws):
    """(logs, G gradients by name) of one port GAN step from the params
    ``g`` on ``batch`` with ``draws``."""
    from test_torch_train import _disc_params, _vgg_pair
    from vanerf_tpu_torch.models import DiscriminatorVis
    from vanerf_tpu_torch.training import create_train_state, make_train_step
    from vanerf_tpu_torch.weights import disc_from_jax_params
    _, port = models(cfg, g)
    disc = DiscriminatorVis()
    disc.load_state_dict(disc_from_jax_params(_disc_params()), strict=True)
    st = create_train_state(port, disc, cfg, steps_per_epoch=10)
    seen = {}
    orig = st.opt_g.step

    def hooked(grads):
        seen["g"] = grads
        orig(grads)
    st.opt_g.step = hooked
    logs = make_train_step(port, disc, cfg, _vgg_pair()[1])(
        st, h.torch_batch(batch), draws=draws)
    names = [n for n, _ in port.named_parameters()]
    return logs, dict(zip(names, seen["g"]))


def _jax_step(cfg, g, batch):
    """(logs, G gradients by port name, the draws) of JAX's GAN step."""
    import optax
    from test_torch_train import _capture, _disc_params, _jax_draws, _vgg_pair
    from vanerf_tpu.models import DiscriminatorVis as JDisc
    from vanerf_tpu.training.train_step import (TrainState,
                                                make_lr_schedule,
                                                make_train_step as j_make)
    d = _disc_params()
    jb = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in batch.items()}
    sched = make_lr_schedule(cfg["training"]["lr"], 10)
    tx_g = optax.chain(_capture(), optax.adam(sched))
    tx_d = optax.chain(_capture(), optax.adam(sched))
    state = TrainState(g, d, tx_g.init(g), tx_d.init(d),
                       jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(3)
    jm, _ = models(cfg, g)
    new, logs = jax.jit(j_make(jm, JDisc(), tx_g, tx_d, cfg,
                               _vgg_pair()[0]))(state, jb, rng)
    rg, rd = jax.random.split(rng)
    draws = {"g": _jax_draws(rg, jb), "d": _jax_draws(rd, jb)}
    grads = from_jax_params(jax.tree.map(np.asarray, new.opt_g[0]))
    return logs, grads, draws


def test_train_step_mxyz_matches_jax(exact):
    """One single-render GAN step of an mxyz model with the batch's
    model_T: losses (rtol 1e-4, tests/test_torch_train.py's bound) and G
    gradients against JAX's, its draws fed in.  Each gradient within a
    relative norm error of 1e-2, the texture path 5e-2: in float32 the
    texture encoder's norms amplify rounding into the texture fusion's
    gate and global-context convs and, through the losses, into every
    gradient (up to ~5.5e-3 seen here, against ~8e-4 for rel_z_decay in
    tests/test_torch_train.py); test_variant_grads_match_jax_f64 holds
    the same path for mxyz to 1e-6 in float64, so this bound covers
    rounding, not a fault."""
    from test_torch_train import TEX_PATH, _rel
    cfg, g = variant(QUERY_CASES["mxyz"])
    cfg = _train_cfg(cfg)
    batch = _mxyz_batch()
    logs_j, grads_j, draws = _jax_step(cfg, g, batch)
    logs_t, grads_t = _port_step(cfg, g, batch, draws)
    assert set(logs_t) == set(logs_j)
    for k in logs_j:
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    total = np.sqrt(sum(float((v.numpy() ** 2).sum())
                        for v in grads_j.values()))
    held = 0
    for n, gt in grads_t.items():
        gj = grads_j[n].numpy().reshape(gt.shape if gt is not None
                                        else grads_j[n].shape)
        gt = np.zeros(gj.shape) if gt is None else gt.numpy()
        if np.linalg.norm(gj) < 1e-6 * total:
            assert np.linalg.norm(gt) < 1e-6 * total, n
            continue
        tol = 5e-2 if n.startswith(TEX_PATH) else 1e-2
        assert _rel(gt, gj) <= tol, (n, _rel(gt, gj))
        held += 1
    assert held > 20 and np.linalg.norm(
        grads_t["mlp_geo.layers1.layers.0.linear.weight_v"].numpy()) > 0


@pytest.mark.parametrize("mode", ["1", "2"])
def test_remat_query_step_equal_to_the_bit(mode, exact):
    """VANERF_REMAT_QUERY=1/2: one single-render GAN step's losses equal to
    the bit, and every gradient equal, to the same step without the
    switch (same state and draws, one thread)."""
    from test_torch_train import _jax_draws
    cfg, g = variant()
    cfg = _train_cfg(cfg)
    batch = h.morton_sorted(h.synthetic_batch()[0])
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if isinstance(v, np.ndarray)}
    rg, rd = jax.random.split(jax.random.PRNGKey(3))
    draws = {"g": _jax_draws(rg, jb), "d": _jax_draws(rd, jb)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with _env(VANERF_REMAT_QUERY=None):
            logs0, grads0 = _port_step(cfg, g, batch, draws)
        with _env(VANERF_REMAT_QUERY=mode):
            logs1, grads1 = _port_step(cfg, g, batch, draws)
    finally:
        torch.set_num_threads(threads)
    assert {k: float(v) for k, v in logs1.items()} == \
        {k: float(v) for k, v in logs0.items()}
    assert grads1.keys() == grads0.keys()
    for n in grads0:
        a, b = grads0[n], grads1[n]
        assert (a is None) == (b is None), n
        assert a is None or torch.equal(a, b), n


def test_remat_query_recomputes(monkeypatch):
    """Under VANERF_REMAT_QUERY the training render's query runs again in
    the backward (twice a pass in all), without it once; mode 2 saves the
    products' outputs (the policy's aten ops)."""
    calls = []
    from vanerf_tpu_torch.models.vanerf import VANeRF
    real = VANeRF.query

    def spy(self, *a, **k):
        calls.append(k.get("training"))
        return real(self, *a, **k)
    monkeypatch.setattr(VANeRF, "query", spy)
    port = h.port_model()
    batch = h.torch_batch(h.synthetic_batch()[0])
    for mode, want in ((None, 2), ("1", 4), ("2", 4)):
        del calls[:]
        with _env(VANERF_REMAT_QUERY=mode):
            out = tr.render_patch(port, batch, grids=T(h.center_grid()),
                                  out_h=h.OUT, out_w=h.OUT,
                                  sample_per_ray_c=h.S_C,
                                  sample_per_ray_f=h.S_F, training=True,
                                  compute_vis_map=False,
                                  generator=torch.Generator().manual_seed(0))
            out["tex_fg_fine"].sum().backward()
        assert len(calls) == want, (mode, calls)


# ---------------------------------------------------------------------------
# VANERF_TWO_RES
# ---------------------------------------------------------------------------

TWO_RES = _set(("tex_args", "n_upsample"), 1)


def test_two_res_sampler_matches_jax():
    """feat_sample_two_res_nhwc against JAX's under the same inputs (fine
    and coarse values), and its coarse values against the port's plain
    sampler within ~1 ulp (the boundary note of grid_sample.py:125-128),
    its fine ones equal; in float32 and bfloat16, batched maps read as
    e % Bm."""
    from vanerf_tpu.ops.grid_sample import (feat_sample_two_res_nhwc as
                                            j_two)
    from vanerf_tpu_torch.ops.grid_sample import (feat_sample_nhwc,
                                                  feat_sample_two_res_nhwc)
    rs = np.random.RandomState(5)
    fine = rs.randn(2, 16, 16, 8).astype(np.float32)
    coarse = rs.randn(2, 8, 8, 8).astype(np.float32)
    uv = (rs.rand(4, 500, 2) * 2.2 - 1.1).astype(np.float32)
    uv[:, :16] = np.linspace(-1, 1, 16)[:, None]        # on cell corners
    for dt in (torch.float32, torch.bfloat16):
        f_t, c_t = T(fine).to(dt), T(coarse).to(dt)
        got_f, got_c = feat_sample_two_res_nhwc(f_t, c_t, T(uv))
        jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
        e = np.arange(4) % 2
        want_f, want_c = j_two(jnp.asarray(fine[e]).astype(jdt),
                               jnp.asarray(coarse[e]).astype(jdt),
                               jnp.asarray(uv))
        np.testing.assert_array_equal(A(got_f.float()),
                                      A(want_f.astype(jnp.float32)))
        np.testing.assert_array_equal(A(got_c.float()),
                                      A(want_c.astype(jnp.float32)))
        if dt == torch.float32:
            assert torch.equal(got_f, feat_sample_nhwc(f_t, T(uv)))
            plain = feat_sample_nhwc(c_t, T(uv))
            np.testing.assert_allclose(A(got_c), A(plain), rtol=0,
                                       atol=4e-7 * np.abs(coarse).max())


def test_two_res_query_and_render_match_jax(exact):
    """VANERF_TWO_RES=1 on the coarse-texture config: the query and an eval
    render_patch against JAX's under the switch (the query's and the
    render's bounds above), the query equal to its output without the
    switch within the sampler's ~1 ulp carried through the network."""
    from vanerf_tpu import renderer as jr
    from vanerf_tpu_torch.ops import grid_sample as tg
    cfg, g = variant(TWO_RES)
    jm, port = models(cfg, g)
    batch = h.morton_sorted(h.synthetic_batch()[0])
    fg, ft = port.encode(T(batch["src_img"]))
    assert ft.shape[1] < fg[1].shape[1]
    used = []
    real = tg.feat_sample_two_res_nhwc
    with _env(VANERF_TWO_RES="1"):
        import vanerf_tpu_torch.models.vanerf as tv
        tv.feat_sample_two_res_nhwc = \
            lambda *a: used.append(1) or real(*a)
        try:
            (out_t, valid_t), (out_j, valid_j) = _query_pair(jm, g, port,
                                                             batch)
            grid = h.center_grid()
            kw = dict(out_h=h.OUT, out_w=h.OUT, sample_per_ray_c=h.S_C,
                      sample_per_ray_f=h.S_F)
            ren_j = jr.render_patch(
                jm, g, {k: jnp.asarray(v) if isinstance(v, np.ndarray)
                        else v for k, v in batch.items()},
                rng=jax.random.PRNGKey(0), grids=jnp.asarray(grid),
                training=False, sdf_chunk=64, **kw)
            ren_t = tr.render_patch(port, h.torch_batch(batch),
                                    grids=T(grid), compute_vis_map=False,
                                    **kw)
        finally:
            tv.feat_sample_two_res_nhwc = real
    assert len(used) == 1 + 2              # the query, the render's passes
    np.testing.assert_array_equal(A(valid_t), A(valid_j))
    np.testing.assert_allclose(A(out_t), A(out_j), rtol=RTOL,
                               atol=ATOL * np.abs(A(out_j)).max())
    for k in ("tex_fg", "alpha", "tex_fg_fine", "alpha_fine"):
        np.testing.assert_allclose(A(ren_t[k]), A(ren_j[k]), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    (out_0, _), _ = _query_pair(jm, g, port, batch)
    np.testing.assert_allclose(A(out_t), A(out_0), rtol=1e-5,
                               atol=1e-6 * np.abs(A(out_0)).max())


# ---------------------------------------------------------------------------
# the fused gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["elu", "rel_cxyz"])
def test_fused_gate_keeps_unheld_networks_unfused(case, exact, monkeypatch):
    """Under VANERF_FUSED_MLP=2 a network the fused kernels do not compute
    (nl_layer elu: the port's gate; sp_type rel_cxyz: JAX's gate too) runs
    the unfused query: equal to JAX's unfused output, no fused kernel
    called."""
    import vanerf_tpu_torch.models.vanerf as tv
    edit = (_set(("mlp_geo_args", "nl_layer"), "elu") if case == "elu"
            else QUERY_CASES["rel_cxyz"])
    cfg, g = variant(edit)
    jm, port = models(cfg, g)
    called = []
    for name in ("fused_geo_mlp", "fused_query_mlp"):
        monkeypatch.setattr(tv, name, lambda *a, n=name, **k:
                            called.append(n))
    batch, _ = h.synthetic_batch()
    with _env(VANERF_FUSED_MLP="0"):
        _, (out_j, valid_j) = _query_pair(jm, g, port, batch)
    with _env(VANERF_FUSED_MLP="2"):
        (out_t, valid_t), _ = _query_pair(jm, g, port, batch)
    assert not called and not port.fused_ok
    np.testing.assert_array_equal(A(valid_t), A(valid_j))
    np.testing.assert_allclose(A(out_t), A(out_j), rtol=RTOL,
                               atol=ATOL * np.abs(A(out_j)).max())


def test_fused_gate_open_on_the_shipped_network():
    """The shipped network (rel_z_decay, softplus, [mean, var]) keeps the
    fused levels."""
    assert h.port_model().fused_ok


# ---------------------------------------------------------------------------
# kernels 11 / 12 in bfloat16 at other widths: the mma.sync body
# ---------------------------------------------------------------------------

OTHER_WIDTHS = {"n_dims1": [9, 96, 96, 80, 64], "n_dims2": [128, 48, 48, 2]}


def _schedule_mma(full: bool, K: int, L: int, dims) -> tuple:
    """csrc/fused_mlp.cu::fm_schedule<true> written out again: the n-tile
    count (fm_ntiles) of each 16-row k-tile, in the consumers' order."""
    d1, d2, d3, e1, e2, lat = dims
    items = []

    def ntiles(m):
        n = -(-m // 8)
        return n if n <= 4 else (8 if n <= 8 else (12 if n <= 12 else 16))

    def push(rows, m):
        items.extend([ntiles(m)] * -(-rows // 16))

    def gate_fuse(kin, hg, ng, hf, nout):
        push(kin, hg), push(hg, ng), push(kin, hf), push(hf, nout)

    if full:
        gate_fuse(196, 10, 3, 64, 64)
        gate_fuse(28, 10, 3, 8, 8)
    per = 120 // (1 + 2 * L)
    for j0 in range(0, K, per):
        push(min(per, K - j0) * (1 + 2 * L), d1)
    for rows, m in ((64, d1), (d1, d2), (d2, d3), (8, d3), (d3, 64),
                    (128, e1), (e1, e2), (e2, 2), (128, lat)):
        push(rows, m)
    if full:
        gate_fuse(96, 96, 6, 96, 3)
    return tuple(items)


def _other_width_model():
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    cfg = default_cfg()
    cfg["models"]["VANeRF"]["mlp_geo_args"].update(OTHER_WIDTHS)
    model = VANeRF.from_config(cfg, num_v=642, image_hw=(256, 256))
    init_like_flax(model, torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("kernel", ["geo", "query"])
def test_packed_bf16_other_widths_are_m16n8k16_fragments(kernel):
    """At widths other than BF16_DIMS the bfloat16 weights are packed for
    the mma.sync body: lane 4 g + t of a (16-row k-tile, n8 tile) holds
    rows 2t, 2t + 1, 2t + 8, 2t + 9 of column g, 128 values a tile in
    fm_ntiles' n-tile counts, every weight once at its address, the
    padding zero, the k-tiles in fm_schedule<true>'s order; at BF16_DIMS
    the wgmma body's layout."""
    model = _other_width_model()
    BF = torch.bfloat16
    with torch.no_grad():
        if kernel == "geo":
            w = tf.prepare_geo_mlp_weights(model, cdt=BF)
            layers, _, dims = tf._geo_layers(w, 42, 3)
            packed = tf.pack_geo_weights(w, 42, 3)
        else:
            w = tf.prepare_query_weights(model, cdt=BF)
            layers, _, dims = tf._query_layers(w, 42, 3)
            packed = tf.pack_query_weights(w, 42, 3)
    assert dims == (96, 96, 80, 48, 48, 24) != tf.BF16_DIMS
    assert tf.bf16_body(dims) == packed.body == tf.BODY_BF16_MMA
    assert tf.bf16_body(tf.BF16_DIMS) == tf.BODY_BF16
    stream, items = tf._pack(layers, tf.BODY_BF16_MMA)
    assert stream.dtype == BF and torch.equal(stream, packed.w)
    assert items == _schedule_mma(kernel == "query", 42, 3, dims)
    assert stream.numel() == 128 * sum(items)
    flat = stream.view(torch.int16).numpy()
    off = 0                                      # in bfloat16 values
    for parts, M in layers:
        nt = tf._ntiles(M, tf.BODY_BF16_MMA)
        for part in parts:
            kt = -(-part.shape[0] // 16)
            want = np.zeros((16 * kt, 8 * nt), np.int16)
            want[:part.shape[0], :M] = part.view(torch.int16).numpy()
            # value j of register r of lane 4 g + t: row 16 a + 8 r + 2 t
            # + j, column 8 b + g, at (((a nt + b) 32 + 4 g + t) 4 + 2 r + j)
            a, b, g, t, r, j = np.meshgrid(
                np.arange(kt), np.arange(nt), np.arange(8), np.arange(4),
                np.arange(2), np.arange(2), indexing="ij")
            addr = (((a * nt + b) * 32 + 4 * g + t) * 4 + 2 * r + j)
            got = np.zeros_like(want)
            got[16 * a + 8 * r + 2 * t + j, 8 * b + g] = flat[off + addr]
            np.testing.assert_array_equal(got, want)
            hits = np.bincount(addr.reshape(-1), minlength=kt * nt * 128)
            assert hits.shape[0] == kt * nt * 128 and (hits == 1).all()
            off += kt * nt * 128
    assert off == stream.numel()


def test_bf16_other_widths_serve_through_the_model():
    """A bfloat16 model at other widths packs for the mma.sync body in
    VANeRF._fused_weights (the choice made by the widths before a launch),
    and its plain versions run the fused levels on the CPU; a float32
    stream handed to the bfloat16 body raises."""
    model = _other_width_model()
    with torch.no_grad():
        w16 = tf.prepare_geo_mlp_weights(model, cdt=torch.bfloat16)
        w32 = tf.prepare_geo_mlp_weights(model)
    p32 = tf.pack_geo_weights(w32, 42, 3)
    assert p32.body == tf.BODY_F32
    assert tf.pack_geo_weights(w16, 42, 3).body == tf.BODY_BF16_MMA
    with pytest.raises(ValueError, match="laid out"):
        tf._check_packed(p32._replace(w=p32.w.to(torch.bfloat16)),
                         torch.bfloat16, torch.device("cpu"))
