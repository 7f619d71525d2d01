"""The dense voxel branch (``sp_conv: true``): the port's voxel ops, its
``VoxelConvNet`` / ``GeoVisFusionSP`` / ``TexVisFusionSP``, the SP query at
one and two views, the eval and training renders, a single-render GAN step
and the tile group against the JAX package, on the CPU, on a 16^3 grid
with the same weights (the SP modules' flax parameters carried into the
port by ``vanerf_tpu_torch.weights``) and the same random draws.

On the JAX side everything runs in float32 at the highest matmul precision
with the far-field tier off, and every program is jitted (the branch's
3-D convolutions compile op by op for minutes when run eagerly).  The SP
fusion modules' flax parameters are seeded draws at these shapes (norm
scales and biases moved off 1 and 0), the other parameters are the dense
tests' converted replica weights.

Tolerances, each with its reason:
  * the voxel ops: the scatter rtol 1e-6 / atol 1e-7 (the sums of
    colliding vertices in vertex order), its gradient rtol 1e-5 / atol
    1e-6; the sampling rtol 1e-5 / atol 1e-5, and its volume gradient
    likewise: the fractional weights carry the coordinate's float32
    rounding (both packages lie ~3e-6 from the float64 values on a
    24-voxel axis, and XLA's fused program rounds otherwise than its
    eager ops, 2.4e-7 apart), the point gradients (weights times corner
    differences) rtol / atol 1e-4;
  * the modules: rtol 1e-4 / atol 1e-5 max|ref| (float32 3-D convolutions
    and group norms over mostly empty volumes, other summation orders);
  * the query, the renders and the GAN step: as
    ``tests/test_torch_views.py`` (query rtol 1e-4 / atol 1e-5 max|ref|;
    render rtol 1e-3 / atol 1e-4; losses rtol 1e-4; each gradient to a
    relative norm error of 1e-3), but the texture path and the whole
    texture fusion behind it (``tex_encoder.*``, ``tex_vis_fusion.*``) at
    1e-1 (the dense tests hold the texture path at 5e-2): under sp_conv the
    texture map and its global context fill the texture branch's voxel
    volume, whose group norms over a mostly empty grid amplify the float32
    rounding the instance norms already amplify, and the CPU convolutions'
    thread-dependent sums move it from run to run
    (``tex_vis_fusion.fconv3.1.weight`` read 2.1e-2 and 6.1e-2 in two
    runs, ``tex_vis_fusion.xyzc.conv0.*`` up to 2.9e-3; every other
    tensor within 1e-3).  A
    float64 run of the encode and the training query
    (:func:`test_query_sp_grads_float64_match_jax`) holds the outputs to
    1e-6 of the largest and every gradient to 1e-5, so the float32 bounds
    cover rounding;
  * ``tile_group`` 4 against 1: equal to the bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers as h
from test_torch_train import (TEX_PATH, _capture, _disc_params, _rel,
                              _vgg_pair)
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.ops import voxel as tv
from vanerf_tpu_torch.weights import disc_from_jax_params, from_jax_params

GRID = (16, 16, 16)
OUT = 8                       # 8x8 training rays: VGG's three pools need 8
# the tensors the GAN step holds with the texture path (module note): every
# row of the texture branch's voxel volume comes from the texture map and
# its global context
SP_TEX_PATH = TEX_PATH + ("tex_vis_fusion.",)


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


# ---------------------------------------------------------------------------
# the voxel ops
# ---------------------------------------------------------------------------

def test_scatter_to_grid_matches_jax():
    """Collisions averaged, coordinates outside the grid clipped onto its
    boundary voxels, a non-cubic grid, two volumes in one call: equal to
    JAX's per-volume scatter."""
    from vanerf_tpu.ops.voxel import scatter_to_grid as j_scatter
    rs = np.random.RandomState(0)
    shape = (5, 6, 7)
    V, C = 40, 3
    feat = rs.randn(2, V, C).astype(np.float32)
    coord = np.stack([rs.randint(-2, s + 2, (2, V)) for s in shape],
                     -1).astype(np.int32)
    coord[:, 5] = coord[:, 3]                      # a collision in each
    got = tv.scatter_to_grid(T(feat), T(coord), shape)
    assert got.shape == (2,) + shape + (C,)
    for b in range(2):
        want = np.asarray(j_scatter(jnp.asarray(feat[b]),
                                    jnp.asarray(coord[b]), shape))
        np.testing.assert_allclose(A(got[b]), want, rtol=1e-6, atol=1e-7)
    d, hh, w = np.clip(coord[0, 3], 0, np.array(shape) - 1)
    np.testing.assert_allclose(A(got[0, d, hh, w]),
                               (feat[0, 3] + feat[0, 5]) / 2, rtol=1e-6)
    # the scatter's gradient: each vertex gets its voxel's, over its count
    gfeat = T(feat).requires_grad_(True)
    wgt = rs.randn(2, *shape, C).astype(np.float32)
    (tv.scatter_to_grid(gfeat, T(coord), shape) * T(wgt)).sum().backward()
    for b in range(2):
        _, vjp = jax.vjp(lambda f: j_scatter(f, jnp.asarray(coord[b]),
                                             shape), jnp.asarray(feat[b]))
        np.testing.assert_allclose(A(gfeat.grad[b]),
                                   np.asarray(vjp(jnp.asarray(wgt[b]))[0]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(5, 6, 7), (16, 24, 24)])
def test_grid_sample_3d_matches_jax(shape, exact):
    """Points inside, on the boundary voxels, within and beyond half a
    voxel outside, and on exact voxel centres, on a non-cubic grid; three
    elements on two volumes (e on e % 2); values and the gradients of
    volume and points against ``jax.vjp``.  The 5x6x7 volume's gradient
    goes through ``take_rows`` (kernel 13's plain version), the 16x24x24
    one (9,216 voxels) through the indexed gather's own backward."""
    from vanerf_tpu.ops.voxel import grid_sample_3d as j_sample
    rs = np.random.RandomState(1)
    C, N = 4, 300
    vol = rs.randn(2, *shape, C).astype(np.float32)
    pts = rs.uniform(-1.3, 1.3, (3, N, 3)).astype(np.float32)
    D, H, W = shape
    centres = np.stack([2.0 * rs.randint(0, n, N) / (n - 1.0) - 1.0
                        for n in (W, H, D)], -1).astype(np.float32)
    pts[2, :N // 2] = centres[:N // 2]
    wgt = rs.randn(3, N, C).astype(np.float32)
    vt = T(vol).requires_grad_(True)
    pt = T(pts).requires_grad_(True)
    got = tv.grid_sample_3d(vt, pt)
    (got * T(wgt)).sum().backward()
    outside = 0
    g_vol = np.zeros_like(vol)
    for e in range(3):
        want, vjp = jax.vjp(j_sample, jnp.asarray(vol[e % 2]),
                            jnp.asarray(pts[e]))
        np.testing.assert_allclose(A(got[e]), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        outside += int((np.abs(np.asarray(want)).sum(-1) == 0).sum())
        gv, gp = vjp(jnp.asarray(wgt[e]))
        g_vol[e % 2] += np.asarray(gv)
        np.testing.assert_allclose(A(pt.grad[e]), np.asarray(gp),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(A(vt.grad), g_vol, rtol=1e-5, atol=1e-5)
    assert outside > 0                          # zeroed beyond half a voxel
    np.testing.assert_allclose(
        A(got[2, :N // 2]), vol[0][tuple(np.round(
            (centres[:N // 2, ::-1] + 1) / 2 * (np.array(shape) - 1))
            .astype(int).T)], rtol=1e-5, atol=1e-5)


def test_world_to_grid_coords_matches_jax():
    """Grid coordinates on a non-cubic grid with the shape passed reversed
    (the JAX callers' (W, H, D), which divides the depth offset by W),
    and the vertices' voxels, against JAX's expressions."""
    from vanerf_tpu.ops.voxel import world_to_grid_coords as j_coords
    rs = np.random.RandomState(2)
    grid = (8, 12, 20)
    bounds = np.array([[[-0.1, -0.05, 0.2], [0.2, 0.15, 0.3]],
                       [[0.0, 0.0, 0.0], [0.1, 0.1, 0.1]]], np.float32)
    pts = (bounds[:, :1] + rs.rand(2, 50, 3) * 0.1).astype(np.float32)
    got = tv.world_to_grid_coords(T(pts), T(bounds), grid[::-1])
    for b in range(2):
        want = j_coords(jnp.asarray(pts[b]), jnp.asarray(bounds[b]),
                        grid[::-1])
        np.testing.assert_allclose(A(got[b]), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # the mirrored axis: the x offset (w order first) over D, z over W
    off = (pts[0, 0] - bounds[0, 0]) / 0.005
    np.testing.assert_allclose(A(got[0, 0]),
                               off / np.array(grid, np.float32) * 2 - 1,
                               rtol=1e-5)
    want_vox = np.stack([np.asarray(jnp.round(
        (jnp.asarray(pts[b])[..., ::-1] - jnp.asarray(bounds[b])[0, ::-1])
        / 0.005).astype(jnp.int32)) for b in range(2)])
    np.testing.assert_array_equal(A(tv.vertex_voxels(T(pts), T(bounds))),
                                  want_vox)


# ---------------------------------------------------------------------------
# the modules, weights carried by vanerf_tpu_torch.weights
# ---------------------------------------------------------------------------

def _seeded(shapes, seed):
    """flax parameters of the given shapes from a seeded normal draw: a
    kernel at 1 / sqrt(fan-in), a norm scale around 1, a bias around 0
    (norm scales and biases moved off their initial values, so each one
    shows in the output)."""
    rs = np.random.RandomState(seed)

    def leaf(path, sd):
        name = path[-1].key
        x = rs.randn(*sd.shape).astype(np.float32)
        if name == "kernel":
            return jnp.asarray(x / np.sqrt(np.prod(sd.shape[:-1])))
        return jnp.asarray(x * 0.2 + (1.0 if name == "scale" else 0.0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port_sd(fn, p):
    """The port's state dict of one SP module from its flax parameters,
    through the writer ``weights.py`` applies to the whole model."""
    from vanerf_tpu_torch import weights as W
    w = W._Writer()
    fn(w, jax.tree.map(np.asarray, p), "m")
    return {k[2:]: v for k, v in w.sd.items()}


def _module_inputs(n=64, seed=3):
    """Inputs of the fusion modules at the small shapes: the fixture's
    first frame projected into its source view, random maps and
    visibilities, points around the hands."""
    rs = np.random.RandomState(seed)
    batch, _ = h.synthetic_batch()
    verts = batch["verts"]
    krt = batch["src_krt"]
    vh = verts @ np.swapaxes(krt[:, :3, :3], -1, -2) + krt[:, None, :3, 3]
    vxy = vh[..., :2] / (vh[..., 2:3] + 1e-8)
    vert_xy = np.stack([2 * vxy[..., 0] / (h.W - 1) - 1,
                        2 * vxy[..., 1] / (h.H - 1) - 1], -1)
    V2 = verts.shape[1]
    f = lambda *s: rs.randn(*s).astype(np.float32)          # noqa: E731
    return dict(
        vert_xy=vert_xy.astype(np.float32), verts=verts,
        bounds=batch["bounds"], v=h.two_hand_points(n, seed)[None],
        fg=[f(1, 8, 8, 64), f(1, 16, 16, 8)],
        fs=[f(1, n, 64), f(1, n, 8)], ft1=f(1, 8, 8, 8),
        img=rs.rand(1, h.H, h.W, 3).astype(np.float32),
        ft_xy=f(1, n, 8), img_xy=rs.rand(1, n, 3).astype(np.float32),
        latent=f(1, n, 24),
        vert_vis=(rs.rand(1, V2, 1) > 0.3).astype(np.float32),
        qv=(rs.rand(1, n, 1) > 0.5).astype(np.float32),
        qs=rs.rand(1, n, 1).astype(np.float32) * 5.0)


@functools.lru_cache(maxsize=1)
def _sp_fusion_params():
    """Seeded flax parameters of GeoVisFusionSP and TexVisFusionSP at the
    small shapes (their shapes traced by ``jax.eval_shape``, nothing
    compiled)."""
    from vanerf_tpu.models.voxel_fusion import GeoVisFusionSP, TexVisFusionSP
    x = _module_inputs(8)
    j = lambda a: jnp.asarray(a)                            # noqa: E731
    key = jax.random.PRNGKey(0)
    geo = GeoVisFusionSP(num_v=h.NUM_V, grid_shape=GRID)
    pg = jax.eval_shape(
        geo.init, key, j(x["vert_xy"]), [j(a) for a in x["fg"]],
        [j(a) for a in x["fs"]], j(x["verts"]), j(x["v"]), j(x["vert_vis"]),
        j(x["qv"]), j(x["qs"]), j(x["bounds"]))
    tex = TexVisFusionSP(num_v=h.NUM_V, grid_shape=GRID)
    pt = jax.eval_shape(
        tex.init, key, j(x["vert_xy"]), j(x["ft1"]), j(x["ft_xy"]),
        j(x["verts"]), j(x["v"]), j(x["vert_vis"]), j(x["qv"]),
        j(x["img_xy"]), j(x["img"]), j(x["latent"]), j(x["bounds"]))
    return _seeded(pg["params"], 10), _seeded(pt["params"], 11)


def _close(t, j, rtol=1e-4):
    j = np.asarray(j)
    np.testing.assert_allclose(A(t), j, rtol=rtol,
                               atol=1e-5 * float(np.abs(j).max()))


def test_voxel_conv_net_matches_jax(exact):
    """VoxelConvNet (16 -> 32 channels, four scales) on a scattered 16^3
    volume, one volume sampled by three elements, against flax."""
    from vanerf_tpu.models.voxel_fusion import VoxelConvNet as JNet
    from vanerf_tpu_torch.models.voxel_fusion import VoxelConvNet
    from vanerf_tpu_torch.weights import _flax_tree
    pg, _ = _sp_fusion_params()
    p = pg["xyzc0"]
    rs = np.random.RandomState(4)
    coord = rs.randint(0, 16, (1, 300, 3)).astype(np.int32)
    vol = tv.scatter_to_grid(T(rs.randn(1, 300, 16).astype(np.float32)),
                             T(coord), GRID)
    gc = rs.uniform(-1.1, 1.1, (3, 200, 3)).astype(np.float32)
    net = VoxelConvNet(16, 32)
    net.load_state_dict(_port_sd(_flax_tree, p), strict=True)
    with torch.no_grad():
        got = net(vol, T(gc))
    assert got.shape == (3, 200, 96)
    f = jax.jit(lambda gci: JNet(16, 32).apply({"params": p},
                                               jnp.asarray(A(vol[0])), gci))
    for e in range(3):
        _close(got[e], f(jnp.asarray(gc[e])))


@pytest.mark.parametrize("branch", ["geo", "tex"])
def test_fusion_sp_matches_jax(branch, exact):
    """GeoVisFusionSP and TexVisFusionSP (16^3 grid) with the weights
    carried by ``weights.py``: outputs and every parameter's gradient of a
    weighted sum (relative norm error 1e-3) against flax."""
    from vanerf_tpu.models import voxel_fusion as jvf
    from vanerf_tpu.ops.knn import nearest_vertex
    from vanerf_tpu_torch import weights as W
    from vanerf_tpu_torch.models import voxel_fusion as pvf
    pg, pt = _sp_fusion_params()
    x = _module_inputs()
    nn_idx = np.asarray(nearest_vertex(jnp.asarray(x["v"][0]),
                                       jnp.asarray(x["verts"][0])))[None]
    j = jnp.asarray
    if branch == "geo":
        params = pg
        mod = pvf.GeoVisFusionSP(num_v=h.NUM_V)
        mod.load_state_dict(_port_sd(W._geo_vis_fusion_sp, params),
                            strict=True)
        wts = [np.random.RandomState(5).randn(1, 64, c).astype(np.float32)
               for c in (64, 8)]

        def j_out(p):
            outs = jvf.GeoVisFusionSP(num_v=h.NUM_V, grid_shape=GRID).apply(
                {"params": p}, j(x["vert_xy"]), [j(a) for a in x["fg"]],
                [j(a) for a in x["fs"]], j(x["verts"]), j(x["v"]),
                j(x["vert_vis"]), j(x["qv"]), j(x["qs"]), j(x["bounds"]))
            return outs, sum((o * j(w)).sum() for o, w in zip(outs, wts))

        outs_t = mod(T(x["vert_xy"]), [T(a) for a in x["fg"]],
                     [T(a) for a in x["fs"]], T(x["verts"]), T(x["v"]),
                     T(x["vert_vis"]), T(x["qv"]), T(x["qs"]),
                     T(x["bounds"]), T(nn_idx), GRID)
    else:
        params = pt
        mod = pvf.TexVisFusionSP(num_v=h.NUM_V, hw3=(8, 8), hw4=(h.H, h.W))
        mod.load_state_dict(_port_sd(W._tex_vis_fusion, params), strict=True)
        wts = [np.random.RandomState(6).randn(1, 64, 40).astype(np.float32)]

        def j_out(p):
            out = jvf.TexVisFusionSP(num_v=h.NUM_V, grid_shape=GRID).apply(
                {"params": p}, j(x["vert_xy"]), j(x["ft1"]), j(x["ft_xy"]),
                j(x["verts"]), j(x["v"]), j(x["vert_vis"]), j(x["qv"]),
                j(x["img_xy"]), j(x["img"]), j(x["latent"]), j(x["bounds"]))
            return [out], (out * j(wts[0])).sum()

        outs_t = [mod(T(x["vert_xy"]), T(x["ft1"]), T(x["ft_xy"]),
                      T(x["verts"]), T(x["v"]), T(x["vert_vis"]), T(x["qv"]),
                      T(x["img_xy"]), T(x["img"]), T(x["latent"]),
                      T(x["bounds"]), T(nn_idx), GRID)]
    (loss_j, outs_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: j_out(p)[::-1], has_aux=True))(params)
    for o_t, o_j in zip(outs_t, outs_j):
        _close(o_t, o_j)
    loss_t = sum((o * T(w)).sum() for o, w in zip(outs_t, wts))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    loss_t.backward()
    fn = W._geo_vis_fusion_sp if branch == "geo" else W._tex_vis_fusion
    grads_j = _port_sd(fn, g_j)
    for n, p in mod.named_parameters():
        assert _rel(A(p.grad), grads_j[n].numpy().reshape(p.shape)) <= 1e-3, n


# ---------------------------------------------------------------------------
# the model: query, renders, GAN step
# ---------------------------------------------------------------------------

def _sp_cfg():
    cfg = h.small_cfg()
    m = cfg["models"]["VANeRF"]
    m["sp_conv"] = True
    m["voxel_grid"] = list(GRID)          # read by the port (JAX: clone)
    return cfg


@functools.lru_cache(maxsize=1)
def _sp_params():
    """The whole generator's flax parameters: the dense tests' converted
    replica weights, the SP fusion modules' perturbed ones (the texture
    branch's global context is the dense branch's, by the same names)."""
    g, _ = h.converted_params()
    pg, pt = _sp_fusion_params()
    p = dict(g["params"])
    tex = dict(pt)
    for k in ("fconv3", "fconv4", "gt0", "gt1"):
        tex[k] = p["tex_vis_fusion"][k]
    p["geo_vis_fusion"], p["tex_vis_fusion"] = pg, tex
    return {"params": p}


def _models():
    """(JAX model, flax params, port model) of the sp_conv config on the
    16^3 grid, the same weights on both sides."""
    from vanerf_tpu.models import VANeRF as JVANeRF
    from vanerf_tpu_torch.models import VANeRF
    cfg = _sp_cfg()
    g = _sp_params()
    port = VANeRF.from_config(cfg, num_v=h.NUM_V, image_hw=(h.H, h.W))
    assert port.sp_conv and port.voxel_grid == GRID
    port.load_state_dict(from_jax_params(g), strict=True)
    jm = JVANeRF.from_config(cfg, num_v=h.NUM_V).clone(voxel_grid=GRID)
    return jm, g, port.eval()


def _query_case(batch, n_views, seed=9, N=128):
    from vanerf_tpu.ops.knn import nearest_vertex_d2
    rs = np.random.RandomState(seed)
    pts = h.two_hand_points(N, seed=seed + 1)[None]
    view = rs.randn(1, N, 3).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    return dict(
        pts=pts, view=view,
        vv=(rs.rand(1, 2 * h.NUM_V, 1) > 0.3).astype(np.float32),
        qv=(rs.rand(1, N, 1) > 0.5).astype(np.float32),
        qs=(rs.randn(1, N, 1) * 0.01).astype(np.float32),
        nn_idx=np.asarray(nearest_vertex_d2(
            jnp.asarray(pts[0]), jnp.asarray(batch["verts"][0]))[0])[None])


def _query_pair(jm, g, port, batch, n_views, dtype=np.float32,
                training=False):
    """(port (out, valid), JAX (out, valid)) of one SP query on the JAX
    encoder's maps, in ``dtype`` on both sides."""
    q = _query_case(batch, n_views)
    c = lambda x: np.asarray(x, dtype)                      # noqa: E731
    cam = {"KRT": c(batch["src_krt"]), "extrin": c(batch["src_extrin"]),
           "width": h.W, "height": h.H, "znear": float(batch["znear"]),
           "zfar": float(batch["zfar"])}
    args = [c(batch["src_img"]), c(batch["src_mask"]), c(batch["verts"]),
            c(q["vv"]), c(q["qv"]), c(q["qs"]), c(batch["kpt3d"])]
    bounds = c(batch["bounds"])

    def j_query(p, pts, view, cam, img, mask, verts, vv, qv, qs, kpt, bnd):
        fg, ft = jm.apply(p, img, method=jm.encode)
        return jm.apply(p, pts, view, cam, fg, ft, img, mask, verts, vv, qv,
                        qs, kpt, 8, n_views, training, bounds=bnd,
                        nn_idx=jnp.asarray(q["nn_idx"]), method=jm.query)

    jcam = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in cam.items()}
    out_j = jax.jit(j_query, static_argnums=())(
        g, jnp.asarray(c(q["pts"])), jnp.asarray(c(q["view"])), jcam,
        *map(jnp.asarray, args), jnp.asarray(bounds))
    fg, ft = jax.jit(lambda p, im: jm.apply(p, im, method=jm.encode))(
        g, jnp.asarray(args[0]))
    tcam = {k: (T(v) if isinstance(v, np.ndarray) else v)
            for k, v in cam.items()}
    with torch.no_grad():
        out_t = port.query(
            T(c(q["pts"])), T(c(q["view"])), tcam, [T(f) for f in fg], T(ft),
            *map(T, args), 8, n_views, training=training,
            nn_idx=T(q["nn_idx"]), bounds=T(bounds))
    return out_t, out_j


@pytest.mark.parametrize("n_views", [1, 2])
def test_query_sp_matches_jax(n_views, exact):
    """The SP query at one and two source views (the bounds repeated per
    view) on the JAX encoder's maps: the outputs within the query
    tolerance, the valid mask equal, and the branch moved the output (a
    second voxel grid gives another one)."""
    jm, g, port = _models()
    batch = (h.synthetic_batch()[0] if n_views == 1
             else h.synthetic_batch_views(n_views))
    (out_t, valid_t), (out_j, valid_j) = _query_pair(jm, g, port, batch,
                                                     n_views)
    assert out_t.shape == (1, 128, 5)
    np.testing.assert_array_equal(A(valid_t), np.asarray(valid_j))
    assert 0 < A(valid_t).mean() < 1
    _close(out_t, out_j)
    port.voxel_grid = (8, 8, 8)
    (out_8, _), _ = _query_pair(jm, g, port, batch, n_views)
    assert not torch.equal(out_8, out_t)


def test_query_sp_grads_float64_match_jax(exact):
    """The encode and the training SP query in float64 on both sides
    (compute dtype float64), from one set of weights: the outputs within
    1e-6 of the largest and every parameter's gradient of a weighted sum
    within a relative norm error of 1e-5, the texture path's and the voxel
    U-nets' included.  So the float32 GAN step's looser bound on the
    texture path (:func:`test_train_step_sp_matches_jax`) covers
    rounding, not a fault.  (The JAX float64 model keeps float32 pins in
    its samplers; both sides' outputs lie ~1e-8 apart.)"""
    import vanerf_tpu_torch.models.vanerf as pv
    jm, g, port = _models()
    exact.setitem(pv.COMPUTE_DTYPES, "float64", torch.float64)
    port = port.double()
    port.compute_dtype = "float64"
    batch = h.synthetic_batch()[0]
    q = _query_case(batch, 1)
    w = np.random.RandomState(4).randn(1, 128, 5)
    c = lambda x: np.asarray(x, np.float64)                 # noqa: E731
    args = [c(q["pts"]), c(q["view"]), c(batch["src_img"]),
            c(batch["src_mask"]), c(batch["verts"]), c(q["vv"]), c(q["qv"]),
            c(q["qs"]), c(batch["kpt3d"]), c(batch["bounds"])]
    cam = {"KRT": c(batch["src_krt"]), "extrin": c(batch["src_extrin"]),
           "width": h.W, "height": h.H, "znear": float(batch["znear"]),
           "zfar": float(batch["zfar"])}
    with jax.enable_x64(True):
        jm = jm.clone(compute_dtype="float64")
        g64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                           g)

        def j_loss(p, pts, view, img, mask, verts, vv, qv, qs, kpt, bnd):
            fg, ft = jm.apply(p, img, method=jm.encode)
            jcam = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                    for k, v in cam.items()}
            out, _ = jm.apply(p, pts, view, jcam, fg, ft, img, mask, verts,
                              vv, qv, qs, kpt, 8, 1, True, bounds=bnd,
                              nn_idx=jnp.asarray(q["nn_idx"]),
                              method=jm.query)
            return (out * jnp.asarray(w)).sum(), out

        (loss_j, out_j), g_j = jax.jit(jax.value_and_grad(
            j_loss, has_aux=True))(g64, *map(jnp.asarray, args))
        g_j = from_jax_params(jax.tree.map(
            lambda a: np.asarray(a, np.float64), g_j))
    pts, view, img, mask, verts, vv, qv, qs, kpt, bnd = map(T, args)
    fg, ft = port.encode(img)
    out_t, _ = port.query(
        pts, view, {k: T(v) if isinstance(v, np.ndarray) else v
                    for k, v in cam.items()}, fg, ft, img, mask, verts, vv,
        qv, qs, kpt, 8, 1, training=True, nn_idx=T(q["nn_idx"]),
        bounds=bnd)
    assert out_t.dtype == torch.float64
    out_j = np.asarray(out_j)
    np.testing.assert_allclose(A(out_t), out_j, rtol=0,
                               atol=1e-6 * np.abs(out_j).max())
    loss_t = (out_t * T(w)).sum()
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    total = np.sqrt(sum(float((v.numpy() ** 2).sum()) for v in g_j.values()))
    held = 0
    for n, p in port.named_parameters():
        gj = g_j[n].numpy().reshape(p.shape)
        gt = np.zeros(p.shape) if p.grad is None else A(p.grad)
        if np.linalg.norm(gj) < 1e-9 * total:
            assert np.linalg.norm(gt) < 1e-9 * total, n
            continue
        assert _rel(gt, gj) <= 1e-5, (n, _rel(gt, gj))
        held += n.startswith(("tex_vis_fusion.xyzc", "geo_vis_fusion.xyzc",
                              "tex_vis_fusion.fconv3", "tex_encoder."))
    assert held > 100


def _render_close(out_t, out_j, keys=("tex_fg", "alpha", "tex_fg_fine",
                                      "alpha_fine")):
    for k in keys:
        np.testing.assert_allclose(A(out_t[k]), np.asarray(out_j[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    for k, acck in (("depth", "alpha"), ("depth_fine", "alpha_fine"),
                    ("sdf", "alpha_fine")):
        m = np.asarray(out_j[acck]) > 1e-2
        assert m.any(), acck
        np.testing.assert_allclose(A(out_t[k])[m], np.asarray(out_j[k])[m],
                                   rtol=1e-3, atol=2e-4, err_msg=k)


def test_eval_render_patch_sp_matches_jax(exact):
    """The eval render under sp_conv: the composite takes the network's
    output as the density (no mesh prior), the far tier is off, and every
    output is within the render tolerance of JAX's; the GT patches and the
    visibility map equal."""
    from vanerf_tpu import renderer as jr
    jm, g, port = _models()
    batch = h.morton_sorted(h.synthetic_batch()[0])
    grids = h.center_grid()
    exact.setenv("VANERF_FAR_TAU", "0.02")       # off under sp_conv anyway
    out_j = jax.jit(lambda p, b, gr: jr.render_patch(
        jm, p, b, rng=jax.random.PRNGKey(0), grids=gr, out_h=h.OUT,
        out_w=h.OUT, sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F,
        fine=True, uniform=True, training=False, n_views=1, sdf_chunk=64,
        compute_vis_map=True))(g, _jbatch(batch), jnp.asarray(grids))
    out_t = tr.render_patch(port, h.torch_batch(batch), grids=T(grids),
                            out_h=h.OUT, out_w=h.OUT, sample_per_ray_c=h.S_C,
                            sample_per_ray_f=h.S_F)
    _render_close(out_t, out_j)
    for k in ("vert_vis", "vis_img", "vis_img_all", "img_in", "input_mask",
              "tar_img"):
        np.testing.assert_array_equal(A(out_t[k]), np.asarray(out_j[k]),
                                      err_msg=k)
    assert out_t["alpha_fine"].max() > 0.05


def test_full_image_tile_group_sp_is_its_elements():
    """``render_full_image`` under sp_conv at ``tile_group`` 4 over two
    frames: each frame-view's voxel pyramid is sampled by its elements in
    place, so every output equals the ``tile_group`` 1 render to the bit;
    the two frames differ."""
    from vanerf_tpu.data.synthetic import make_synthetic_batch
    _, _, port = _models()
    batch, _, _ = make_synthetic_batch(batch_size=2, H=h.H, W=h.W, subdiv=2)
    tb = h.torch_batch(batch)
    kw = dict(level=2, sample_per_ray_c=4, sample_per_ray_f=4)
    want = tr.render_full_image(port, tb, tile_group=1, **kw)
    got = tr.render_full_image(port, tb, tile_group=4, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert not torch.equal(want["tex_fg_fine"][0], want["tex_fg_fine"][1])


def _train_cfg(n_views=1):
    cfg = _sp_cfg()
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = OUT
    m["dr_kwargs"]["sample_per_ray_c"] = h.S_C
    m["dr_kwargs"]["sample_per_ray_f"] = h.S_F
    cfg["training"]["reference_faithful_gan"] = False
    cfg["dataset"]["num_input_view"] = n_views
    return cfg


def test_training_render_sp_matches_jax(exact):
    """The training render under sp_conv with JAX's draws fed in (jitter,
    noise, importance uniforms): every output within the render tolerance,
    the GT visibility patches equal."""
    from vanerf_tpu import renderer as jr
    from test_torch_train import _jax_draws
    jm, g, port = _models()
    batch = h.morton_sorted(h.synthetic_batch()[0])
    jb = _jbatch(batch)
    key = jax.random.PRNGKey(21)
    dr = _jax_draws(key, jb)
    _, krender = jax.random.split(key)
    kw = dict(out_h=OUT, out_w=OUT, sample_per_ray_c=h.S_C,
              sample_per_ray_f=h.S_F, fine=True, uniform=False,
              rand_noise_std=0.01, training=True, n_views=1)
    out_j = jax.jit(lambda p, b, k, gr: jr.render_patch(
        jm, p, b, rng=k, grids=gr, sdf_chunk=64, **kw))(
        g, jb, krender, jnp.asarray(dr["grids"]))
    out_t = tr.render_patch(port, h.torch_batch(batch), grids=T(dr["grids"]),
                            compute_vis_map=True, draws=dr, **kw)
    assert out_t["tex_fg_fine"].requires_grad
    _render_close(out_t, out_j, ("alpha", "alpha_fine", "tex_fg",
                                 "tex_fg_fine"))
    for k in ("vis_img", "vis_img_all", "tar_img", "tar_alpha"):
        np.testing.assert_array_equal(A(out_t[k]), np.asarray(out_j[k]),
                                      err_msg=k)


# the JAX step's cold compile takes ~115 s on one CPU worker
@pytest.mark.slow
def test_train_step_sp_matches_jax(exact):
    """One single-render GAN step under sp_conv with JAX's draws: losses,
    and every generator parameter's gradient (the SP modules' included,
    each non-zero) within the bounds of the module note."""
    import optax
    from vanerf_tpu.models import DiscriminatorVis as JDisc
    from vanerf_tpu.training.train_step import (TrainState,
                                                make_lr_schedule,
                                                make_train_step as j_make)
    from test_torch_train import _jax_draws
    from vanerf_tpu_torch.models import DiscriminatorVis
    from vanerf_tpu_torch.training import (create_train_state,
                                           make_train_step)
    cfg = _train_cfg()
    jm, g, model = _models()
    d = _disc_params()
    batch = h.morton_sorted(h.synthetic_batch()[0])
    jb = _jbatch(batch)
    vgg_j, vgg_t = _vgg_pair()
    sched = make_lr_schedule(cfg["training"]["lr"], 10)
    tx_g = optax.chain(_capture(), optax.adam(sched))
    tx_d = optax.chain(_capture(), optax.adam(sched))
    state = TrainState(g, d, tx_g.init(g), tx_d.init(d),
                       jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(3)
    new, logs_j = jax.jit(j_make(jm, JDisc(), tx_g, tx_d, cfg, vgg_j))(
        state, jb, rng)
    rg, rd = jax.random.split(rng)
    draws = {"g": _jax_draws(rg, jb), "d": _jax_draws(rd, jb)}

    disc = DiscriminatorVis()
    disc.load_state_dict(disc_from_jax_params(d), strict=True)
    st = create_train_state(model, disc, cfg, steps_per_epoch=10)
    seen = {}
    orig = st.opt_g.step

    def hooked(grads):
        seen["g"] = grads
        orig(grads)
    st.opt_g.step = hooked
    logs_t = make_train_step(model, disc, cfg, vgg_t)(
        st, h.torch_batch(batch), draws=draws)
    assert set(logs_t) == set(logs_j)
    for k in logs_j:
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    grads_j = from_jax_params(jax.tree.map(np.asarray, new.opt_g[0]))
    names = [n for n, _ in model.named_parameters()]
    total = np.sqrt(sum(float((grads_j[n].numpy() ** 2).sum())
                        for n in names))
    sp = 0
    for n, p, gt in zip(names, st.opt_g.params, seen["g"]):
        gj = grads_j[n].numpy().reshape(p.shape)
        gt = np.zeros(p.shape) if gt is None else gt.numpy()
        if np.linalg.norm(gj) < 1e-6 * total:
            assert np.linalg.norm(gt) < 1e-6 * total, n
            continue
        sp += ".xyzc" in n
        assert _rel(gt, gj) <= (1e-1 if n.startswith(SP_TEX_PATH)
                                else 1e-3), (n, _rel(gt, gj))
    assert sp > 50          # the voxel U-nets' tensors have gradients
