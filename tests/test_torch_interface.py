"""The port's interface against the JAX package's, on the CPU: the
``VANERF_COMPUTE_DTYPE`` override, the switches the port refuses or
honours (``VANERF_MXU_INTERP``), the ``render_patch`` /
``render_full_image`` keywords (``compute_vis_map`` on by default,
``fine``, ``nml_scale``, ``vis_size``, ``sdf_chunk``, a ``tile_group``
that does not divide stride^2 and the refused ``mesh``), and kernel 13's
workspace sizes.

The render comparisons use the small shapes of ``tests/torch_port_helpers``
(8x4 rays, 8 coarse samples, the fine pass off), faces in the port's
Morton order, and the tolerances of ``tests/test_torch_render.py``.
"""

import contextlib
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers as h
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.models import vanerf as tv
from vanerf_tpu_torch.ops import onehot_gather


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@contextlib.contextmanager
def _env(**kv):
    """Set (a str) or unset (None) environment variables for a block."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in kv.items():
            if v is None:
                mp.delenv(k, raising=False)
            else:
                mp.setenv(k, v)
        yield


# ---------------------------------------------------------------------------
# VANERF_COMPUTE_DTYPE: the environment first, then the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env_dt,cfg_dt", [
    ("float32", None), ("float32", "bfloat16"), (None, "float32"),
    (None, None), ("bfloat16", "float32"), ("bfloat16", None),
    (None, "bfloat16"), ("float16", "bfloat16")])
def test_compute_dtype_reads_env_first(env_dt, cfg_dt):
    """The port resolves the dtype as the JAX package does (on the CPU):
    float32 and bfloat16 are taken, any other type raises."""
    from vanerf_tpu.models import VANeRF as JVANeRF
    from vanerf_tpu_torch.models import VANeRF
    cfg = h.small_cfg()
    if cfg_dt is not None:
        cfg["models"]["VANeRF"]["compute_dtype"] = cfg_dt
    with _env(VANERF_COMPUTE_DTYPE=env_dt):
        want = JVANeRF.from_config(cfg, num_v=h.NUM_V).compute_dtype
        if want in ("float32", "bfloat16"):
            got = VANeRF.from_config(cfg, num_v=h.NUM_V, image_hw=(h.H, h.W))
            assert got.compute_dtype == want
        else:
            with pytest.raises(NotImplementedError, match=want):
                VANeRF.from_config(cfg, num_v=h.NUM_V, image_hw=(h.H, h.W))
    assert want == (env_dt or cfg_dt or "float32")


# ---------------------------------------------------------------------------
# switches the port does not take: refused unless at the JAX default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,value", [
    ("VANERF_TWO_RES", "1"), ("VANERF_PE_DIRECT", "1"),
    ("VANERF_MESH_TILE_P", "96"), ("VANERF_MESH_TILE_P", "512"),
    ("VANERF_CULL_CHUNK", "256")])
def test_unported_switch_raises(name, value):
    with _env(**{name: value}):
        with pytest.raises(NotImplementedError, match=name):
            tv._check_env()


@pytest.mark.parametrize("name,value", [
    ("VANERF_TWO_RES", "0"), ("VANERF_PE_DIRECT", ""),
    ("VANERF_CULL_EARLY", "0"), ("VANERF_MESH_TILE_P", "128"),
    ("VANERF_CULL_CHUNK", "128"), ("VANERF_CULL_EARLY", "1"),
    ("VANERF_MESH_TILE_P", "256"), ("VANERF_CULL_CHUNK", "64")])
def test_unported_switch_at_its_default_is_accepted(name, value):
    with _env(**{name: value}):
        tv._check_env()


def test_remat_query_refused_in_training():
    batch = h.torch_batch(h.synthetic_batch()[0])
    with _env(VANERF_REMAT_QUERY="1"):
        with pytest.raises(NotImplementedError, match="VANERF_REMAT_QUERY"):
            tr.render_patch(None, batch, grids=T(h.center_grid()),
                            out_h=h.OUT, out_w=h.OUT, training=True)


# ---------------------------------------------------------------------------
# VANERF_MXU_INTERP: kernel D (its plain version on CPU tensors) or the
# gather sampler, as vanerf_tpu/models/vanerf.py:307-324 reads it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,kernel_d", [
    (None, True), ("1", True), ("force", True), ("0", False), ("", False)])
def test_mxu_interp_switch_picks_the_sampler(value, kernel_d, monkeypatch):
    calls = []
    monkeypatch.setattr(tv, "interp_sample_nhwc",
                        lambda f, xy: calls.append("D") or f[:, :1, 0])
    monkeypatch.setattr(tv, "feat_sample_nhwc",
                        lambda f, xy: calls.append("gather") or f[:, :1, 0])
    f = torch.zeros(1, 32, 32, 4)          # a map kernel D takes
    assert tv.interp_mxu_viable(32, 32)
    xy = torch.zeros(1, 5, 2)
    with _env(VANERF_MXU_INTERP=value), torch.no_grad():
        tv._psamp(f, xy, training=False)
        tv._psamp(f, xy, training=True)     # kernel D has no gradient
    assert calls == ["D" if kernel_d else "gather", "gather"]


# ---------------------------------------------------------------------------
# render_patch keywords against JAX: compute_vis_map by default, fine=False,
# nml_scale, vis_size, sdf_chunk; VANERF_MXU_INTERP=0
# ---------------------------------------------------------------------------

KW = dict(sample_per_ray_c=h.S_C, fine=False, nml_scale=50.0, vis_size=128,
          sdf_chunk=64)
RTOL, ATOL = 1e-3, 1e-4


def _grid():
    """16 rays on the hands and 16 at a corner, as test_torch_render."""
    c = h.center_grid()[0]
    y, x = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    corner = np.stack([x, y], -1).reshape(-1, 2).astype(np.float32)
    return np.concatenate([c, corner], 0)[None]


@pytest.fixture(scope="module")
def renders():
    """JAX's render_patch (its default compute_vis_map) and the port's with
    the same keywords, by default and under VANERF_MXU_INTERP=0."""
    from vanerf_tpu import renderer as jr
    g, _ = h.converted_params()
    batch = h.morton_sorted(h.synthetic_batch()[0])
    grids = _grid()
    with _env(VANERF_FAR_TAU="0", VANERF_MXU_INTERP=None):
        out_j = jr.render_patch(
            h.jax_model(), g,
            {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in batch.items()},
            rng=jax.random.PRNGKey(0), grids=jnp.asarray(grids), out_h=8,
            out_w=4, uniform=True, training=False, n_views=1, **KW)
        out_j = {k: np.asarray(v) for k, v in out_j.items()}
        model, tb = h.port_model(), h.torch_batch(batch)
        kw = dict(grids=T(grids), out_h=8, out_w=4, **KW)
        out_d = tr.render_patch(model, tb, **kw)
        sampled = []
        with pytest.MonkeyPatch.context() as mp:
            real = tv.feat_sample_nhwc
            mp.setattr(tv, "interp_sample_nhwc",
                       lambda *a: sampled.append("D"))
            mp.setattr(tv, "feat_sample_nhwc",
                       lambda *a: sampled.append("gather") or real(*a))
            mp.setenv("VANERF_MXU_INTERP", "0")
            out_g = tr.render_patch(model, tb, **kw)
        # the culled query's early-exit walk on both sides (the JAX CPU
        # path's exact query has no walk to reorder; it runs from the
        # compiled pieces above)
        with _env(VANERF_CULL_EARLY="1"):
            out_je = jr.render_patch(
                h.jax_model(), g,
                {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                 for k, v in batch.items()},
                rng=jax.random.PRNGKey(0), grids=jnp.asarray(grids),
                out_h=8, out_w=4, uniform=True, training=False, n_views=1,
                **KW)
            out_je = {k: np.asarray(v) for k, v in out_je.items()}
            out_e = tr.render_patch(model, tb, **kw)
    return dict(jax=out_j, D=out_d, gather=out_g, sampled=sampled,
                jax_early=out_je, early=out_e)


def _close(out_t, out_j):
    for k in ("tex_fg", "alpha"):
        np.testing.assert_allclose(out_t[k].numpy(), out_j[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    m = out_j["alpha"] > 1e-2
    assert m.any()
    np.testing.assert_allclose(out_t["depth"].numpy()[m], out_j["depth"][m],
                               rtol=RTOL, atol=2e-4, err_msg="depth")


@pytest.mark.parametrize("sampler", ["D", "gather"])
def test_render_patch_fine_false_matches_jax(renders, sampler):
    """fine=False: no fine outputs, and the coarse pass (with nml_scale's
    fill of the samples outside the view) within the render tolerance."""
    out_t, out_j = renders[sampler], renders["jax"]
    assert set(out_t) == set(out_j)
    assert not {"tex_fg_fine", "alpha_fine", "depth_fine", "sdf"} & set(out_t)
    _close(out_t, out_j)
    assert out_t["alpha"].max() > 0.2, "rays missed the fixture mesh"


def test_mxu_interp_off_takes_the_gather_sampler(renders):
    """Under VANERF_MXU_INTERP=0 every map goes through feat_sample_nhwc
    (the JAX CPU path's sampler): the coarse pass equals JAX's within the
    f32 tolerance, and kernel D is never reached."""
    assert renders["sampled"] and set(renders["sampled"]) == {"gather"}
    _close(renders["gather"], renders["jax"])


def test_render_patch_under_cull_early_matches_jax(renders):
    """Eval render_patch under VANERF_CULL_EARLY=1 against JAX under the
    same switch, at the render tolerance; the early walk changes no
    distance, so the SDF equals the default render's."""
    out_t, out_j = renders["early"], renders["jax_early"]
    assert set(out_t) == set(out_j)
    _close(out_t, out_j)
    for k in ("tex_fg", "alpha", "depth"):
        np.testing.assert_allclose(out_t[k].numpy(), renders["D"][k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert out_t["alpha"].max() > 0.2, "rays missed the fixture mesh"


def test_render_patch_vis_map_on_by_default(renders):
    """compute_vis_map defaults to True, as in JAX: vis_img at the grid and
    vis_img_all over the target view."""
    out_j = renders["jax"]
    for sampler in ("D", "gather"):
        out_t = renders[sampler]
        for k in ("vis_img", "vis_img_all"):
            assert out_t[k].shape == out_j[k].shape, k
            np.testing.assert_allclose(out_t[k].numpy(), out_j[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    assert out_j["vis_img_all"].shape == (1, 1, h.H, h.W)


def test_render_patch_vis_size_matches_jax(renders):
    """vis_size is the source-view visibility raster's size: the vertex
    visibility at 128^2 equals JAX's, and differs from the 256^2 one."""
    vis = renders["D"]["vert_vis"].numpy()
    np.testing.assert_array_equal(vis, renders["jax"]["vert_vis"])
    batch = h.torch_batch(h.morton_sorted(h.synthetic_batch()[0]))
    full = tr.encode_frame(h.port_model(), batch, 256)[2].numpy()
    assert vis.shape == full.shape and (vis != full).any()


# ---------------------------------------------------------------------------
# render_full_image: the JAX keywords, and honest refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,err,match", [
    pytest.param(dict(tile_group=3), ValueError, "must divide",
                 id="kw0-item 2"),
    pytest.param(dict(mesh=object()), NotImplementedError, "item 9",
                 id="kw1-item 9")])
def test_render_full_image_refuses_unported_keywords(kw, err, match):
    """``tile_group`` (queue 1 item 2) is ported: one that does not divide
    stride^2 raises, as the JAX package asserts; a device ``mesh`` (item 9)
    is not ported and raises."""
    batch = h.torch_batch(h.synthetic_batch()[0])
    with pytest.raises(err, match=match):
        tr.render_full_image(None, batch, level=3, rng=None, sdf_chunk=64,
                             **kw)


# ---------------------------------------------------------------------------
# kernel 13's workspace: the sizes vt_onehot_scatter checks
# ---------------------------------------------------------------------------

CU = os.path.join(os.path.dirname(tv.__file__), os.pardir, "csrc",
                  "onehot_scatter.cu")


def _defines():
    src = open(CU).read()
    d = {m.group(1): m.group(2) for m in
         re.finditer(r"^#define (OS_\w+) (.+?)\s*(?://.*)?$", src, re.M)}
    val = {}
    for k, v in d.items():
        val[k] = eval(re.sub(r"OS_\w+", lambda m: str(val[m.group(0)]),
                             v).replace("/", "//"))
    return val


def test_scatter_constants_match_the_kernel_source():
    d = _defines()
    assert onehot_gather.SCATTER_SMALL_N == d["OS_SMALL_N"]
    assert onehot_gather.SCATTER_CHUNK == d["OS_CHUNK"]
    assert onehot_gather.SCATTER_SEG == d["OS_SEG"]
    assert onehot_gather.SCATTER_MAX_T == d["OS_MAX_T"]


@pytest.mark.parametrize("n,c,t", [(0, 5, 3), (1284, 256, 1024),
                                   (4096, 32, 4096), (4097, 32, 4096),
                                   (262144, 204, 1284), (262144, 256, 1024),
                                   (262144, 32, 4096), (262144, 5, 8192)])
def test_scatter_workspace_sizes(n, c, t):
    """The workspace layout of csrc/onehot_scatter.cu: nothing up to the
    one-launch limit; else rank | perm | counts | seg | sub | piece_row |
    rowticket | ticket and one partial row per piece."""
    d = _defines()
    ints, floats = onehot_gather.scatter_workspace(n, c, t)
    if n <= d["OS_SMALL_N"]:
        assert (ints, floats) == (0, 0)
        return
    chunks = -(-n // d["OS_CHUNK"])
    pieces = -(-n // d["OS_SEG"]) + t
    layout = dict(rank=n, perm=n, counts=chunks * (t + 1), seg=t + 2,
                  sub=t + 1, piece_row=pieces, rowticket=t, ticket=1)
    assert ints == sum(layout.values())
    assert floats == pieces * c
    assert ints < 2 ** 31 and floats < 2 ** 31


def test_scatter_on_cpu_takes_the_plain_version():
    rs = np.random.RandomState(3)
    g = T(rs.randn(5000, 12).astype(np.float32))
    i = T(rs.randint(0, 37, 5000).astype(np.int32))
    n0 = onehot_gather.launches
    got = onehot_gather.onehot_scatter(g, i, 37)
    assert onehot_gather.launches == n0
    want = np.zeros((37, 12), np.float64)
    np.add.at(want, i.numpy(), g.numpy().astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
