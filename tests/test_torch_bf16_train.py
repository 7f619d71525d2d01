"""The port's bfloat16 training (``compute_dtype="bfloat16"``) against the
JAX package's under ``VANERF_COMPUTE_DTYPE=bfloat16``, on the CPU.

The JAX side runs at the highest matmul precision (what
``VANERF_PRECISION=highest`` sets) and both with the far-field tier off
(``VANERF_FAR_TAU=0``), from the same weights and the same random draws.

Kernel 13.  Off a TPU the JAX package's gathers take XLA's native scatter
in their backward (``vanerf_tpu/ops/onehot_gather.py:53-63``), which on a
bfloat16 table rounds every add to bfloat16; the port's ``take_rows`` sums
in float32 and rounds once, as the JAX kernel does.  So that the reference
is the JAX kernel's semantics, ``onehot_scatter_enabled`` of the JAX
package is patched to the port's policy (every table of at most 8,192
rows); its callers import it at call time, and ``take_rows`` then runs its
Pallas kernel in interpret mode (``VANERF_ONEHOT_BN=16``).  Nothing in the
JAX package is edited.  ``test_take_rows_bf16_plain_matches_jax`` also
prints how far JAX's unpatched native scatter lies from its kernel.

Tolerances, and where they come from:

* kernel 13's plain version on a bfloat16 table against the JAX kernel:
  each element within one bfloat16 unit in the last place, and equal
  wherever the float32 sum is not within 1e-5 (relative) of a bfloat16
  rounding boundary: both sum the same bfloat16 values in float32, in
  other orders, and round once.
* the samplers' table gradients: within one bfloat16 unit of JAX's (the
  same lerp backward, then two float32 sums in other orders and the
  bfloat16 adds of the corner pack's pieces).
* the losses, the render and the generator's gradients: the bounds of
  ``tests/test_torch_bf16.py::near_jax_bf16``.  Each element within 2 S +
  the float32 tolerance (S the largest |bfloat16 - float32| of JAX's
  result); the RMS error at most S / 2 + 2 E (S the RMS of JAX's own
  bfloat16-vs-float32 spread, E the RMS of the two packages' float32
  disagreement), which the port's float32 result must fail.  For the
  gradients, per tensor: a tensor below 1e-6 of the total gradient norm
  (rounding noise in float32) at most that plus twice the norm of JAX's
  bfloat16-vs-float32 spread; the element bound on every other tensor,
  with the float32 tolerance of
  ``tests/test_torch_train.py`` (1e-3, on the texture path 5e-2, of the
  tensor's largest float32 element); the RMS bound on every tensor holding
  at least 1e-3 of the total norm, and the control on those tensors taken
  together.  The gradients of the biases of the bfloat16 dense layers are
  held by the element bound only, with one more bfloat16 unit of each
  element: JAX reduces a bias's cotangent over the points in bfloat16,
  each add rounded, in an order of XLA's choosing, where the port sums it
  in float32 and rounds once (``test_bf16_bias_gradient_sums_in_float32``);
  they lie ~0.4-0.7 S (RMS) from JAX's.
* both packages take the JAX encoder's float32 feature maps (as
  ``tests/test_torch_bf16.py`` does): the port's maps are replaced by JAX's
  values in the forward while their gradient reaches the port's encoder
  (:func:`jax_maps_forward`).  The encoders are float32 and agree to
  float32's tolerance; a cast to bfloat16 would turn those last-bit
  differences into bfloat16 units in ~5% of the maps' values.

Under ``VANERF_FUSED_TRAIN`` both packages sample every map by gather in
the fused forward (``VANERF_MXU_INTERP=0``: JAX's CPU path does not take
kernel D, and the port's kernel D rounds as a hat sum, not a lerp).
"""

import contextlib
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers as h
from test_torch_bf16 import BF, A, bf, rms, ulp_bf16, within_spread
from test_torch_fused import route_and_level0_grads
from test_torch_train import (OUT, TEX_PATH, _capture, _disc_params,
                              _jax_draws, _jbatch, _train_cfg, _vgg_pair)
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.models import mlp as tmlp
from vanerf_tpu_torch.ops import onehot_gather as tog
from vanerf_tpu_torch.ops.grid_sample import grid_sample_2d
from vanerf_tpu_torch.ops.knn import knn_gather_1
from vanerf_tpu_torch.weights import disc_from_jax_params, from_jax_params


def T(x):
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def kernel13_policy(n_rows: int, n_queries: int) -> bool:
    """The port's take_rows policy in place of the JAX package's
    ``onehot_scatter_enabled``."""
    return n_rows <= tog.SCATTER_MAX_T


@contextlib.contextmanager
def switches(cdt: str = "bfloat16", fused: str = "0"):
    """The comparisons' switches on both sides, restored on exit."""
    import vanerf_tpu.ops.onehot_gather as jog
    kv = dict(VANERF_COMPUTE_DTYPE=cdt, VANERF_FUSED_TRAIN=fused,
              VANERF_FAR_TAU="0", VANERF_ONEHOT_BN="16",
              VANERF_MXU_INTERP="0")
    old = {k: os.environ.get(k) for k in list(kv) + ["VANERF_FUSED_MLP"]}
    os.environ.update(kv)
    os.environ.pop("VANERF_FUSED_MLP", None)
    policy = jog.onehot_scatter_enabled
    jog.onehot_scatter_enabled = kernel13_policy
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        jog.onehot_scatter_enabled = policy
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture
def env():
    with switches():
        yield


def near_boundary(s64: np.ndarray, rel: float) -> np.ndarray:
    """Where a sum lies within ``rel`` (relative) of the midpoint between
    the two bfloat16 values around it."""
    a = np.abs(s64).astype(np.float32)
    lo = (a.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    hi = (lo.view(np.uint32) + np.uint32(0x10000)).view(np.float32)
    mid = 0.5 * (lo.astype(np.float64) + hi.astype(np.float64))
    return np.abs(np.abs(s64) - mid) <= rel * np.abs(s64)


# ---------------------------------------------------------------------------
# (a) kernel 13 on a bfloat16 table, and the samplers' table gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [200, 256])
def test_take_rows_bf16_plain_matches_jax(n, env):
    """take_rows on a bfloat16 table: the forward is the gather; the table
    gradient (kernel 13's plain version: float32 sums of the bfloat16
    rows, one rounding) against the JAX take_rows in interpret mode."""
    from vanerf_tpu.ops.onehot_gather import take_rows as j_take_rows
    rs = np.random.RandomState(n)
    t_rows, c = 37, 12
    tj, tt = bf(rs.randn(t_rows, c).astype(np.float32))
    # skewed indices: a few rows take most of the points
    idx = np.minimum(rs.geometric(0.15, n) - 1, t_rows - 1).astype(np.int32)
    gj, gt = bf(rs.randn(n, c).astype(np.float32))
    _, vjp = jax.vjp(lambda tb: j_take_rows(tb, jnp.asarray(idx),
                                            interpret=True), tj)
    (want,) = vjp(gj)
    _, vjp = jax.vjp(lambda tb: tb.at[jnp.asarray(idx)].get(
        mode="promise_in_bounds"), tj)
    (native,) = vjp(gj)

    tab = tt.clone().requires_grad_(True)
    out = tog.take_rows(tab, T(idx))
    assert out.dtype == BF and torch.equal(out, tt[T(idx).long()])
    (got,) = torch.autograd.grad(out, tab, gt)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    assert torch.equal(got, tog.onehot_scatter_plain(gt, T(idx), t_rows))
    assert tog.launches_bf16 == tog.launches == 0
    s64 = np.zeros((t_rows, c))
    np.add.at(s64, idx, A(gt).astype(np.float64))
    err = np.abs(A(got) - A(want))
    ulp = ulp_bf16(np.maximum(np.abs(A(got)), np.abs(A(want))))
    assert (err <= ulp).all()
    assert (err[~near_boundary(s64, 1e-5)] == 0).all()
    nat = np.abs(A(native) - A(want)) / ulp_bf16(np.abs(A(want)))
    print(f"n={n}: the JAX kernel against XLA's native bfloat16 scatter: "
          f"{(nat > 0).mean():.3f} of the elements differ, by up to "
          f"{nat.max():.0f} units")


def _spy_scatter(monkeypatch):
    calls = []
    real = tog.onehot_scatter_plain
    monkeypatch.setattr(tog, "onehot_scatter_plain", lambda g, i, n: calls
                        .append((g.dtype, n)) or real(g, i, n))
    return calls


def test_grid_sample_grad_bf16_through_take_rows_matches_jax(env,
                                                              monkeypatch):
    """The bilinear sampler on a bfloat16 map: its table gradient goes
    through the bfloat16 scatter (on the packed corners) and lies within
    one bfloat16 unit of JAX's."""
    from vanerf_tpu.ops.grid_sample import grid_sample_2d as j_gs
    rs = np.random.RandomState(11)
    fj, ft = bf(rs.randn(8, 16, 5).astype(np.float32))
    uv = rs.uniform(-1.1, 1.1, (300, 2)).astype(np.float32)
    wj, wt = bf(rs.randn(300, 5).astype(np.float32))
    out_j, vjp = jax.vjp(lambda f: j_gs(f, jnp.asarray(uv)), fj)
    (g_j,) = vjp(wj)
    calls = _spy_scatter(monkeypatch)
    leaf = ft.clone().requires_grad_(True)
    out = grid_sample_2d(leaf, T(uv))
    (g_t,) = torch.autograd.grad(out, leaf, wt)
    assert calls == [(BF, 8 * 16)]       # the packed (H*W, 4C) table
    np.testing.assert_array_equal(A(out), A(out_j))
    assert g_t.dtype == BF
    err = np.abs(A(g_t) - A(g_j))
    assert (err <= ulp_bf16(np.maximum(np.abs(A(g_t)), np.abs(A(g_j))))).all()


def test_knn_gather_grad_bf16_through_take_rows_matches_jax(env,
                                                             monkeypatch):
    """The K=1 vertex-feature gather on a bfloat16 table: one bfloat16
    scatter per batch element, the gradient within one bfloat16 unit of
    JAX's."""
    from vanerf_tpu.ops.knn import knn_gather_1 as j_knn
    rs = np.random.RandomState(12)
    B, N, V, C = 2, 160, 2 * 20, 7
    verts = rs.randn(B, V, 3).astype(np.float32)
    fj, ft = bf(rs.randn(B, V, C).astype(np.float32))
    vj, vt = bf((rs.rand(B, V, 1) > 0.5).astype(np.float32))
    idx = rs.randint(0, V, size=(B, N)).astype(np.int32)
    ws = [bf(rs.randn(B, N, k).astype(np.float32)) for k in (C, C, 1, 1)]
    outs_j, vjp = jax.vjp(lambda f: j_knn(
        jnp.zeros((B, N, 3)), jnp.asarray(verts), f, vj, V // 2,
        nn_idx=jnp.asarray(idx)), fj)
    (g_j,) = vjp(tuple(w for w, _ in ws))
    calls = _spy_scatter(monkeypatch)
    leaf = ft.clone().requires_grad_(True)
    outs = knn_gather_1(torch.zeros(B, N, 3), T(verts), leaf, vt, V // 2,
                        T(idx))
    (g_t,) = torch.autograd.grad(outs, leaf, [w for _, w in ws])
    assert calls == [(BF, V), (BF, V)]
    for o, oj in zip(outs, outs_j):
        np.testing.assert_array_equal(A(o), A(oj))
    err = np.abs(A(g_t) - A(g_j))
    assert (err <= ulp_bf16(np.maximum(np.abs(A(g_t)), np.abs(A(g_j))))).all()


def test_bf16_bias_gradient_sums_in_float32():
    """A bfloat16 dense layer's bias gradient is the float32 sum of its
    cotangent over the points, rounded once (torch's sum of bfloat16);
    flax's ``Dense`` in bfloat16 reduces it in bfloat16 (XLA's reduce with a
    bfloat16 accumulator), which lies further from that sum.  The softplus
    and sigmoid gradients round op by op as JAX's rules do: equal to the
    bit."""
    import flax.linen as fnn
    from vanerf_tpu.models.mlp import get_nl
    rs = np.random.RandomState(4)
    N, C = 1024, 24
    xj, xt = bf(rs.randn(N, 16).astype(np.float32))
    gj, gt = bf(rs.randn(N, C).astype(np.float32))
    w = rs.randn(C, 16).astype(np.float32) * 0.2
    b = torch.zeros(C, requires_grad=True)
    out = tmlp.dense(xt, T(w), b)
    (db,) = torch.autograd.grad(out, b, gt)
    f32_sum = A(gt).astype(np.float64).sum(0)
    np.testing.assert_array_equal(A(db), A(gt.float().sum(0).to(BF)))
    dense = fnn.Dense(C, dtype=jnp.bfloat16)
    p = {"params": {"kernel": jnp.asarray(w.T), "bias": jnp.zeros(C)}}
    _, vjp = jax.vjp(lambda pp: dense.apply(pp, xj), p)
    db_j = A(vjp(gj)[0]["params"]["bias"])
    assert np.abs(A(db) - f32_sum).max() < np.abs(db_j - f32_sum).max()
    for name, jfn, tfn in (("softplus", get_nl("softplus"), tmlp.softplus100),
                           ("sigmoid", jax.nn.sigmoid, tmlp.sigmoid)):
        x2j, x2t = bf((rs.randn(N, 8) * 0.1).astype(np.float32))
        c2j, c2t = bf(rs.randn(N, 8).astype(np.float32))
        y_j, vjp = jax.vjp(jfn, x2j)
        leaf = x2t.clone().requires_grad_(True)
        y_t = tfn(leaf)
        (d_t,) = torch.autograd.grad(y_t, leaf, c2t)
        np.testing.assert_array_equal(A(y_t), A(y_j), err_msg=name)
        np.testing.assert_array_equal(A(d_t), A(vjp(c2j)[0]), err_msg=name)


# ---------------------------------------------------------------------------
# (b) VANERF_FUSED_TRAIN's backward is the level-0 query's gradient
# ---------------------------------------------------------------------------

def _port_model(cdt: str):
    from vanerf_tpu_torch.models import VANeRF
    g, _ = h.converted_params()
    cfg = h.small_cfg()
    cfg["models"]["VANeRF"]["compute_dtype"] = cdt
    model = VANeRF.from_config(cfg, num_v=h.NUM_V, image_hw=(h.H, h.W))
    model.load_state_dict(from_jax_params(g), strict=True)
    assert model.compute_dtype == cdt
    return model.eval()


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", [1, 2])
def test_fused_train_backward_is_level0(cdt, level, monkeypatch):
    """For a fixed cotangent, the route ``VANERF_FUSED_TRAIN=<level>``
    takes (``fused_train_query``) gives the gradients of
    ``query(fused_override=0)`` for the points, the view, the maps, the
    visibility / SDF and every parameter, bit for bit, in both dtypes; its
    forward is the fused level's."""
    monkeypatch.delenv("VANERF_COMPUTE_DTYPE", raising=False)
    (out_r, g_r), (out_0, g_0), fused = route_and_level0_grads(
        _port_model(cdt), level)
    assert torch.equal(out_r, fused) and not torch.equal(out_r, out_0)
    used = 0
    for a, b in zip(g_r, g_0):
        assert (a is None) == (b is None)
        if a is not None:
            used += 1
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert used > 20


# ---------------------------------------------------------------------------
# (c) the training render and the GAN step against JAX
# ---------------------------------------------------------------------------

def _jax_map_values(params=None):
    """The JAX encoder's float32 maps of the fixture image (numpy), with
    ``params`` or the tests' weights."""
    if params is None:
        params, _ = h.converted_params()
    jm = h.jax_model()
    fg, ft = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode))(
        params, jnp.asarray(h.synthetic_batch()[0]["src_img"]))
    return [A(f) for f in fg], A(ft)


class _Values(torch.autograd.Function):
    """``want``'s values with ``x``'s gradient."""

    @staticmethod
    def forward(ctx, x, want):
        return want.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def jax_maps_forward(model, params=None) -> None:
    """Make ``model.encode`` return the JAX encoder's map values (with
    ``params``), their gradients flowing to the port's encoder."""
    fg_j, ft_j = _jax_map_values(params)
    real = type(model).encode.__get__(model)

    def encode(im):
        fg, ft = real(im)
        return ([_Values.apply(a, T(b)) for a, b in zip(fg, fg_j)],
                _Values.apply(ft, T(ft_j)))
    model.encode = encode


@functools.lru_cache(maxsize=None)
def _jax_render(cdt: str):
    from vanerf_tpu import renderer as jr
    with switches(cdt):
        g, _ = h.converted_params()
        jb = _jbatch()
        key = jax.random.PRNGKey(21)
        _, krender = jax.random.split(key)
        dr = _jax_draws(key, jb)
        jm = h.jax_model()
        out = jax.jit(lambda p, b, k, gr: jr.render_patch(
            jm, p, b, rng=k, grids=gr, out_h=OUT, out_w=OUT,
            sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F, fine=True,
            uniform=False, rand_noise_std=0.01, training=True, n_views=1,
            sdf_chunk=64))(g, jb, krender, jnp.asarray(dr["grids"]))
        return {k: A(v) for k, v in out.items()}, dr


def test_render_patch_training_bf16_matches_jax():
    """``render_patch(training=True)`` in bfloat16 against the JAX
    package's under the same draws: float32 outputs that carry a graph,
    each held by :func:`near_jax_bf16` with the float32 render test's
    tolerance (rtol 1e-3 / atol 1e-4; depth on hit rays atol 2e-4), the
    port's float32 render the control (not for the alphas, which
    saturate)."""
    from test_torch_bf16 import near_jax_bf16
    want, dr = _jax_render("bfloat16")
    want_f32, _ = _jax_render("float32")
    got = {}
    for cdt in ("bfloat16", "float32"):
        with switches(cdt):
            model = _port_model(cdt)
            jax_maps_forward(model)
            got[cdt] = tr.render_patch(
                model, h.torch_batch(h.synthetic_batch()[0]),
                grids=T(dr["grids"]), out_h=OUT, out_w=OUT,
                sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F,
                training=True, compute_vis_map=True, rand_noise_std=0.01,
                draws=dr)
    g16, g32 = got["bfloat16"], got["float32"]
    assert g16["tex_fg_fine"].requires_grad
    assert g16["alpha_fine"].max() > 0.2, "rays missed the fixture mesh"
    for k in ("alpha", "alpha_fine"):
        near_jax_bf16(g16[k], g32[k], want[k], want_f32[k], 1e-3, 1e-4, k,
                      control=False)
    for k in ("tex_fg", "tex_fg_fine"):
        # the float32 render test's face-edge tie: where the float32
        # colours already differ beyond its tolerance (at most 2 of the 64
        # pixels, by less than 0.02) the bfloat16 ones are held to that
        a, b = A(g16[k]), want[k]
        tie = ~np.isclose(A(g32[k]), want_f32[k], rtol=1e-3,
                          atol=1e-4).all(-1)
        assert tie.sum() <= 2 and np.abs(a - b)[tie].max(initial=0) < 0.02
        assert g16[k].dtype == torch.float32
        near_jax_bf16(a[~tie], A(g32[k])[~tie], b[~tie], want_f32[k][~tie],
                      1e-3, 1e-4, k)
    for k, acck in (("depth", "alpha"), ("depth_fine", "alpha_fine")):
        m = want[acck] > 1e-2
        assert m.any()
        near_jax_bf16(A(g16[k])[m], A(g32[k])[m], want[k][m],
                      want_f32[k][m], 1e-3, 2e-4, k)


@functools.lru_cache(maxsize=None)
def _jax_step(cdt: str, fused: str = "0", faithful: bool = False):
    """One JAX GAN step: (logs, generator gradients by the port's names,
    post-Adam generator as a port state dict)."""
    import optax
    from vanerf_tpu.models import DiscriminatorVis as JDisc
    from vanerf_tpu.training.train_step import (TrainState,
                                                make_lr_schedule,
                                                make_train_step as j_make)
    with switches(cdt, fused):
        cfg = _train_cfg(faithful)
        g, _ = h.converted_params()
        d = _disc_params()
        vgg_j, _ = _vgg_pair()
        sched = make_lr_schedule(cfg["training"]["lr"], 10)
        tx_g = optax.chain(_capture(), optax.adam(sched))
        tx_d = optax.chain(_capture(), optax.adam(sched))
        state = TrainState(g, d, tx_g.init(g), tx_d.init(d),
                           jnp.zeros((), jnp.int32))
        new, logs = jax.jit(j_make(h.jax_model(), JDisc(), tx_g, tx_d, cfg,
                                   vgg_j))(state, _jbatch(),
                                           jax.random.PRNGKey(3))
        np_tree = lambda t: jax.tree.map(np.asarray, t)    # noqa: E731
        return ({k: float(v) for k, v in logs.items()},
                {k: v.numpy() for k, v in
                 from_jax_params(np_tree(new.opt_g[0])).items()},
                new.params_g)


def _port_step(cdt: str, fused: str = "0", faithful: bool = False):
    """The port's step on the same draws: (logs, generator gradients); in
    the faithful mode the D render runs through JAX's post-Adam generator
    and its maps, so that both D steps see one patch."""
    from vanerf_tpu_torch.models import DiscriminatorVis
    from vanerf_tpu_torch.training import create_train_state, make_train_step
    post = _jax_step(cdt, fused, faithful)[2] if faithful else None
    with switches(cdt, fused):
        cfg = _train_cfg(faithful)
        jb = _jbatch()
        rg, rd = jax.random.split(jax.random.PRNGKey(3))
        draws = {"g": _jax_draws(rg, jb), "d": _jax_draws(rd, jb)}
        model = _port_model(cdt)
        jax_maps_forward(model)
        disc = DiscriminatorVis()
        disc.load_state_dict(disc_from_jax_params(_disc_params()),
                             strict=True)
        st = create_train_state(model, disc, cfg, steps_per_epoch=10)
        seen = {}
        step_g = st.opt_g.step

        def hooked(grads):
            seen["g"] = grads
            step_g(grads)
            if post is not None:
                model.load_state_dict(from_jax_params(
                    jax.tree.map(np.asarray, post)))
                jax_maps_forward(model, post)
        st.opt_g.step = hooked
        _, vgg_t = _vgg_pair()
        logs = make_train_step(model, disc, cfg, vgg_t)(
            st, h.torch_batch(h.synthetic_batch()[0]), draws=draws)
        names = [n for n, _ in model.named_parameters()]
        return ({k: float(v) for k, v in logs.items()},
                {n: (np.zeros(p.shape, np.float32) if gr is None
                     else A(gr)) for n, p, gr in
                 zip(names, st.opt_g.params, seen["g"])})


def _bf16_bias(name: str) -> bool:
    """The bias of a dense layer that computes in bfloat16."""
    return name.endswith(".bias") and name.startswith(
        ("mlp_geo.", "ibr_compress_gfeat.", "mlp_tex."))


def hold_step(fused: str = "0", faithful: bool = False):
    """The port's bfloat16 step against JAX's (module note); returns the
    readings."""
    got, grads = _port_step("bfloat16", fused, faithful)
    got32, grads32 = _port_step("float32", fused, faithful)
    want, jgrads = _jax_step("bfloat16", fused, faithful)[:2]
    want32, jgrads32 = _jax_step("float32", fused, faithful)[:2]
    assert set(got) == set(want)
    # the losses, as one vector
    keys = sorted(want)
    vec = [np.array([d[k] for k in keys]) for d in (got, got32, want,
                                                    want32)]
    within_spread(vec[0], vec[2], vec[3], 1e-4, 1e-7, "losses")
    S, E = rms(vec[2] - vec[3]), rms(vec[1] - vec[3])
    assert S > 0, "bfloat16 did not move JAX's losses"
    assert rms(vec[0] - vec[2]) <= S / 2 + 2 * E, ("losses", S, E)
    assert rms(vec[1] - vec[2]) > S / 2 + 2 * E, "float32 control passes"
    # the generator's gradients, per tensor
    total = np.sqrt(sum(float(np.square(jgrads32[n]).sum()) for n in grads))
    rows, ctrl_parts = [], []
    for n in grads:
        w, w32 = jgrads[n].reshape(-1), jgrads32[n].reshape(-1)
        g, g32 = grads[n].reshape(-1), grads32[n].reshape(-1)
        share = np.linalg.norm(w32) / total
        if share < 1e-6:
            # rounding noise in float32 (tests/test_torch_train.py), which
            # bfloat16 may grow by twice JAX's own spread
            assert (np.linalg.norm(g) < 1e-6 * total
                    + 2 * np.linalg.norm(w - w32)), n
            continue
        tol = (5e-2 if n.startswith(TEX_PATH) else 1e-3) * np.abs(w32).max()
        # a bias of a bfloat16 layer: one more bfloat16 unit of the value
        # (2^-7 of it bounds the unit) for the two ways of summing
        within_spread(g, w, w32, 2.0 ** -7 if _bf16_bias(n) else 0.0, tol,
                      n)
        if share < 1e-3 or _bf16_bias(n):
            continue
        S, E = rms(w - w32), rms(g32 - w32)
        err = rms(g - w)
        rows.append((err / (S / 2 + 2 * E), n, err / S))
        assert err <= S / 2 + 2 * E, (n, "RMS error", err / S, "S; E", E / S)
        ctrl_parts.append((g32, w, w32))
    assert len(rows) >= 10
    g32, w, w32 = (np.concatenate(p) for p in zip(*ctrl_parts))
    S, E = rms(w - w32), rms(g32 - w32)
    ctrl = rms(g32 - w)
    assert ctrl > S / 2 + 2 * E, ("the float32 step passes", ctrl / S)
    rows.sort(reverse=True)
    print(f"{len(rows)} tensors; worst {rows[0][1]}: {rows[0][2]:.3f} S, "
          f"{rows[0][0]:.3f} of its bound; the float32 step {ctrl / S:.3f} "
          f"S against a bound of {(S / 2 + 2 * E) / S:.3f} S")
    return rows


@pytest.mark.parametrize("faithful", [
    # the faithful JAX step compiles two renders: over a minute on one CPU
    pytest.param(True, marks=pytest.mark.slow), False])
def test_train_step_bf16_matches_jax(faithful):
    """One GAN step of a bfloat16 model (``create_train_state`` /
    ``make_train_step``, G update then D update) against the JAX package's
    bfloat16 step with the same draws: the losses and every generator
    gradient within the module note's bounds, which the same step kept in
    float32 fails."""
    hold_step("0", faithful)


def test_fused_train_bf16_matches_jax():
    """The same step under ``VANERF_FUSED_TRAIN=2`` in bfloat16: the fused
    forward (kernel 11's plain version; JAX's Pallas kernel in interpret
    mode) with the level-0 query's gradients, against JAX's fused-train
    step at the same bounds."""
    hold_step("2")
