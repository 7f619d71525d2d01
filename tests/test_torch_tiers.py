"""The port's serving tiers (VANERF_FAR_SKIP / VANERF_FAR_NET /
VANERF_FAR_TNET, ``vanerf_tpu_torch/renderer.py``) against the JAX
renderer, on the CPU, mirroring ``tests/test_far_skip.py``.

One fixture, one encode and one set of weights serve the module: 8 x 8
rays on the hands, 8 + 8 samples, the 32^2 two-hand fixture.  Under each
switch the port's ``render_patch`` is held against JAX's under the same
switch at the tolerance of ``test_render_patch_matches_jax`` (rtol 1e-3 /
atol 1e-4 on colours and alphas, on every pixel: both packages get the
faces in the port's Morton order, ``torch_port_helpers.morton_sorted``, so
exact face ties fall alike).  Both packages pick the budget's samples by a
stable sort of the same certified nearest-vertex distances, so they
evaluate the same rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_helpers as h
from test_torch_render import T, _compare, _jbatch
from vanerf_tpu_torch import renderer as tr

OUT = 8
TIERS = ("VANERF_FAR_SKIP", "VANERF_FAR_NET", "VANERF_FAR_TNET")


def _grid():
    lo = h.W // 2 - OUT // 2
    y, x = np.meshgrid(np.arange(lo, lo + OUT), np.arange(lo, lo + OUT),
                       indexing="ij")
    return np.stack([x, y], -1).reshape(1, -1, 2).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """Models, batches and the frame's encode of both packages (the vertex
    visibility is the port's: the two are equal,
    ``test_render_patch_matches_jax``)."""
    g, _ = h.converted_params()
    batch = h.morton_sorted(h.synthetic_batch()[0])
    jm, pm = h.jax_model(), h.port_model()
    jb, tb = _jbatch(batch), h.torch_batch(batch)
    with torch.no_grad():
        cached_t = tr.encode_frame(pm, tb)
    fg, ft = jm.apply(g, jb["src_img"], method=jm.encode)
    cached_j = (fg, ft, jnp.asarray(cached_t[2].numpy()))
    return dict(jm=jm, g=g, jb=jb, pm=pm, tb=tb, cached_j=cached_j,
                cached_t=cached_t)


def _clear(monkeypatch):
    for k in TIERS + ("VANERF_FAR_TAU", "VANERF_TNET_IMPL",
                      "VANERF_TNET_STEPS", "VANERF_SOA_POINTS",
                      "VANERF_FUSED_MLP"):
        monkeypatch.delenv(k, raising=False)


def _port(scene, model=None, **kw):
    return tr.render_patch(model or scene["pm"], scene["tb"],
                           grids=T(_grid()), out_h=OUT, out_w=OUT,
                           sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F,
                           cached=scene["cached_t"], **kw)


def _jax(scene, params=None):
    from vanerf_tpu import renderer as jr
    return jr.render_patch(
        scene["jm"], params or scene["g"], scene["jb"],
        rng=jax.random.PRNGKey(0), grids=jnp.asarray(_grid()), out_h=OUT,
        out_w=OUT, sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F, fine=True,
        uniform=True, training=False, n_views=1, sdf_chunk=64,
        compute_vis_map=False, cached=scene["cached_j"])


def _against_jax(scene, params=None, model=None):
    """The port's render under the current switches against JAX's."""
    out_j = _jax(scene, params)
    out_t = _port(scene, model)
    _compare(out_j, out_t)
    for k, v in out_t.items():
        if torch.is_tensor(v) and v.is_floating_point():
            assert torch.isfinite(v).all(), k
    assert out_t["alpha_fine"].max() > 0.2, "rays missed the fixture mesh"
    return out_t


def _trained_beta(scene):
    """Port model and JAX params at sigmoid_beta = 5e-3, the trained regime
    of ``tests/test_far_skip.py:80``: the prior density saturates within
    ~1 cm of the surface."""
    import copy
    import flax
    pm = copy.deepcopy(scene["pm"])
    with torch.no_grad():
        pm.sigmoid_beta.fill_(5e-3)
    params = flax.core.unfreeze(jax.tree.map(lambda x: x, scene["g"]))
    params["params"]["sigmoid_beta"] = jnp.full((1,), 5e-3)
    return pm, params


def _training_render(scene, seed=3):
    rs = np.random.RandomState(seed)
    P = OUT * OUT
    draws = {"u_c": rs.rand(1, P, h.S_C).astype(np.float32),
             "u_f": rs.rand(1, P, h.S_F).astype(np.float32),
             "noise_c": rs.randn(1, P * h.S_C, 1).astype(np.float32),
             "noise_f": rs.randn(1, P * h.S_F, 1).astype(np.float32)}
    with torch.no_grad():
        return _port(scene, training=True, rand_noise_std=0.01, draws=draws)


# ---------------------------------------------------------------------------
# VANERF_FAR_SKIP
# ---------------------------------------------------------------------------

def test_far_skip_full_budget_lossless(scene, monkeypatch):
    """frac = 1.0 runs every sample through the compaction: the within-ray
    permutation and the scatter back reproduce the base render (rtol 1e-6 /
    atol 1e-7, ``tests/test_far_skip.py:64``)."""
    _clear(monkeypatch)
    base = _port(scene)
    monkeypatch.setenv("VANERF_FAR_SKIP", "1.0")
    rows = []
    real = scene["pm"].query
    monkeypatch.setattr(scene["pm"], "query", lambda *a, **k: rows.append(
        (a[0].shape[1], a[12])) or real(*a, **k))
    skip = _against_jax(scene)
    assert rows == [(OUT * OUT * h.S_C, h.S_C), (OUT * OUT * h.S_F, h.S_F)]
    for k, v in base.items():
        if torch.is_tensor(v) and v.is_floating_point():
            np.testing.assert_allclose(skip[k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_far_skip_half_budget(scene, monkeypatch):
    """frac = 0.5 against JAX under the same switch; the network sees half
    the rows, as 4 samples a ray."""
    _clear(monkeypatch)
    monkeypatch.setenv("VANERF_FAR_SKIP", "0.5")
    rows = []
    real = scene["pm"].query
    monkeypatch.setattr(scene["pm"], "query", lambda *a, **k: rows.append(
        (a[0].shape[1], a[12])) or real(*a, **k))
    _against_jax(scene)
    assert rows == [(OUT * OUT * 4, 4)] * 2


def test_far_skip_trained_regime_stays_close(scene, monkeypatch):
    """At the trained sigmoid_beta a 6-of-8 budget drops samples that carry
    ~no weight: the image stays within 0.02 mean absolute colour of the
    exact one (``tests/test_far_skip.py:79``), and equals JAX's."""
    _clear(monkeypatch)
    pm, params = _trained_beta(scene)
    base = _port(scene, pm)
    monkeypatch.setenv("VANERF_FAR_SKIP", "0.75")
    skip = _against_jax(scene, params, pm)
    diff = (skip["tex_fg_fine"] - base["tex_fg_fine"]).abs().mean()
    assert float(diff) < 0.02, float(diff)


def test_far_skip_composes_with_far_tau(scene, monkeypatch):
    _clear(monkeypatch)
    monkeypatch.setenv("VANERF_FAR_TAU", "0.05")
    monkeypatch.setenv("VANERF_FAR_SKIP", "0.5")
    far_rows = []
    real = scene["pm"].query
    monkeypatch.setattr(scene["pm"], "query", lambda *a, **k: far_rows.append(
        k["far_mask"]) or real(*a, **k))
    _against_jax(scene)
    # the far flags travel with the compacted rows
    assert all(f is not None and f.shape == (1, OUT * OUT * 4, 1)
               and f.dtype == torch.bool for f in far_rows)


# ---------------------------------------------------------------------------
# VANERF_FAR_NET
# ---------------------------------------------------------------------------

def test_far_net_global_budget(scene, monkeypatch):
    """A generous global budget tracks the exact render
    (``tests/test_far_skip.py:119``), equals JAX's under the switch, and
    composes with the far tier."""
    _clear(monkeypatch)
    monkeypatch.setenv("VANERF_FAR_TAU", "0")
    exact = _port(scene)
    monkeypatch.setenv("VANERF_FAR_NET", "0.8")
    rows = []
    real = scene["pm"].query
    monkeypatch.setattr(scene["pm"], "query", lambda *a, **k: rows.append(
        (a[0].shape[1], a[12])) or real(*a, **k))
    budget = _against_jax(scene)
    # round(512 * 0.8) = 410, rounded up to 128 rows: 512 = every row, so
    # the tier is off (renderer.py:536-539)
    assert rows == [(512, 8)] * 2
    monkeypatch.setenv("VANERF_FAR_NET", "0.7")      # 358 -> 384 rows
    del rows[:]
    budget = _against_jax(scene)
    assert rows == [(384, 384)] * 2
    # (the JAX test's 0.8 budget keeps every row here; at 384 of 512 rows
    # and the initial sigmoid_beta the mean colour moves by 0.009)
    d = (budget["tex_fg_fine"] - exact["tex_fg_fine"]).abs().mean()
    assert float(d) < 2e-2, float(d)
    da = (budget["alpha_fine"] - exact["alpha_fine"]).abs().mean()
    assert float(da) < 2e-2, float(da)
    monkeypatch.setenv("VANERF_FAR_TAU", "0.05")
    _against_jax(scene)


# ---------------------------------------------------------------------------
# VANERF_FAR_TNET and the inheritance helpers
# ---------------------------------------------------------------------------

def test_inherit_nearest_evaluated_unit():
    """Each skipped sample copies its nearest evaluated neighbour by depth;
    rays with none keep their zero rows; and the JAX function agrees."""
    from vanerf_tpu.renderer import inherit_nearest_evaluated as jfn
    z = np.array([[0., 1., 2., 3., 4., 5., 0., 1., 2., 3., 4., 5.]],
                 np.float32)                                 # 2 rays x 6
    ev = np.zeros((1, 12), bool)
    ev[0, [1, 4]] = True
    full = np.zeros((1, 12, 2), np.float32)
    full[0, 1] = [10., 1.]
    full[0, 4] = [40., 1.]
    out = tr.inherit_nearest_evaluated(T(full), T(ev), T(z), 6).numpy()
    np.testing.assert_allclose(out[0, :6, 0], [10, 10, 10, 40, 40, 40])
    np.testing.assert_allclose(out[0, :6, 1], 1.0)
    np.testing.assert_allclose(out[0, 6:], 0.0)
    np.testing.assert_array_equal(
        out, np.asarray(jfn(jnp.asarray(full), jnp.asarray(ev),
                            jnp.asarray(z), 6)))


def test_inherit_tie_prefers_forward():
    z = np.array([[0., 1., 2., 3.]], np.float32)
    ev = np.array([[True, False, False, True]])
    full = np.zeros((1, 4, 1), np.float32)
    full[0, 0, 0], full[0, 3, 0] = 5., 9.
    out = tr.inherit_nearest_evaluated(T(full), T(ev), T(z), 4).numpy()
    np.testing.assert_allclose(out[0, :, 0], [5, 5, 9, 9])
    z_tie = np.array([[0., 1., 2.]], np.float32)      # slot 1 equidistant
    ev = np.array([[True, False, True]])
    full = np.zeros((1, 3, 1), np.float32)
    full[0, 0, 0], full[0, 2, 0] = 5., 9.
    out = tr.inherit_nearest_evaluated(T(full), T(ev), T(z_tie), 3).numpy()
    np.testing.assert_allclose(out[0, :, 0], [5, 5, 9])


@pytest.mark.parametrize("steps", [4, 2])
def test_inherit_select_matches_scan_and_jax(steps):
    """The select fill equals the scan when 2^steps - 1 >= S - 1 (random
    patterns, distinct depths), and the JAX functions at any reach."""
    from vanerf_tpu.renderer import (inherit_nearest_evaluated,
                                     inherit_nearest_evaluated_select)
    rng = np.random.default_rng(11)
    B, Pn, S, C = 2, 7, 16, 3
    z = np.sort(rng.uniform(0, 1, (B, Pn, S)), -1).reshape(B, -1) \
        .astype(np.float32)
    ev = rng.random((B, Pn * S)) < 0.3
    full = np.where(ev[..., None], rng.normal(size=(B, Pn * S, C)), 0.0) \
        .astype(np.float32)
    a = tr.inherit_nearest_evaluated(T(full), T(ev), T(z), S).numpy()
    b = tr.inherit_nearest_evaluated_select(T(full), T(ev), T(z), S,
                                            steps=steps).numpy()
    if steps == 4:
        np.testing.assert_allclose(b, a, atol=1e-6)
    else:
        assert (b != a).any(), "reach 3 leaves far samples on zero rows"
    args = (jnp.asarray(full), jnp.asarray(ev), jnp.asarray(z), S)
    np.testing.assert_array_equal(a, np.asarray(
        inherit_nearest_evaluated(*args)))
    np.testing.assert_array_equal(b, np.asarray(
        inherit_nearest_evaluated_select(*args, steps=steps)))


def test_inherit_select_bounded_reach():
    S = 16
    z = torch.arange(S, dtype=torch.float32)[None]
    ev = torch.zeros(1, S, dtype=torch.bool)
    ev[0, 0] = True
    full = torch.zeros(1, S, 1)
    full[0, 0, 0] = 7.0
    out = tr.inherit_nearest_evaluated_select(full, ev, z, S, steps=2)
    np.testing.assert_allclose(out[0, :4, 0].numpy(), 7.0)      # reach 3
    np.testing.assert_allclose(out[0, 4:, 0].numpy(), 0.0)


@pytest.mark.parametrize("impl", ["select", "scan"])
def test_far_tnet_render(scene, impl, monkeypatch):
    """FAR_TNET against JAX under the same switch, with both fills; at
    S = 8 the select fill's reach of 15 covers a ray, so the two agree."""
    _clear(monkeypatch)
    monkeypatch.setenv("VANERF_FAR_TNET", "0.5")
    monkeypatch.setenv("VANERF_TNET_IMPL", impl)
    used = []
    for name in ("inherit_nearest_evaluated",
                 "inherit_nearest_evaluated_select"):
        real = getattr(tr, name)
        monkeypatch.setattr(tr, name, lambda *a, _r=real, _n=name, **k:
                            used.append((_n, k.get("steps"))) or _r(*a, **k))
    out = _against_jax(scene)
    want = (("inherit_nearest_evaluated", None) if impl == "scan"
            else ("inherit_nearest_evaluated_select", 4))
    assert used == [want] * 2
    monkeypatch.setenv("VANERF_TNET_IMPL", "scan" if impl == "select"
                       else "select")
    other = _port(scene)
    for k in ("tex_fg", "tex_fg_fine", "alpha_fine"):
        np.testing.assert_allclose(other[k].numpy(), out[k].numpy(),
                                   atol=1e-6, err_msg=k)


def test_far_tnet_steps_switch(scene, monkeypatch):
    """VANERF_TNET_STEPS bounds the select fill's reach: one step (reach 1)
    leaves samples on the mesh prior that four steps fill, and JAX agrees."""
    _clear(monkeypatch)
    monkeypatch.setenv("VANERF_FAR_TNET", "0.25")
    full = _port(scene)
    monkeypatch.setenv("VANERF_TNET_STEPS", "1")
    short = _against_jax(scene)
    assert (short["tex_fg_fine"] - full["tex_fg_fine"]).abs().max() > 1e-4


def test_far_tnet_trained_regime_no_farther_than_far_net(scene, monkeypatch):
    """At the trained sigmoid_beta the inheritance removes FAR_NET's cliff
    at the budget boundary: the same budget is at least as close to the
    exact image (``tests/test_far_skip.py:302``)."""
    _clear(monkeypatch)
    pm, _ = _trained_beta(scene)
    base = _port(scene, pm)
    monkeypatch.setenv("VANERF_FAR_TNET", "0.5")
    tnet = _port(scene, pm)
    monkeypatch.delenv("VANERF_FAR_TNET")
    monkeypatch.setenv("VANERF_FAR_NET", "0.5")
    net = _port(scene, pm)
    for k, v in tnet.items():
        if torch.is_tensor(v) and v.is_floating_point():
            assert torch.isfinite(v).all(), k
    assert tnet["alpha_fine"].max() > 0.2
    d_tnet = float((tnet["tex_fg_fine"] - base["tex_fg_fine"]).abs().mean())
    d_net = float((net["tex_fg_fine"] - base["tex_fg_fine"]).abs().mean())
    assert d_tnet < 0.05, d_tnet
    assert d_tnet <= d_net + 1e-3, (d_tnet, d_net)


# ---------------------------------------------------------------------------
# guards, precedence, budgets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("switch", TIERS)
def test_tiers_ignored_in_training(scene, switch, monkeypatch):
    """The budgets are serving-only: a training render with the same draws
    is identical with a tier set (``tests/test_far_skip.py:184``)."""
    _clear(monkeypatch)
    base = _training_render(scene)
    monkeypatch.setenv(switch, "0.5")
    tier = _training_render(scene)
    for k, v in base.items():
        if torch.is_tensor(v):
            assert torch.equal(tier[k], v), k


@pytest.mark.parametrize("guard", ["VANERF_FUSED_MLP", "VANERF_SOA_POINTS"])
def test_tiers_off_under_fused_and_soa(scene, guard, monkeypatch):
    _clear(monkeypatch)
    monkeypatch.setenv(guard, "2" if guard == "VANERF_FUSED_MLP" else "1")
    base = _port(scene)
    for switch in TIERS:
        monkeypatch.setenv(switch, "0.5")
    tier = _port(scene)
    for k, v in base.items():
        if torch.is_tensor(v):
            assert torch.equal(tier[k], v), k


def test_tier_precedence_and_config_values(scene, monkeypatch):
    """TNET > NET > SKIP; the config's ``inference`` values count when the
    switch is unset, and an env value (even 0) overrides them."""
    import copy
    _clear(monkeypatch)
    pm = copy.deepcopy(scene["pm"])
    rows, fills = [], []
    real = pm.query
    pm.query = lambda *a, **k: rows.append(a[0].shape[1]) or real(*a, **k)
    real_fill = tr.inherit_nearest_evaluated_select
    monkeypatch.setattr(tr, "inherit_nearest_evaluated_select",
                        lambda *a, **k: fills.append(1) or real_fill(*a, **k))

    def run(**env):
        del rows[:], fills[:]
        for k in TIERS:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        _port(scene, pm)
        return rows[0], len(fills)

    assert run() == (512, 0)
    assert run(VANERF_FAR_SKIP="0.5") == (256, 0)
    assert run(VANERF_FAR_SKIP="0.5", VANERF_FAR_NET="0.25") == (128, 0)
    assert run(VANERF_FAR_SKIP="0.5", VANERF_FAR_NET="0.25",
               VANERF_FAR_TNET="0.75") == (384, 2)
    # FAR_TNET = 1 is no budget: FAR_NET's stands
    assert run(VANERF_FAR_NET="0.25", VANERF_FAR_TNET="1") == (128, 0)
    pm.far_skip = 0.25
    assert run() == (128, 0)                       # 2 samples a ray
    assert run(VANERF_FAR_SKIP="0") == (512, 0)
    pm.far_skip, pm.far_tnet = 0.0, 0.5
    assert run() == (256, 2)
    with pytest.raises(ValueError):
        run(VANERF_FAR_NET="half")


@pytest.mark.parametrize("n_total,n_samples,fracs,want", [
    (262144, 64, (0.0, 0.0, 0.0), (0, 0, False)),
    (262144, 64, (0.5, 0.0, 0.0), (0, 32, False)),
    (262144, 64, (1.0, 0.0, 0.0), (0, 64, False)),
    (262144, 64, (0.01, 0.0, 0.0), (0, 1, False)),
    (262144, 64, (0.5, 0.3, 0.0), (78720, 0, False)),
    (262144, 64, (0.0, 0.3, 0.5), (131072, 0, True)),
    (262144, 64, (0.0, 0.9999, 0.0), (0, 0, False)),
    (512, 8, (0.0, 0.0001, 0.0), (128, 0, False)),
    (100, 4, (0.0, 0.5, 0.0), (0, 0, False))])
def test_network_budget(n_total, n_samples, fracs, want):
    """The budgets of ``vanerf_tpu/renderer.py:530-543``: kc rounded up to
    128 rows and off when that is every row, ks at least one sample."""
    assert tr._network_budget(n_total, n_samples, *fracs) == want
    kc = want[0]
    assert kc % 128 == 0 and kc < n_total
