"""The port's fused-MLP serving configuration (``VANERF_FUSED_MLP=1/2``,
the row gather, ``VANERF_FUSED_TRAIN``) against the JAX package and
against the port's own unfused path, on the CPU.

On the CPU every wrapper of ``vanerf_tpu_torch/ops/fused_mlp.py`` and
``ops/interp_mxu.py`` runs its plain version; the JAX side runs its Pallas
kernels in interpret mode, in float32 at the highest matmul precision.
Level 2 needs the shipped widths (64 / 8 / 8 / 24 channels, 42 keypoints),
so the tests use few points, not narrow layers.

Tolerances: prepared weights atol 1e-6 (the same weight norm in two
frameworks); kernels and renders rtol 2e-4 / atol 2e-5 (the bound of
``tests/test_renderer_train.py::test_render_patch_fused_mlp_matches``:
float32 with other summation orders); the row gather exact; the fused
training step against the unfused one: losses rtol 5e-3 / atol 5e-4, each
gradient's largest error <= 1e-2 of its largest element + 1e-4 (the bounds
of ``test_train_step_fused_train_matches``).  The tests marked ``cuda``
hold each new kernel against its plain version on a GPU and skip without
one; run them there with
``python -m pytest tests/test_torch_fused.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

import torch_port_helpers as h
from vanerf_tpu_torch import ops
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.models import vanerf as tv
from vanerf_tpu_torch.ops import fused_mlp as tf
from vanerf_tpu_torch.ops import interp_mxu as ti
from vanerf_tpu_torch.ops import knn as tk

RTOL, ATOL = 2e-4, 2e-5
KW = dict(sp_level=3, scale=1.0, sigma=0.1)


def T(x):
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def A(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


@pytest.fixture
def exact(monkeypatch):
    """float32 at the highest matmul precision on the JAX side."""
    import jax
    monkeypatch.setenv("VANERF_COMPUTE_DTYPE", "float32")
    with jax.default_matmul_precision("highest"):
        yield


def _kernel_inputs(n: int, seed: int = 0) -> dict:
    """Seeded inputs of both fused kernels for n points."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    vis = lambda: (rs.rand(n, 1) > 0.4).astype(f32)        # noqa: E731
    pw = rs.rand(n, 1).astype(f32)
    g2 = rs.randn(n, 204).astype(f32)
    g2[:, 101:102], g2[:, 203:204] = vis(), vis()
    return dict(
        cxyz=(rs.randn(n, 3) * 0.08 + [0, 0, 0.9]).astype(f32),
        kpt_T=(rs.randn(3, 42) * 0.06 + [[0], [0], [0.9]]).astype(f32),
        aux=np.concatenate([rs.randn(n, 72).astype(f32), vis(), pw], 1),
        feats=np.concatenate([rs.randn(n, 83).astype(f32),
                              (rs.randn(n, 1) * 0.01).astype(f32), vis(),
                              vis(), pw], 1),
        g2=g2)


# ---------------------------------------------------------------------------
# (a) prepared weights
# ---------------------------------------------------------------------------

def test_prepare_geo_mlp_weights_match_jax():
    import jax.numpy as jnp
    from vanerf_tpu.ops.fused_mlp import prepare_geo_mlp_weights as j_prep
    g, _ = h.converted_params()
    want = j_prep(g["params"], jnp.float32)
    with torch.no_grad():
        got = tf.prepare_geo_mlp_weights(h.port_model())
    assert set(got) == set(want)
    for k in want:
        if k == "biases":
            assert len(got[k]) == len(want[k]) == 8
            for a, b in zip(got[k], want[k]):
                assert tuple(a.shape) == b.shape
                np.testing.assert_allclose(A(a), A(b), atol=1e-6, rtol=0)
        else:
            assert tuple(got[k].shape) == want[k].shape, k
            np.testing.assert_allclose(A(got[k]), A(want[k]), atol=1e-6,
                                       rtol=0, err_msg=k)
    assert got["w0_parts"].shape == (294, 128)


def test_prepare_query_weights_match_jax():
    import jax.numpy as jnp
    from vanerf_tpu.ops.fused_mlp import _WEIGHT_ORDER
    from vanerf_tpu.ops.fused_mlp import prepare_query_weights as j_prep
    g, _ = h.converted_params()
    want = j_prep(g["params"], jnp.float32)
    with torch.no_grad():
        got = tf.prepare_query_weights(h.port_model())
    assert tuple(tf._WEIGHT_ORDER) == tuple(_WEIGHT_ORDER)
    assert set(got) == set(want) == set(_WEIGHT_ORDER)
    for k in _WEIGHT_ORDER:
        assert len(got[k]) == len(want[k]), k
        for a, b in zip(got[k], want[k]):
            assert tuple(a.shape) == b.shape, k
            np.testing.assert_allclose(A(a), A(b), atol=1e-6, rtol=0,
                                       err_msg=k)
    assert got["tfu_1"][0].shape == (96, 3)


def test_prepared_weights_carry_gradients():
    """The preparation is differentiable torch: a loss on the prepared
    groups reaches weight_v / weight_g and the 1x1 conv weights."""
    model = h.port_model()
    w = tf.prepare_query_weights(model)
    sum(t.square().sum() for k in w for t in w[k]).backward()
    lin = model.mlp_geo.layers1.layers[0].linear
    for p in (lin.weight_v, lin.weight_g, lin.bias,
              model.ibr_compress_gfeat.weight,
              model.geo_vis_fusion.fconv_at[0].weight,
              model.tex_vis_fusion.fconv[2].weight):
        assert p.grad is not None and p.grad.abs().sum() > 0
    # the rgb slice: the fuse layer's columns beyond 3 are dead
    assert model.tex_vis_fusion.fconv[2].weight.grad[3:].abs().sum() == 0


# ---------------------------------------------------------------------------
# (b) the kernels' plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["geo", "query"])
def test_fused_mlp_matches_jax_kernel(kernel, exact):
    import jax.numpy as jnp
    from vanerf_tpu.ops import fused_mlp as jf
    g, _ = h.converted_params()
    d = _kernel_inputs(300)            # not a multiple of the JAX tile
    J = {k: jnp.asarray(v) for k, v in d.items()}
    D = {k: T(v) for k, v in d.items()}
    model = h.port_model()
    with torch.no_grad():
        if kernel == "geo":
            want = jf.fused_geo_mlp(
                J["cxyz"], J["kpt_T"], J["aux"],
                jf.prepare_geo_mlp_weights(g["params"], jnp.float32),
                interpret=True, **KW)
            got = tf.fused_geo_mlp(D["cxyz"], D["kpt_T"], D["aux"],
                                   tf.prepare_geo_mlp_weights(model), **KW)
            assert got[0].shape == (300, 2) and got[1].shape == (300, 24)
        else:
            want = (jf.fused_query_mlp(
                J["cxyz"], J["kpt_T"], J["feats"], J["g2"],
                jf.prepare_query_weights(g["params"], jnp.float32),
                interpret=True, **KW),)
            got = (tf.fused_query_mlp(D["cxyz"], D["kpt_T"], D["feats"],
                                      D["g2"],
                                      tf.prepare_query_weights(model), **KW),)
            assert got[0].shape == (300, 5)
    for a, b in zip(got, want):
        assert np.abs(A(b)).max() > 1e-3
        np.testing.assert_allclose(A(a), A(b), rtol=RTOL, atol=ATOL)
    assert ops.launch_counts()["fused_geo_mlp"] == 0
    assert ops.launch_counts()["fused_query_mlp"] == 0


# ---------------------------------------------------------------------------
# (b2) kernels 11 / 12's 3xTF32 layer products
# ---------------------------------------------------------------------------

def _full_width_model():
    """The shipped configuration at full width (kernel 11 takes only it),
    seeded as chip_smoke.py seeds it."""
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    model = VANeRF.from_config(default_cfg(), num_v=642, image_hw=(256, 256))
    init_like_flax(model, torch.Generator().manual_seed(0))
    return model.eval()


def _schedule(full: bool, K: int, L: int, dims) -> tuple:
    """csrc/fused_mlp.cu::fm_schedule written out again: the n-tile count
    of each k-tile, in the order the kernel's warps consume them."""
    d1, d2, d3, e1, e2, lat = dims
    items = []

    def push(rows, m):
        n = -(-m // 8)
        n = n if n <= 4 else (8 if n <= 8 else (12 if n <= 12 else 16))
        items.extend([n] * -(-rows // 8))

    def gate_fuse(kin, hg, ng, hf, nout):
        push(kin, hg), push(hg, ng), push(kin, hf), push(hf, nout)

    if full:
        gate_fuse(196, 10, 3, 64, 64)
        gate_fuse(28, 10, 3, 8, 8)
    P = 1 + 2 * L
    per = 120 // P
    for j0 in range(0, K, per):
        push(min(per, K - j0) * P, d1)
    for rows, m in ((64, d1), (d1, d2), (d2, d3), (8, d3), (d3, 64),
                    (128, e1), (e1, e2), (e2, 2), (128, lat)):
        push(rows, m)
    if full:
        gate_fuse(96, 96, 6, 96, 3)
    return tuple(items)


@pytest.mark.parametrize("where", ["gaussian", "softplus"])
def test_division_by_a_constant_is_xlas_product(where):
    """The JAX kernel divides by constants: the encoding's Gaussian by
    2 sigma^2, softplus by 100.  XLA compiles such a division to a product
    by the constant's float32 reciprocal, so the kernels and their plain
    versions multiply by it (``fused_mlp.py::_inv_two_sig2``, ``* 0.01``):
    equal to the compiled JAX expression to the bit, where a division
    differs from it."""
    import jax
    import jax.numpy as jnp
    x = np.random.RandomState(0).rand(100000).astype(np.float32) * 0.3
    c = 2.0 * KW["sigma"] ** 2 if where == "gaussian" else 100.0
    factor = tf._inv_two_sig2(KW["sigma"]) if where == "gaussian" else 0.01
    want = np.asarray(jax.jit(lambda v: v / c)(jnp.asarray(x)))
    np.testing.assert_array_equal((T(x) * factor).numpy(), want)
    assert (x / np.float32(c) != want).any()


@pytest.mark.parametrize("kernel", ["geo", "query"])
def test_packed_weights_are_tf32_hi_lo_fragments(kernel):
    """The stream kernels 11 / 12 read: every value a TF32 number (the low
    13 mantissa bits clear), each weight recovered from its hi + lo to
    2^-22 relative, the padding zero, the k-tiles in the order
    fm_schedule takes them, and the source's widths those of the packer."""
    import re
    src = open(f"{h.ROOT}/vanerf_tpu_torch/csrc/fused_mlp.cu").read()
    for name, value in (("FM_HMAX", tf._MAX_WIDTH),
                        ("FM_PE_ROWS", tf._PE_ROWS)):
        assert int(re.search(rf"#define {name} (\d+)", src)[1]) == value
    with torch.no_grad():
        model = _full_width_model()
        if kernel == "geo":
            w = tf.prepare_geo_mlp_weights(model)
            layers, _, dims = tf._geo_layers(w, 42, 3)
            packed = tf.pack_geo_weights(w, 42, 3)
        else:
            w = tf.prepare_query_weights(model)
            layers, _, dims = tf._query_layers(w, 42, 3)
            packed = tf.pack_query_weights(w, 42, 3)
    stream, items = tf._pack(layers)
    assert torch.equal(stream, packed.w)
    assert items == _schedule(kernel == "query", 42, 3, dims)
    assert stream.numel() == 128 * sum(items)
    assert not (stream.view(torch.int32) & 0x1FFF).any()
    off = 0
    for parts, M in layers:
        nt = tf._ntiles(M)
        for part in parts:
            kt = -(-part.shape[0] // 8)
            blk = stream[off:off + kt * nt * 128].reshape(kt, nt, 8, 4, 4)
            off += kt * nt * 128
            # [a, b, g, t, (hi j0, hi j1, lo j0, lo j1)] -> rows 8a + 4j + t,
            # columns 8b + g
            hi = blk[..., :2].permute(0, 4, 3, 1, 2).reshape(8 * kt, 8 * nt)
            lo = blk[..., 2:].permute(0, 4, 3, 1, 2).reshape(8 * kt, 8 * nt)
            want = torch.zeros(8 * kt, 8 * nt)
            want[:part.shape[0], :M] = part
            assert torch.equal(hi, tf.tf32_round(want))
            err = (hi.double() + lo.double() - want.double()).abs()
            assert bool((err <= 2.0 ** -22 * want.double().abs()).all())
    assert off == stream.numel()


class _TF32x3(torch.overrides.TorchFunctionMode):
    """Every matrix product in the block as kernels 11 / 12 run it on the
    tensor cores: lo(x) hi(w) + hi(x) lo(w) + hi(x) hi(w) with TF32 hi / lo
    parts (``fused_mlp.tf32_split``), f32 sums; ``passes=1`` keeps only
    hi(x) hi(w), a plain TF32 product."""

    def __init__(self, passes: int = 3):
        super().__init__()
        self.passes, self.products = passes, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
            x, w = args
            self.products += 1
            xh, xl = tf.tf32_split(x)
            wh, wl = tf.tf32_split(w)
            if self.passes == 1:
                return xh @ wh
            return xl @ wh + xh @ wl + xh @ wh
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kernel", ["geo", "query"])
def test_tf32x3_products_hold_the_kernel_bound(kernel):
    """The numerics of kernels 11 / 12 before a card runs them: the plain
    networks at full width on seeded inputs of the main path's widths
    (8,192 points), with every layer product in 3xTF32, against the same
    networks in f32 at rtol 2e-4 / atol 2e-5.  One TF32 pass does not
    hold that bound."""
    d = {k: T(v) for k, v in _kernel_inputs(8192, seed=11).items()}
    with torch.no_grad():
        model = _full_width_model()
        if kernel == "geo":
            w = tf.prepare_geo_mlp_weights(model)
            run = lambda: tf.fused_geo_mlp_plain(          # noqa: E731
                d["cxyz"], d["kpt_T"], d["aux"], w, **KW)
        else:
            w = tf.prepare_query_weights(model)
            run = lambda: (tf.fused_query_mlp_plain(       # noqa: E731
                d["cxyz"], d["kpt_T"], d["feats"], d["g2"], w, **KW),)
        want = run()
        worst = {}
        for passes in (3, 1):
            with _TF32x3(passes) as mode:
                got = run()
            assert mode.products >= (17 if kernel == "geo" else 35)
            worst[passes] = max(
                ((a - b).abs() / (ATOL + RTOL * b.abs())).max().item()
                for a, b in zip(got, want))
    assert worst[3] <= 1.0, worst
    assert worst[1] > 1.0, worst


# ---------------------------------------------------------------------------
# (c) the row gather
# ---------------------------------------------------------------------------

def test_mxu_row_gather_exact():
    import jax.numpy as jnp
    from vanerf_tpu.ops.interp_mxu import mxu_row_gather as j_gather
    rs = np.random.RandomState(3)
    for V, C in ((1558, 20), (1284, 204), (130, 7)):
        tbl = rs.randn(V, C).astype(np.float32)
        idx = rs.randint(0, V, size=900).astype(np.int32)
        got = ti.mxu_row_gather(T(tbl), T(idx))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(A(got), tbl[idx])
        np.testing.assert_array_equal(
            A(got), A(j_gather(jnp.asarray(tbl), jnp.asarray(idx),
                               interpret=True)))
    # the copy has no row limit (the JAX one-hot product stops at 4,096)
    tbl = rs.randn(8192, 4).astype(np.float32)
    idx = rs.randint(0, 8192, size=50).astype(np.int32)
    np.testing.assert_array_equal(A(ti.mxu_row_gather(T(tbl), T(idx))),
                                  tbl[idx])


def test_knn_gather_raw_matches_jax(monkeypatch):
    """The raw rows [feat | vis | feat_toh | vis_toh]: through the row
    gather without a graph (one call for the batch), through take_rows
    (same rows, and a table gradient; one call a batch element) under
    one."""
    import jax.numpy as jnp
    from vanerf_tpu.ops.knn import knn_gather_raw as j_raw
    rs = np.random.RandomState(4)
    B, V, C, N, nv = 2, 2 * h.NUM_V, 13, 50, h.NUM_V
    feat = rs.randn(B, V, C).astype(np.float32)
    vis = (rs.rand(B, V, 1) > 0.5).astype(np.float32)
    idx = rs.randint(0, V, size=(B, N)).astype(np.int32)
    want = A(j_raw(None, None, jnp.asarray(feat), jnp.asarray(vis), nv,
                   nn_idx=jnp.asarray(idx)))
    calls = []
    for name in ("mxu_row_gather", "take_rows"):
        real = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _n=name, _r=real:
                            calls.append(_n) or _r(*a))
    got = tk.knn_gather_raw(None, None, T(feat), T(vis), nv, T(idx))
    assert got.shape == (B, N, 2 * (C + 1))
    np.testing.assert_array_equal(A(got), want)
    f, f_toh, v, v_toh = tk.knn_gather_1(None, None, T(feat), T(vis), nv,
                                         T(idx))
    np.testing.assert_array_equal(A(torch.cat([f, f_toh], -1)),
                                  np.concatenate([want[..., :C]
                                                  * want[..., C:C + 1],
                                                  want[..., C + 1:-1]
                                                  * want[..., -1:]], -1))
    # one launch of kernel 10 for the batch, a gather
    assert calls == ["mxu_row_gather"] * 2
    del calls[:]
    table = T(feat).requires_grad_(True)
    got = tk.knn_gather_raw(None, None, table, T(vis), nv, T(idx))
    assert calls == ["take_rows"] * B
    np.testing.assert_array_equal(A(got), want)
    got.sum().backward()
    assert table.grad.abs().sum() > 0
    with torch.no_grad():       # a table that wants a gradient, no graph
        tk.knn_gather_raw(None, None, table, T(vis), nv, T(idx))
    assert calls[B:] == ["mxu_row_gather"]


# ---------------------------------------------------------------------------
# (d) VANeRF.query at levels 1 and 2
# ---------------------------------------------------------------------------

def _query_args(n: int = 96):
    batch = h.torch_batch(h.synthetic_batch()[0])
    rs = np.random.RandomState(9)
    pts = T(h.two_hand_points(n, seed=10)[None])
    view = rs.randn(1, n, 3).astype(np.float32)
    vv = T((rs.rand(1, 2 * h.NUM_V, 1) > 0.3).astype(np.float32))
    qv = T((rs.rand(1, n, 1) > 0.5).astype(np.float32))
    qs = T((rs.randn(1, n, 1) * 0.01).astype(np.float32))
    cam = {"KRT": batch["src_krt"], "extrin": batch["src_extrin"],
           "width": h.W, "height": h.H, "znear": batch["znear"],
           "zfar": batch["zfar"]}
    return batch, (pts, T(view), cam), (vv, qv, qs)


def _query(port, batch, head, tail, feats, **kw):
    return port.query(*head, *feats, batch["src_img"], batch["src_mask"],
                      batch["verts"], *tail, batch["kpt3d"], 8, **kw)


def _spy(monkeypatch, calls):
    """Record calls of the fused entry points and of the row gather."""
    for mod, name in ((tv, "fused_geo_mlp"), (tv, "fused_query_mlp"),
                      (tk, "mxu_row_gather")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))


class _EncoderSpy:
    """The spatial encoder, recording its calls."""

    def __init__(self, real, calls):
        self.real, self.calls = real, calls

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __call__(self, **kw):
        self.calls.append("sp_encoder")
        return self.real(**kw)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("via", ["env", "override"])
def test_query_fused_levels_match_level0(level, via, monkeypatch):
    """The level comes from VANERF_FUSED_MLP or from ``fused_override``."""
    port = h.port_model()
    batch, head, tail = _query_args()
    calls = []
    _spy(monkeypatch, calls)
    monkeypatch.setattr(port, "sp_encoder",
                        _EncoderSpy(port.sp_encoder, calls))
    with torch.no_grad():
        feats = port.encode(batch["src_img"])
        want, valid0 = _query(port, batch, head, tail, feats)
        assert calls == ["sp_encoder", "mxu_row_gather"]
        del calls[:]
        if via == "env":
            monkeypatch.setenv("VANERF_FUSED_MLP", str(level))
            kw = {}
        else:
            monkeypatch.setenv("VANERF_FUSED_MLP", str(3 - level))
            kw = {"fused_override": level}
        got, valid = _query(port, batch, head, tail, feats, **kw)
        fused = "fused_geo_mlp" if level == 1 else "fused_query_mlp"
        # the spatial encoder is not run at level >= 1
        assert calls == ["mxu_row_gather", fused]
        # training pins level 0
        del calls[:]
        train, _ = _query(port, batch, head, tail, feats, training=True,
                          **kw)
        assert calls == ["sp_encoder", "mxu_row_gather"]
    assert 0 < valid.mean() < 1 and torch.equal(valid, valid0)
    np.testing.assert_allclose(A(got), A(want), rtol=RTOL, atol=ATOL)
    # (a training query samples the small maps by gather, not kernel D)
    np.testing.assert_allclose(A(train), A(want), rtol=1e-5, atol=1e-6)


def test_fused_weights_are_prepared_once_per_set_of_weights(monkeypatch):
    """Without a graph the passes of a frame share one preparation; a
    parameter written in place or loaded anew invalidates it; where a
    graph may be built nothing is kept."""
    port = h.port_model()
    batch, head, tail = _query_args(24)
    n = []
    real = tv.prepare_query_weights
    monkeypatch.setattr(tv, "prepare_query_weights", lambda *a, **k:
                        n.append(1) or real(*a, **k))
    with torch.no_grad():
        feats = port.encode(batch["src_img"])
        lvl0, _ = _query(port, batch, head, tail, feats)
        a, _ = _query(port, batch, head, tail, feats, fused_override=2)
        b, _ = _query(port, batch, head, tail, feats, fused_override=2)
        assert len(n) == 1 and torch.equal(a, b)
        lin = port.mlp_geo.layers2.layers[2].linear
        lin.bias.add_(0.5)
        c, _ = _query(port, batch, head, tail, feats, fused_override=2)
        assert len(n) == 2
        np.testing.assert_allclose(A(c[..., :2]), A(a[..., :2]) + 0.5,
                                   rtol=0, atol=1e-6)
        sd = {k: v.clone() for k, v in port.state_dict().items()}
        sd["mlp_geo.layers2.layers.2.linear.bias"] -= 0.5
        port.load_state_dict(sd)
        d, _ = _query(port, batch, head, tail, feats, fused_override=2)
        assert len(n) == 3
        np.testing.assert_allclose(A(d), A(lvl0), rtol=RTOL, atol=ATOL)
    # a query that wants a gradient: prepared anew, kept not, and refused
    # by the kernel entry point, which has no backward (VANERF_FUSED_TRAIN
    # differentiates level 0 instead)
    with pytest.raises(RuntimeError, match="no backward"):
        _query(port, batch, head, tail, feats, fused_override=2)
    assert len(n) == 4
    port.requires_grad_(False)          # grad mode on, nothing to train
    _query(port, batch, head, tail, feats, fused_override=2)
    _query(port, batch, head, tail, feats, fused_override=2)
    assert len(n) == 6


def test_query_level2_steps_down_off_shipped_dims(monkeypatch):
    """Level 2 assumes the shipped widths; off them it runs level 1."""
    port = h.port_model()
    batch, head, tail = _query_args(40)
    calls = []
    _spy(monkeypatch, calls)
    with torch.no_grad():
        feats = port.encode(batch["src_img"])
        lvl1, _ = _query(port, batch, head, tail, feats, fused_override=1)
        del calls[:]
        monkeypatch.setattr(port, "gcompress_out", 16)
        got, _ = _query(port, batch, head, tail, feats, fused_override=2)
    assert calls == ["mxu_row_gather", "fused_geo_mlp"]
    np.testing.assert_array_equal(A(got), A(lvl1))


def test_two_res_still_raises(monkeypatch):
    monkeypatch.setenv("VANERF_TWO_RES", "1")
    with pytest.raises(NotImplementedError):
        tv._check_env()


# ---------------------------------------------------------------------------
# (e) eval render_patch under VANERF_FUSED_MLP against JAX
# ---------------------------------------------------------------------------

def _grid8():
    lo = h.W // 2 - 4
    y, x = np.meshgrid(np.arange(lo, lo + 8), np.arange(lo, lo + 8),
                       indexing="ij")
    return np.stack([x, y], -1).reshape(1, -1, 2).astype(np.float32)


@pytest.mark.parametrize("level", ["1", "2"])
def test_render_patch_fused_matches_jax(level, exact, monkeypatch):
    """8x8 rays, 8+8 samples, VANERF_FAR_TAU untouched: the fused switch
    turns the far tier off in both packages."""
    import jax
    import jax.numpy as jnp
    from vanerf_tpu import renderer as jr
    monkeypatch.setenv("VANERF_FUSED_MLP", level)
    monkeypatch.setenv("VANERF_MXU_INTERP", "force")
    monkeypatch.delenv("VANERF_FAR_TAU", raising=False)
    g, _ = h.converted_params()
    batch, _ = h.synthetic_batch()
    jb = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in batch.items()}
    grids = _grid8()
    out_j = jr.render_patch(
        h.jax_model(), g, jb, rng=jax.random.PRNGKey(0),
        grids=jnp.asarray(grids), out_h=8, out_w=8, sample_per_ray_c=h.S_C,
        sample_per_ray_f=h.S_F, fine=True, uniform=True, training=False,
        n_views=1, sdf_chunk=64, compute_vis_map=False)
    far_seen = []
    real = tr.cal_vis_sdf_prepared
    monkeypatch.setattr(tr, "cal_vis_sdf_prepared", lambda *a, **k:
                        far_seen.append(k.get("far2")) or real(*a, **k))
    out_t = tr.render_patch(h.port_model(), h.torch_batch(batch),
                            grids=T(grids), out_h=8, out_w=8,
                            sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F)
    assert far_seen == [None, None]
    assert out_t["alpha_fine"].max() > 0.2, "rays missed the fixture mesh"
    for k in ("tex_fg", "alpha", "tex_fg_fine", "alpha_fine"):
        np.testing.assert_allclose(A(out_t[k]), A(out_j[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for k, acck in (("depth", "alpha"), ("depth_fine", "alpha_fine"),
                    ("sdf", "alpha_fine")):
        m = A(out_j[acck]) > 1e-2
        assert m.any()
        np.testing.assert_allclose(A(out_t[k])[m], A(out_j[k])[m],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("level", ["0", "1", "2"])
def test_render_patch_fused_matches_unfused_port(level, monkeypatch):
    """The port under the switch against the port without it (far tier off
    by hand there): every floating output."""
    model = h.port_model()
    batch = h.torch_batch(h.synthetic_batch()[0])
    kw = dict(grids=T(_grid8()), out_h=8, out_w=8, sample_per_ray_c=h.S_C,
              sample_per_ray_f=h.S_F)
    monkeypatch.setenv("VANERF_FAR_TAU", "0")
    want = tr.render_patch(model, batch, **kw)
    monkeypatch.delenv("VANERF_FAR_TAU")
    monkeypatch.setenv("VANERF_FUSED_MLP", level)
    got = tr.render_patch(model, batch, **kw)
    for k, v in want.items():
        if v.is_floating_point():
            np.testing.assert_allclose(A(got[k]), A(v), rtol=RTOL, atol=ATOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# (f) VANERF_FUSED_TRAIN: kernel forward, level-0 backward
# ---------------------------------------------------------------------------

def _g_loss_and_grads(monkeypatch, level: str):
    from vanerf_tpu_torch.losses import VGGLoss
    from vanerf_tpu_torch.models import DiscriminatorVis, init_like_flax
    from vanerf_tpu_torch.training import generator_loss, generator_outputs
    cfg = h.small_cfg()
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = 8
    m["dr_kwargs"]["sample_per_ray_c"] = h.S_C
    m["dr_kwargs"]["sample_per_ray_f"] = h.S_F
    model = h.port_model()
    disc = DiscriminatorVis()
    init_like_flax(disc, torch.Generator().manual_seed(1))
    vgg = VGGLoss()
    init_like_flax(vgg.vgg_net, torch.Generator().manual_seed(19))
    gen = torch.Generator().manual_seed(5)
    P = 64
    draws = {"grids": T(_grid8()),
             "u_c": torch.rand(1, P, h.S_C, generator=gen),
             "noise_c": torch.randn(1, P * h.S_C, 1, generator=gen),
             "u_f": torch.rand(1, P, h.S_F, generator=gen),
             "noise_f": torch.randn(1, P * h.S_F, 1, generator=gen)}
    monkeypatch.setenv("VANERF_FUSED_TRAIN", level)
    calls = []
    _spy(monkeypatch, calls)
    out = generator_outputs(model, h.torch_batch(h.synthetic_batch()[0]),
                            cfg, draws=draws)
    loss, err = generator_loss(out, disc, vgg, cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    monkeypatch.undo()
    return (loss.item(), {k: float(v.detach()) for k, v in err.items()},
            dict(zip(names, grads)), calls)


@pytest.mark.parametrize("level", ["1", "2"])
def test_fused_train_matches_unfused(level, monkeypatch):
    """The G loss and every gradient of a training patch whose query
    forward went through the fused entry point (cotangents from the fused
    outputs, gradients from the level-0 query) against the unfused
    render on the same draws."""
    loss0, err0, g0, calls0 = _g_loss_and_grads(monkeypatch, "0")
    loss1, err1, g1, calls1 = _g_loss_and_grads(monkeypatch, level)
    assert calls0 == []
    fused = "fused_geo_mlp" if level == "1" else "fused_query_mlp"
    # the coarse and the fine pass, each without a graph: the KNN rows
    # through kernel 10, then the fused kernel
    assert calls1 == ["mxu_row_gather", fused] * 2
    np.testing.assert_allclose(loss1, loss0, rtol=5e-3, atol=5e-4)
    for k in err0:
        np.testing.assert_allclose(err1[k], err0[k], rtol=5e-3, atol=5e-4,
                                   err_msg=k)
    for n, a in g0.items():
        b = g1[n]
        assert (a is None) == (b is None), n
        if a is None:
            continue
        a, b = a.double().numpy(), b.double().numpy()
        diff = np.abs(b - a).max()
        bound = 1e-2 * np.abs(a).max() + 1e-4
        assert diff < bound, f"{n}: {diff:.2e} > {bound:.2e}"
    # the gradients reach the weight-norm parameters through the prepared
    # weights, and the encoders through the packs
    for n in ("mlp_geo.layers1.layers.0.linear.weight_v",
              "mlp_geo.layers1.layers.0.linear.weight_g",
              "mlp_geo.layers2.layers.2.linear.weight",
              "ibr_compress_gfeat.weight", "geo_encoder.conv1.weight",
              "tex_vis_fusion.fconv_at.0.weight"):
        assert g1[n] is not None and g1[n].abs().sum() > 0, n


def route_and_level0_grads(port, level: int, seed: int = 4):
    """The query's output and its gradients for a fixed cotangent, taken
    through ``fused_train_query`` at ``level`` and straight through the
    level-0 query, on the same inputs: the points, the view, the feature
    maps, the visibility / SDF and every parameter.  Returns ((out, grads)
    of the route, (out, grads) of level 0, the fused forward without a
    graph)."""
    batch, head, tail = _query_args(40)
    (pts, view, cam), (vv, qv, qs) = head, tail
    with torch.no_grad():
        fg, ft = port.encode(batch["src_img"])
    rs = np.random.RandomState(seed)
    data = [t.clone().requires_grad_(True)
            for t in (pts, view, ft, qv, qs, *fg)]
    params = [p for p in port.parameters() if p.requires_grad]

    def query(lvl, pts, view, ft, qv, qs, *fg):
        return _query(port, batch, (pts, view, cam), (vv, qv, qs),
                      (list(fg), ft), fused_override=lvl)

    ct = None
    res = []
    for route in (True, False):
        if route:
            out, _ = tf.fused_train_query(
                lambda fused, *d: query(level if fused else 0, *d), data,
                params)
        else:
            out, _ = query(0, *data)
        if ct is None:
            ct = T(rs.randn(*out.shape).astype(np.float32))
        res.append((out.detach(), torch.autograd.grad(
            out, data + params, ct, allow_unused=True)))
    with torch.no_grad():
        fused, _ = query(level, *data)
    return res[0], res[1], fused


def test_fused_mlp_backward_is_the_plain_gradient():
    """The fused kernels' entry points have no backward (they refuse inputs
    that want a gradient); under ``VANERF_FUSED_TRAIN`` the gradients are
    those of the plain network, the level-0 query: for a fixed cotangent
    ``fused_train_query``'s gradients for the points, the view, the maps,
    the visibility / SDF and the parameters equal ``autograd.grad`` of
    ``query(fused_override=0)`` bit for bit, its forward the fused
    level's (float32 here; bfloat16 and level 1 in
    tests/test_torch_bf16_train.py)."""
    d = {k: T(v) for k, v in _kernel_inputs(37, seed=2).items()}
    model = h.port_model()
    d["feats"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tf.fused_query_mlp(d["cxyz"], d["kpt_T"], d["feats"], d["g2"],
                           tf.prepare_query_weights(model), **KW)
    (out_r, g_r), (out_0, g_0), fused = route_and_level0_grads(model, 2)
    assert torch.equal(out_r, fused) and not torch.equal(out_r, out_0)
    used = 0
    for a, b in zip(g_r, g_0):
        assert (a is None) == (b is None)
        if a is not None:
            used += 1
            assert torch.equal(a, b)
    assert used > 20


def test_fused_train_is_off_at_eval_and_far_tier_goes_off(monkeypatch):
    """VANERF_FUSED_TRAIN acts on training renders only; with it (or with
    VANERF_FUSED_MLP set at all) the far tier is off."""
    model = h.port_model()
    batch = h.torch_batch(h.synthetic_batch()[0])
    kw = dict(grids=T(h.center_grid()), out_h=4, out_w=4, sample_per_ray_c=4,
              sample_per_ray_f=4)
    seen = []
    real_q = model.query
    real_m = tr.cal_vis_sdf_prepared
    monkeypatch.setattr(model, "query", lambda *a, **k: seen.append(
        (k.get("training"), k.get("fused_override"))) or real_q(*a, **k))
    monkeypatch.setattr(tr, "cal_vis_sdf_prepared", lambda *a, **k:
                        seen.append(k.get("far2")) or real_m(*a, **k))
    monkeypatch.setenv("VANERF_FUSED_TRAIN", "2")
    tr.render_patch(model, batch, **kw)
    assert seen == [pytest.approx(4e-4), (False, None)] * 2
    del seen[:]
    tr.render_patch(model, batch, **kw, training=True, uniform=True)
    assert seen == [None, (False, 2)] * 2
    del seen[:]
    monkeypatch.delenv("VANERF_FUSED_TRAIN")
    monkeypatch.setenv("VANERF_FUSED_MLP", "0")
    tr.render_patch(model, batch, **kw)
    assert seen == [None, (False, None)] * 2


# ---------------------------------------------------------------------------
# (g) on the card: each new kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_model(dev):
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    model = VANeRF.from_config(default_cfg(), num_v=642, image_hw=(256, 256))
    init_like_flax(model, torch.Generator().manual_seed(0))
    return model.to(dev).eval()


@pytest.mark.cuda
def test_row_gather_kernel_matches_plain(cuda):
    rs = np.random.RandomState(6)
    for V, C, n in ((1284, 204, 262144), (130, 7, 900), (1, 3, 5)):
        tbl = T(rs.randn(V, C).astype(np.float32)).to(cuda)
        idx = T(rs.randint(0, V, size=n).astype(np.int32)).to(cuda)
        n0 = ti.row_gather_launches
        got = ti.mxu_row_gather(tbl, idx)
        torch.cuda.synchronize()
        assert ti.row_gather_launches == n0 + 1
        assert torch.equal(got, ti.row_gather_plain(tbl, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096 + 37, 5])
def test_fused_geo_kernel_matches_plain(n, cuda):
    d = {k: T(v).to(cuda) for k, v in _kernel_inputs(n, seed=7).items()}
    with torch.no_grad():
        w = tf.prepare_geo_mlp_weights(_card_model(cuda))
        n0 = tf.geo_launches
        got = tf.fused_geo_mlp(d["cxyz"], d["kpt_T"], d["aux"], w, **KW)
        torch.cuda.synchronize()
        assert tf.geo_launches == n0 + 1
        want = tf.fused_geo_mlp_plain(d["cxyz"], d["kpt_T"], d["aux"], w,
                                      **KW)
        again = tf.fused_geo_mlp(
            d["cxyz"], d["kpt_T"], d["aux"], w,
            packed=tf.pack_geo_weights(w, 42, KW["sp_level"]), **KW)
    for a, b, c in zip(got, want, again):
        assert torch.allclose(a, b, rtol=RTOL, atol=ATOL)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096 + 37, 5])
def test_fused_query_kernel_matches_plain(n, cuda):
    d = {k: T(v).to(cuda) for k, v in _kernel_inputs(n, seed=8).items()}
    model = _card_model(cuda)
    with torch.no_grad():
        w = tf.prepare_query_weights(model)
        n0 = tf.query_launches
        got = tf.fused_query_mlp(d["cxyz"], d["kpt_T"], d["feats"], d["g2"],
                                 w, **KW)
        torch.cuda.synchronize()
        assert tf.query_launches == n0 + 1
        want = tf.fused_query_mlp_plain(d["cxyz"], d["kpt_T"], d["feats"],
                                        d["g2"], w, **KW)
    assert torch.allclose(got, want, rtol=RTOL, atol=ATOL)
    # buffers packed ahead give the same launch (float32 weights prepared
    # are the parameters themselves where no cast is needed: no graph)
    packed = tf.pack_query_weights(w, 42, KW["sp_level"])
    with torch.no_grad():
        again = tf.fused_query_mlp(d["cxyz"], d["kpt_T"], d["feats"],
                                   d["g2"], w, packed=packed, **KW)
    assert torch.equal(again, got)
    n0 += 1
    # under a graph the entry point refuses, before any launch: the
    # kernels have no backward (VANERF_FUSED_TRAIN differentiates level 0)
    feats = d["feats"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tf.fused_query_mlp(d["cxyz"], d["kpt_T"], feats, d["g2"],
                           tf.prepare_query_weights(model), **KW)
    assert tf.query_launches == n0 + 1
