"""The port's bfloat16 serving configuration (``compute_dtype="bfloat16"``)
against the JAX package under ``VANERF_COMPUTE_DTYPE=bfloat16``, on the CPU.

The same numpy inputs, rounded to bfloat16, go through both packages:
kernel D's and kernel 10's plain versions, the gather sampler, kernels 11
/ 12's plain versions (the JAX kernels in interpret mode), ``VANeRF.query``
at fused levels 0 / 1 / 2 and the eval ``render_patch``.  Kernel D is
forced on the JAX side (``VANERF_MXU_INTERP=force``), so both packages
sample the small maps with it.

Tolerances, and where they come from:

* the gather sampler and kernel 10: equal to the bit.  The sampler rounds
  every op of its lerp in bfloat16 in both packages, in one order; the
  row gather copies rows.
* kernel D: at most one bfloat16 unit in the last place of the output.
  Both packages round each hat weight to bfloat16 (exact products with
  the bfloat16 corners), sum in float32 and round once; the two float32
  sums may differ by their order, which can move the one rounding by one
  unit.
* the networks (kernels 11 / 12, the IBR head, the query, the render),
  two checks (:func:`near_jax_bf16`).  Each element: the bfloat16
  roundings move an output by up to the JAX package's own bfloat16-vs-
  float32 spread (the largest |bf16 - f32| of the JAX output on the same
  inputs); the port rounds at the JAX package's places, so its own spread
  is of the same size, and by the triangle inequality through the float32
  outputs, which agree to the float32 tolerance of the f32 tests (kernels
  rtol 2e-4 / atol 2e-5, the query rtol 1e-4 / atol 1e-5, the render rtol
  1e-3 / atol 1e-4 (depth and sdf atol 2e-4) on hit rays), each element
  lies within twice that spread + that tolerance of JAX's bfloat16 output.
  That bound alone also passes a port that kept float32 between layers
  (it lies one spread away), so the root mean square of the error is held
  nearer to JAX's bfloat16 output than to its float32 one: at most S / 2
  + 2 E, S the RMS of JAX's bfloat16-vs-float32 spread, E the RMS of the
  two packages' float32 disagreement (counted once in each of the two
  runs it may enter).  A port that rounds where JAX rounds differs from
  JAX only where a float32 difference before a rounding moves it (at most
  0.18 S on these inputs); the control, the port's float32 output on the
  same inputs, lies at 1.0 S and must fail the bound wherever bfloat16
  moves the output (every output but the saturated alphas).  Both
  packages take the same feature maps (the JAX encoder's, in float32):
  the encoders are float32 and agree to float32's tolerance, and the cast
  to bfloat16 would turn those last-bit differences into bfloat16 units
  in ~5% of the maps' values.
* the port's bfloat16 query against its own float32 query: JAX's own
  bound for the same comparison, atol / rtol 0.1
  (``tests/test_models.py:222-224``).

The tests marked ``cuda`` hold the bfloat16 kernels against their plain
versions on a GPU and skip without one (``chip_smoke.py`` phase 2b does
the same at the main path's shapes, with the kernels 11 / 12 bound derived
there); they import no JAX, so that they run where only the port is
installed:
``python -m pytest tests/test_torch_bf16.py -m cuda --noconftest``.
"""


import numpy as np
import pytest
import torch

import torch_port_helpers as h
from vanerf_tpu_torch import ops
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.ops import fused_mlp as tf
from vanerf_tpu_torch.ops import grid_sample as tg
from vanerf_tpu_torch.ops import interp_mxu as ti

KW = dict(sp_level=3, scale=1.0, sigma=0.1)
BF = torch.bfloat16


def T(x):
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def A(x):
    """float32 numpy of a torch, numpy or JAX array (bfloat16 widened
    exactly)."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    if isinstance(x, np.ndarray):
        return x.astype(np.float32)
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf(x):
    """numpy f32 -> (JAX bfloat16, torch bfloat16) of the same values."""
    import jax.numpy as jnp
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, T(A(j)).to(BF)


def ulp_bf16(x):
    """One bfloat16 unit in the last place at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


def within_spread(got, want, want_f32, rtol, atol, name=""):
    """|got - want| <= 2 S + atol + rtol |want|, S = max |want - want_f32|
    (see the module note); returns the worst share of that bound."""
    got, want, want_f32 = A(got), A(want), A(want_f32)
    spread = np.abs(want - want_f32).max()
    bound = 2.0 * spread + atol + rtol * np.abs(want)
    worst = (np.abs(got - want) / bound).max()
    assert worst <= 1.0, (name, worst, np.abs(got - want).max(), spread)
    return worst


def rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(A(x).astype(np.float64)))))


def near_jax_bf16(got, got_f32, want, want_f32, rtol, atol, name="",
                  control=True):
    """The port's bfloat16 output ``got`` against JAX's ``want``: each
    element within :func:`within_spread`, and the RMS error at most
    S / 2 + 2 E (module note); with ``control`` the port's float32 output
    ``got_f32`` must fail that bound.  Returns (RMS error, bound) / S."""
    got, got_f32, want, want_f32 = map(A, (got, got_f32, want, want_f32))
    within_spread(got, want, want_f32, rtol, atol, name)
    S, E = rms(want - want_f32), rms(got_f32 - want_f32)
    bound = S / 2 + 2 * E
    err, ctrl = rms(got - want), rms(got_f32 - want)
    print(f"{name}: RMS error {err / S:.3f} S, bound {bound / S:.3f} S, "
          f"float32 control {ctrl / S:.3f} S (S {S:.3g}, E {E:.3g})")
    assert err <= bound, (name, "RMS error", err, "S", S, "E", E)
    if control:
        assert ctrl > bound, (name, "the float32 control passes the bound",
                              S, E)
    return err / S, bound / S


@pytest.fixture
def env(monkeypatch):
    """The switches the comparisons run under: kernel D on both sides."""
    monkeypatch.setenv("VANERF_MXU_INTERP", "force")
    monkeypatch.delenv("VANERF_FUSED_MLP", raising=False)
    monkeypatch.delenv("VANERF_COMPUTE_DTYPE", raising=False)
    return monkeypatch


def _jax_model(cdt: str):
    from vanerf_tpu.models import VANeRF as JVANeRF
    cfg = h.small_cfg()
    cfg["models"]["VANeRF"]["compute_dtype"] = cdt
    return JVANeRF.from_config(cfg, num_v=h.NUM_V)


def _port_model(cdt: str):
    from vanerf_tpu_torch.models import VANeRF
    from vanerf_tpu_torch.weights import from_jax_params
    g, _ = h.converted_params()
    cfg = h.small_cfg()
    cfg["models"]["VANeRF"]["compute_dtype"] = cdt
    model = VANeRF.from_config(cfg, num_v=h.NUM_V, image_hw=(h.H, h.W))
    model.load_state_dict(from_jax_params(g), strict=True)
    assert model.compute_dtype == cdt
    return model.eval()


# ---------------------------------------------------------------------------
# (a) the samplers and the row gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hwc", [(32, 32, 64), (64, 64, 16), (16, 16, 6)])
def test_interp_bf16_twin_matches_jax(hwc):
    """Kernel D's plain version on a bfloat16 map against the JAX kernel
    in interpret mode: bfloat16 out, within one unit in the last place;
    the hat weights are rounded (the float32 map's weights give other
    values)."""
    import jax.numpy as jnp
    from vanerf_tpu.ops.interp_mxu import mxu_grid_sample
    rs = np.random.RandomState(sum(hwc))
    fj, ft = bf(rs.randn(*hwc).astype(np.float32))
    uv = (rs.rand(1500, 2) * 2.4 - 1.2).astype(np.float32)
    want = A(mxu_grid_sample(fj, jnp.asarray(uv), interpret=True))
    got = ti.mxu_grid_sample(ft, T(uv))
    assert got.dtype == BF and got.shape == (1500, hwc[2])
    err = np.abs(A(got) - want)
    assert (err <= ulp_bf16(np.maximum(np.abs(A(got)), np.abs(want)))).all()
    f32 = A(ti.mxu_grid_sample(ft.float(), T(uv)).to(BF))
    assert (f32 != A(got)).any()
    assert ops.launch_counts()["interp_mxu_bf16"] == 0


def test_gather_sampler_bf16_lerp_matches_jax():
    """The gather sampler on bfloat16 maps (``VANERF_MXU_INTERP=0`` and the
    maps kernel D does not take): the lerp in bfloat16, equal to the bit;
    batched as the query calls it."""
    import jax.numpy as jnp
    from vanerf_tpu.ops.grid_sample import feat_sample_nhwc
    rs = np.random.RandomState(5)
    for shape in ((2, 64, 64, 11), (1, 32, 32, 1), (1, 13, 9, 4)):
        fj, ft = bf(rs.randn(*shape).astype(np.float32))
        uv = (rs.rand(shape[0], 700, 2) * 2.2 - 1.1).astype(np.float32)
        want = A(feat_sample_nhwc(fj, jnp.asarray(uv)))
        got = tg.feat_sample_nhwc(ft, T(uv))
        assert got.dtype == BF
        np.testing.assert_array_equal(A(got), want)


def test_row_gather_bf16_matches_jax():
    """Kernel 10's plain version on the bfloat16 KNN table: the rows, bit
    for bit, in bfloat16."""
    import jax.numpy as jnp
    from vanerf_tpu.ops.interp_mxu import mxu_row_gather as j_gather
    rs = np.random.RandomState(3)
    for V, C in ((1284, 204), (130, 7)):
        tj, tt = bf(rs.randn(V, C).astype(np.float32))
        idx = rs.randint(0, V, size=900).astype(np.int32)
        got = ti.mxu_row_gather(tt, T(idx))
        assert got.dtype == BF
        np.testing.assert_array_equal(A(got), A(j_gather(tj, jnp.asarray(idx),
                                                         interpret=True)))


def test_kernel_wrappers_refuse_other_dtypes():
    """A dtype with no kernel raises at the wrapper: nothing is cast to
    float32 to reach the float32 kernel."""
    half = torch.zeros(32, 32, 4, dtype=torch.float16)
    with pytest.raises(ValueError, match="no kernel"):
        ti.interp_cuda(half, torch.zeros(5, 2))
    with pytest.raises(ValueError, match="no kernel"):
        ti.row_gather_cuda(half[0], torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel"):
        tf._check_points(torch.zeros(5, 3), torch.zeros(3, 42),
                         [("aux", torch.zeros(5, 74, dtype=torch.float16),
                           74)])


# ---------------------------------------------------------------------------
# (b) kernels 11 / 12: prepared weights, packing, plain versions
# ---------------------------------------------------------------------------

def test_prepared_bf16_weights_match_jax():
    """The weights in bfloat16 (weight norm in float32, then the cast) and
    the biases in float32, as the JAX package prepares them: each weight
    within one bfloat16 unit (the two frameworks' float32 norms may round
    differently), the biases to 1e-6."""
    import jax.numpy as jnp
    from vanerf_tpu.ops import fused_mlp as jf
    g, _ = h.converted_params()
    model = _port_model("bfloat16")
    with torch.no_grad():
        got = tf.prepare_query_weights(model, cdt=BF)
    want = jf.prepare_query_weights(g["params"], jnp.bfloat16)
    for name in tf._WEIGHT_ORDER:
        for a, b in zip(got[name], want[name]):
            if name == "b":
                assert a.dtype == torch.float32
                np.testing.assert_allclose(A(a), A(b), atol=1e-6)
                continue
            assert a.dtype == BF and a.shape == tuple(b.shape), name
            err = np.abs(A(a) - A(b))
            assert (err <= ulp_bf16(A(b))).all(), name


def _schedule_bf16(full: bool, K: int, L: int, dims) -> tuple:
    """csrc/fused_mlp_bf16.cu::fm_schedule written out again for the bfloat16
    body: the n8 tiles (ceil(M / 8)) of each 16-row k-tile, in the
    consumers' order."""
    d1, d2, d3, e1, e2, lat = dims
    items = []

    def push(rows, m):
        items.extend([-(-m // 8)] * -(-rows // 16))

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


def _descriptor_offsets() -> tuple:
    """(leading, stride) byte offsets of the B descriptor, read from
    csrc/fused_mlp_bf16.cu::fw_desc: ``(LBO >> 4) << 16`` and
    ``(SBO >> 4) << 32``."""
    import pathlib
    import re
    src = (pathlib.Path(tf.__file__).resolve().parent.parent / "csrc"
           / "fused_mlp_bf16.cu").read_text()
    body = src[src.index("fw_desc(const void* p)"):]
    body = body[:body.index("}")]
    lbo = re.search(r"\((\d+) >> 4\) << 16", body)
    sbo = re.search(r"\((\d+) >> 4\) << 32", body)
    return int(lbo.group(1)), int(sbo.group(1))


@pytest.mark.parametrize("kernel", ["geo", "query"])
def test_packed_bf16_weights_are_m16n8k16_fragments(kernel):
    """The bfloat16 stream as the wgmma descriptor reads it: k-step a of
    an N-wide layer is N / 8 groups of two K-major core matrices (8
    columns x 8 rows, a column's rows in 16 contiguous bytes); column 8 j
    + n, row 16 a + 8 h + k sits at byte SBO j + LBO h + 16 n + 2 k of the
    k-step, LBO / SBO those of ``fw_desc``.  Each weight once at that
    address, the padding zero, the k-tiles in fm_schedule's order, 128
    values a (k-tile, n8 tile).  (The name is the m16n8k16 layout's, which
    this one replaced.)"""
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    model = VANeRF.from_config(default_cfg(), num_v=642, image_hw=(256, 256))
    init_like_flax(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        if kernel == "geo":
            w = tf.prepare_geo_mlp_weights(model, cdt=BF)
            layers, _, dims = tf._geo_layers(w, 42, 3)
            packed = tf.pack_geo_weights(w, 42, 3)
        else:
            w = tf.prepare_query_weights(model, cdt=BF)
            layers, _, dims = tf._query_layers(w, 42, 3)
            packed = tf.pack_query_weights(w, 42, 3)
    assert tuple(dims) == tf.BF16_DIMS
    stream, items = tf._pack(layers)
    assert stream.dtype == BF and torch.equal(stream, packed.w)
    assert packed.b.dtype == torch.float32
    assert items == _schedule_bf16(kernel == "query", 42, 3, dims)
    assert stream.numel() == 128 * sum(items)
    lbo, sbo = _descriptor_offsets()
    assert (lbo, sbo) == (128, 256)
    flat = stream.view(torch.int16).numpy()
    off = 0                                      # in bfloat16 values
    for parts, M in layers:
        nt = -(-M // 8)
        for part in parts:
            kt = -(-part.shape[0] // 16)
            want = np.zeros((16 * kt, 8 * nt), np.int16)
            want[:part.shape[0], :M] = part.view(torch.int16).numpy()
            a, h, k, j, n = np.meshgrid(np.arange(kt), np.arange(2),
                                        np.arange(8), np.arange(nt),
                                        np.arange(8), indexing="ij")
            byte = a * 32 * 8 * nt + sbo * j + lbo * h + 16 * n + 2 * k
            got = np.zeros_like(want)
            got[16 * a + 8 * h + k, 8 * j + n] = flat[off + byte // 2]
            np.testing.assert_array_equal(got, want)
            # every value of the part's k-steps is read exactly once
            hits = np.bincount(byte.reshape(-1) // 2,
                               minlength=kt * nt * 128)
            assert hits.shape[0] == kt * nt * 128 and (hits == 1).all()
            off += kt * nt * 128
    assert off == stream.numel()


def _kernel_inputs(n: int, seed: int = 0) -> dict:
    """Seeded inputs of both fused kernels (float32; the packs are rounded
    to bfloat16 by the caller)."""
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


@pytest.mark.parametrize("kernel", ["geo", "query"])
def test_fused_mlp_bf16_twins_match_jax(kernel):
    """Kernels 12 / 11's plain versions in bfloat16 (bfloat16 packs and
    weights) against the JAX kernels in interpret mode with
    ``prepare_*_weights(params, bfloat16)``: ``out`` float32, the latent
    bfloat16, each output held by :func:`near_jax_bf16` with rtol 2e-4 /
    atol 2e-5; the float32 side of both packages runs the float32 kernels
    and weights on the same (bfloat16-valued) packs."""
    import jax
    import jax.numpy as jnp
    from vanerf_tpu.ops import fused_mlp as jf
    g, _ = h.converted_params()
    d = _kernel_inputs(300)                # not a multiple of the JAX tile
    model = _port_model("bfloat16")
    packs = ("aux",) if kernel == "geo" else ("feats", "g2")
    J = {k: jnp.asarray(d[k]) for k in ("cxyz", "kpt_T")}
    Tt = {k: T(d[k]) for k in ("cxyz", "kpt_T")}
    for k in packs:
        J[k], Tt[k] = bf(d[k])
    with torch.no_grad(), jax.default_matmul_precision("highest"):
        if kernel == "geo":
            def run_j(cdt):
                return jf.fused_geo_mlp(
                    J["cxyz"], J["kpt_T"], J["aux"].astype(cdt),
                    jf.prepare_geo_mlp_weights(g["params"], cdt),
                    interpret=True, **KW)

            def run_t(cdt):
                return tf.fused_geo_mlp(
                    Tt["cxyz"], Tt["kpt_T"], Tt["aux"].to(cdt),
                    tf.prepare_geo_mlp_weights(model, cdt), **KW)
            got = run_t(BF)
            assert got[0].dtype == torch.float32 and got[1].dtype == BF
        else:
            def run_j(cdt):
                return (jf.fused_query_mlp(
                    J["cxyz"], J["kpt_T"], J["feats"].astype(cdt),
                    J["g2"].astype(cdt),
                    jf.prepare_query_weights(g["params"], cdt),
                    interpret=True, **KW),)

            def run_t(cdt):
                return (tf.fused_query_mlp(
                    Tt["cxyz"], Tt["kpt_T"], Tt["feats"].to(cdt),
                    Tt["g2"].to(cdt),
                    tf.prepare_query_weights(model, cdt=cdt), **KW),)
            got = run_t(BF)
            assert got[0].dtype == torch.float32
        got_f32 = run_t(torch.float32)
        want, want_f32 = run_j(jnp.bfloat16), run_j(jnp.float32)
    for i, (a, a32, b, c) in enumerate(zip(got, got_f32, want, want_f32)):
        assert np.abs(A(b)).max() > 1e-3
        assert (A(b) != A(c)).any()        # JAX did compute in bfloat16
        near_jax_bf16(a, a32, b, c, 2e-4, 2e-5, f"{kernel} output {i}")
    for name in ("fused_geo_mlp_bf16", "fused_query_mlp_bf16"):
        assert ops.launch_counts()[name] == 0


# ---------------------------------------------------------------------------
# (c) VANeRF.query at fused levels 0 / 1 / 2
# ---------------------------------------------------------------------------

def _query_inputs(n_views: int = 1):
    """The query's inputs on the fixture batch with ``n_views`` source views
    (the last element)."""
    import jax.numpy as jnp
    from vanerf_tpu.ops.knn import nearest_vertex_d2
    batch = (h.synthetic_batch()[0] if n_views == 1
             else h.synthetic_batch_views(n_views))
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
    return batch, pts, view, vv, qv, qs, nn_idx, cam, n_views


def _jax_maps(batch):
    """The JAX encoder's float32 feature maps of the batch's image:
    ([coarse, fine] geometry maps, texture map), as JAX arrays."""
    import jax.numpy as jnp
    g, _ = h.converted_params()
    jm = _jax_model("float32")
    return jm.apply(g, jnp.asarray(batch["src_img"]), method=jm.encode)


def _jax_query(cdt, level, inputs):
    import jax.numpy as jnp
    g, _ = h.converted_params()
    batch, pts, view, vv, qv, qs, nn_idx, cam, n_views = inputs
    jm = _jax_model(cdt)
    fg, ft = _jax_maps(batch)
    return jm.apply(
        g, jnp.asarray(pts), jnp.asarray(view),
        {k: jnp.asarray(v) for k, v in cam.items()}, fg, ft,
        jnp.asarray(batch["src_img"]), jnp.asarray(batch["src_mask"]),
        jnp.asarray(batch["verts"]), jnp.asarray(vv), jnp.asarray(qv),
        jnp.asarray(qs), jnp.asarray(batch["kpt3d"]), 8, n_views, False,
        nn_idx=jnp.asarray(nn_idx), fused_override=level, method=jm.query)


def _port_query(model, level, inputs, maps=None):
    """The port's query; ``maps``: the feature maps to take instead of the
    port's encoder's (as :func:`_jax_maps` gives them)."""
    batch, pts, view, vv, qv, qs, nn_idx, cam, n_views = inputs
    cam_t = {k: (T(v) if isinstance(v, np.ndarray) else v)
             for k, v in cam.items()}
    with torch.no_grad():
        if maps is None:
            fg, ft = model.encode(T(batch["src_img"]))
        else:
            fg, ft = [T(A(f)) for f in maps[0]], T(A(maps[1]))
        return model.query(
            T(pts), T(view), cam_t, fg, ft, T(batch["src_img"]),
            T(batch["src_mask"]), T(batch["verts"]), T(vv), T(qv), T(qs),
            T(batch["kpt3d"]), 8, n_views, nn_idx=T(nn_idx),
            fused_override=level)


@pytest.mark.parametrize("level", [0, 1, 2, "v2"])
def test_query_bf16_matches_jax(level, env):
    """``VANeRF.query`` in bfloat16 at each fused level, and at two source
    views ("v2": level 0, the only level there), against the JAX query in
    bfloat16 (its Pallas kernels in interpret mode), both on the JAX
    encoder's maps: float32 out, ``valid`` equal, each channel held by
    :func:`near_jax_bf16` with rtol 1e-4 / atol 1e-5, the port's float32
    query the control."""
    import jax.numpy as jnp
    from vanerf_tpu_torch.models import vanerf as tv
    n_views = 2 if level == "v2" else 1
    level = 0 if level == "v2" else level
    inputs = _query_inputs(n_views)
    maps = _jax_maps(inputs[0])
    calls = []
    real = tv.interp_sample_nhwc
    env.setattr(tv, "interp_sample_nhwc",
                lambda *a: calls.append(a[0].dtype) or real(*a))
    out_t, valid_t = _port_query(_port_model("bfloat16"), level, inputs,
                                 maps)
    assert out_t.dtype == torch.float32 and calls and set(calls) == {BF}
    out_t32, _ = _port_query(_port_model("float32"), level, inputs, maps)
    out_j, valid_j = _jax_query("bfloat16", level, inputs)
    out_f, _ = _jax_query("float32", level, inputs)
    assert out_j.dtype == jnp.float32
    np.testing.assert_array_equal(A(valid_t), A(valid_j))
    assert 0 < A(valid_t).mean() < 1
    for c in range(5):
        near_jax_bf16(out_t[..., c], out_t32[..., c], A(out_j)[..., c],
                      A(out_f)[..., c], 1e-4, 1e-5,
                      f"level {level} channel {c}")


def test_bf16_query_within_jax_bound_of_f32(env):
    """The port's bfloat16 query against its own float32 query at each
    level: within JAX's own bound for that comparison (atol / rtol 0.1,
    ``tests/test_models.py:222-224``), ``valid`` equal, and not equal to
    the bit (the activations did round)."""
    inputs = _query_inputs()
    m16, m32 = _port_model("bfloat16"), _port_model("float32")
    for level in (0, 1, 2):
        o16, v16 = _port_query(m16, level, inputs)
        o32, v32 = _port_query(m32, level, inputs)
        assert o16.dtype == torch.float32
        assert torch.equal(v16, v32)
        assert not torch.equal(o16, o32)
        np.testing.assert_allclose(A(o16), A(o32), atol=0.1, rtol=0.1)


def test_ibr_head_bf16_matches_flax():
    """The IBR head (run by the model at two or more views only) in the
    activations' dtype: bfloat16 in, bfloat16 out, held by
    :func:`near_jax_bf16` with rtol 1e-4 / atol 1e-5 against flax's head
    on the same bfloat16 inputs (the float32 heads on those inputs the
    float32 side)."""
    import jax.numpy as jnp
    from vanerf_tpu.models.ibr import IBRRenderingHead
    g, _ = h.converted_params()
    rs = np.random.RandomState(8)
    R, S, V = 5, 4, 2
    ins = [bf(rs.randn(R, S, V, 40).astype(np.float32)),
           bf(rs.randn(R, S, V, 4).astype(np.float32)),
           bf((rs.rand(R, S, V, 1) > 0.2).astype(np.float32))]
    head = {"params": g["params"]["mlp_tex"]}
    want = IBRRenderingHead().apply(head, *(j for j, _ in ins))
    want_f32 = IBRRenderingHead().apply(
        head, *(j.astype(jnp.float32) for j, _ in ins))
    with torch.no_grad():
        got = _port_model("bfloat16").mlp_tex(*(t for _, t in ins))
        got_f32 = _port_model("float32").mlp_tex(*(t.float() for _, t in ins))
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    near_jax_bf16(got, got_f32, want, want_f32, 1e-4, 1e-5, "ibr head")


# ---------------------------------------------------------------------------
# (d) eval render_patch and render_full_image
# ---------------------------------------------------------------------------

def _jax_render(cdt, batch):
    import jax
    import jax.numpy as jnp
    from vanerf_tpu import renderer as jr
    g, _ = h.converted_params()
    jb = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in batch.items()}
    return jr.render_patch(
        _jax_model(cdt), g, jb, rng=jax.random.PRNGKey(0),
        grids=jnp.asarray(h.center_grid()), out_h=h.OUT, out_w=h.OUT,
        sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F, fine=True,
        uniform=True, training=False, n_views=1, sdf_chunk=64,
        compute_vis_map=False)


@pytest.mark.parametrize("level", ["0", "1", "2"])
def test_render_patch_bf16_matches_jax(level, env):
    """Eval ``render_patch`` in bfloat16 under ``VANERF_FUSED_MLP`` 0 / 1 /
    2 against the JAX package's, both on the JAX encoder's maps: float32
    outputs, each held by :func:`near_jax_bf16` with rtol 1e-3 / atol 1e-4
    (depth and sdf on hit rays, atol 2e-4), the port's float32 render the
    control (not for the alphas, which saturate on this fixture: bfloat16
    does not move them beyond float32's noise).  The faces come in Morton
    order, so both packages break exact distance ties alike
    (``torch_port_helpers.morton_sorted``)."""
    env.setenv("VANERF_FUSED_MLP", level)
    batch = h.morton_sorted(h.synthetic_batch()[0])
    want = _jax_render("bfloat16", batch)
    want_f32 = _jax_render("float32", batch)
    maps = _jax_maps(batch)
    maps = ([T(A(f)) for f in maps[0]], T(A(maps[1])))
    got = {}
    for cdt in ("bfloat16", "float32"):
        model = _port_model(cdt)
        env.setattr(model, "encode", lambda img: maps)
        got[cdt] = tr.render_patch(
            model, h.torch_batch(batch), grids=T(h.center_grid()),
            out_h=h.OUT, out_w=h.OUT, sample_per_ray_c=h.S_C,
            sample_per_ray_f=h.S_F, compute_vis_map=False)
    g16, g32 = got["bfloat16"], got["float32"]
    assert g16["alpha_fine"].max() > 0.2, "rays missed the fixture mesh"
    for k in ("tex_fg", "alpha", "tex_fg_fine", "alpha_fine"):
        assert g16[k].dtype == torch.float32
        near_jax_bf16(g16[k], g32[k], want[k], want_f32[k], 1e-3, 1e-4, k,
                      control=not k.startswith("alpha"))
    for k, acck in (("depth", "alpha"), ("depth_fine", "alpha_fine"),
                    ("sdf", "alpha_fine")):
        m = A(want[acck]) > 1e-2
        assert m.any()
        near_jax_bf16(A(g16[k])[m], A(g32[k])[m], A(want[k])[m],
                      A(want_f32[k])[m], 1e-3, 2e-4, k)


@pytest.mark.parametrize("switches", [
    {"VANERF_FAR_SKIP": "0.5"}, {"VANERF_FAR_NET": "0.5"},
    {"VANERF_FAR_TNET": "0.5"}, {"VANERF_MXU_INTERP": "0"},
    {"VANERF_SOA_POINTS": "1"}, {"VANERF_KNN_CULL": "1"}])
def test_bf16_serving_switches_compose(switches, env):
    """The serving switches under bfloat16: the render runs, its outputs
    float32 and finite, within JAX's bound for bfloat16 against float32
    (atol / rtol 0.1) of the float32 render under the same switch."""
    for k, v in switches.items():
        env.setenv(k, v)
    batch = h.torch_batch(h.synthetic_batch()[0])
    kw = dict(grids=T(h.center_grid()), out_h=h.OUT, out_w=h.OUT,
              sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F,
              compute_vis_map=False)
    got = tr.render_patch(_port_model("bfloat16"), batch, **kw)
    want = tr.render_patch(_port_model("float32"), batch, **kw)
    assert got["alpha_fine"].max() > 0.2
    for k in ("tex_fg", "alpha", "tex_fg_fine", "alpha_fine", "depth_fine"):
        assert got[k].dtype == torch.float32 and torch.isfinite(got[k]).all()
        np.testing.assert_allclose(A(got[k]), A(want[k]), atol=0.1,
                                   rtol=0.1, err_msg=k)


@pytest.mark.parametrize("level", ["0", "2"])
def test_render_full_image_bf16_is_its_patches(level, env):
    """``render_full_image`` in bfloat16: float32 and finite, and equal to
    the bit to its stride-offset patches rendered one by one with
    ``render_patch`` in bfloat16 (which the test above holds to JAX)."""
    env.setenv("VANERF_FUSED_MLP", level)
    model = _port_model("bfloat16")
    batch = h.torch_batch(h.synthetic_batch()[0])
    full = tr.render_full_image(model, batch, level=3, sample_per_ray_c=4,
                                sample_per_ray_f=4)
    assert full["tex_fg_fine"].dtype == torch.float32
    assert torch.isfinite(full["tex_fg_fine"]).all()
    s = 4
    for i, j in ((0, 0), (1, 3), (3, 2)):
        grids = tr.strided_grid(1, h.H, h.W, 3, [[j, i]])
        tile = tr.render_patch(model, batch, grids=grids, out_h=h.H // s,
                               out_w=h.W // s, sample_per_ray_c=4,
                               sample_per_ray_f=4, compute_vis_map=False)
        for k in ("tex_fg_fine", "alpha_fine", "depth_fine"):
            assert torch.equal(full[k][:, i::s, j::s], tile[k]), (k, i, j)


# ---------------------------------------------------------------------------
# (e) on the card: each bfloat16 kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_interp_and_row_gather_bf16_kernels_match_plain(cuda):
    rs = np.random.RandomState(6)
    for hwc, n in (((32, 32, 64), 262144), ((16, 16, 6), 999)):
        fm = T(rs.randn(*hwc).astype(np.float32)).to(cuda, BF)
        uv = T((rs.rand(n, 2) * 2.4 - 1.2).astype(np.float32)).to(cuda)
        n0 = ti.launches_bf16
        got = ti.mxu_grid_sample(fm, uv)
        torch.cuda.synchronize()
        assert ti.launches_bf16 == n0 + 1
        assert torch.equal(got, ti.interp_plain(fm, uv))
    for V, C, n in ((1284, 204, 262144), (130, 7, 900)):
        tbl = T(rs.randn(V, C).astype(np.float32)).to(cuda, BF)
        idx = T(rs.randint(0, V, size=n).astype(np.int32)).to(cuda)
        n0 = ti.row_gather_launches_bf16
        got = ti.mxu_row_gather(tbl, idx)
        torch.cuda.synchronize()
        assert ti.row_gather_launches_bf16 == n0 + 1
        assert torch.equal(got, ti.row_gather_plain(tbl, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["geo", "query"])
def test_fused_bf16_kernels_match_plain(kernel, cuda):
    """Each bfloat16 fused kernel within 2 S of its plain version, S the
    spread of the plain version between its float32 and its bfloat16
    form on the same inputs (a looser cousin of chip_smoke's bound)."""
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    model = VANeRF.from_config(default_cfg(), num_v=642, image_hw=(256, 256))
    init_like_flax(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    d = {k: T(v).to(cuda) for k, v in _kernel_inputs(4096 + 37, 7).items()}
    for k in ("aux", "feats", "g2"):
        d[k] = d[k].to(BF)
    with torch.no_grad():
        if kernel == "geo":
            def run(fn, cdt):
                w = tf.prepare_geo_mlp_weights(model, cdt)
                return fn(d["cxyz"], d["kpt_T"], d["aux"].to(cdt), w, **KW)
            fn, plain, counter = (tf.fused_geo_mlp, tf.fused_geo_mlp_plain,
                                  "geo_launches_bf16")
        else:
            def run(fn, cdt):
                w = tf.prepare_query_weights(model, cdt=cdt)
                return (fn(d["cxyz"], d["kpt_T"], d["feats"].to(cdt),
                           d["g2"].to(cdt), w, **KW),)
            fn, plain, counter = (tf.fused_query_mlp,
                                  tf.fused_query_mlp_plain,
                                  "query_launches_bf16")
        n0 = getattr(tf, counter)
        got = run(fn, BF)
        torch.cuda.synchronize()
        assert getattr(tf, counter) == n0 + 1
        want, want_f32 = run(plain, BF), run(plain, torch.float32)
    for a, b, c in zip(got, want, want_f32):
        within_spread(a.cpu(), b.cpu(), c.cpu(), 0.0, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["softplus", "sigmoid"])
def test_fused_bf16_activations_exact_on_every_input(act, cuda):
    """Kernels 11 / 12's bfloat16 softplus and sigmoid (their fast forms
    and the fallback to the plain formula) equal the plain version's
    rounded result on all 65,536 bfloat16 inputs, bit for bit (NaN where
    it is NaN)."""
    a = tf.ACT_SOFTPLUS if act == "softplus" else tf.ACT_SIGMOID
    got = tf.act_bf16_all_cuda(a, cuda)
    want = tf.act_bf16_all_plain(a, cuda)
    torch.cuda.synchronize()
    nan = torch.isnan(got.float()) & torch.isnan(want.float())
    same = got.view(torch.int16) == want.view(torch.int16)
    assert (same | nan).all(), int((~(same | nan)).sum())
    assert int(nan.sum()) == 2 * 127


@pytest.mark.cuda
def test_onehot_scatter_bf16_kernel_matches_plain(cuda):
    """Kernel 13 on bfloat16 rows: equal to the float32 kernel on the rows
    widened to float32, rounded once to bfloat16 (the same sums); within
    one bfloat16 unit of its plain version; two runs equal; the one-launch
    and the counting-sort path, 4-channel and scalar lanes."""
    from vanerf_tpu_torch.ops import onehot_gather as og
    rs = np.random.RandomState(13)
    for n, T_, C in ((262144, 1284, 204), (262144, 1024, 256),
                     (262144, 4096, 32), (1284, 1024, 256), (5000, 37, 5)):
        g = T(rs.randn(n, C).astype(np.float32)).to(cuda, BF)
        idx = T(np.minimum(rs.geometric(2.0 / T_, n) - 1, T_ - 1)
                .astype(np.int32)).to(cuda)
        n0, f0 = og.launches_bf16, og.launches
        got = og.onehot_scatter(g, idx, T_)
        again = og.onehot_scatter(g, idx, T_)
        f32 = og.onehot_scatter(g.float(), idx, T_)
        torch.cuda.synchronize()
        assert got.dtype == BF and got.shape == (T_, C)
        assert og.launches_bf16 == n0 + 2 and og.launches == f0 + 1
        assert torch.equal(got, again)
        assert torch.equal(got, f32.to(BF))
        want = og.onehot_scatter_plain(g, idx, T_)
        a, b = got.float().cpu().numpy(), want.float().cpu().numpy()
        assert (np.abs(a - b) <= ulp_bf16(np.maximum(np.abs(a),
                                                     np.abs(b)))).all()
