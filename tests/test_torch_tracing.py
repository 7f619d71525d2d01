"""The port's spans and work counters (``vanerf_tpu_torch/profiling.py``),
on the CPU.

A tiny ``render_full_image`` (the 32^2 two-hand fixture at level 2, four
tiles in one group of G = 4, 8 + 8 samples) and a tiny faithful GAN step
(an 8 x 8 patch, 4 + 4 samples) run twice each: once under a
``torch.profiler`` session (``profiling.trace``) and once with none, with
``torch.profiler.record_function`` replaced by a function that raises.
The first run must emit every span, nested as ``PERF.md`` lists them under
the root ``vanerf.frame`` / ``vanerf.step``, and count the work; the
second must open no span and count nothing; the two must give equal
outputs, to the bit (the traced run asks kernel A's plain version for its
visits).  The counters are held to counts made here without them: the
samples and network rows from the shapes, the far samples and kernel A's
visited chunk pairs from the recorded calls of ``cal_vis_sdf_prepared``
run again outside the profiler.
"""

import json

import pytest
import torch

import torch_port_helpers as h
from vanerf_tpu_torch import profiling
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.ops import mesh_query as mq

LEVEL, G = 2, 4
PATCH, S_T = 8, 4              # the training patch and its samples a pass
PASSES = {"vanerf.pass.coarse", "vanerf.pass.fine"}
QUERY = ("vanerf.query.sample", "vanerf.query.gather", "vanerf.query.net")

# each span and the spans it may sit directly under (None: a root)
FRAME_SPANS = {
    "vanerf.frame": {None},
    "vanerf.encode": {"vanerf.frame"},
    "vanerf.prepare": {"vanerf.frame"},
    "vanerf.patch": {"vanerf.frame"},
    "vanerf.pass.coarse": {"vanerf.patch"},
    "vanerf.pass.fine": {"vanerf.patch"},
    "vanerf.mesh_prior": PASSES,
    "vanerf.query": PASSES,
    "vanerf.composite": PASSES,
    "vanerf.assemble": {"vanerf.patch", "vanerf.frame"},
    **{name: {"vanerf.query"} for name in QUERY},
}
PHASES = [f"vanerf.{who}.{what}" for who in ("g", "d")
          for what in ("render", "loss", "backward", "optimizer")]
STEP_SPANS = {
    **{k: v for k, v in FRAME_SPANS.items()
       if k not in ("vanerf.frame", "vanerf.patch")},
    "vanerf.step": {None},
    **{name: {"vanerf.step"} for name in PHASES},
    "vanerf.patch": {"vanerf.g.render", "vanerf.d.render"},
    "vanerf.encode": {"vanerf.patch"},
    "vanerf.prepare": {"vanerf.patch"},
    "vanerf.assemble": {"vanerf.patch"},
}
WORK = ("samples", "net_points", "far_samples", "a_pairs_visited",
        "a_pairs")


def _model(cfg):
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    model = VANeRF.from_config(cfg, num_v=h.NUM_V, image_hw=(h.H, h.W))
    init_like_flax(model, torch.Generator().manual_seed(0))
    return model


def _batch(split: str):
    from vanerf_tpu_torch.data import make_synthetic_batch, to_torch
    batch, _faces, num_v = make_synthetic_batch(
        batch_size=1, H=h.H, W=h.W, subdiv=2, split=split, device="cpu")
    assert num_v == h.NUM_V
    return to_torch(batch, "cpu")


def _raise(*_a, **_k):
    raise AssertionError("a span was opened with no profiler recording")


class _Recorder:
    """``renderer.cal_vis_sdf_prepared`` with its arguments kept."""

    def __init__(self):
        self.calls = []
        self.real = tr.cal_vis_sdf_prepared

    def __call__(self, mesh, points, ub_d2, n_samples=None, far2=None):
        self.calls.append((mesh, points.detach().clone(),
                           ub_d2.detach().clone(), n_samples, far2))
        return self.real(mesh, points, ub_d2, n_samples=n_samples,
                         far2=far2)


def _traced(fn, tmp, name):
    """``fn()`` under ``profiling.trace`` with the mesh queries recorded:
    (result, the spans [(name, parent)], counters file, recorded calls)."""
    rec = _Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tr, "cal_vis_sdf_prepared", rec)
        with profiling.trace(str(tmp), f"{name}.json") as prof:
            out = fn()
    spans = []
    for ev in prof.events():
        if ev.name.startswith("vanerf."):
            up = ev.cpu_parent
            while up is not None and not up.name.startswith("vanerf."):
                up = up.cpu_parent
            spans.append((ev.name, None if up is None else up.name))
    counts = json.loads((tmp / f"{name}.counters.json").read_text())
    return out, spans, counts, rec.calls


def _untraced(fn):
    """``fn()`` with no profiler and ``record_function`` raising: (result,
    the counters afterwards)."""
    profiling.reset_counters()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _raise)
        out = fn()
    return out, profiling.counters()


def _independent(calls) -> dict:
    """far_samples, a_pairs_visited and a_pairs of the recorded calls, run
    again with no profiler: the far masks of ``cal_vis_sdf_prepared`` and
    the visits of ``point_mesh_query_vis_culled(..., visits=True)``."""
    assert not profiling.recording()
    out = dict.fromkeys(("far_samples", "a_pairs_visited", "a_pairs"), 0)
    for mesh, pts, ub, n_samples, far2 in calls:
        with torch.no_grad():
            far = mq.cal_vis_sdf_prepared(mesh, pts, ub, n_samples=n_samples,
                                          far2=far2)[2]
            centred = (pts - mq._centers(mesh, pts.shape[0])[:, None])
            visits = mq.point_mesh_query_vis_culled(
                centred.contiguous(), mesh, ub.contiguous(),
                mq.tile_geometry(pts.shape[-2], n_samples), far2,
                visits=True)[5]
        out["far_samples"] += 0 if far is None else int(far.sum())
        out["a_pairs_visited"] += int(visits[..., 0].sum())
        out["a_pairs"] += visits[..., 0].numel() * mesh["cbox"].shape[-2]
    return out


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    model = _model(h.small_cfg()).eval()
    batch = _batch("test")

    def render():
        return tr.render_full_image(model, batch, level=LEVEL,
                                    sample_per_ray_c=h.S_C,
                                    sample_per_ray_f=h.S_F, tile_group=G)
    on, spans, counts, calls = _traced(render, tmp_path_factory.mktemp(
        "frame"), "frame")
    off, off_counts = _untraced(render)
    return dict(on=on, off=off, spans=spans, counts=counts, calls=calls,
                off_counts=off_counts)


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    from vanerf_tpu_torch.losses import VGGLoss
    from vanerf_tpu_torch.models import DiscriminatorVis
    from vanerf_tpu_torch.training import (create_train_state,
                                           make_train_step)
    cfg = h.small_cfg()
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = PATCH
    m["dr_kwargs"].update(sample_per_ray_c=S_T, sample_per_ray_f=S_T)
    batch = _batch("train")

    def one():
        """A fresh state from the same seeds, one step: (logs, the
        parameters after it)."""
        torch.manual_seed(0)
        model, disc = _model(cfg), DiscriminatorVis()
        vgg = VGGLoss()
        ts = create_train_state(model, disc, cfg, steps_per_epoch=10)
        logs = make_train_step(model, disc, cfg, vgg)(
            ts, batch, generator=torch.Generator().manual_seed(3))
        params = [p.detach().clone() for p in
                  list(model.parameters()) + list(disc.parameters())]
        return logs, params
    # on more than one CPU thread a step's last bits vary from run to run,
    # with or without a profiler: one thread makes it repeat
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        on, spans, counts, calls = _traced(one, tmp_path_factory.mktemp(
            "step"), "step")
        off, off_counts = _untraced(one)
    finally:
        torch.set_num_threads(threads)
    return dict(on=on, off=off, spans=spans, counts=counts, calls=calls,
                off_counts=off_counts)


@pytest.mark.parametrize("kind", ["frame", "step"])
def test_every_span_is_emitted_and_nested(kind, request):
    run = request.getfixturevalue(kind)
    table = FRAME_SPANS if kind == "frame" else STEP_SPANS
    root = f"vanerf.{kind}"
    seen = {}
    for name, parent in run["spans"]:
        assert name in table, name
        assert parent in table[name], (name, parent)
        seen[name] = seen.get(name, 0) + 1
    assert set(seen) == set(table)
    assert seen[root] == 1
    # a frame: one patch call of both passes; a step: two
    assert seen["vanerf.pass.coarse"] == (1 if kind == "frame" else 2)


@pytest.mark.parametrize("kind", ["frame", "step"])
def test_no_profiler_no_span_and_no_count(kind, request):
    counts = request.getfixturevalue(kind)["off_counts"]
    assert not profiling.recording()
    assert all(counts.get(k, 0) == 0 for k in WORK), counts
    # the launch counters are read through the same call
    assert "mesh_query" in counts


def test_frame_equal_with_the_profiler_on_and_off(frame):
    on, off = frame["on"], frame["off"]
    assert set(on) == set(off)
    for k, v in on.items():
        assert torch.equal(v, off[k]), k


def test_step_equal_with_the_profiler_on_and_off(step):
    (logs_on, params_on), (logs_off, params_off) = step["on"], step["off"]
    assert set(logs_on) == set(logs_off)
    for k, v in logs_on.items():
        assert torch.equal(v, logs_off[k]), k
    assert all(torch.equal(a, b) for a, b in zip(params_on, params_off))


def test_frame_counters_equal_independent_counts(frame):
    counts = frame["counts"]
    rays = h.H * h.W              # level 2: four tiles, every pixel once
    assert counts["samples"] == rays * (h.S_C + h.S_F)
    assert counts["net_points"] == counts["samples"]      # no serving tier
    assert len(frame["calls"]) == 2
    want = _independent(frame["calls"])
    assert want["far_samples"] > 0 and want["a_pairs_visited"] > 0
    for k, v in want.items():
        assert counts[k] == v, k
    assert counts["a_pairs_visited"] < counts["a_pairs"]


def test_step_counters_equal_independent_counts(step):
    counts = step["counts"]
    # two renders (G and D) of both passes
    assert counts["samples"] == 2 * PATCH * PATCH * (S_T + S_T)
    assert counts["net_points"] == counts["samples"]
    assert len(step["calls"]) == 4
    want = _independent(step["calls"])
    for k, v in want.items():
        assert counts[k] == v, k


@pytest.mark.parametrize("kind", ["frame", "step"])
def test_sampler_route_counters(kind, request):
    """On the CPU every point ``feat_sample_nhwc`` samples takes the plain
    version: counted as gathered while the profiler records, and not at
    all without it."""
    run = request.getfixturevalue(kind)
    assert run["counts"]["sample_gather_points"] > 0
    assert run["counts"].get("sample_kernel_points", 0) == 0
    assert run["counts"]["bilinear"] == 0
    for k in ("sample_gather_points", "sample_kernel_points"):
        assert run["off_counts"].get(k, 0) == 0, k


def test_trace_writes_the_counters_beside_the_trace(frame, tmp_path):
    assert set(WORK) <= set(frame["counts"])
    assert frame["counts"]["mesh_query"] == 0     # plain versions: no launch
    with profiling.trace(str(tmp_path), "t.trace.json"):
        profiling.count("samples", 7)
    assert (tmp_path / "t.trace.json").is_file()
    counts = json.loads((tmp_path / "t.trace.counters.json").read_text())
    assert counts["samples"] == 7


def test_a_span_is_a_flag_read_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert profiling.span("a") is profiling.span("b")
    profiling.reset_counters()
    profiling.count("samples", 3)
    profiling.count_device("far_samples", torch.tensor(5))
    counts = profiling.counters()
    assert counts.get("samples", 0) == 0 and counts.get("far_samples", 0) == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_frame_on_the_card_equal_with_the_profiler_on_and_off(cuda,
                                                              tmp_path):
    """On the card kernel A writes its visits only while counting: the
    frame is equal to the bit either way, and the counters equal the
    recorded queries run again (kernel A with ``visits=True``)."""
    model = _model(h.small_cfg()).eval().to(cuda)
    batch = {k: v.to(cuda) for k, v in _batch("test").items()}

    def render():
        return tr.render_full_image(model, batch, level=LEVEL,
                                    sample_per_ray_c=h.S_C,
                                    sample_per_ray_f=h.S_F, tile_group=G)
    on, _spans, counts, calls = _traced(render, tmp_path, "frame")
    off, off_counts = _untraced(render)
    for k, v in on.items():
        assert torch.equal(v, off[k]), k
    assert all(off_counts.get(k, 0) == 0 for k in WORK)
    want = _independent(calls)
    assert want["a_pairs_visited"] > 0
    for k, v in want.items():
        assert counts[k] == v, k
    assert counts["mesh_query"] == 2
