"""The readers of the program's spans and counters (``benchmark/spans.py``
and the nine metrics that use it) on a hand-built parsed trace: their
values, None in the other kind of cell, and None where the program has no
such span or counter (an older tree)."""

import sys
import types

import pytest

from benchmark import spans
from benchmark.manifest import ROOT, Manifest

# times in microseconds; two serving frames on thread 1 (ops launched
# 10 us into each range they belong to)
SERVE_HOST = [
    ("vanerf.frame", 0, 1000, 1), ("vanerf.encode", 10, 100, 1),
    ("vanerf.patch", 100, 900, 1), ("vanerf.pass.coarse", 110, 500, 1),
    ("vanerf.query", 120, 400, 1), ("vanerf.query.sample", 130, 200, 1),
    ("vanerf.query.gather", 200, 300, 1), ("vanerf.query.net", 300, 400, 1),
    ("vanerf.composite", 400, 500, 1), ("vanerf.assemble", 900, 1000, 1),
    ("vanerf.frame", 2000, 3000, 1), ("vanerf.query.gather", 2100, 2200, 1),
    ("aten::cat", 2110, 2120, 1),
]
SERVE_OPS = [   # (name, device start, device end, launch ts, launch tid)
    ("encoder", 20, 60, 20, 1),              # 40 in encode
    ("sample", 140, 160, 140, 1),            # 20 in sample
    ("CatArrayBatchedCopy<x>", 210, 290, 210, 1),   # 80 in gather
    ("gemm", 310, 390, 310, 1),              # 80 in net
    ("rgba2out", 410, 430, 410, 1),          # 20 in composite
    ("unshuffle", 910, 930, 910, 1),         # 20 in assemble
    ("CatArrayBatchedCopy<x>", 2110, 2150, 2110, 1),  # 40 in gather
    ("h2d", 1500, 1510, 1500, 1),            # outside every span
    ("other thread", 140, 150, 140, 2),      # launched on another thread
]
TRAIN_HOST = [
    ("vanerf.step", 0, 1000, 1), ("vanerf.g.render", 0, 300, 1),
    ("vanerf.patch", 5, 295, 1), ("vanerf.g.loss", 300, 350, 1),
    ("vanerf.g.backward", 350, 500, 1), ("vanerf.g.optimizer", 500, 600, 1),
    ("vanerf.d.render", 600, 800, 1), ("vanerf.d.loss", 800, 850, 1),
    ("vanerf.d.backward", 850, 900, 1), ("vanerf.d.optimizer", 900, 980, 1),
    ("autograd::engine::evaluate_function: X", 360, 480, 2),
]
TRAIN_OPS = [
    ("render g", 10, 250, 10, 1),            # 240 in g.render
    ("backward", 370, 470, 370, 2),          # autograd thread
    ("adam", 510, 590, 510, 1),
    ("render d", 610, 790, 610, 1),          # 180 in d.render
]
COUNTS = {"samples": 1000, "net_points": 800, "far_samples": 250,
          "a_pairs_visited": 30, "a_pairs": 120, "mesh_query": 4}


def parsed(host, ops, items):
    return {"host": host, "ops": ops, "busy_s": 4e-4, "window_s": 3e-3,
            "span_s": 3e-3, "items": items}


def serve_ctx():
    return {"kind": "serve", "trace": parsed(SERVE_HOST, SERVE_OPS, 2)}


def train_ctx():
    return {"kind": "train", "trace": parsed(TRAIN_HOST, TRAIN_OPS, 1)}


@pytest.fixture(scope="module")
def readers():
    return Manifest(ROOT.parent / "BENCHMARK.json").readers


@pytest.fixture
def counts(monkeypatch):
    monkeypatch.setattr(spans, "program_counters", lambda: dict(COUNTS))


NEW = {   # metric -> (kind, value on the hand-built trace and counters)
    "encode_ms.serve": ("serve", 0.040 / 2),
    "sample_ms.serve": ("serve", 0.020 / 2),
    "gather_ms.serve": ("serve", 0.120 / 2),
    "composite_ms.serve": ("serve", 0.040 / 2),
    "net_points.serve": ("serve", 800 / 2 / 1e6),
    "far_share.serve": ("serve", 25.0),
    "visited_share.serve": ("serve", 25.0),
    "render_ms.train": ("train", 0.420),
    "optimizer_ms.train": ("train", 0.180),
}


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_values(name, readers, counts):
    kind, want = NEW[name]
    ctx = serve_ctx() if kind == "serve" else train_ctx()
    assert readers[name].read(ctx) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_none_in_the_other_kind(name, readers, counts):
    kind, _ = NEW[name]
    other = train_ctx() if kind == "serve" else serve_ctx()
    assert readers[name].read(other) is None
    assert readers[name].read({"kind": kind, "trace": None}) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_none_without_the_programs_spans_or_counters(
        name, readers, monkeypatch):
    """An older program: no ``vanerf.*`` range in its trace and no
    ``profiling.counters`` to import."""
    monkeypatch.setitem(sys.modules, "vanerf_tpu_torch.profiling",
                        types.ModuleType("vanerf_tpu_torch.profiling"))
    assert spans.program_counters() is None
    kind, _ = NEW[name]
    host = [h for h in (SERVE_HOST if kind == "serve" else TRAIN_HOST)
            if not h[0].startswith("vanerf.")]
    ops = SERVE_OPS if kind == "serve" else TRAIN_OPS
    assert readers[name].read({"kind": kind,
                               "trace": parsed(host, ops, 2)}) is None


def test_counter_readers_none_without_the_counter(readers, monkeypatch):
    monkeypatch.setattr(spans, "program_counters", lambda: {"samples": 10})
    for name in ("net_points.serve", "far_share.serve",
                 "visited_share.serve"):
        assert readers[name].read(serve_ctx()) is None, name


def test_innermost_span_of_each_launch():
    got = spans.innermost(parsed(SERVE_HOST, SERVE_OPS, 2))
    assert got == ["vanerf.encode", "vanerf.query.sample",
                   "vanerf.query.gather", "vanerf.query.net",
                   "vanerf.composite", "vanerf.assemble",
                   "vanerf.query.gather", None, None]


def test_innermost_takes_the_outer_of_two_that_start_together():
    host = [("vanerf.query.net", 0, 10, 1), ("vanerf.query", 0, 100, 1)]
    ops = [("a", 0, 1, 5, 1), ("b", 0, 1, 50, 1)]
    assert spans.innermost(parsed(host, ops, 1)) == ["vanerf.query.net",
                                                      "vanerf.query"]


def test_span_table():
    # the benchmark's network range inside vanerf.query.net takes the gemm
    host = SERVE_HOST + [("bench.network", 305, 395, 1)]
    tab = spans.table(parsed(host, SERVE_OPS, 2))
    assert tab["exclusive_ms"]["vanerf.query.gather"] == pytest.approx(0.06)
    assert tab["exclusive_ms"]["bench.network"] == pytest.approx(0.04)
    assert "vanerf.query.net" not in tab["exclusive_ms"]
    assert tab["exclusive_ms"]["(no span)"] == pytest.approx(0.01)
    assert tab["inclusive_ms"]["vanerf.frame"] == pytest.approx(0.15)
    assert tab["inclusive_ms"]["vanerf.query.net"] == pytest.approx(0.04)
    assert tab["host_ms"]["vanerf.frame"] == pytest.approx(1.0)
    assert tab["root_share_of_busy"]["vanerf.frame"] == pytest.approx(
        0.15 / 0.2)
    cat = tab["classes"]["CatArrayBatchedCopy"]
    assert cat["by_span_ms"] == {"vanerf.query.gather": pytest.approx(0.06)}


def test_step_cover():
    cover = spans.table(parsed(TRAIN_HOST, TRAIN_OPS, 1))["step"]
    assert cover["step_ms"] == pytest.approx(1.0)
    assert cover["uncovered_share"] == pytest.approx(0.02)   # 980 .. 1000
    # the gaps 250-370, 470-510 and 590-610, by the range open at their
    # middle
    assert cover["idle_in_step_ms_by_label"] == {
        "vanerf.g.loss": pytest.approx(0.12),
        "vanerf.g.backward": pytest.approx(0.04),
        "vanerf.g.optimizer": pytest.approx(0.02)}
