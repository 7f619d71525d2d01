"""A configuration's family (``benchmark/families/<name>.py``) is where a
run takes its weight skeleton, its check and its FLOP count from: a
fixture family that re-exports ``vanerf`` but doubles the FLOPs and moves
the reference frame's RGB by 1e-3 makes a served run not correct and
doubles ``flops_per_item`` in a serving and a training run; a
configuration with no ``"family"`` key reads what one that names
``vanerf`` reads, to the bit.  On the CPU at a tiny size."""

import json
import shutil
import time

import pytest

from benchmark import serve, train
from benchmark.manifest import Manifest
from benchmark.run import execute
from benchmark.tests.tiny import tiny_copy

SEED = 2 ** 40 + 7
DOUBLED = '''
import pathlib

from benchmark.families import load_family

_base = load_family("vanerf", pathlib.Path(__file__).resolve().parents[1])
train = _base.train
NETWORK_MODULES = _base.NETWORK_MODULES
BUILT = []        # the device of every generator this family built


class Generator(_base.Generator):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        BUILT.append(self.sigmoid_beta.device.type)


def render_frame(G, req, **kw):
    out = dict(_base.render_frame(G, req, **kw))
    out["tex_fg_fine"] = out["tex_fg_fine"] + 1e-3
    return out


def frame_flops(*args):
    return 2 * _base.frame_flops(*args)


def step_flops(*args):
    return 2 * _base.step_flops(*args)
'''


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    path = tiny_copy(tmp)
    bench = tmp / "benchmark"
    (bench / "families" / "doubled.py").write_text(DOUBLED)
    spec = json.loads(path.read_text())
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    for fam in ("doubled", "vanerf"):
        name = f"tiny-{fam}"
        (bench / "configs" / f"{name}.json").write_text(
            json.dumps(dict(cfg, family=fam)))
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": ["models"], "why": "CPU tests"})
    cells = {"doubled-serve": ("tiny-doubled", "tiny-frames", "tiny-serve"),
             "doubled-train": ("tiny-doubled", "tiny-steps", "tiny-train"),
             "vanerf-serve": ("tiny-vanerf", "tiny-frames", "tiny-serve")}
    for cell, (config, traffic, like) in cells.items():
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "CPU tests"})
        shutil.copy(bench / "limits" / f"{like}.json",
                    bench / "limits" / f"{cell}.json")
        for metric in spec["end_to_end"]:
            if like in metric.get("workloads", []):
                metric["workloads"].append(cell)
    path.write_text(json.dumps(spec))
    return Manifest(path, root=bench)


def run(mf, cell, monkeypatch):
    """``execute``'s result and the driver's context of one CPU run."""
    got = {}
    for mod in (serve, train):
        def spy(*args, _run=mod.run, **kwargs):
            got["res"] = _run(*args, **kwargs)
            return got["res"]
        monkeypatch.setattr(mod, "run", spy)
    out = execute(mf, cell, SEED, 0.01, False, "cpu", time.perf_counter())
    return out, got["res"]["ctx"]


def test_the_served_check_flops_and_skeleton_come_from_the_family(
        manifest, monkeypatch):
    fam, base = manifest.family("doubled-serve"), manifest.family("tiny-serve")
    assert fam is not base and fam.train is base.train
    del fam.BUILT[:]
    out, ctx = run(manifest, "doubled-serve", monkeypatch)
    assert out["correct"] is False
    rgb = out["checked"]["rgb_mae"]
    assert rgb["value"] > rgb["limit"] and rgb["value"] > 9e-4
    m = manifest.config("doubled-serve")["models"]["VANeRF"]
    drk = m["dr_kwargs"]
    assert ctx["flops_per_item"] == 2 * base.frame_flops(
        m, 32, 32, 2, drk["sample_per_ray_c"], drk["sample_per_ray_f"], 1)
    assert fam.BUILT == ["meta", "cpu"]     # the weights' skeleton, the check


def test_the_step_flops_come_from_the_family(manifest, monkeypatch):
    fam, base = manifest.family("doubled-train"), manifest.family("tiny-train")
    del fam.BUILT[:]
    _, ctx = run(manifest, "doubled-train", monkeypatch)
    m = manifest.config("doubled-train")["models"]["VANeRF"]
    assert ctx["flops_per_item"] == 2 * base.step_flops(m, 32, 32, 1)
    assert fam.BUILT == ["meta", "meta"]    # the weights' skeleton, follow()


def test_no_family_key_reads_as_vanerf_to_the_bit(manifest, monkeypatch):
    assert manifest.family("vanerf-serve").__file__ == manifest.family(
        "tiny-serve").__file__
    plain, plain_ctx = run(manifest, "tiny-serve", monkeypatch)
    named, named_ctx = run(manifest, "vanerf-serve", monkeypatch)
    assert named["checked"] == plain["checked"]
    assert named_ctx["flops_per_item"] == plain_ctx["flops_per_item"]
