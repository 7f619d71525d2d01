"""The harness finds a configuration, its model family, a traffic mix, a
per-layer metric and a cell by the names ``BENCHMARK.json`` and the
configuration give them, with no code edited, and refuses entries that
break the manifest's rules."""

import json

import pytest

from benchmark.manifest import Manifest, ManifestError
from benchmark.tests.tiny import tiny_copy

READER = '''
LAYER = "network: a new layer"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(ctx):
    return 1.5 if ctx.get("kind") == "serve" else None
'''

# a family that lacks one export (step_flops)
HALF_FAMILY = '''
from benchmark.families.vanerf import (NETWORK_MODULES, Generator,
                                       frame_flops, render_frame, train)
'''


def add_everything(tmp_path):
    path = tiny_copy(tmp_path)
    bench = tmp_path / "benchmark"
    spec = json.loads(path.read_text())
    cfg = json.loads((bench / "configs" / "vanerf-2view.json").read_text())
    (bench / "configs" / "new-model.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "new-mix.json").write_text(json.dumps(
        {"kind": "serve", "image_size": 64, "level": 2, "pool": 4,
         "warmup": 1, "traced": 1, "checked": 1}))
    (bench / "metrics" / "new_ms.serve.py").write_text(READER)
    (bench / "families" / "half.py").write_text(HALF_FAMILY)
    for name, fam in (("no-family", "no_such_family"), ("half-family", "half"),
                      ("bad-family", "../vanerf")):
        (bench / "configs" / f"{name}.json").write_text(
            json.dumps(dict(cfg, family=fam)))
    spec["configs"].append({"name": "new-model", "source": "a paper",
                            "file": "benchmark/configs/new-model.json",
                            "reduced": [], "why": "a new model"})
    spec["workloads"].append({"name": "new-cell", "config": "new-model",
                              "traffic": "new-mix", "chips": 1,
                              "why": "a new cell"})
    spec["end_to_end"][0]["workloads"].append("new-cell")
    spec["per_layer"].append({"name": "new_ms.serve", "unit": "ms/frame",
                              "better": "lower", "source": "device_trace",
                              "layer": "network: a new layer",
                              "moves": "frames_per_s",
                              "workloads": ["new-cell"]})
    path.write_text(json.dumps(spec))
    return path, spec


def test_new_files_and_entries_are_found(tmp_path):
    path, _ = add_everything(tmp_path)
    mf = Manifest(path, root=tmp_path / "benchmark")
    assert "new-cell" in mf.cells
    assert mf.config("new-cell")["dataset"]["num_input_view"] == 2
    assert mf.traffic("new-cell")["image_size"] == 64
    assert mf.per_layer("new-cell")[-1] == "new_ms.serve"
    assert "new_ms.serve" not in mf.per_layer("serve-1view-g16")
    assert mf.readers["new_ms.serve"].read({"kind": "serve"}) == 1.5
    assert mf.end_to_end("new-cell") == ["frames_per_s", "setup_s"]
    assert mf.family("new-cell").NETWORK_MODULES == mf.family(
        "serve-1view-g16").NETWORK_MODULES


@pytest.mark.parametrize("breakage", [
    ("workloads", -1, "name", "new cell"),          # a space in a name
    ("per_layer", -1, "unit", "ms per frame"),      # a space in a unit
    ("per_layer", -1, "layer", "another layer"),    # not the reader's layer
    ("per_layer", -1, "moves", "train_step_ms"),    # the cell lacks it
    ("per_layer", -1, "moves", "setup_s"),
    ("workloads", -1, "traffic", "no-such-mix"),
    ("workloads", -1, "chips", 2),
    ("end_to_end", 0, "bound", 0.3),
    ("configs", -1, "file", "benchmark/configs/missing.json"),
    ("configs", -1, "file", "benchmark/configs/no-family.json"),
    ("configs", -1, "file", "benchmark/configs/half-family.json"),
    ("configs", -1, "file", "benchmark/configs/bad-family.json"),
])
def test_broken_entries_are_refused(tmp_path, breakage):
    path, spec = add_everything(tmp_path)
    group, i, key, value = breakage
    spec[group][i][key] = value
    path.write_text(json.dumps(spec))
    with pytest.raises((ManifestError, KeyError, StopIteration)):
        Manifest(path, root=tmp_path / "benchmark")


def test_the_repository_manifest_checks():
    from benchmark.manifest import ROOT
    mf = Manifest(ROOT.parent / "BENCHMARK.json")
    assert list(mf.cells) == ["serve-1view-g16", "train-1view",
                              "serve-2view-g16"]
    for cell in mf.cells:
        assert mf.per_layer(cell)
        assert mf.family(cell).__file__.endswith("families/vanerf.py")
