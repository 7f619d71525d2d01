"""A copy of the benchmark with CPU-sized cells, for the tests: the same
code, a 32^2 frame at level 2 with 16 + 16 samples and a two-level
hourglass, an 8 x 8 training patch."""

from __future__ import annotations

import json
import pathlib
import shutil

ROOT = pathlib.Path(__file__).resolve().parents[1]


def tiny_copy(dst: pathlib.Path) -> pathlib.Path:
    """Copy the benchmark under ``dst`` and add a tiny serving cell and a
    tiny training cell to its ``BENCHMARK.json``.  Returns the manifest's
    path."""
    bench = dst / "benchmark"
    shutil.copytree(ROOT, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "configs" / "vanerf-1view.json").read_text())
    m = cfg["models"]["VANeRF"]
    m["geo_args"]["n_downsample"] = 2
    m["dr_kwargs"].update(sample_per_ray_c=16, sample_per_ray_f=16)
    m["train_out_h"] = m["train_out_w"] = 8
    cfg["training"]["eval_tile_group"] = 4
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny-frames.json").write_text(json.dumps(
        {"kind": "serve", "image_size": 32, "level": 2, "pool": 2,
         "warmup": 1, "traced": 1, "checked": 1}))
    (bench / "traffic" / "tiny-steps.json").write_text(json.dumps(
        {"kind": "train", "image_size": 32, "pool": 4, "traced": 1}))
    for cell, of in (("tiny-serve", "serve-1view-g16"),
                     ("tiny-train", "train-1view")):
        shutil.copy(ROOT / "limits" / f"{of}.json",
                    bench / "limits" / f"{cell}.json")
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": ["models"], "why": "CPU tests"})
    spec["workloads"] += [
        {"name": "tiny-serve", "config": "tiny", "traffic": "tiny-frames",
         "chips": 1, "why": "CPU tests"},
        {"name": "tiny-train", "config": "tiny", "traffic": "tiny-steps",
         "chips": 1, "why": "CPU tests"}]
    for metric in spec["end_to_end"]:
        if metric["name"] == "frames_per_s":
            metric["workloads"].append("tiny-serve")
        if metric["name"] == "train_step_ms":
            metric["workloads"].append("tiny-train")
    path = dst / "BENCHMARK.json"
    path.write_text(json.dumps(spec, indent=1))
    return path
