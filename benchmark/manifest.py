"""``BENCHMARK.json`` and the files it names, found by name and checked.

A cell names a configuration (``benchmark/configs/<name>.json``) and a
traffic mix (``benchmark/traffic/<name>.json``); a configuration names its
model family (``benchmark/families/<name>.py``: its reference, weight
skeleton, FLOP counts and network modules); a per-layer metric is a
reader ``benchmark/metrics/<name>.py`` that declares its layer, unit,
``better``, ``source`` and the end-to-end metric it ``moves``.  A cell may
have limits for its output check (``benchmark/limits/<cell>.json``).  A
later change adds a cell, a configuration, a family, a mix or a metric by
adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

from .families import DEFAULT, load_family

ROOT = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


class ManifestError(ValueError):
    pass


def _need(cond, msg):
    if not cond:
        raise ManifestError(msg)


def _line(s, what):
    _need(isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s
          and "\t" not in s, f"{what}: 1 to 200 characters on one line")


def load_metric(name: str, root: pathlib.Path = ROOT):
    """The reader module of per-layer metric ``name``."""
    path = root / "metrics" / f"{name}.py"
    _need(path.is_file(), f"metric {name}: no reader {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """A checked ``BENCHMARK.json``."""

    def __init__(self, path: pathlib.Path, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.spec = json.loads(pathlib.Path(path).read_text())
        self.check()

    def check(self):
        s = self.spec
        _need(set(s) == KEYS, f"keys {sorted(s)} are not {sorted(KEYS)}")
        _need(isinstance(s["run_seconds"], int)
              and 1 <= s["run_seconds"] <= 51, "run_seconds: 1 to 51")
        names = set()
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            for e in s[group]:
                _need(NAME.match(e["name"]) is not None,
                      f"{group}: bad name {e['name']!r}")
                key = group if group in ("configs", "workloads") else "m"
                _need((key, e["name"]) not in names,
                      f"{group}: {e['name']} twice")
                names.add((key, e["name"]))
        self.configs = {c["name"]: c for c in s["configs"]}
        self.families = {}
        for c in s["configs"]:
            _need(set(c) == {"name", "source", "file", "reduced", "why"},
                  f"config {c['name']}: keys")
            _line(c["source"], f"config {c['name']} source")
            _line(c["why"], f"config {c['name']} why")
            _need((self.root.parent / c["file"]).is_file(),
                  f"config {c['name']}: no file {c['file']}")
            fam = json.loads((self.root.parent / c["file"]).read_text()).get(
                "family", DEFAULT)
            _need(isinstance(fam, str) and NAME.match(fam) is not None,
                  f"config {c['name']}: bad family {fam!r}")
            self.families[c["name"]] = load_family(fam, self.root)
            for k in c["reduced"]:
                _need(NAME.match(k) is not None, f"reduced key {k!r}")
        e2e = {m["name"]: m for m in s["end_to_end"]}
        _need("setup_s" in e2e, "setup_s is missing")
        for m in s["end_to_end"]:
            _need(set(m) <= {"name", "unit", "better", "bound", "source",
                             "workloads"}, f"metric {m['name']}: keys")
            _need(m["source"] in ("host_clock", "device_trace"),
                  f"{m['name']}: end-to-end source")
            _need(0.01 <= m["bound"] <= 0.25, f"{m['name']}: bound")
            self._metric_common(m)
        self.cells = {w["name"]: w for w in s["workloads"]}
        for w in s["workloads"]:
            _need(set(w) == {"name", "config", "traffic", "chips", "why"},
                  f"cell {w['name']}: keys")
            _need(w["config"] in self.configs,
                  f"cell {w['name']}: unknown config")
            _need(NAME.match(w["traffic"]) is not None, "traffic name")
            _need((self.root / "traffic" / f"{w['traffic']}.json").is_file(),
                  f"cell {w['name']}: no traffic file {w['traffic']}")
            _need(w["chips"] in (1, 4), f"cell {w['name']}: chips")
            _line(w["why"], f"cell {w['name']} why")
        pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
        _need(len(set(pairs)) == len(pairs), "a config/traffic pair twice")
        used = {w["config"] for w in s["workloads"]}
        _need(used == set(self.configs), "a configuration no cell uses")
        self.readers = {}
        for m in s["per_layer"]:
            _need(set(m) <= {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}, f"{m['name']}: keys")
            self._metric_common(m)
            _line(m["layer"], f"{m['name']} layer")
            _need(m["moves"] in e2e and m["moves"] != "setup_s",
                  f"{m['name']}: moves {m['moves']!r}")
            mod = load_metric(m["name"], self.root)
            for attr in ("LAYER", "UNIT", "MOVES", "SOURCE", "BETTER"):
                _need(getattr(mod, attr) == m[attr.lower()],
                      f"{m['name']}: {attr.lower()} differs from its reader")
            self.readers[m["name"]] = mod
        for w in s["workloads"]:
            rep = self.end_to_end(w["name"])
            _need(len(rep) >= 2 and "setup_s" in rep,
                  f"cell {w['name']}: needs setup_s and another metric")
            _need(self.per_layer(w["name"]),
                  f"cell {w['name']}: no per-layer metric")
            for m in self.per_layer(w["name"]):
                mv = next(x for x in s["per_layer"] if x["name"] == m)
                _need(mv["moves"] in rep,
                      f"{m} moves {mv['moves']}, which {w['name']} lacks")

    def _metric_common(self, m):
        _need(UNIT.match(m["unit"]) is not None, f"{m['name']}: unit")
        _need(m["better"] in ("lower", "higher"), f"{m['name']}: better")
        _need(m["source"] in SOURCES, f"{m['name']}: source")
        for w in m.get("workloads", []):
            _need(w in {c["name"] for c in self.spec["workloads"]},
                  f"{m['name']}: unknown cell {w}")

    def end_to_end(self, cell: str) -> list:
        return [m["name"] for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        rep = set(self.end_to_end(cell))
        return [m["name"] for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell]) and m["moves"] in rep]

    def metric(self, name: str) -> dict:
        return next(m for m in self.spec["end_to_end"] + self.spec["per_layer"]
                    if m["name"] == name)

    def config(self, cell: str) -> dict:
        return json.loads((self.root.parent / self.configs[
            self.cells[cell]["config"]]["file"]).read_text())

    def family(self, cell: str):
        """The family module of ``cell``'s configuration."""
        return self.families[self.cells[cell]["config"]]

    def traffic(self, cell: str) -> dict:
        return json.loads((self.root / "traffic" / (
            self.cells[cell]["traffic"] + ".json")).read_text())

    def limits(self, cell: str) -> dict:
        path = self.root / "limits" / f"{cell}.json"
        return json.loads(path.read_text()) if path.is_file() else {}
