"""What the program's own spans and counters say in a traced run
(``vanerf_tpu_torch/profiling.py``: ``vanerf.frame`` / ``vanerf.step`` and
the spans under them, and the work counters the program counts while a
profiler records).  The readers of the ``program_span`` and
``program_counter`` metrics share the functions here; a program with no
such span or counter (an older tree) reads None.

    python3 -m benchmark.spans --workload <cell> --seed <n> \
        [--seconds <s>] [--out <file.json>]

runs one traced run of the cell (as ``benchmark.run --trace 1`` does) and
prints its span table: device ms an item by the innermost span open at
each operation's launch (and by every span that holds it), each span's
host ms an item (its durations summed), where the
largest operation classes fall by span, the traced busy time inside the
root span, and the host time of each ``vanerf.step`` that its phases do
not cover, with the idle gaps that fall inside it.
"""

from __future__ import annotations

import argparse
import bisect
import json
import pathlib
import sys
import time
from collections import defaultdict

from . import devtrace

PREFIX = "vanerf."
# the ranges the table attributes to: the program's spans and the
# benchmark's own network range (serve.py), which splits vanerf.query.net
# into the fusion nets and MLPs and the rest (the point encoder, gcompress)
TABLE_RANGES = (PREFIX, "bench.")
STEP_PHASES = tuple(f"vanerf.{who}.{what}" for who in ("g", "d")
                    for what in ("render", "loss", "backward", "optimizer"))


def _trace(ctx: dict, kind: str):
    tr = ctx.get("trace")
    return tr if ctx.get("kind") == kind and tr else None


def device_ms(ctx: dict, kind: str, names) -> float | None:
    """Device ms an item of the operations launched inside a span named in
    ``names`` (each operation once), in a ``kind`` cell's traced run."""
    tr = _trace(ctx, kind)
    if tr is None:
        return None
    s = devtrace.device_s_in(tr, lambda n: n in names)
    return 1e3 * s / tr["items"] if s > 0 else None


def host_ms(ctx: dict, kind: str, names) -> float | None:
    """Host ms an item of the spans named in ``names`` (their durations
    summed)."""
    tr = _trace(ctx, kind)
    if tr is None:
        return None
    us = sum(end - ts for name, ts, end, _tid in tr["host"] if name in names)
    return 1e-3 * us / tr["items"] if us > 0 else None


def program_counters() -> dict | None:
    """The program's counters (``profiling.counters()``), or None where the
    program has none."""
    try:
        from vanerf_tpu_torch.profiling import counters
    except ImportError:
        return None
    return counters()


def counter_per_item(ctx: dict, kind: str, name: str, scale: float = 1.0):
    """Counter ``name`` an item of the traced run, times ``scale``."""
    tr = _trace(ctx, kind)
    c = program_counters() if tr is not None else None
    if not c or name not in c:
        return None
    return scale * c[name] / tr["items"]


def counter_share(ctx: dict, kind: str, part: str, whole: str):
    """100 x counter ``part`` / counter ``whole`` of the traced run."""
    c = program_counters() if _trace(ctx, kind) is not None else None
    if not c or part not in c or not c.get(whole):
        return None
    return 100.0 * c[part] / c[whole]


# ---------------------------------------------------------------------------
# the span table of one traced run
# ---------------------------------------------------------------------------

def innermost(trace: dict) -> list:
    """For each device operation of ``trace``, the innermost program span
    (or benchmark range) open on its launch thread at its launch (None:
    none is), by one sweep a thread (the ranges of a thread nest)."""
    by_tid = defaultdict(list)
    for name, ts, end, tid in trace["host"]:
        if name.startswith(TABLE_RANGES):
            by_tid[tid].append((ts, end, name))
    ops_by_tid = defaultdict(list)
    for i, (_n, _s, _e, lts, ltid) in enumerate(trace["ops"]):
        if lts is not None:
            ops_by_tid[ltid].append((lts, i))
    out = [None] * len(trace["ops"])
    for tid, ops in ops_by_tid.items():
        # by start, the outer of two that start together first
        spans = sorted(by_tid.get(tid, ()), key=lambda x: (x[0], -x[1]))
        ops.sort()
        stack, k = [], 0
        for lts, i in ops:
            while k < len(spans) and spans[k][0] <= lts:
                while stack and stack[-1][0] < spans[k][0]:
                    stack.pop()
                stack.append((spans[k][1], spans[k][2]))
                k += 1
            while stack and stack[-1][0] < lts:
                stack.pop()
            out[i] = stack[-1][1] if stack else None
    return out


def op_class(name: str) -> str:
    """A device operation's class: its name without ``void``, namespaces,
    template arguments and parameters (``CatArrayBatchedCopy``,
    ``vectorized_gather_kernel``, a cuBLAS kernel's name)."""
    name = name.replace("(anonymous namespace)::", "")
    for cut in ("<", "("):
        name = name.split(cut)[0]
    return name.replace("void ", "").split("::")[-1].strip()[:80]


def table(trace: dict, top: int = 8) -> dict:
    """The span table of a parsed trace (``devtrace.parse``) with
    ``trace["items"]``."""
    items = trace["items"]
    owner = innermost(trace)
    excl = defaultdict(float)
    by_class = defaultdict(lambda: defaultdict(float))
    class_total = defaultdict(float)
    for (name, s, e, _l, _t), span in zip(trace["ops"], owner):
        excl[span or "(no span)"] += e - s
        cls = op_class(name)
        by_class[cls][span or "(no span)"] += e - s
        class_total[cls] += e - s
    names = sorted({h[0] for h in trace["host"]
                    if h[0].startswith(TABLE_RANGES)})
    incl = {n: 1e3 * devtrace.device_s_in(trace, lambda x, n=n: x == n)
            / items for n in names}
    host = defaultdict(float)
    for name, ts, end, _tid in trace["host"]:
        if name in incl:
            host[name] += 1e-3 * (end - ts) / items
    busy_ms = 1e3 * trace["busy_s"] / items
    roots = [n for n in ("vanerf.frame", "vanerf.step") if n in names]
    out = {
        "items": items, "busy_ms": busy_ms,
        "window_ms": 1e3 * trace["window_s"] / items,
        "exclusive_ms": {k: 1e-3 * v / items for k, v in
                         sorted(excl.items(), key=lambda x: -x[1])},
        "inclusive_ms": incl,
        "host_ms": dict(host),
        "root_share_of_busy": {r: incl[r] / busy_ms for r in roots},
        "classes": {cls: {"total_ms": 1e-3 * class_total[cls] / items,
                          "by_span_ms": {k: 1e-3 * v / items for k, v in
                                         sorted(by_class[cls].items(),
                                                key=lambda x: -x[1])}}
                    for cls in sorted(class_total, key=lambda c:
                                      -class_total[c])[:top]},
    }
    if "vanerf.step" in names:
        out["step"] = step_cover(trace)
    return out


def step_cover(trace: dict) -> dict:
    """Host time of each ``vanerf.step`` that its eight phase spans (on its
    thread, inside it) do not cover, and the labels of the device's idle
    gaps whose middle falls inside a step (``devtrace.breakdown``'s
    rule)."""
    steps = sorted((h for h in trace["host"] if h[0] == "vanerf.step"),
                   key=lambda h: h[1])
    phases = [h for h in trace["host"] if h[0] in STEP_PHASES]
    total = covered = 0.0
    for _n, ts, end, tid in steps:
        total += end - ts
        covered += sum(min(e, end) - max(s, ts) for _p, s, e, t in phases
                       if t == tid and s < end and e > ts)
    spans = sorted((o[1], o[2]) for o in trace["ops"])
    gaps, last = [], None
    for s, e in spans:
        if last is not None and s > last:
            gaps.append((last, s))
        last = e if last is None else max(last, e)
    starts = [ts for _n, ts, _e, _t in steps]
    inside = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        k = bisect.bisect_right(starts, mid) - 1
        if k < 0 or mid > steps[k][2]:
            continue
        open_ = [h for h in trace["host"] if h[1] <= mid <= h[2]]
        label = (min(open_, key=lambda h: h[2] - h[1])[0][:80] if open_
                 else "host outside any operator")
        inside[label] += (g1 - g0) * 1e-3
    return {"step_ms": 1e-3 * total / max(len(steps), 1),
            "uncovered_share": (total - covered) / total if total else None,
            "idle_in_step_ms_by_label": dict(sorted(
                ((k, v / max(len(steps), 1)) for k, v in inside.items()),
                key=lambda x: -x[1]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch

    from .manifest import Manifest
    from .run import ROOT
    manifest = Manifest(ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = (manifest.config(args.workload),
                    manifest.traffic(args.workload))
    if traffic["kind"] == "serve":
        from . import serve as driver
    else:
        from . import train as driver
    res = driver.run(manifest.family(args.workload), cfg, traffic,
                     args.seed, args.seconds, True, "cuda", t_start)
    tr = res["ctx"]["trace"]
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), **table(tr),
           "counters": program_counters(),
           "breakdown": devtrace.breakdown(tr)}
    text = json.dumps(out, indent=1)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
