"""What the traced part of a run reads from ``torch.profiler``: the device
operations, the device's busy time, the device time of the kernels
launched inside named host ranges, and the breakdown the result line
carries.

The trace is exported as Chrome trace JSON and read from there: a device
operation (categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``; not the
``gpu_user_annotation`` mirrors of host ranges, which span gaps between
kernels) links to the host call that launched it by its ``correlation``
id, and a launch lies in a host range where it starts inside the range on
the range's thread.  Busy time is the union of the device operations'
intervals (the program's ``bench.py::device_activity``, copied here).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Ranges:
    """Host ranges named by the benchmark around the forward of chosen
    modules (forward pre- and post-hooks), for the traced part only."""

    def __init__(self):
        self.handles = []
        self.stack = []

    def attach(self, module: torch.nn.Module, name: str) -> None:
        def pre(_m, _a):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self.stack.append(rf)

        def post(_m, _a, _o):
            self.stack.pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def detach(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


@contextlib.contextmanager
def traced():
    """``torch.profiler`` over the block; yields a dict that holds the
    parsed trace (:func:`parse`) once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    res = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield res
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            res.update(parse(json.load(f)))
    finally:
        os.unlink(path)


def _union(spans):
    busy, cur = 0.0, None
    for s, e in sorted(spans):
        if cur is None or s > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return busy + (0.0 if cur is None else cur[1] - cur[0])


def parse(trace: dict) -> dict:
    """The parts of a Chrome trace the readers use (times in seconds).

    Returns ops: [(name, start_us, end_us, launch_ts_us, launch_tid)],
    busy_s, span_s (first operation's start to the last one's end), and
    host: [(name, ts_us, end_us, tid)] of the host ranges and operators."""
    ev = [e for e in trace.get("traceEvents", trace) if e.get("ph") == "X"]
    launch = {}
    for e in ev:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = (e["ts"], e["tid"])
    ops, host = [], []
    for e in ev:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            c = e.get("args", {}).get("correlation")
            lts, ltid = launch.get(c, (None, None))
            ops.append((e["name"], e["ts"], e["ts"] + e.get("dur", 0), lts,
                        ltid))
        elif cat in ("cpu_op", "user_annotation"):
            host.append((e["name"], e["ts"], e["ts"] + e.get("dur", 0),
                         e["tid"]))
    spans = [(o[1], o[2]) for o in ops]
    span = (max(s[1] for s in spans) - min(s[0] for s in spans)) if spans \
        else 0.0
    return {"ops": ops, "host": host, "busy_s": _union(spans) * 1e-6,
            "span_s": span * 1e-6}


def device_s_in(trace: dict, match) -> float:
    """Device seconds of the operations launched inside a host range whose
    name ``match(name)`` accepts (each operation counted once)."""
    by_tid = defaultdict(list)
    for name, ts, end, tid in trace["host"]:
        if match(name):
            by_tid[tid].append((ts, end))
    merged = {}
    for tid, iv in by_tid.items():
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        merged[tid] = ([a for a, _ in out], [b for _, b in out])
    total = 0.0
    for name, s, e, lts, ltid in trace["ops"]:
        if lts is None or ltid not in merged:
            continue
        starts, ends = merged[ltid]
        k = bisect.bisect_right(starts, lts) - 1
        if k >= 0 and lts <= ends[k]:
            total += e - s
    return total * 1e-6


def device_s_named(trace: dict, names) -> float:
    """Device seconds of the kernels whose name holds one of ``names``."""
    return sum(e - s for n, s, e, _, _ in trace["ops"]
               if any(k in n for k in names)) * 1e-6


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps of the device labelled by the innermost host range or
    operator open at the gap's middle."""
    by = defaultdict(float)
    for n, s, e, _, _ in trace["ops"]:
        by[n[:120]] += (e - s) * 1e-6
    ops = sorted(by.items(), key=lambda x: -x[1])[:top]
    spans = sorted((o[1], o[2]) for o in trace["ops"])
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        open_ = [h for h in trace["host"] if h[1] <= mid <= h[2]]
        label = (min(open_, key=lambda h: h[2] - h[1])[0][:120] if open_
                 else "host outside any operator")
        out.append([label, (g1 - g0) * 1e-6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": out}
