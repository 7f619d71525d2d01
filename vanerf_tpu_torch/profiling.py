"""Profiling & debugging helpers, port of ``vanerf_tpu/profiling.py`` (the
reference has none — SURVEY.md §5).

- `trace(dir)`: context manager around `torch.profiler`, writing a Chrome
  trace (the CUDA activity included where a card is present) and the work
  counters of the block beside it.
- `span(name)` / `spanned(name)`: a named range of the program
  (``vanerf.frame``, ``vanerf.step`` and their phases; the decorator wraps
  a function's calls), live only while a profiler records:
  it lands in the same trace, on the same clock, as the kernels launched
  inside it, and its parent is the span that encloses it on its thread.
- `count` / `count_device` / `counters`: work counters of the program
  (samples, network rows, far samples, kernel A's visited chunk pairs),
  counted only while a profiler records; `counters()` also reads the
  kernels' launch counters (``ops.launch_counts``).
- `nan_guard`: non-finite detection for loss dicts (replacement for torch
  detect_anomaly, reference ``train.py:12,61``).

With no profiler recording, a span or a count is one read of
``torch.autograd.profiler._is_profiler_enabled``: no allocation and no
device operation.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
from collections import defaultdict

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` session records on this process."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: the function's calls run inside :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


# host counts (Python ints) and device counts (one 0-d accumulator a name
# and device, added to without a host sync)
_HOST = defaultdict(int)
_DEVICE = {}


def count(name: str, n: int) -> None:
    """Add ``n`` to host counter ``name`` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        _HOST[name] += int(n)


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the 0-d tensor ``t`` to counter ``name`` on ``t``'s device while
    a profiler records (one device addition, no host sync)."""
    if _autograd_profiler._is_profiler_enabled:
        key = (name, t.device)
        acc = _DEVICE.get(key)
        t = t.detach().to(torch.int64)
        _DEVICE[key] = t if acc is None else acc + t


def counters() -> dict:
    """Every counter as a plain dict of ints: the program's work counters
    (host and device, one sync a device) and the kernels' launch counters
    (``ops.launch_counts``)."""
    from . import ops
    out = dict(ops.launch_counts())
    out.update(_HOST)
    by_dev = defaultdict(list)
    for (name, dev), t in _DEVICE.items():
        by_dev[dev].append((name, t))
    for items in by_dev.values():
        values = torch.stack([t for _, t in items]).tolist()
        for (name, _), v in zip(items, values):
            out[name] = out.get(name, 0) + int(v)
    return out


def reset_counters() -> None:
    """Zero the program's work counters and the kernels' launch
    counters."""
    from . import ops
    _HOST.clear()
    _DEVICE.clear()
    ops.reset_launches()


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile the block; write ``<log_dir>/<name>`` as a Chrome trace and
    the block's counters (:func:`counters`) as
    ``<log_dir>/<stem of name>.counters.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    reset_counters()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, name))
    stem = os.path.splitext(name)[0]
    with open(os.path.join(log_dir, f"{stem}.counters.json"), "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)


def nan_guard(logs: dict, step: int | None = None):
    """Raise on non-finite scalars (train-anomaly tripwire)."""
    bad = {k: float(v) for k, v in logs.items()
           if not np.isfinite(float(v))}
    if bad:
        raise FloatingPointError(
            f"non-finite metrics at step {step}: {bad}")
