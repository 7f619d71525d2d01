"""Profiling & debugging helpers, port of ``vanerf_tpu/profiling.py`` (the
reference has none — SURVEY.md §5).

- `trace(dir)`: context manager around `torch.profiler`, writing a Chrome
  trace (the CUDA activity included where a card is present).
- `timed`: wall-clock timing ending in `torch.cuda.synchronize()` where the
  JAX package blocks on the result.
- `nan_guard`: non-finite detection for loss dicts (replacement for torch
  detect_anomaly, reference ``train.py:12,61``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile the block; write ``<log_dir>/<name>`` as a Chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 5, **kw):
    """Run fn with warmup, return (mean_seconds, last_result)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    _sync()
    return (time.perf_counter() - t0) / iters, out


def nan_guard(logs: dict, step: int | None = None):
    """Raise on non-finite scalars (train-anomaly tripwire)."""
    bad = {k: float(v) for k, v in logs.items()
           if not np.isfinite(float(v))}
    if bad:
        raise FloatingPointError(
            f"non-finite metrics at step {step}: {bad}")
