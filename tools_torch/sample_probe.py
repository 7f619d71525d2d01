#!/usr/bin/env python3
"""The query's ``feat_sample_nhwc`` calls of one served frame, timed one by
one on the card.

    python3 tools_torch/sample_probe.py [--cells serve-1view-g16 ...]
        [--seed 1] [--out out/sample_probe.json]

For each serving cell of ``BENCHMARK.json`` it builds the program as
``benchmark/serve.py`` does (the cell's configuration, the seed's weights
and first request), renders one frame to warm up, then renders one more
with ``VANeRF.query``'s ``feat_sample_nhwc`` wrapped so that each call's
map and points are kept.  Each kept call is then run alone: kernel 14
(``bilinear_cuda``) and the plain version (``feat_sample_nhwc_plain``,
the gather and lerp), their outputs compared to the bit, each timed with
CUDA events over ``--reps`` calls; with two source views the plain
version also on each view's element-views alone.  Beside each call: the
bytes a single pass would move (points read, rows written) and how
scattered its reads are (the share of neighbouring points whose texels
lie more than one row apart).  With ``--frames 1`` (the default) also
whole frames with every sample on the kernel and on the plain version, in
turns: host ms, one profiled frame's device ms by kernel, and whether the
two frames are equal to the bit.  Prints one JSON object; ``--out`` also
writes it.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ms(fn, reps: int) -> float:
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _scatter(feat, uv) -> float:
    """The share of neighbouring points (within an element) whose top-left
    texels lie more than one map row apart."""
    import torch
    H, W = feat.shape[1:3]
    x = ((uv[..., 0] + 1.0) * 0.5 * (W - 1.0)).clamp(0.0, W - 1.0).floor()
    y = ((uv[..., 1] + 1.0) * 0.5 * (H - 1.0)).clamp(0.0, H - 1.0).floor()
    t = y * W + x
    return float(((t[:, 1:] - t[:, :-1]).abs() > W).float().mean())


def probe(cell: str, seed: int, reps: int, n_frames: bool) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    from benchmark import serve
    from benchmark.manifest import Manifest
    from vanerf_tpu_torch.models import vanerf as tv
    from vanerf_tpu_torch.ops import grid_sample as gs
    manifest = Manifest(ROOT / "BENCHMARK.json")
    cfg, traffic = manifest.config(cell), manifest.traffic(cell)
    sh = serve.shape(cfg, traffic)
    H = W = traffic["image_size"]
    state = serve.seeded_weights(cfg, (H, W), seed, "cuda")
    req = serve.host_pool(seed, dict(traffic, pool=1), sh["n_views"],
                          "cuda")[0]
    model = serve.program(cfg, state, (H, W), "cuda")
    batch = serve.to_device(req, "cuda")
    serve.render(model, batch, sh)
    kept = []
    real = tv.feat_sample_nhwc

    def keep(feat, uv):
        kept.append((feat, uv))
        return real(feat, uv)
    tv.feat_sample_nhwc = keep
    try:
        serve.render(model, batch, sh)
    finally:
        tv.feat_sample_nhwc = real
    torch.cuda.synchronize()
    V = sh["n_views"]
    calls = []
    for i, (feat, uv) in enumerate(kept):
        feat, uv = feat.contiguous(), uv.contiguous()
        got = gs.bilinear_cuda(feat, uv)
        want = gs.feat_sample_nhwc_plain(feat, uv)
        B, N = uv.shape[:2]
        row = {"call": i, "map": list(feat.shape), "points": [B, N],
               "dtype": str(feat.dtype).replace("torch.", ""),
               "equal": bool(torch.equal(got, want)),
               "kernel_ms": _ms(lambda: gs.bilinear_cuda(feat, uv), reps),
               "plain_ms": _ms(lambda: gs.feat_sample_nhwc_plain(feat, uv),
                               max(2, reps // 4)),
               "bytes": uv.numel() * uv.element_size()
               + got.numel() * got.element_size(),
               "scatter": _scatter(feat, uv)}
        row["bound_ms"] = row["bytes"] / 3.35e12 * 1e3
        if V > 1:
            # element b V + v of the batch is view v (the query repeats each
            # frame's elements per view); its map is feat[v]
            row["views"] = []
            for v in range(V):
                f_v = feat[v::V].contiguous()
                u_v = uv[v::V].contiguous()
                row["views"].append({
                    "view": v,
                    "plain_ms": _ms(
                        lambda: gs.feat_sample_nhwc_plain(f_v, u_v),
                        max(2, reps // 4)),
                    "kernel_ms": _ms(lambda: gs.bilinear_cuda(f_v, u_v),
                                     reps),
                    "scatter": _scatter(f_v, u_v)})
        calls.append(row)
    per_frame = {k: sum(c[k] for c in calls)
                 for k in ("kernel_ms", "plain_ms", "bound_ms", "bytes")}
    del kept
    frames = whole_frames(model, batch, sh) if n_frames else None
    return {"cell": cell, "seed": seed, "views": V,
            "tile_group": sh["tile_group"], "calls": calls,
            "per_frame": per_frame, "frames": frames}


def whole_frames(model, batch, sh, rounds: int = 3) -> dict:
    """The frame with every sample on kernel 14 and with every sample on
    the plain version (``bilinear_viable`` answering no), in turns: host ms
    of each, one profiled frame of each (its device ms and the kernels
    that take most of it), and whether the two frames are equal to the
    bit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import serve
    from vanerf_tpu_torch.ops import grid_sample as gs
    real = gs.bilinear_viable

    def frame(plain: bool):
        gs.bilinear_viable = (lambda *a: False) if plain else real
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = serve.render(model, batch, sh)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3
        finally:
            gs.bilinear_viable = real
    res = {"kernel_ms": [], "plain_ms": []}
    outs = {}
    for _ in range(rounds):
        for plain in (False, True, True, False):
            out, ms = frame(plain)
            res["plain_ms" if plain else "kernel_ms"].append(ms)
            outs[plain] = out
    res["equal"] = all(torch.equal(v, outs[True][k])
                       for k, v in outs[False].items()
                       if torch.is_tensor(v))
    for plain in (False, True):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            frame(plain)
        by = {}
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                by[e.key] = by.get(e.key, 0.0) + e.self_device_time_total
        top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
        res["plain_top" if plain else "kernel_top"] = [
            (k[:90], round(v / 1e3, 3)) for k, v in top]
        res["plain_busy_ms" if plain else "kernel_busy_ms"] = \
            sum(by.values()) / 1e3
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+",
                    default=["serve-1view-g16", "serve-2view-g16"])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--frames", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"gpu": smi, "cells": []}
    for cell in args.cells:
        out["cells"].append(probe(cell, args.seed, args.reps,
                                  bool(args.frames)))
        torch.cuda.empty_cache()
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        pathlib.Path(args.out).write_text(text)
    print(text)
    ok = all(c["equal"] for r in out["cells"] for c in r["calls"])
    ok &= all(r["frames"] is None or r["frames"]["equal"]
              for r in out["cells"])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
