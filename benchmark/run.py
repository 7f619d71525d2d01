"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Reads ``BENCHMARK.json`` at the root of the checkout, builds the cell's
configuration, traffic, weights and inputs from ``--seed`` on the card,
warms up, measures for ``--seconds``, checks the outputs against the
plain reference of the configuration's family and prints one JSON line
last: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``).  Without
a CUDA card, or with fewer than the cell asks for, it exits with code 2
and prints no result.  The program's kernels build into
``build/vanerf_tpu_torch/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vanerf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the part before the first dot, compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> tuple:
    """The card's name (as torch reports it) and its power limit."""
    import torch
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except OSError:
        limit = ""
    return name, limit.splitlines()[0] if limit else None


def check_lines(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, reading, limit)]): every number that has a limit at
    or under it; a limit without a number fails, and so do no limits."""
    rows = [(k, readings.get(k), limits[k]) for k in sorted(limits)]
    ok = bool(rows) and all(r is not None and lim is not None and r <= lim
                            for _, r, lim in rows)
    return ok, rows


def execute(manifest, cell: str, seed: int, seconds: float, trace: bool,
            device, t_start: float, alter=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result object."""
    import torch
    cfg, traffic = manifest.config(cell), manifest.traffic(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if traffic["kind"] == "serve":
        from . import serve as driver
    else:
        from . import train as driver
    res = driver.run(manifest.family(cell), cfg, traffic, seed, seconds,
                     trace, device, t_start, alter=alter)
    cuda = torch.device(device).type == "cuda"
    dev_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    correct, rows = check_lines(res["readings"], manifest.limits(cell))
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"]}
    metrics = {}
    if not trace:
        for name in manifest.end_to_end(cell):
            value = res["setup_s"] if name == "setup_s" else res["e2e"][name]
            metrics[name] = {"value": value,
                             "unit": manifest.metric(name)["unit"]}
    else:
        ctx = dict(res["ctx"], device_name=dev_name)
        for name in manifest.per_layer(cell):
            value = manifest.readers[name].read(ctx)
            if value is not None:
                metrics[name] = {"value": value,
                                 "unit": manifest.metric(name)["unit"]}
    out["metrics"] = metrics
    out["device"] = {"platform": "gpu" if cuda else "cpu", "kind": dev_name,
                     "count": 1, "memory_peak_bytes": res["peak"]}
    if trace and res["ctx"]["trace"] is not None:
        from .devtrace import breakdown
        tr = res["ctx"]["trace"]
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = breakdown(tr)
    out["checked"] = {k: {"value": r, "limit": lim} for k, r, lim in rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program and of its libraries inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark.manifest import Manifest
    manifest = Manifest(ROOT / "BENCHMARK.json")
    if args.workload not in manifest.cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    chips = manifest.cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    name, limit = card()
    res = execute(manifest, args.workload, args.seed, args.seconds,
                  bool(args.trace), "cuda", T_START)
    res["device"]["kind"] = name
    res["device"]["power_limit"] = limit
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    res["checked"] = res.pop("checked")       # the compared numbers, last
    for k, row in res["checked"].items():
        print(f"{k} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
