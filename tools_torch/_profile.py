"""Reading a ``torch.profiler`` trace of the card: device operations, busy
time, idle share and the time per kernel name (shared by
``profile_train.py`` and ``profile_serve.py``)."""

from __future__ import annotations


def summarize(prof, n_units: int, wall_ms: float, unit: str = "step",
              top: int = 25):
    """(summary dict, per-kernel table) of a profile that ran ``n_units``
    steps or patches in ``wall_ms``.

    Device events and busy time as the port's benchmark entry point reads
    them (``vanerf_tpu_torch.bench.device_activity``)."""
    from vanerf_tpu_torch.bench import device_activity
    kern, busy_us, span_us = device_activity(prof)
    by_name = {}
    for e in kern:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us()
    table = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    per_ms = n_units * 1e3
    summary = {
        f"wall_ms_per_{unit}": wall_ms / n_units,
        f"device_ops_per_{unit}": len(kern) / n_units,
        f"device_busy_ms_per_{unit}": busy_us / per_ms,
        f"device_kernel_sum_ms_per_{unit}":
            sum(v[1] for v in by_name.values()) / per_ms,
        "idle_share_of_span": 1.0 - busy_us / span_us if span_us else None,
        "top": [{"name": n[:120], f"launches_per_{unit}": c / n_units,
                 f"ms_per_{unit}": us / per_ms} for n, (c, us) in table[:top]],
    }
    return summary, table


def write_table(f, table, n_units: int, unit: str) -> None:
    for n, (c, us) in table:
        f.write(f"{us / (n_units * 1e3):10.4f} ms/{unit} {c / n_units:9.1f} "
                f"launches/{unit}  {n}\n")
