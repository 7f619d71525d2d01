"""Reading a ``torch.profiler`` trace of the card: device operations, busy
time, idle share and the time per kernel name (shared by
``profile_train.py`` and ``profile_serve.py``)."""

from __future__ import annotations


def summarize(prof, n_units: int, wall_ms: float, unit: str = "step",
              top: int = 25):
    """(summary dict, per-kernel table) of a profile that ran ``n_units``
    steps or patches in ``wall_ms``.

    Device events are the kernels, copies and fills, less the GPU mirrors
    of host annotations (such as ``Optimizer.step``), which span gaps
    between kernels; busy time is the union of their intervals."""
    from torch.autograd import DeviceType
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in host_names]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    span_us = (spans[-1][1] - spans[0][0]) if spans else 0.0
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
