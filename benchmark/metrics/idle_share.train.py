"""Share of the traced steps' wall time in which the card ran no
operation (1 - busy / window), from the profiler's trace."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_step_ms"
KIND = "train"


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != KIND or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
