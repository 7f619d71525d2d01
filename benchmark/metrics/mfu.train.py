"""The model's FLOPs of the steps completed in the untraced window
(``benchmark/flops.py``), over the window's seconds times the card's
published peak in the configuration's compute type."""

LAYER = "train step: training/train_step.py"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_step_ms"
KIND = "train"


def read(ctx):
    from benchmark import flops
    if ctx.get("kind") != KIND or ctx["window_s"] <= 0:
        return None
    try:
        peak = flops.peak_flops(ctx["device_name"], ctx["compute_dtype"])
    except KeyError:
        return None
    return 100.0 * ctx["items_done"] * ctx["flops_per_item"] \
        / (ctx["window_s"] * peak)
