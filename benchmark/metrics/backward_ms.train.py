"""Device milliseconds a traced step of the operations the autograd engine
launches (the backward of the query, kernel 13, cuDNN's backward),
inside its ``autograd::engine::evaluate_function`` ranges."""

LAYER = "backward: autograd of the query, kernel 13, cuDNN backward"
UNIT = "ms/step"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_step_ms"
PREFIX = "autograd::engine::evaluate_function"


def read(ctx):
    from benchmark import devtrace
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or not tr:
        return None
    s = devtrace.device_s_in(tr, lambda n: n.startswith(PREFIX))
    return 1e3 * s / tr["items"] if s > 0 else None
