"""Device milliseconds a traced frame of the kernels launched inside the
forward of the per-point networks (``GeoVisFusion``, ``MLPUNetFusion``,
``TexVisFusion``, ``IBRRenderingHead``), which the benchmark wraps in
profiler ranges by forward hooks (``benchmark/serve.py``)."""

LAYER = "network: models/ (GeoVisFusion, MLPUNetFusion, TexVisFusion, IBRRenderingHead)"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frames_per_s"
RANGE = "bench.network"


def read(ctx):
    from benchmark import devtrace
    tr = ctx.get("trace")
    if ctx.get("kind") != "serve" or not tr:
        return None
    s = devtrace.device_s_in(tr, lambda n: n == RANGE)
    return 1e3 * s / tr["items"] if s > 0 else None
