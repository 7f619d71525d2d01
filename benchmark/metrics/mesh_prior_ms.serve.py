"""Device milliseconds a traced frame of the mesh-prior kernels, by name:
the culled point-to-mesh query (A / 7), the nearest-vertex searches
(B / 8, the culled 9 and its chunk boxes), the z-buffer (C) and the sweep
over every face."""

LAYER = "mesh priors: ops/mesh_query.py, ops/knn.py, ops/rasterize.py -> csrc/"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "frames_per_s"
KERNELS = ("mesh_query_culled_kernel", "mesh_query_kernel", "knn_kernel",
           "knn_culled_kernel", "knn_chunk_boxes_kernel", "raster_kernel")


def read(ctx):
    from benchmark import devtrace
    tr = ctx.get("trace")
    if ctx.get("kind") != "serve" or not tr:
        return None
    s = devtrace.device_s_named(tr, KERNELS)
    return 1e3 * s / tr["items"] if s > 0 else None
