"""Share of a traced frame's samples that the far tier of kernel A
skips (their tile's every bound beyond ``far_tau``): the program's
``far_samples`` over ``samples`` counters."""

LAYER = "mesh priors: ops/mesh_query.py, ops/knn.py, ops/rasterize.py -> csrc/"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(ctx):
    from benchmark import spans
    return spans.counter_share(ctx, "serve", "far_samples", "samples")
