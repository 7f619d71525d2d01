"""Share of the (tile, face chunk) pairs whose distance kernel A / 7
visited in a traced frame, after its culling: the program's
``a_pairs_visited`` over ``a_pairs`` counters."""

LAYER = "mesh priors: ops/mesh_query.py, ops/knn.py, ops/rasterize.py -> csrc/"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(ctx):
    from benchmark import spans
    return spans.counter_share(ctx, "serve", "a_pairs_visited", "a_pairs")
