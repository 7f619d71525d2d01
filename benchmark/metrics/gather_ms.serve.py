"""Device milliseconds a traced frame of the operations launched inside
the program's ``vanerf.query.gather`` spans: the vertices' projection, the
vertex tables and the nearest-vertex row gathers (``knn_gather_1`` /
``knn_gather_raw``, kernel 10) with the far tier's substitution."""

LAYER = "query: models/vanerf.py VANeRF.query (projection, sampling, KNN gathers)"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    from benchmark import spans
    return spans.device_ms(ctx, "serve", ("vanerf.query.gather",))
