"""Device milliseconds a traced frame of the operations launched inside
the program's ``vanerf.query.sample`` span: the points' projection into
the source views, the masks and pixel weights, and the feature maps'
bilinear samples (kernel D, ``feat_sample_nhwc``)."""

LAYER = "query: models/vanerf.py VANeRF.query (projection, sampling, KNN gathers)"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    from benchmark import spans
    return spans.device_ms(ctx, "serve", ("vanerf.query.sample",))
