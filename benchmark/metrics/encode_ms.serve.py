"""Device milliseconds a traced frame of the operations launched inside
the program's ``vanerf.encode`` span: the encoders and the vertex
visibility (kernel C) of ``renderer.encode_frame``."""

LAYER = "frame / patch: renderer.py (encode_frame, prepare_frame_meshes, render_patch)"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    from benchmark import spans
    return spans.device_ms(ctx, "serve", ("vanerf.encode",))
