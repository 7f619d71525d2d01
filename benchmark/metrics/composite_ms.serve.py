"""Device milliseconds a traced frame of the operations launched inside
the program's ``vanerf.composite`` spans (``rgba2out``, the importance
samples, the sort and merge of both passes) and ``vanerf.assemble`` spans
(the context patches, the tiles' split and the inverse pixel shuffle)."""

LAYER = "frame / patch: renderer.py (encode_frame, prepare_frame_meshes, render_patch)"
UNIT = "ms/frame"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    from benchmark import spans
    return spans.device_ms(ctx, "serve", ("vanerf.composite",
                                          "vanerf.assemble"))
