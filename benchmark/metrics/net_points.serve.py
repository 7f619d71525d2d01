"""Millions of rows a traced frame handed to the per-point network
(``VANeRF.query``): the program's ``net_points`` counter, every sample of
both passes, or the serving tiers' budgets where they are on."""

LAYER = "frame / patch: renderer.py (encode_frame, prepare_frame_meshes, render_patch)"
UNIT = "Mpt/frame"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(ctx):
    from benchmark import spans
    return spans.counter_per_item(ctx, "serve", "net_points", 1e-6)
