"""Device milliseconds a traced step of the operations launched inside
the program's ``vanerf.g.render`` and ``vanerf.d.render`` spans: the
forward renders of the generator's patch and of the discriminator's (the
backward's launches, on the autograd thread, are ``backward_ms.train``'s)."""

LAYER = "train step: training/train_step.py"
UNIT = "ms/step"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_step_ms"


def read(ctx):
    from benchmark import spans
    return spans.device_ms(ctx, "train", ("vanerf.g.render",
                                          "vanerf.d.render"))
