"""Host milliseconds a traced step of the program's
``vanerf.g.optimizer`` and ``vanerf.d.optimizer`` spans: both Adam updates
and their schedules."""

LAYER = "train step: training/train_step.py"
UNIT = "ms/step"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_step_ms"


def read(ctx):
    from benchmark import spans
    return spans.host_ms(ctx, "train", ("vanerf.g.optimizer",
                                        "vanerf.d.optimizer"))
