"""Host milliseconds a tracker batch spends being scored (the program's span
``evaluator.score``: Success and Precision of its boxes, once they are back),
the mean over the traced sub-window's batches."""

from benchmark.spans import mean_ms


def read(layer):
    return mean_ms(layer, "evaluator.score")
