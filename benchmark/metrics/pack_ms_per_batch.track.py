"""Host milliseconds a tracker batch spends packing it (the program's span
``evaluator.pack``: padding, quantizing and pinning the batch's clouds), the
mean over the traced sub-window's batches."""

from benchmark.spans import mean_ms


def read(layer):
    return mean_ms(layer, "evaluator.pack")
