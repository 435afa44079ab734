"""Share of the traced sub-window, in percent, in which the device ran
nothing while the host was inside one of the program's spans (the trainer's
loop, the train step's dispatch, a graph's capture), each idle moment put
down to the innermost span; the fetch from the loader (``trainer.fetch``) is
not counted: there the feed waits for the device. At most ``idle_pct.train``."""

from benchmark.spans import host_idle_pct


def read(layer):
    return host_idle_pct(layer, {"trainer.fetch"})
