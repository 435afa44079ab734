"""Share of the traced sub-window, in percent, in which the device ran
nothing while the host was inside one of the program's spans (its evaluator
and frame loop), each idle moment put down to the innermost span; the wait
for a batch's boxes (``evaluator.wait``) is not counted: there the host waits
for the device. At most ``idle_pct.track``."""

from benchmark.spans import host_idle_pct


def read(layer):
    return host_idle_pct(layer, {"evaluator.wait"})
