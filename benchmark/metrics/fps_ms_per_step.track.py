"""Device milliseconds of ``fps_kernel`` a frame step in the traced
sub-window (FPS keeps a time: its latency bound rests on assumed cycle
counts)."""

from benchmark.trace import kernel_us


def read(layer):
    t, steps = layer.get("traced"), layer.get("steps_traced")
    if t is None or not steps:
        return None
    us = kernel_us(t.events, t.window, ("fps_kernel",))
    return us / 1e3 / steps if us > 0 else None
