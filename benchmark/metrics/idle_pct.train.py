"""Share of the traced sub-window (whole train steps) in which no
kernel, copy or set ran on the device, in percent."""

from benchmark.trace import device_busy_us


def read(layer):
    t = layer.get("traced")
    if t is None:
        return None
    return 100.0 * (1.0 - device_busy_us(t.events, t.window.start_us, t.window.end_us) / t.window.dur_us)
