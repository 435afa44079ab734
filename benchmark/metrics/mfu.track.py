"""The frame step's share of the float32 peak: the reference forward's FLOPs
at the batch's shapes (``counts/flops.py``) times the frame steps in the
traced sub-window, over its seconds, against ``counts/peaks.py``."""

from benchmark.counts.peaks import PEAK_F32_FLOPS


def read(layer):
    t = layer.get("traced")
    if t is None or not layer.get("steps_traced"):
        return None
    return 100.0 * layer["flops_per_step"] * layer["steps_traced"] / (t.window.dur_us / 1e6) / PEAK_F32_FLOPS
