"""The SA kernels' share of their roofline: the least time of every SA call
of a frame step (``counts/sa.py`` bytes and operations against
``counts/peaks.py``), averaged over the check's sampled frame steps, times the
frame steps in the traced sub-window, over the device time of ``sa_pre_kernel``
and ``sa_kernel`` there."""

from benchmark.counts.peaks import bound_s
from benchmark.trace import kernel_us


def read(layer):
    t, steps = layer.get("traced"), layer.get("steps_traced")
    per_step = layer.get("sa_counts_per_step")
    if t is None or not steps or not per_step:
        return None
    device_s = kernel_us(t.events, t.window, ("sa_pre_kernel", "sa_kernel")) / 1e6
    if device_s <= 0:
        return None
    bound = sum(sum(bound_s(b, o) for b, o in calls) for calls in per_step) / len(per_step)
    return 100.0 * bound * steps / device_s
