"""The vector-attention kernels' share of their roofline: the least time of a
frame step's calls that the program sent to ``csrc/vattn.cu`` (its shape
counters ``launches.vattn.<Q>x<k>x<d>`` over its ``frame_loop.frame_steps``,
each shape's bytes priced by ``counts/vattn.py`` against ``counts/peaks.py``),
times the frame steps in the traced sub-window, over the device time of
``vattn_in_kernel`` and ``vattn_out_kernel`` there. None where the program has
no such counters (one from before the kernels) or the kernels did not run."""

from benchmark.counts.vattn import PREFIX, bound_per_step_s
from benchmark.trace import kernel_us

KERNELS = ("vattn_in_kernel", "vattn_out_kernel")


def read(layer):
    from ptt_tpu_torch.utils import timer

    t, steps = layer.get("traced"), layer.get("steps_traced")
    if t is None or not steps:
        return None
    bound = bound_per_step_s(timer.counters(PREFIX), timer.counter("frame_loop.frame_steps"))
    device_s = kernel_us(t.events, t.window, KERNELS) / 1e6
    if bound is None or device_s <= 0:
        return None
    return 100.0 * bound * steps / device_s
