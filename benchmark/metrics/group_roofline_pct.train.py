"""The group kernels' share of their roofline: the least time of a train
step's grouped first layers, forward and backward (``counts/group.py`` against
``counts/peaks.py``, from the reference's SA calls on the first checked
batch), times the steps in the traced sub-window, over the device time of
``group_fwd_kernel`` and the backward's ``group_csr_kernel``,
``group_sum_kernel`` and ``group_combine_kernel`` there."""

from benchmark.counts.peaks import bound_s
from benchmark.trace import kernel_us

KERNELS = ("group_fwd_kernel", "group_csr_kernel", "group_sum_kernel", "group_combine_kernel")


def read(layer):
    t, steps, counts = layer.get("traced"), layer.get("steps_traced"), layer.get("group_counts")
    if t is None or not steps or not counts:
        return None
    device_s = kernel_us(t.events, t.window, KERNELS) / 1e6
    if device_s <= 0:
        return None
    bound = sum(bound_s(b, o) for b, o in counts["fwd"] + counts["bwd"])
    return 100.0 * bound * steps / device_s
