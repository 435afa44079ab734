"""The product kernel's share of its roofline: the least time of a frame
step's products that the program sent to ``csrc/tf32x3.cu`` (its shape
counters ``launches.tf32x3.<M>x<K>x<N>`` over its ``frame_loop.frame_steps``,
each shape priced by ``counts/products.py`` against ``counts/peaks.py``),
times the frame steps in the traced sub-window, over the device time of
``tf32x3_split_kernel`` and ``tf32x3_gemm_kernel`` there. The program says
which shapes ran; the benchmark says what each costs. None where the program
has no such counters (one from before them) or the kernels did not run."""

from benchmark.counts.products import PREFIX, bound_per_step_s
from benchmark.trace import kernel_us

KERNELS = ("tf32x3_split_kernel", "tf32x3_gemm_kernel")


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
