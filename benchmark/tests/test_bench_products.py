"""The product kernel's roofline reader on a synthetic trace:
``counts/products.py``'s bound of a shape against a count by hand (one shape
bound by its bytes, one by its operations), the reader's share from the
program's shape counters over its frame steps, nothing read without those
counters or the kernels."""

import pytest

from benchmark.counts import products
from benchmark.trace import Event, Traced
from benchmark.tests.test_bench_spans import bench, reader
from ptt_tpu_torch.utils import timer

GAMMA = (131072, 128, 128)  # fc_gamma of a ptt_waymo head's layer at B = 8: 256 seeds x 16 neighbours x 4 heads
QKV = (2048, 512, 512)  # w_qs of the same layer: 256 seeds x 8 tracklets


@pytest.fixture(autouse=True)
def fresh_registry():
    timer.reset()
    yield
    timer.reset()


def test_bounds_by_hand():
    # fc_gamma: 4 (M K + K N + M N) = 134,283,264 bytes over 3.35 TB/s, 40.08 us, above
    # 2 M K N = 4,294,967,296 operations over 165 TFLOP/s, 26.03 us: bound by its bytes
    nbytes, ops = products.product_counts(*GAMMA)
    assert (nbytes, ops) == (134_283_264, 4_294_967_296)
    # w_qs: 9,437,184 bytes, 2.82 us, under 1,073,741,824 operations, 6.51 us: bound by its operations
    assert products.product_counts(*QKV) == (9_437_184, 1_073_741_824)
    counters = {"launches.tf32x3.131072x128x128": 12, "launches.tf32x3.2048x512x512": 3, "launches.tf32x3": 15,
                "launches.sa": 7}
    per_step = products.bound_per_step_s(counters, frame_steps=3)
    assert per_step == pytest.approx((4 * 134_283_264 / 3.35e12) + 1_073_741_824 / 165e12, rel=1e-12)
    assert products.shape_of("launches.tf32x3") is None and products.shape_of("launches.tf32x3.1x2") is None
    assert products.bound_per_step_s({"launches.tf32x3": 8}, 3) is None
    assert products.bound_per_step_s(counters, 0) is None


def kernel(name, start, end):
    return Event(name, "kernel", start, end - start)


def product_trace():
    """A 10 ms window with 200 us of split kernels and 800 us of product
    kernels in it, and 500 us of product kernels outside it."""
    window = bench("window", 1000, 11000)
    events = [window, kernel("tf32x3_split_kernel", 1000, 1200), kernel("void tf32x3_gemm_kernel<128>", 1200, 2000),
              kernel("sa_kernel", 2000, 4000), kernel("tf32x3_gemm_kernel", 11500, 12000)]
    return {"traced": Traced(events, window, 0, None), "steps_traced": 10}


def test_product_roofline_reader():
    layer = product_trace()
    read = reader("tf32x3_roofline_pct.track")
    assert read(layer) is None  # no counters: a program without them
    timer.count("launches.tf32x3", 20)
    timer.count("frame_loop.frame_steps", 5)
    assert read(layer) is None  # no shape counters
    timer.count("launches.tf32x3.2048x512x512", 10)  # 2 a frame step
    share = 100.0 * 2 * 1_073_741_824 / 165e12 * 10 / 1000e-6
    assert read(layer) == pytest.approx(share, rel=1e-12)
    assert 0 < share < 100
    window = layer["traced"].window
    assert read({"traced": Traced([window], window, 0, None), "steps_traced": 10}) is None  # the kernels did not run

