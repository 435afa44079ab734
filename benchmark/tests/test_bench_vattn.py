"""The vector-attention kernels' roofline reader on a synthetic trace:
``counts/vattn.py``'s bytes of a call against a count by hand, the reader's
share from the program's shape counters over its frame steps, nothing read
without those counters or the kernels."""

import pytest

from benchmark.counts import vattn
from benchmark.tests.test_bench_spans import bench, reader
from benchmark.trace import Event, Traced
from ptt_tpu_torch.utils import timer

CENTROID = (2048, 16, 512)  # a ptt_waymo centroid-head layer at B = 8: 256 seeds x 8 tracklets
BOX = (1024, 16, 512)


@pytest.fixture(autouse=True)
def fresh_registry():
    timer.reset()
    yield
    timer.reset()


def test_bytes_by_hand():
    # in: pos and A 2 x 2048 x 16 x 512 floats, q and kproj 2 x 2048 x 512, idx 2048 x 16 ints;
    # out: logits and pos 2 x 2048 x 16 x 512, vproj and res 2 x 2048 x 512, idx again
    floats = 2 * 16_777_216 + 2 * 1_048_576 + 32_768 + 2 * 16_777_216 + 2 * 1_048_576 + 32_768
    assert vattn.call_bytes(*CENTROID) == 4 * floats == 285_474_816
    assert vattn.call_bytes(*BOX) == 285_474_816 // 2
    counters = {"launches.vattn.2048x16x512": 6, "launches.vattn.1024x16x512": 6, "launches.vattn": 12,
                "launches.tf32x3.131072x128x128": 12}
    per_step = vattn.bound_per_step_s(counters, frame_steps=3)
    assert per_step == pytest.approx(2 * (285_474_816 + 142_737_408) / 3.35e12, rel=1e-12)
    assert vattn.shape_of("launches.vattn") is None and vattn.shape_of("launches.vattn.1x2") is None
    assert vattn.shape_of("launches.tf32x3.1x2x3") is None
    assert vattn.bound_per_step_s({"launches.vattn": 8}, 3) is None
    assert vattn.bound_per_step_s(counters, 0) is None


def kernel(name, start, end):
    return Event(name, "kernel", start, end - start)


def vattn_trace():
    """A 10 ms window with 400 us of vattn_in and 600 us of vattn_out kernels
    in it, and 400 us of them outside it."""
    window = bench("window", 1000, 11000)
    events = [window, kernel("vattn_in_kernel", 1000, 1400),
              kernel("vattn_out_kernel(float4 const*, float4 const*)", 1400, 2000),
              kernel("tf32x3_gemm_kernel", 2000, 4000), kernel("vattn_out_kernel", 11500, 11900)]
    return {"traced": Traced(events, window, 0, None), "steps_traced": 10}


def test_vattn_roofline_reader():
    layer = vattn_trace()
    read = reader("vattn_roofline_pct.track")
    assert read(layer) is None  # no counters: a program without the kernels, as the parent
    timer.count("launches.vattn", 20)
    timer.count("frame_loop.frame_steps", 10)
    assert read(layer) is None  # no shape counters
    timer.count("launches.vattn.1024x16x512", 20)  # 2 a frame step
    share = 100.0 * 2 * 142_737_408 / 3.35e12 * 10 / 1000e-6
    assert read(layer) == pytest.approx(share, rel=1e-12)
    assert 0 < share < 100
    window = layer["traced"].window
    assert read({"traced": Traced([window], window, 0, None), "steps_traced": 10}) is None  # the kernels did not run
    assert read({"traced": None, "steps_traced": 10}) is None
