"""Host milliseconds a train step: the traced sub-window's ``trainer.upload``
spans (stacking, pinning and enqueueing the copy of a step's batch) and the
self time of its ``train_step.dispatch`` spans (BatchNorm factors, the
optimizer's rows, the copies into the graph's inputs), over the steps they
dispatched. Left out: the graph's launch (``train_step.replay``, the
dispatch's child), which waits while the device's queue is full, and the
fetch from the loader (``trainer.fetch``), which holds the feed's own wait
for the device."""

from benchmark.spans import window_spans


def read(layer):
    spans = window_spans(layer) or ()
    steps = sum(s.n for s in spans if s.name == "train_step.dispatch")
    if not steps:
        return None
    upload = sum(s.dur_us for s in spans if s.name == "trainer.upload")
    return (upload + sum(s.self_us for s in spans if s.name == "train_step.dispatch")) / 1e3 / steps
