"""Host milliseconds a tracker batch: the benchmark's spans around
``dispatch_batch`` (pack, upload, enqueue) and ``finish_batch`` (scoring),
the wait for the device timed apart (``boxes`` first) and left out; the mean
over the window's batches."""


def read(layer):
    ms = layer.get("host_ms")
    return sum(ms) / len(ms) if ms else None
