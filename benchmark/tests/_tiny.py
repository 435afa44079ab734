"""Tiny traffic for the CPU tests: the cells' own configurations at their
published widths, few and short tracklets, small train batches; one entry a
traffic kind."""

TRACK = dict(tracklets_per_batch=2, frames=4, pool_batches=2, warmup_batches=1, check_pairs=4, check_block=2)
TRAIN = dict(batch_size=4, pool_batches=4, train_tracklets=4, train_frames=6, warmup_steps=1)
TINY = {"track": TRACK, "train": TRAIN}


def tiny(spec):
    kind = spec.traffic["kind"]
    if kind not in TINY:
        raise KeyError(f"no tiny traffic for kind {kind!r}; benchmark/tests/_tiny.py has {', '.join(TINY)}")
    spec.traffic.update(TINY[kind])
    return spec
