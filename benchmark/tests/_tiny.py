"""Tiny traffic for the CPU tests: the cells' own configurations at their
published widths, few and short tracklets, small train batches."""

TRACK = dict(tracklets_per_batch=2, frames=4, pool_batches=2, warmup_batches=1, check_pairs=4, check_block=2)
TRAIN = dict(batch_size=4, pool_batches=4, train_tracklets=4, train_frames=6, warmup_steps=1)


def tiny(spec):
    spec.traffic.update(TRACK if spec.traffic["kind"] == "track" else TRAIN)
    return spec
