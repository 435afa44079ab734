"""The port's loader on worker processes (``ptt_tpu_torch/data/loader.py``) and
the Trainer's upload (``train/train_step.py`` ``BatchUploader``), on the CPU.

The batches of the process loader equal, bit for bit, those of the thread
loader it replaced, whose index-and-collate logic is kept here
(``thread_loader_batches``): train items stacked by hand and test tracklets,
over two epochs, one and two shards, in the main process and on two workers.
An item that raises, raises in the consumer, as does a worker that dies; an
epoch left early returns at once, the next one is whole, and ``close`` leaves
no child process; ``chip_smoke.py`` ends every process it started before it
exits, the fork server and a loader left open included. Each loader here
starts at most two workers."""

import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ptt_tpu_torch.data.loader import DataLoader, default_collate, identity_collate
from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset
from ptt_tpu_torch.train import train_step
from ptt_tpu_torch.train.train_step import BatchUploader
from tests._torch_port_loader_items import Raising
from tests.test_torch_port_train import small_data_cfg

torch.set_num_threads(1)

CHILDREN_GONE_S = 10.0  # close() joins each worker with a 5 s limit, then terminates it
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def thread_loader_batches(dataset, batch_size, shuffle, drop_last, seed, epoch, num_shards, shard_id, collate):
    """The thread loader's batches (the loader before its processes): the
    (seed, epoch) permutation, ``drop_last``, the shard rule
    ``batch_idx[shard_id::num_shards]``, then each item built in turn."""
    n = len(dataset)
    order = (np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(n) if shuffle
             else np.arange(n))
    stop = (n // batch_size) * batch_size if drop_last else n
    out = []
    for start in range(0, stop, batch_size):
        idx = order[start:start + batch_size][shard_id::num_shards]
        if len(idx):
            out.append(collate([dataset[int(i)] for i in idx]))
    return out


def assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if isinstance(b, dict):  # train: (B, ...) arrays
            assert a.keys() == b.keys()
            for key in b:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            continue
        assert len(a) == len(b)  # test: whole tracklets, (clouds, boxes, annos) each
        for (pcs, boxes, annos), (rpcs, rboxes, rannos) in zip(a, b):
            assert len(pcs) == len(rpcs) and annos == rannos
            for pc, rpc in zip(pcs, rpcs):
                assert pc.dtype == rpc.dtype
                np.testing.assert_array_equal(pc, rpc)
            for box, rbox in zip(boxes, rboxes):
                np.testing.assert_array_equal(box.center, rbox.center)
                np.testing.assert_array_equal(box.wlh, rbox.wlh)
                np.testing.assert_array_equal(box.orientation.elements, rbox.orientation.elements)


def wait_children_gone(limit=CHILDREN_GONE_S):
    t0 = time.monotonic()
    while multiprocessing.active_children() and time.monotonic() - t0 < limit:
        time.sleep(0.05)
    return multiprocessing.active_children()


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("split", ["train", "test"])
def test_process_batches_equal_thread_loader(split, shards, workers):
    training = split == "train"
    dataset = SyntheticTrackingDataset(small_data_cfg(), training=training, seed=3)
    batch_size, collate = (8, default_collate) if training else (2, identity_collate)
    loaders = [DataLoader(dataset, batch_size, shuffle=training, drop_last=training, seed=3, num_workers=workers,
                          collate_fn=collate, num_shards=shards, shard_id=r) for r in range(shards)]
    try:
        for epoch in (0, 1):
            for r, loader in enumerate(loaders):
                loader.set_epoch(epoch)
                ref = thread_loader_batches(dataset, batch_size, training, training, 3, epoch, shards, r, collate)
                assert len(ref) == (8 if training else 2)
                assert_batches_equal(list(loader), ref)
    finally:
        for loader in loaders:
            loader.close()
    assert not wait_children_gone()


@pytest.mark.parametrize("workers", [0, 2])
def test_item_error_raises_in_consumer(workers):
    loader = DataLoader(Raising(), 4, num_workers=workers)
    try:
        with pytest.raises(ValueError, match="item 5 is broken"):
            list(loader)
    finally:
        loader.close()
    assert not wait_children_gone()


def test_dead_worker_raises_in_consumer():
    loader = DataLoader(Raising(die=True), 4, num_workers=2)
    try:
        with pytest.raises(RuntimeError, match="exited unexpectedly"):
            list(loader)
    finally:
        loader.close()
    assert not wait_children_gone()


def test_early_break_neither_hangs_nor_leaves_processes():
    """Out of an epoch after one batch: the loop ends at once; the next epoch
    is whole and right; ``close`` leaves no child process behind, and a
    loader dropped without ``close`` stops its workers too."""
    dataset = SyntheticTrackingDataset(small_data_cfg(), seed=3)
    loader = DataLoader(dataset, 8, shuffle=True, drop_last=True, seed=3, num_workers=2)
    try:
        for batch in loader:
            t0 = time.monotonic()
            break
        assert time.monotonic() - t0 < 1.0 and batch["search_points"].shape[0] == 8
        assert len(multiprocessing.active_children()) == 2  # the workers wait for the next epoch
        loader.set_epoch(1)
        assert_batches_equal(list(loader), thread_loader_batches(dataset, 8, True, True, 3, 1, 1, 0,
                                                                 default_collate))
        t0 = time.monotonic()
        loader.close()
        assert time.monotonic() - t0 < CHILDREN_GONE_S
    finally:
        loader.close()
    assert not wait_children_gone()

    dropped = DataLoader(dataset, 8, shuffle=True, drop_last=True, num_workers=2)
    next(iter(dropped))
    assert len(multiprocessing.active_children()) == 2
    del dropped
    assert not wait_children_gone()


def test_batches_are_pinned_only_where_cuda_is(monkeypatch):
    """Without CUDA the upload gives plain CPU tensors equal to the batch and
    never makes a pinned copy (on the card, ``chip_smoke.py`` phase 7 reads
    the copies as pinned from the profiler's trace)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py phase 7 checks the pinned upload")
    dataset = SyntheticTrackingDataset(small_data_cfg(), seed=3)
    batch = default_collate([dataset[i] for i in range(4)])

    def no_pinning(batch):
        raise AssertionError("pinned a batch without CUDA")

    monkeypatch.setattr(train_step, "pin_batch", no_pinning)
    uploader = BatchUploader("cpu")
    assert uploader.stream is None
    got = uploader.take(uploader.put(batch))
    assert uploader.put(None) is None and got.keys() == batch.keys()
    for key, value in got.items():
        assert value.device.type == "cpu" and not value.is_pinned()
        np.testing.assert_array_equal(value.numpy(), batch[key])


# A run of chip_smoke.py in miniature: a loader left open (two workers, the
# fork server, the resource tracker), an orphan of a subprocess, then the end
# of the run, by its last line or by a failed phase.
SMOKE_CHILD = """
import subprocess, sys
import chip_smoke
from ptt_tpu_torch.data.loader import DataLoader
from tests._torch_port_loader_items import Range
chip_smoke.adopt_orphans()
loader = DataLoader(Range(64), 4, shuffle=True, drop_last=True, num_workers=2)
next(iter(loader))
subprocess.run(["sh", "-c", "sleep 600 >/dev/null 2>&1 &"])
print("running", len(chip_smoke.descendants()), flush=True)
if sys.argv[1] == "end":
    chip_smoke.stop_children()
else:
    chip_smoke.fail("a phase failed")
"""


def session_processes(sid):
    """(pid, name) of the live processes of session ``sid``."""
    found = []
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[3]) == sid and fields[0] != "Z":
            found.append((int(entry), stat[stat.index("(") + 1:stat.rindex(")")]))
    return found


@pytest.mark.parametrize("exit_path", ["end", "fail"])
def test_chip_smoke_leaves_no_process_at_exit(tmp_path, exit_path):
    """The moment chip_smoke.py's process has exited, by its end or by a
    failed phase, no process it started runs: not the loader's workers, the
    fork server or the resource tracker, nor a subprocess's orphan."""
    log = tmp_path / "log"
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-c", SMOKE_CHILD, exit_path], cwd=REPO, stdout=out,
                                stderr=subprocess.STDOUT, start_new_session=True)
        rc = proc.wait(timeout=120)
    left = session_processes(proc.pid)
    for pid, _ in left:
        os.kill(pid, 9)
    text = log.read_text()
    assert rc == (0 if exit_path == "end" else 1), text
    assert not left, text
    running = int(text.split("running ", 1)[1].split()[0])
    assert running >= 5, text  # fork server, tracker, two workers, the orphan
    assert "fork server stopped: True; resource tracker stopped: True" in text and "left: none" in text, text
    assert "sleep[" in text.split("other processes ended: ", 1)[1], text
