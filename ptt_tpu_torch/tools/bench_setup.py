"""The workloads the port's tools share (the JAX ``bench.py``
``build_bench_setup`` and the trained-asset setup of its ``tools/``).

``build_bench_setup`` is the benchmark workload: a configuration, 8
synthetic tracklets of 64 frames (600 object and 400 clutter points a frame),
its tracker from a seeded init on the device, and ``max_points``.
``agreement_setup`` is the trained asset (``tests/assets/ptt_synth_trained.npz``)
on ``ptt.yaml`` with the 8 x 24-frame agreement tracklets (seed 11), which
``fused_ab`` and ``parity_decomposition`` run.
"""

from __future__ import annotations

from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parents[2]
ASSET = REPO_ROOT / "tests" / "assets" / "ptt_synth_trained.npz"
BENCH_CFG = "tools/cfgs/kitti_models/ptt.yaml"


def bench_tracklets(data_cfg: dict, n_tracklets: int = 8, n_frames: int = 64):
    """The benchmark's synthetic eval tracklets on the configuration's
    ``DATA_CONFIG``: ``n_tracklets`` of ``n_frames`` frames, 600 object and
    400 clutter points a frame. Builds no model."""
    from ..data.synthetic import make_tracklets

    return make_tracklets(dict(data_cfg, NUM_TRACKLETS=n_tracklets, FRAMES_PER_TRACKLET=n_frames,
                               POINTS_PER_FRAME=600, CLUTTER_POINTS=400))


def build_bench_setup(n_tracklets: int = 8, n_frames: int = 64, max_points: int = 2048,
                      cfg_file: str = BENCH_CFG, device="cuda", seed: int = 0,
                      set_cfgs=None):
    """The benchmark workload -> (cfg, model, tracklets, max_points): the
    configuration of ``cfg_file`` (with the ``--set`` overrides ``set_cfgs``),
    the synthetic eval tracklets, and the tracker built after
    ``torch.manual_seed(seed)`` on ``device``, in eval mode; the caller's
    random state is kept."""
    from .. import resolve_device
    from ..config import cli_config
    from ..nn import build_network

    cfg = cli_config(cfg_file, set_cfgs)
    tracklets = bench_tracklets(cfg["DATA_CONFIG"], n_tracklets, n_frames)
    with torch.random.fork_rng(devices=[]):  # the caller's generator state is left as it was
        torch.manual_seed(seed)
        model = build_network(cfg["MODEL"], device=resolve_device(device))
    return cfg, model, tracklets, max_points


def agreement_setup(device="cuda", n_tracklets: int = 8, n_frames: int = 24):
    """The trained asset on ``ptt.yaml`` and the agreement tracklets ->
    (cfg, model, tracklets, metadata); the metadata holds the asset's
    recorded host Success/Precision (``host_success``, ``host_precision``)."""
    from .. import resolve_device
    from ..config import ptt_config
    from ..convert import npz_metadata, state_dict_from_npz
    from ..data.synthetic import make_tracklets
    from ..nn import build_network

    cfg = ptt_config()
    model = build_network(cfg["MODEL"], device=resolve_device(device))
    model.load_state_dict(state_dict_from_npz(ASSET), strict=True)
    tracklets = make_tracklets({"NUM_TRACKLETS": n_tracklets, "FRAMES_PER_TRACKLET": n_frames, "SYNTH_SEED": 11})
    return cfg, model, tracklets, npz_metadata(ASSET)
