"""Tracklet datasets (KITTI, synthetic), host-side item construction (crop,
resample, augment in numpy) and the prefetching loader."""

from .dataset import TrackingDataset
from .kitti import KittiTrackingDataset
from .loader import DataLoader, build_dataloader
from .synthetic import SyntheticTrackingDataset


class NuscenesTrackingDataset:
    """Not ported yet (ROADMAP.md Queue 1 item 6)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("NuscenesTrackingDataset is not ported yet (ROADMAP.md Queue 1 item 6)")


ALL_DATASETS = {
    "KittiTrackingDataset": KittiTrackingDataset,
    "NuscenesTrackingDataset": NuscenesTrackingDataset,
    "SyntheticTrackingDataset": SyntheticTrackingDataset,
}

__all__ = ["ALL_DATASETS", "DataLoader", "KittiTrackingDataset", "NuscenesTrackingDataset",
           "SyntheticTrackingDataset", "TrackingDataset", "build_dataloader"]
