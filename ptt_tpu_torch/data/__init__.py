"""Tracklet datasets (KITTI, nuScenes, synthetic), host-side item construction
(crop, resample, augment in numpy) and the prefetching loader."""

from .dataset import TrackingDataset
from .kitti import KittiTrackingDataset
from .loader import DataLoader, build_dataloader
from .nuscenes import NuscenesTrackingDataset
from .synthetic import SyntheticTrackingDataset


ALL_DATASETS = {
    "KittiTrackingDataset": KittiTrackingDataset,
    "NuscenesTrackingDataset": NuscenesTrackingDataset,
    "SyntheticTrackingDataset": SyntheticTrackingDataset,
}

__all__ = ["ALL_DATASETS", "DataLoader", "KittiTrackingDataset", "NuscenesTrackingDataset",
           "SyntheticTrackingDataset", "TrackingDataset", "build_dataloader"]
