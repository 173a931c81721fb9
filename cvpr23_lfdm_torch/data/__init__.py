"""Data pipeline: specs, datasets, sampling, augmentation, loading
(counterpart of `cvpr23_lfdm_tpu/data`)."""

from cvpr23_lfdm_torch.data.augment import ClipAugment
from cvpr23_lfdm_torch.data.datasets import (
    DatasetRepeater,
    DMVideoDataset,
    LFAEPairDataset,
    PairedDataset,
)
from cvpr23_lfdm_torch.data.loader import PrefetchLoader, collate
from cvpr23_lfdm_torch.data.specs import SPECS, DatasetSpec, get_spec

__all__ = [
    "ClipAugment",
    "DatasetRepeater",
    "DMVideoDataset",
    "LFAEPairDataset",
    "PairedDataset",
    "PrefetchLoader",
    "collate",
    "SPECS",
    "DatasetSpec",
    "get_spec",
]
