"""Datasets and input pipelines (the port's copy of `ipercore_tpu/data`)."""

from ipercore_tpu_torch.data.datasets import (  # noqa: F401
    DATASET_REGISTRY,
    BackgroundDataset,
    PersonalizedDataset,
    ProcessedVideoDataset,
    VideoBackgroundDataset,
    build_dataset,
    resize_linear,
)
