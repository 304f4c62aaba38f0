"""The host data pipeline (counterpart of ``mvfnet_tpu/data``): datasets,
pipeline ops, the sharded sampler and the threaded loader. Numpy and cv2,
and nvJPEG for JPEG frames on a CUDA device (``native_io.py``); the device
copy lives in ``engine/prefetch.py``."""

from .builder import DATASETS, PIPELINES, RepeatDataset, build_dataset
from .pipeline import (Compose, dataset_decoder, decode_counts,
                       device_norm_cfg)
from . import sampling, transforms, loading, datasets  # noqa: F401 (registry)
from .loader import DataLoader, build_dataloader, default_collate
from .sampler import ShardedSampler

__all__ = ['DATASETS', 'PIPELINES', 'build_dataset', 'RepeatDataset',
           'Compose', 'dataset_decoder', 'decode_counts', 'device_norm_cfg',
           'DataLoader',
           'build_dataloader', 'default_collate', 'ShardedSampler']
