"""The host data pipeline (counterpart of ``mvfnet_tpu/data``): datasets,
pipeline ops, the sharded sampler and the threaded loader. Framework-free
numpy and cv2; the device copy lives in ``engine/prefetch.py``."""

from .builder import DATASETS, PIPELINES, RepeatDataset, build_dataset
from .pipeline import Compose, dataset_decoder, device_norm_cfg
from . import sampling, transforms, loading, datasets  # noqa: F401 (registry)
from .loader import DataLoader, build_dataloader, default_collate
from .sampler import ShardedSampler

__all__ = ['DATASETS', 'PIPELINES', 'build_dataset', 'RepeatDataset',
           'Compose', 'dataset_decoder', 'device_norm_cfg', 'DataLoader',
           'build_dataloader', 'default_collate', 'ShardedSampler']
