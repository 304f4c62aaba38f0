"""Dataset/pipeline registries (counterpart of ``mvfnet_tpu/data/builder.py``;
reference ``codes/datasets/builder.py:4-51``)."""

from __future__ import annotations

from typing import Any, Dict

from ..registry import Registry, build_from_cfg

DATASETS = Registry('dataset')
PIPELINES = Registry('pipeline')


class RepeatDataset:
    """Virtually lengthen a dataset by ``times`` (epoch-lengthening for small
    datasets; reference ``builder.py:31-51``)."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times
        self._ori_len = len(dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]

    def __len__(self):
        return self.times * self._ori_len

    def set_epoch(self, epoch: int) -> None:
        # forward per-epoch augmentation reseeding to the wrapped dataset
        # (DataLoader.set_epoch only forwards if the attr exists)
        if hasattr(self.dataset, 'set_epoch'):
            self.dataset.set_epoch(epoch)


def build_dataset(cfg: Dict[str, Any]):
    if cfg.get('type') == 'RepeatDataset':
        return RepeatDataset(build_dataset(cfg['dataset']), cfg['times'])
    return build_from_cfg(cfg, DATASETS)
