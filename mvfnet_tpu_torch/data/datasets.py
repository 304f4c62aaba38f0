"""Datasets: annotation parsing + per-sample pipeline execution (counterpart
of ``mvfnet_tpu/data/datasets.py``).

Reference: ``codes/datasets/{base,rawframes_dataset,video_dataset,
pkl_dataset}.py``. No
torch Dataset dependency: these are plain map-style objects consumed by the
threaded loader.

Per-sample determinism: ``__getitem__`` seeds a ``numpy.random.Generator``
from ``(base_seed, epoch, idx)`` and passes it through the pipeline as
``results['rng']``, so augmentation is reproducible and worker-order
independent (the reference relied on global RNG state).
"""

from __future__ import annotations

import copy
import os.path as osp
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils import tracing
from .builder import DATASETS
from .pipeline import Compose


class BaseDataset(ABC):
    def __init__(self, ann_file: str, pipeline, data_root: Optional[str] = None,
                 test_mode: bool = False, modality: Optional[str] = 'RGB',
                 seed: int = 0):
        self.ann_file = ann_file
        self.data_root = data_root
        self.test_mode = test_mode
        self.pipeline = Compose(pipeline)
        self.video_infos = self.load_annotations()
        self.modality = modality
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _make_rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, idx]))

    @abstractmethod
    def load_annotations(self) -> List[Dict[str, Any]]:
        ...

    def prepare_frames(self, idx: int):
        results = copy.deepcopy(self.video_infos[idx])
        results['modality'] = self.modality
        results['test_mode'] = self.test_mode
        results['rng'] = self._make_rng(idx)
        results['vid_idx'] = idx
        return self.pipeline(results)

    def __len__(self) -> int:
        return len(self.video_infos)

    def __getitem__(self, idx: int):
        with tracing.span('data.getitem', req=idx):
            return self.prepare_frames(idx)


def _frame_list(ann_file: str, data_root: Optional[str]
                ) -> List[Dict[str, Any]]:
    """Ann lines ``path total_frames label``; blank lines skipped."""
    video_infos = []
    with open(ann_file) as fin:
        for line in fin:
            if not line.strip():
                continue
            path, total_frames, label = line.split()
            if data_root is not None:
                path = osp.join(data_root, path)
            video_infos.append(dict(filename=path,
                                    total_frames=int(total_frames),
                                    label=int(label)))
    return video_infos


@DATASETS.register_module
class RawFramesDataset(BaseDataset):
    """Ann lines: ``dir total_frames label`` (reference
    ``rawframes_dataset.py:10-69``)."""

    def __init__(self, ann_file, pipeline, data_root=None, test_mode=False,
                 filename_tmpl='img_{:05}.jpg', modality='RGB', seed=0):
        super().__init__(ann_file, pipeline, data_root, test_mode, modality,
                         seed)
        self.filename_tmpl = filename_tmpl

    def load_annotations(self):
        return _frame_list(self.ann_file, self.data_root)

    def prepare_frames(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['test_mode'] = self.test_mode
        results['rng'] = self._make_rng(idx)
        results['vid_idx'] = idx
        return self.pipeline(results)


@DATASETS.register_module
class VideoDataset(BaseDataset):
    """Ann lines: ``file.mp4 label``, or ``file.mp4`` alone (label 0: a
    feature-extraction list). The frame count comes from the container
    (``SampleFrames`` probes it). When the pipeline gives ``None`` (an
    unreadable container or a failed decode) another index is drawn with
    ``rng.integers(0, len)`` from the same generator, up to ``num_retries``
    tries in all, then ``RuntimeError`` (reference
    ``video_dataset.py:57-76``): the JAX package's draws, one for one."""

    def __init__(self, ann_file, pipeline, data_root=None, test_mode=False,
                 num_retries=10, modality='RGB', seed=0):
        super().__init__(ann_file, pipeline, data_root, test_mode, modality,
                         seed)
        self._num_retries = num_retries

    def load_annotations(self):
        video_infos = []
        with open(self.ann_file) as fin:
            for line in fin:
                split = line.split()
                if not split:
                    continue
                filename, label = (split[0], split[1]) if len(split) > 1 \
                    else (split[0], 0)
                if self.data_root is not None:
                    filename = osp.join(self.data_root, filename)
                video_infos.append(dict(filename=filename, label=int(label)))
        return video_infos

    def prepare_frames(self, idx):
        rng = self._make_rng(idx)
        for _ in range(self._num_retries):
            results = copy.deepcopy(self.video_infos[idx])
            results['modality'] = self.modality
            results['test_mode'] = self.test_mode
            results['rng'] = rng
            results['vid_idx'] = idx
            data = self.pipeline(results)
            if data is not None:
                return data
            idx = int(rng.integers(0, len(self.video_infos)))
        raise RuntimeError(
            f'Failed to fetch video after {self._num_retries} retries.')


@DATASETS.register_module
class PklDataset(BaseDataset):
    """Ann lines: ``file.pkl total_frames label``: frames pre-packed as
    pickled JPEG-bytes lists (reference ``pkl_dataset.py:9-42``)."""

    def load_annotations(self):
        return _frame_list(self.ann_file, self.data_root)
