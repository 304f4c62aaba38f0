"""Batched, multi-threaded, prefetching data loader (counterpart of
``mvfnet_tpu/data/loader.py``).

Replaces the reference's torch DataLoader + DistributedSampler stack
(``codes/datasets/loader/build_loader.py:16-52``). Decode and
augmentation run on a thread pool (cv2/numpy release the GIL), batches are
assembled as dicts of numpy arrays, and a separate device-prefetch stage
(``engine/prefetch.py``) stages them in pinned memory and copies them to
the GPU ahead of the step.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..utils import tracing
from .sampler import ShardedSampler


def default_collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack 'img_group' and 'label'; meta becomes a list."""
    batch: Dict[str, Any] = {}
    first = samples[0]
    for key in first:
        if key == 'img_meta':
            batch[key] = [s.get(key) for s in samples]
        elif isinstance(first[key], np.ndarray) or np.isscalar(first[key]):
            batch[key] = np.stack([np.asarray(s[key]) for s in samples])
        else:
            batch[key] = [s[key] for s in samples]
    return batch


class DataLoader:
    """Map-style loader: sampler indices -> threaded pipeline -> batches.

    Matches the reference loader contract: ``shuffle`` via an epoch-seeded
    sharded sampler, ``drop_last`` for train (fixed shapes for jit), ordered
    results (determinism).
    """

    def __init__(self,
                 dataset,
                 batch_size: int,
                 sampler: Optional[ShardedSampler] = None,
                 num_workers: int = 4,
                 drop_last: bool = False,
                 collate_fn: Callable = default_collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(len(dataset), shuffle=False)
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, 'set_epoch'):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = list(self.sampler)
        if self.drop_last:
            usable = (len(indices) // self.batch_size) * self.batch_size
            indices = indices[:usable]
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # Submit a sliding window of fetches; yield in order.
            window = self.num_workers * 2 + self.batch_size
            futures: List[cf.Future] = []
            it = iter(indices)
            submitted = 0

            def submit_next():
                nonlocal submitted
                try:
                    idx = next(it)
                except StopIteration:
                    return False
                futures.append(pool.submit(self.dataset.__getitem__, idx))
                submitted += 1
                return True

            for _ in range(window):
                if not submit_next():
                    break
            pos = 0
            batch: List[Dict[str, Any]] = []
            while pos < len(futures):
                with tracing.span('loader.wait', req=indices[pos]):
                    sample = futures[pos].result()
                futures[pos] = None  # release memory
                pos += 1
                submit_next()
                if sample is None:
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self._collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self._collate(batch)

    def _collate(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        with tracing.span('loader.collate'):
            return self.collate_fn(batch)


def _raise_nofile_limit(min_limit: int = 4096) -> None:
    """Raise RLIMIT_NOFILE like the reference loader (``build_loader.py``):
    frame datasets hold many JPEGs open across workers."""
    try:
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < min_limit:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (min(min_limit, hard), hard))
    except (ImportError, ValueError, OSError):
        pass


def _dist_world_rank():
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            'build_dataloader(dist=True) needs world_size and rank, or an '
            'initialized torch.distributed process group')
    return dist.get_world_size(), dist.get_rank()


def build_dataloader(dataset,
                     videos_per_gpu: int,
                     workers_per_gpu: int,
                     dist: bool = False,
                     num_gpus: int = 1,
                     shuffle: bool = True,
                     seed: int = 0,
                     drop_last: Optional[bool] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> DataLoader:
    """Reference-compatible facade (``build_loader.py:16-52``).

    dist=True shards by process: world size and rank come from the
    arguments or from an initialized ``torch.distributed``, and it raises
    without either. dist=False batches ``num_gpus * videos_per_gpu`` like
    the reference's non-dist path.
    """
    _raise_nofile_limit()
    if dist:
        if world_size is None or rank is None:
            world_size, rank = _dist_world_rank()
        sampler = ShardedSampler(len(dataset), world_size, rank,
                                 shuffle=shuffle, seed=seed)
    else:
        sampler = ShardedSampler(len(dataset), 1, 0, shuffle=shuffle,
                                 seed=seed)
    # videos_per_gpu is per GPU; a process that drives num_gpus GPUs
    # batches them together
    batch_size = num_gpus * videos_per_gpu
    if drop_last is None:
        drop_last = shuffle  # train loaders need static shapes for jit
    return DataLoader(dataset, batch_size, sampler,
                      num_workers=workers_per_gpu, drop_last=drop_last)
