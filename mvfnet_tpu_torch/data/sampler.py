"""Index sampling for sharded epochs (counterpart of
``mvfnet_tpu/data/sampler.py``).

Reimplements the reference DistributedSampler semantics
(``codes/datasets/loader/sampler.py:54-78``): epoch-seeded
shuffle, pad to a size divisible by world_size, then a rank-strided slice —
so every host sees a disjoint, equally-sized shard and the union covers the
padded dataset.

'rank'/'world_size' are those of the processes that share the epoch, one
per GPU.
"""

from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np


class GroupSampler:
    """Flag-grouped batching (reference ``sampler.py:14-51``): samples
    sharing a group flag are shuffled and batched together so every batch is
    flag-homogeneous (e.g. aspect-ratio groups). Unused by the shipped MVF
    configs but part of the loader surface."""

    def __init__(self, flags, samples_per_batch: int, seed: int = 0):
        self.flags = np.asarray(flags)
        self.samples_per_batch = samples_per_batch
        self.seed = seed
        self.epoch = 0
        self.group_sizes = np.bincount(self.flags)
        self.num_samples = int(sum(
            int(np.ceil(s / samples_per_batch)) * samples_per_batch
            for s in self.group_sizes))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def local_indices(self) -> List[int]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch]))
        batches = []
        for flag, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            idx = np.where(self.flags == flag)[0]
            idx = idx[rng.permutation(len(idx))]
            # pad to a multiple of samples_per_batch; np.tile (not a single
            # idx[:pad_n] slice) so groups smaller than the batch size fill
            # correctly — the reference's slice-pad (sampler.py:35-37)
            # crashes its own length assert there
            target = int(np.ceil(size / self.samples_per_batch)
                         ) * self.samples_per_batch
            if target > len(idx):
                reps = -(-target // len(idx))
                idx = np.tile(idx, reps)[:target]
            batches.extend(np.split(idx, len(idx) // self.samples_per_batch))
        order = rng.permutation(len(batches))
        return [int(i) for b in order for i in batches[b]]

    def __iter__(self) -> Iterator[int]:
        return iter(self.local_indices())

    def __len__(self) -> int:
        return self.num_samples


class DistributedGroupSampler(GroupSampler):
    """GroupSampler + contiguous block sharding (reference
    ``sampler.py:81-163``): each group is padded to a multiple of
    ``samples_per_batch * world_size``, the ``samples_per_batch``-blocks are
    permuted globally, and each rank takes a contiguous ``num_samples``
    slice — so every rank's batches stay flag-homogeneous and
    ``num_samples = sum_g ceil(size_g / spb / W) * spb``
    (``sampler.py:115-120``). An earlier version rank-strided the flat
    sequence, which interleaved blocks and broke per-rank batch
    homogeneity — caught by executing the reference sampler
    (tests/test_reference_aux_parity.py)."""

    def __init__(self, flags, samples_per_batch: int, world_size: int = 1,
                 rank: int = 0, seed: int = 0):
        super().__init__(flags, samples_per_batch, seed)
        self.world_size = world_size
        self.rank = rank
        self.num_samples = int(sum(
            int(np.ceil(s / (samples_per_batch * world_size)))
            * samples_per_batch for s in self.group_sizes))

    def local_indices(self) -> List[int]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch]))
        spb = self.samples_per_batch
        parts = []
        for flag, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            idx = np.where(self.flags == flag)[0]
            idx = idx[rng.permutation(len(idx))]
            # pad to a multiple of spb * world_size (reference
            # sampler.py:134-138 slice-pads; np.tile so the pad survives
            # pads longer than the group)
            target = int(np.ceil(size / (spb * self.world_size))
                         ) * spb * self.world_size
            if target > len(idx):
                reps = -(-target // len(idx))
                idx = np.tile(idx, reps)[:target]
            parts.append(idx)
        if not parts:
            return []
        blocks = np.concatenate(parts).reshape(-1, spb)
        blocks = blocks[rng.permutation(len(blocks))]
        flat = blocks.reshape(-1)
        off = self.num_samples * self.rank
        return [int(i) for i in flat[off:off + self.num_samples]]


class ShardedSampler:
    def __init__(self, dataset_len: int, world_size: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0,
                 pad: bool = True):
        assert 0 <= rank < world_size
        self.dataset_len = dataset_len
        self.world_size = world_size
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.pad = pad
        self.epoch = 0
        if pad:
            self.num_samples = int(
                math.ceil(dataset_len / world_size))
            self.total_size = self.num_samples * world_size
        else:
            self.num_samples = len(self._local_indices_nopad())
            self.total_size = dataset_len

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _global_order(self) -> np.ndarray:
        if self.shuffle:
            g = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch]))
            order = g.permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        return order

    def _local_indices_nopad(self) -> np.ndarray:
        return np.arange(self.dataset_len)[self.rank::self.world_size]

    def local_indices(self) -> List[int]:
        order = self._global_order()
        if self.pad:
            # wrap-pad to total_size (reference sampler.py:69-72). np.tile
            # (not order[:pad_n]) so the wrap survives world_size >
            # dataset_len — a single-slice pad silently under-fills there
            # and starves the highest ranks.
            if self.total_size > len(order):
                reps = -(-self.total_size // max(len(order), 1))
                order = np.tile(order, reps)[:self.total_size]
            # rank-strided slice (reference sampler.py:74-76)
            return list(order[self.rank::self.world_size])
        return list(order[self.rank::self.world_size])

    def __iter__(self) -> Iterator[int]:
        return iter(self.local_indices())

    def __len__(self) -> int:
        return self.num_samples
