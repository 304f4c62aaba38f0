"""Segmental consensus (counterpart of ``mvfnet_tpu/models/heads/consensus.py``).

- ``SimpleConsensus``: the mean over the segment axis.
- ``RelationModule`` (TRN) and ``RelationModuleMultiScale``
  (TRNmultiscale): relation MLPs over concatenated frame features. Their
  names are the reference's: ``classifier.{1,3}`` and
  ``fc_fusion_scales.{i}.{1,3}`` (``Sequential(ReLU, Linear, ReLU,
  Linear)``); the Linears run in the features' dtype.

The multiscale module sums, for every scale below the full one, the MLP
over ``min(3, subsets)`` frame subsets. Which subsets: with no generator
and no picks, the evenly spaced ``_deterministic_pick``, in training too,
as the JAX package's train step (which supplies no ``'subsets'`` RNG)
trains on it; a ``torch.Generator`` draws them at random without
replacement on each forward where a scale has more subsets than it sums,
and explicit ``picks`` choose them: one entry per scale below the full
one, the subset indices (what ``jax.random.choice`` gives the JAX module)
or None for the deterministic pick.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import SEGMENTAL_CONSENSUSES
from ..common import lecun_normal_


@SEGMENTAL_CONSENSUSES.register_module
class SimpleConsensus(nn.Module):
    """Mean over ``dim`` (the segment axis), keeping the axis."""

    def __init__(self, consensus_type: str = 'avg', dim: int = 1):
        super().__init__()
        if consensus_type != 'avg':
            raise ValueError(f'consensus {consensus_type!r}')
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=self.dim, keepdim=True)


def _all_relation_subsets(num_frames: int, scale: int) -> np.ndarray:
    """Every ordered frame-index subset of size ``scale``."""
    return np.array(list(itertools.combinations(range(num_frames), scale)),
                    dtype=np.int64)


def _deterministic_pick(n_combos: int, k: int) -> np.ndarray:
    """Evenly spaced subset choice, the pick without an RNG."""
    if n_combos <= k:
        return np.arange(n_combos, dtype=np.int64)
    return np.linspace(0, n_combos - 1, k).astype(np.int32).astype(np.int64)


def _mlp(in_features: int, bottleneck: int, classes: int) -> nn.Sequential:
    return nn.Sequential(nn.ReLU(), nn.Linear(in_features, bottleneck),
                         nn.ReLU(), nn.Linear(bottleneck, classes))


def _run_mlp(mlp: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    fc1, fc2 = mlp[1], mlp[3]
    h = F.linear(torch.relu(x), fc1.weight.to(x.dtype), fc1.bias.to(x.dtype))
    return F.linear(torch.relu(h), fc2.weight.to(x.dtype),
                    fc2.bias.to(x.dtype))


def _reset_mlps(module: nn.Module, generator: torch.Generator) -> None:
    """flax Dense's init: lecun-normal kernels, zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)


class RelationModule(nn.Module):
    """Single-scale TRN: the MLP over all ``num_frames`` frames' features
    concatenated. ``(B, num_frames, D) -> (B, 1, classes)``."""

    def __init__(self, img_feature_dim: int, num_frames: int,
                 num_classes: int, num_bottleneck: int = 512):
        super().__init__()
        self.num_frames = num_frames
        self.classifier = _mlp(num_frames * img_feature_dim, num_bottleneck,
                               num_classes)

    reset_parameters = _reset_mlps

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        return _run_mlp(self.classifier, x.reshape(x.shape[0], -1))[:, None]


class RelationModuleMultiScale(nn.Module):
    """Multi-scale TRN over scales ``num_frames, ..., 2``: the full scale's
    one subset, then ``min(3, subsets)`` subsets a scale, each scale's MLP
    summed over them; ``(B, num_frames, D) -> (B, 1, classes)``. The module
    docstring says how the subsets are chosen."""

    def __init__(self, img_feature_dim: int, num_frames: int,
                 num_classes: int, num_bottleneck: int = 256):
        super().__init__()
        self.num_frames = num_frames
        self.scales = list(range(num_frames, 1, -1))
        self.fc_fusion_scales = nn.ModuleList(
            _mlp(s * img_feature_dim, num_bottleneck, num_classes)
            for s in self.scales)

    reset_parameters = _reset_mlps

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                picks: Optional[Sequence] = None) -> torch.Tensor:
        b = x.shape[0]
        out = None
        for si, scale in enumerate(self.scales):
            combos = _all_relation_subsets(self.num_frames, scale)
            k = 1 if si == 0 else min(3, len(combos))
            if si == 0:
                chosen = [0]
            elif picks is not None and picks[si - 1] is not None:
                chosen = [int(i) for i in picks[si - 1]]
            elif picks is None and generator is not None \
                    and len(combos) > k:
                chosen = torch.randperm(len(combos), generator=generator,
                                        device=generator.device)[:k].tolist()
            else:
                chosen = _deterministic_pick(len(combos), k).tolist()
            acc = None
            for ci in chosen:
                idx = torch.as_tensor(combos[ci], device=x.device)
                h = _run_mlp(self.fc_fusion_scales[si],
                             x.index_select(1, idx).reshape(b, -1))
                acc = h if acc is None else acc + h
            out = acc if out is None else out + acc
        return out[:, None]


def return_trn(relation_type: str, img_feature_dim: int, num_frames: int,
               num_classes: int) -> nn.Module:
    """The reference's ``return_TRN``; the head passes its projected
    feature size (256), as the JAX package does."""
    if relation_type == 'TRN':
        return RelationModule(img_feature_dim, num_frames, num_classes)
    if relation_type == 'TRNmultiscale':
        return RelationModuleMultiScale(img_feature_dim, num_frames,
                                        num_classes)
    raise ValueError(f'Unknown TRN type {relation_type}')
