"""Dense-test inference over a dataset (counterpart of
``mvfnet_tpu/engine/eval.py``).

The process infers its sampler shard through one eval step
(``train_step.make_eval_step``): the threaded loader decodes and crops on
the host, ``prefetch.prefetch_to_device`` uploads the next batch while the
current one computes, and the scores stay on the device until the end.
Results come back in dataset order, truncated to the dataset's length, as
the reference's ``collect_results_gpu`` does (``codes/core/test.py:147-185``).
Gathering across processes is not ported yet (``ROADMAP.md``, A8).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..data import DataLoader, ShardedSampler
from .prefetch import prefetch_to_device
from .train_step import make_eval_step, resolve_device


def _world_rank():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def evaluate_dataset(model: torch.nn.Module, dataset,
                     videos_per_gpu: int = 1, workers_per_gpu: int = 2,
                     extract_feat: bool = False, progress: bool = False,
                     norm_cfg: Optional[Dict[str, Any]] = None,
                     device: Union[None, str, torch.device] = None
                     ) -> np.ndarray:
    """Run inference over the whole dataset; returns (N, K) scores in
    dataset order, on the host.

    ``norm_cfg`` is the pipeline's ``Normalize(device=True)`` node
    (``data.device_norm_cfg``), None when the host normalizes. ``device``
    is CUDA unless the caller asks for the CPU.
    """
    if extract_feat:
        raise NotImplementedError('extract_feat needs forward_extract_feat, '
                                  'which is not ported yet (ROADMAP.md, A5)')
    if getattr(getattr(model, 'backbone', None), 'quant', None):
        raise NotImplementedError('quantized backbones are not ported yet '
                                  '(ROADMAP.md, A13)')
    device = resolve_device(device)
    world, rank = _world_rank()
    if world > 1:
        raise NotImplementedError('multi-process evaluation is not ported '
                                  'yet (ROADMAP.md, A8)')
    sampler = ShardedSampler(len(dataset), world, rank, shuffle=False,
                             pad=True)
    loader = DataLoader(dataset, videos_per_gpu, sampler,
                        num_workers=workers_per_gpu, drop_last=False)
    step = _cached_eval_step(model, _freeze(norm_cfg), device)

    out: List[torch.Tensor] = []
    n_batches = len(loader)
    arrays = (np.asarray(batch['img_group']) for batch in loader)
    for bi, imgs in enumerate(prefetch_to_device(arrays, device)):
        out.append(step(model, imgs))
        if progress and rank == 0 and (bi % 20 == 0 or bi == n_batches - 1):
            print(f'\r[eval] {bi + 1}/{n_batches}', end='', flush=True)
    if progress and rank == 0:
        print()
    if not out:
        # pad=True gives every rank >= 1 sample whenever the dataset is
        # non-empty, so an empty shard can only mean an empty dataset
        if len(dataset) == 0:
            return np.zeros((0, 0))
        raise RuntimeError(
            f'rank {rank}: produced no scores for a non-empty dataset '
            f'({len(dataset)} videos, shard {len(sampler)})')
    scores = torch.cat(out)
    if scores.dtype == torch.bfloat16:        # numpy has no bfloat16
        scores = scores.float()
    local = scores.cpu().numpy()
    # rows must be a multiple of the shard length, or a strided reorder
    # across ranks would misassign scores
    if local.shape[0] % len(sampler):
        raise RuntimeError(f'shard size mismatch: got {local.shape[0]} rows '
                           f'for {len(sampler)} sampler indices')
    return local[:len(dataset)]


def _freeze(obj):
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple, np.ndarray)):
        return tuple(_freeze(v) for v in obj)
    return obj


_EVAL_STEP_CACHE: Dict[Any, Any] = {}


def _cached_eval_step(model: torch.nn.Module, norm_key, device: torch.device):
    """One eval step per (model, norm, device), reused by repeated evals.

    The entry holds a strong reference to ``model``: the key uses
    ``id(model)``, and without it a new model allocated at a collected
    model's address would reuse a stale step."""
    key = (id(model), norm_key, str(device))
    if key not in _EVAL_STEP_CACHE:
        norm_cfg = ({k: (list(v) if isinstance(v, tuple) else v)
                     for k, v in norm_key} if norm_key else None)
        _EVAL_STEP_CACHE[key] = (model, make_eval_step(model, norm_cfg,
                                                       device))
    return _EVAL_STEP_CACHE[key][1]


def reorder_rank_strided(gathered: np.ndarray, world: int,
                         n: int) -> np.ndarray:
    """Invert the rank-strided shard layout: global index i was evaluated by
    rank ``i % world`` at slot ``i // world`` (reference
    ``collect_results_gpu`` reorder + truncate, ``test.py:171-185``)."""
    per_rank = gathered.reshape(world, -1, gathered.shape[-1])
    interleaved = per_rank.transpose(1, 0, 2).reshape(-1, gathered.shape[-1])
    return interleaved[:n]
