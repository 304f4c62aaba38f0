"""Dense-test inference over a dataset (counterpart of
``mvfnet_tpu/engine/eval.py``).

Each process infers its rank-strided sampler shard through one eval step
(``train_step.make_eval_step``): the threaded loader decodes and crops on
the host, ``prefetch.prefetch_to_device`` uploads the next batch while the
current one computes, and the scores stay on the device until the end.
Then every rank gathers every shard (``parallel.all_gather_rows``, the
counterpart of JAX's ``process_allgather``) and puts them back in dataset
order, truncated to the dataset's length, as the reference's
``collect_results_gpu`` does (``codes/core/test.py:147-185``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..data import DataLoader, ShardedSampler
from ..models.common import check_quant_calibrated, quant_calibration
from ..parallel import all_gather_rows, world_rank
from ..utils import tracing
from .prefetch import prefetch_to_device
from .train_step import make_eval_step, resolve_device


def evaluate_dataset(model: torch.nn.Module, dataset,
                     videos_per_gpu: int = 1, workers_per_gpu: int = 2,
                     extract_feat: bool = False, progress: bool = False,
                     norm_cfg: Optional[Dict[str, Any]] = None,
                     device: Union[None, str, torch.device] = None
                     ) -> np.ndarray:
    """Run inference over the whole dataset; returns (N, K) scores in
    dataset order, on the host, or with ``extract_feat`` the features of
    ``model.forward_extract_feat``, (N, rows * C): each video's rows (its
    clip volumes, or its frames), C features each, in one row. In a
    process group every rank infers its shard and returns the whole array.
    ``model`` is the module itself, not a ``DistributedDataParallel``
    wrapper.

    ``norm_cfg`` is the pipeline's ``Normalize(device=True)`` node
    (``data.device_norm_cfg``), None when the host normalizes. ``device``
    is CUDA unless the caller asks for the CPU. An ``int8_static`` model
    must be calibrated (``models.common.check_quant_calibrated``).

    With tracing on, ``eval.pass`` spans the call, ``eval.setup`` its start
    up to the first batch's request and ``eval.scores`` the scores'
    gather and copy to the host.
    """
    with tracing.span('eval.pass'):
        return _evaluate(model, dataset, videos_per_gpu, workers_per_gpu,
                         extract_feat, progress, norm_cfg, device)


def _evaluate(model, dataset, videos_per_gpu, workers_per_gpu, extract_feat,
              progress, norm_cfg, device) -> np.ndarray:
    with tracing.span('eval.setup'):
        check_quant_calibrated(model)
        device = resolve_device(device)
        world, rank = world_rank()
        sampler = ShardedSampler(len(dataset), world, rank, shuffle=False,
                                 pad=True)
        loader = DataLoader(dataset, videos_per_gpu, sampler,
                            num_workers=workers_per_gpu, drop_last=False)
        step = _cached_eval_step(model, extract_feat, _freeze(norm_cfg),
                                 device)
        # a cached step finds the model as the caller left it: a train loop
        # evaluating between epochs leaves it in train mode
        was_training = model.training
        model.eval()

    out: List[torch.Tensor] = []
    n_batches = len(loader)
    arrays = (np.asarray(batch['img_group']) for batch in loader)
    try:
        for bi, imgs in enumerate(prefetch_to_device(arrays, device)):
            res = step(model, imgs)
            # features come as (videos * rows, C): one row a video
            out.append(res.reshape(imgs.shape[0], -1) if extract_feat
                       else res)
            if progress and rank == 0 and (bi % 20 == 0
                                           or bi == n_batches - 1):
                print(f'\r[eval] {bi + 1}/{n_batches}', end='', flush=True)
    finally:
        model.train(was_training)
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
    with tracing.span('eval.scores'):
        return _gather_scores(out, sampler, world, len(dataset))


def _gather_scores(out: List[torch.Tensor], sampler, world: int,
                   n: int) -> np.ndarray:
    scores = torch.cat(out)
    if scores.dtype == torch.bfloat16:        # numpy has no bfloat16
        scores = scores.float()
    # rows must be a multiple of the shard length, or a strided reorder
    # across ranks would misassign scores
    if scores.shape[0] % len(sampler):
        raise RuntimeError(f'shard size mismatch: got {scores.shape[0]} '
                           f'rows for {len(sampler)} sampler indices')
    if world > 1:
        return reorder_rank_strided(all_gather_rows(scores).cpu().numpy(),
                                    world, n)
    return scores.cpu().numpy()[:n]


def calibrate_quant(model: torch.nn.Module, dataset, videos: int,
                    norm_cfg: Optional[Dict[str, Any]] = None,
                    device: Union[None, str, torch.device] = None) -> int:
    """Record an ``int8_static`` model's activation abs-max on the dataset's
    first ``videos`` videos, one at a time through the eval step (the root
    ``test_recognizer.py:97-113`` loop, the JAX model applied with
    ``mutable=['quant_stats']``); returns how many it used, 0 for a model
    that is not ``int8_static``."""
    if getattr(model.backbone, 'quant', None) != 'int8_static':
        return 0
    step = make_eval_step(model, norm_cfg, resolve_device(device))
    n = min(videos, len(dataset))
    with quant_calibration(model):
        for i in range(n):
            step(model, np.asarray(dataset[i]['img_group'])[None])
    return n


def _freeze(obj):
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple, np.ndarray)):
        return tuple(_freeze(v) for v in obj)
    return obj


_EVAL_STEP_CACHE: Dict[Any, Any] = {}


def _cached_eval_step(model: torch.nn.Module, extract_feat: bool, norm_key,
                      device: torch.device):
    """One eval step per (model, mode, norm, device), reused by repeated
    evals; the mode is scores or features.

    The entry holds a strong reference to ``model``: the key uses
    ``id(model)``, and without it a new model allocated at a collected
    model's address would reuse a stale step."""
    key = (id(model), extract_feat, norm_key, str(device))
    if key not in _EVAL_STEP_CACHE:
        norm_cfg = ({k: (list(v) if isinstance(v, tuple) else v)
                     for k, v in norm_key} if norm_key else None)
        _EVAL_STEP_CACHE[key] = (model, make_eval_step(
            model, norm_cfg, device, extract_feat=extract_feat))
    return _EVAL_STEP_CACHE[key][1]


def reorder_rank_strided(gathered: np.ndarray, world: int,
                         n: int) -> np.ndarray:
    """Invert the rank-strided shard layout: global index i was evaluated by
    rank ``i % world`` at slot ``i // world`` (reference
    ``collect_results_gpu`` reorder + truncate, ``test.py:171-185``)."""
    per_rank = gathered.reshape(world, -1, gathered.shape[-1])
    interleaved = per_rank.transpose(1, 0, 2).reshape(-1, gathered.shape[-1])
    return interleaved[:n]
