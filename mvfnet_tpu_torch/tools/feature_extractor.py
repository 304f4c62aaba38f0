"""Feature-extraction CLI of the port (counterpart of the root
``feature_extractor.py``).

    python -m mvfnet_tpu_torch.tools.feature_extractor CONFIG CHECKPOINT \\
        [--out features.json] [--fcn_testing] [--videos_per_gpu N] \\
        [--launcher none|env|slurm] [--device cuda|cpu]

Builds the config's recognizer with its head in ``extract_feat`` mode and
``average_clips=None`` (``fcn_testing`` on the model and the head with
``--fcn_testing``), loads a ``.pth`` or ``.msgpack`` checkpoint as the test
CLI does, runs the config's test split through
``engine.eval.evaluate_dataset(extract_feat=True)`` and writes
``{basename(filename): [floats]}`` as JSON: each video's rows (its clip
volumes with ``--fcn_testing``, else its frames) of pooled backbone
features, flattened. The features are computed in the config's
``compute_dtype`` (bf16 for the flagship) and written as floats. Under
``--launcher env`` (torchrun) or ``slurm`` (srun) every rank extracts its
shard and rank 0 alone writes the JSON. It runs on CUDA unless
``--device cpu`` is given, and raises without CUDA.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='Extract video features')
    parser.add_argument('config', help='config file path')
    parser.add_argument('checkpoint', help='checkpoint file (.pth torch or '
                        '.msgpack of the JAX package)')
    parser.add_argument('--out', default='features.json')
    parser.add_argument('--fcn_testing', action='store_true')
    parser.add_argument('--videos_per_gpu', type=int, default=1)
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'env', 'slurm'])
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default; raises without CUDA) or "
                             "'cpu'")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[float]]:
    """Extract and write the features; returns what was written (on every
    rank)."""
    args = parse_args(argv)
    from ..parallel import process_group
    with process_group(args.launcher, args.device) as device:
        return _extract(args, device)


def _extract(args, device) -> Dict[str, List[float]]:
    from ..config import Config
    from ..data import (build_dataset, dataset_decoder, decode_counts,
                        device_norm_cfg)
    from ..engine.eval import evaluate_dataset
    from ..models.builder import model_name
    from ..parallel import is_main_process
    from ..utils.logging import get_root_logger
    from .test_recognizer import build_model, load_checkpoint

    cfg = Config.fromfile(args.config)
    logger = get_root_logger(cfg.get('log_level', 'INFO'))
    model = build_model(cfg, args.fcn_testing, None, extract_feat=True)
    logger.info('model: %s, compute dtype %s', model_name(cfg.model),
                model.compute_dtype)
    load_checkpoint(model, args.checkpoint, logger)

    dataset = build_dataset(dict(cfg.data['test']), device)
    logger.info('dataset: %d videos, decoder %s', len(dataset),
                dataset_decoder(dataset))
    feats = evaluate_dataset(
        model, dataset, videos_per_gpu=args.videos_per_gpu,
        workers_per_gpu=cfg.data.get('workers_per_gpu', 4),
        extract_feat=True, progress=True,
        norm_cfg=device_norm_cfg(cfg.data['test'].get('pipeline')),
        device=device)
    logger.info('frames decoded: %s', decode_counts(dataset))
    out = {info['filename'].split('/')[-1]: [float(x) for x in feat]
           for info, feat in zip(dataset.video_infos, feats)}
    if is_main_process():
        with open(args.out, 'w') as f:
            json.dump(out, f)
        logger.info('wrote %d features to %s', len(out), args.out)
    return out


if __name__ == '__main__':
    main()
