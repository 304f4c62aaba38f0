"""Dense-test CLI of the port (counterpart of the root ``test_recognizer.py``).

    python -m mvfnet_tpu_torch.tools.test_recognizer CONFIG CHECKPOINT \\
        [--out scores.pkl] [--fcn_testing] [--average-clips prob|score] \\
        [--videos_per_gpu N] [--launcher none|env|slurm] [--device cuda|cpu]

Builds the model and the config's test dataset, loads a ``.pth`` checkpoint
through the non-strict importer (``utils.checkpoint.import_torch_state_dict``,
the JAX CLI's ``import_torch_weights`` rules) or a ``.msgpack`` one of the
JAX package as its ``from_state_dict`` does, and logs the report, runs
``engine.eval.evaluate_dataset`` on the device, writes the scores as a
pickled list of ``(K,)`` arrays, and prints Top-1 / Top-5 / mean-class
accuracy in the JAX CLI's format. The compute dtype is the config's
``compute_dtype`` (bf16 for the flagship, whose fused kernel's tiled path
is bf16; the JAX CLI computes in float32 whatever the config says); the
config's ``Normalize`` decides whether the host or the device normalizes.
Under ``--launcher env`` (torchrun) or ``slurm`` (srun) every rank scores
its shard of the videos and rank 0 alone writes the pickle and prints.
It runs on CUDA unless ``--device cpu`` is given, and raises without CUDA.

A config whose backbone sets ``quant='int8_static'`` is calibrated first
on ``--calib_videos`` videos of the test set (8 by default), as the root
CLI does: the activation abs-max starts from what the checkpoint holds (a
``.msgpack`` with a ``quant_stats`` collection) or from zeros, the JAX
init pass on zeros, and grows over those videos. ``quant='int8'``
quantizes each call with its own scales and needs no calibration.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Any, Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='Test an action recognizer')
    parser.add_argument('config', help='config file path')
    parser.add_argument('checkpoint', help='checkpoint file (.pth torch or '
                        '.msgpack of the JAX package)')
    parser.add_argument('--out', default=None, help='output pkl of scores')
    parser.add_argument('--fcn_testing', action='store_true',
                        help='fully-convolutional dense testing')
    parser.add_argument('--average-clips', default='prob',
                        choices=['prob', 'score'])
    parser.add_argument('--videos_per_gpu', type=int, default=1)
    parser.add_argument('--view_chunk', type=int, default=None,
                        help="stored in the model's test_cfg")
    parser.add_argument('--calib_videos', type=int, default=8,
                        help='videos used to calibrate activation scales '
                             "when backbone.quant='int8_static'")
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'env', 'slurm'])
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default; raises without CUDA) or "
                             "'cpu'")
    return parser.parse_args(argv)


def build_model(cfg, fcn_testing: bool, average_clips: Optional[str],
                view_chunk: Optional[int] = None, extract_feat: bool = False,
                backbone: Optional[Dict[str, Any]] = None):
    """The config's recognizer for dense testing, in its compute dtype; with
    ``extract_feat`` its head returns pooled features. ``backbone`` updates
    the config's backbone options."""
    from ..models import build_recognizer
    model_cfg = dict(cfg.model, fcn_testing=fcn_testing,
                     dtype=cfg.get('compute_dtype'))
    if backbone:
        model_cfg['backbone'] = dict(model_cfg['backbone'], **backbone)
    if 'cls_head' in model_cfg:
        model_cfg['cls_head'] = dict(model_cfg['cls_head'],
                                     fcn_testing=fcn_testing,
                                     extract_feat=extract_feat)
    test_cfg = dict(cfg.get('test_cfg') or {}, average_clips=average_clips)
    if view_chunk:
        test_cfg['view_chunk'] = view_chunk
    return build_recognizer(model_cfg, train_cfg=None, test_cfg=test_cfg)


def load_checkpoint(model, checkpoint: str, logger=None) -> Dict[str, Any]:
    """Load a checkpoint into ``model`` as the JAX CLI's
    ``load_model_variables`` does (``utils.checkpoint.load_weights``: a
    ``.pth`` non-strictly, a ``.msgpack`` with every model entry required);
    logs and returns the import report."""
    from ..utils.checkpoint import load_weights
    from ..utils.logging import get_root_logger
    logger = logger or get_root_logger()
    report = load_weights(model, checkpoint, logger=logger)
    logger.info('loaded %s: %s', checkpoint, ', '.join(
        f'{len(v)} {k}' for k, v in report.items()))
    return report


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the dense test; returns the scores, the three accuracies and the
    int8 convs' calibration buffers (empty without quant), on every
    rank."""
    args = parse_args(argv)
    from ..parallel import process_group
    with process_group(args.launcher, args.device) as device:
        return _test(args, device)


def calibrate(model, dataset, videos: int, norm_cfg, device,
              logger) -> None:
    """Calibrate an ``int8_static`` model on the dataset's first ``videos``
    videos (nothing for other models)."""
    from ..engine.eval import calibrate_quant
    n = calibrate_quant(model, dataset, videos, norm_cfg, device)
    if n:
        logger.info('calibrated int8 activation scales on %d videos', n)


def _test(args, device) -> Dict[str, Any]:
    from ..config import Config
    from ..data import (build_dataset, dataset_decoder, decode_counts,
                        device_norm_cfg)
    from ..engine.eval import evaluate_dataset
    from ..models.common import quant_buffers
    from ..models.builder import model_name
    from ..parallel import is_main_process
    from ..utils.logging import get_root_logger
    from ..utils.metrics import mean_class_accuracy, top_k_accuracy

    cfg = Config.fromfile(args.config)
    logger = get_root_logger(cfg.get('log_level', 'INFO'))
    model = build_model(cfg, args.fcn_testing, args.average_clips,
                        args.view_chunk)
    logger.info('model: %s, compute dtype %s', model_name(cfg.model),
                model.compute_dtype)
    load_checkpoint(model, args.checkpoint, logger)

    dataset = build_dataset(dict(cfg.data['test']), device)
    logger.info('test dataset: %d videos, decoder %s', len(dataset),
                dataset_decoder(dataset))
    norm_cfg = device_norm_cfg(cfg.data['test'].get('pipeline'))
    calibrate(model, dataset, args.calib_videos, norm_cfg, device, logger)
    scores = evaluate_dataset(
        model, dataset, videos_per_gpu=args.videos_per_gpu,
        workers_per_gpu=cfg.data.get('workers_per_gpu', 4), progress=True,
        norm_cfg=norm_cfg, device=device)

    counts = decode_counts(dataset)
    logger.info('frames decoded: %s', counts)
    labels = [info['label'] for info in dataset.video_infos]
    top1, top5 = top_k_accuracy(scores, labels, k=(1, 5))
    mca = mean_class_accuracy(scores, labels)
    if is_main_process():
        if args.out:
            with open(args.out, 'wb') as f:
                pickle.dump(list(scores), f)
            logger.info('scores written to %s', args.out)
        print(f'Top-1 Accuracy = {top1 * 100:.02f}')
        print(f'Top-5 Accuracy = {top5 * 100:.02f}')
        print(f'Mean Class Accuracy = {mca * 100:.02f}')
    return dict(scores=scores, top1=top1, top5=top5, mean_class=mca,
                decoder=dataset_decoder(dataset), decode_counts=counts,
                quant_stats={k: v.detach().cpu()
                             for k, v in quant_buffers(model).items()})


if __name__ == '__main__':
    main()
