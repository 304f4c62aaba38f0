"""Dense-test CLI of the port (counterpart of the root ``test_recognizer.py``).

    python -m mvfnet_tpu_torch.tools.test_recognizer CONFIG CHECKPOINT.pth \\
        [--out scores.pkl] [--fcn_testing] [--average-clips prob|score] \\
        [--videos_per_gpu N] [--device cuda|cpu]

Builds the model and the config's test dataset, loads a ``.pth`` checkpoint
(every key of the model, no other), runs ``engine.eval.evaluate_dataset``
on the device, writes the scores as a pickled list of ``(K,)`` arrays, and
prints Top-1 / Top-5 / mean-class accuracy in the JAX CLI's format. The
compute dtype is the config's ``compute_dtype``; the config's
``Normalize`` decides whether the host or the device normalizes. It runs on
CUDA unless ``--device cpu`` is given, and raises without CUDA.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Any, Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='Test an action recognizer')
    parser.add_argument('config', help='config file path')
    parser.add_argument('checkpoint', help='checkpoint file (.pth)')
    parser.add_argument('--out', default=None, help='output pkl of scores')
    parser.add_argument('--fcn_testing', action='store_true',
                        help='fully-convolutional dense testing')
    parser.add_argument('--average-clips', default='prob',
                        choices=['prob', 'score'])
    parser.add_argument('--videos_per_gpu', type=int, default=1)
    parser.add_argument('--view_chunk', type=int, default=None,
                        help="stored in the model's test_cfg")
    parser.add_argument('--calib_videos', type=int, default=8,
                        help='int8 calibration videos (int8 is not ported '
                             'yet)')
    parser.add_argument('--launcher', default='none',
                        choices=['none', 'env', 'slurm'])
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default; raises without CUDA) or "
                             "'cpu'")
    return parser.parse_args(argv)


def build_model(cfg, fcn_testing: bool, average_clips: str,
                view_chunk: Optional[int] = None):
    """The config's recognizer for dense testing, in its compute dtype."""
    from ..models import build_recognizer
    if (cfg.model.get('backbone') or {}).get('quant'):
        raise NotImplementedError('quantized backbones and int8 calibration '
                                  'are not ported yet (ROADMAP.md, A13)')
    model_cfg = dict(cfg.model, fcn_testing=fcn_testing,
                     dtype=cfg.get('compute_dtype'))
    if 'cls_head' in model_cfg:
        model_cfg['cls_head'] = dict(model_cfg['cls_head'],
                                     fcn_testing=fcn_testing)
    test_cfg = dict(cfg.get('test_cfg') or {}, average_clips=average_clips)
    if view_chunk:
        test_cfg['view_chunk'] = view_chunk
    return build_recognizer(model_cfg, train_cfg=None, test_cfg=test_cfg)


def load_checkpoint(model, checkpoint: str) -> None:
    """Load a ``.pth`` state dict into ``model``: every key, no other."""
    if not checkpoint.endswith('.pth'):
        raise NotImplementedError(
            f'{checkpoint}: only .pth checkpoints load in the port; the '
            '.msgpack loader is not ported yet (ROADMAP.md, A9)')
    from ..utils.checkpoint import load_torch_state_dict
    model.load_state_dict(load_torch_state_dict(checkpoint), strict=True)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the dense test; returns the scores and the three accuracies."""
    args = parse_args(argv)
    if args.launcher != 'none':
        raise NotImplementedError(
            f'--launcher {args.launcher}: multi-process testing is not '
            'ported yet (ROADMAP.md, A8)')
    from ..config import Config
    from ..data import build_dataset, device_norm_cfg
    from ..engine.eval import evaluate_dataset
    from ..engine.train_step import resolve_device
    from ..utils.logging import get_root_logger
    from ..utils.metrics import mean_class_accuracy, top_k_accuracy

    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    logger = get_root_logger(cfg.get('log_level', 'INFO'))
    model = build_model(cfg, args.fcn_testing, args.average_clips,
                        args.view_chunk)
    load_checkpoint(model, args.checkpoint)

    dataset = build_dataset(dict(cfg.data['test']))
    logger.info('test dataset: %d videos', len(dataset))
    scores = evaluate_dataset(
        model, dataset, videos_per_gpu=args.videos_per_gpu,
        workers_per_gpu=cfg.data.get('workers_per_gpu', 4), progress=True,
        norm_cfg=device_norm_cfg(cfg.data['test'].get('pipeline')),
        device=device)

    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(list(scores), f)
        logger.info('scores written to %s', args.out)
    labels = [info['label'] for info in dataset.video_infos]
    top1, top5 = top_k_accuracy(scores, labels, k=(1, 5))
    mca = mean_class_accuracy(scores, labels)
    print(f'Top-1 Accuracy = {top1 * 100:.02f}')
    print(f'Top-5 Accuracy = {top5 * 100:.02f}')
    print(f'Mean Class Accuracy = {mca * 100:.02f}')
    return dict(scores=scores, top1=top1, top5=top5, mean_class=mca)


if __name__ == '__main__':
    main()
