"""Accuracy-parity runbook of the port (counterpart of the root
``tools/validate_k400.py``).

    python -m mvfnet_tpu_torch.tools.validate_k400 --checkpoint CKPT \\
        --ann VAL_LIST --data-root ROOT [--config CONFIG] \\
        [--expected-top1 P] [--budget 0.2] [--max-videos N] \\
        [--videos-per-gpu N] [--out verdict.json] [--device cuda|cpu] \
        [--quant int8|int8_static [--quant-stages S1 S2 S3 S4] \
         [--calib-videos N]]

Runs the config's test split, re-pointed at ``--ann`` and
``--data-root``, through the dense-test protocol (``fcn_testing``,
``'prob'`` clip averaging) with a ``.pth`` or ``.msgpack`` checkpoint, as
the test CLI does (in the config's ``compute_dtype``), and prints one JSON
line with the JAX tool's keys: Top-1 / Top-5 / mean-class accuracy in
percent and a pass/fail verdict against the published Top-1
(``EXPECTED_TOP1``, by the config's name) less ``--budget``. Exits 1 when
the verdict fails. ``--quant`` validates the int8 eval path instead, on
the stages ``--quant-stages`` selects; ``int8_static`` first calibrates on
``--calib-videos`` videos (8 by default), as the test CLI does. It runs on
CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional, Sequence

# Published dense-test Top-1 (BASELINE.md; the reference README)
EXPECTED_TOP1 = {
    'mvf_kinetics400_r50_4x16_dense': 74.2,
    'mvf_kinetics400_r50_8x8_dense': 76.0,
    'mvf_kinetics400_r50_8x8_dense_v5e16': 76.0,
    'mvf_kinetics400_r50_16x4_dense': 77.0,
    'mvf_kinetics400_r101_8x8_dense': 77.4,
    'mvf_kinetics400_video_r50_4x16_dense': 74.2,
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='K400 accuracy parity runbook')
    p.add_argument('--checkpoint', required=True,
                   help='released .pth or .msgpack of the JAX package')
    p.add_argument('--ann', required=True, help='K400 val datalist')
    p.add_argument('--data-root', required=True,
                   help='root of the extracted val rawframes (or videos)')
    p.add_argument('--config',
                   default='configs/mvf/k400/mvf_kinetics400_r50_8x8_dense.py')
    p.add_argument('--expected-top1', type=float, default=None,
                   help='override the published number (percent)')
    p.add_argument('--budget', type=float, default=0.2,
                   help='allowed Top-1 shortfall in percent')
    p.add_argument('--quant', default=None, choices=['int8', 'int8_static'],
                   help='validate the int8 eval path instead of the '
                        "config's compute dtype")
    p.add_argument('--quant-stages', type=int, nargs=4, default=None,
                   metavar=('S1', 'S2', 'S3', 'S4'))
    p.add_argument('--calib-videos', type=int, default=8)
    p.add_argument('--max-videos', type=int, default=None,
                   help='evaluate only the first N videos (smoke runs)')
    p.add_argument('--videos-per-gpu', type=int, default=1)
    p.add_argument('--out', default=None, help='also write the JSON here')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default; raises without CUDA) or 'cpu'")
    return p.parse_args(argv)


def validate(args: argparse.Namespace) -> Dict[str, Any]:
    """The verdict dictionary (the JAX tool's keys)."""
    from ..config import Config
    from ..data import build_dataset, device_norm_cfg
    from ..engine.eval import evaluate_dataset
    from ..utils.logging import get_root_logger
    from ..utils.metrics import mean_class_accuracy, top_k_accuracy
    from .test_recognizer import build_model, calibrate, load_checkpoint

    cfg = Config.fromfile(args.config)
    logger = get_root_logger(cfg.get('log_level', 'INFO'))
    quant = {}
    if args.quant:
        quant = dict(quant=args.quant)
        if args.quant_stages:
            quant['quant_stages'] = tuple(args.quant_stages)
    model = build_model(cfg, True, 'prob', backbone=quant)
    load_checkpoint(model, args.checkpoint, logger)
    data_cfg = dict(cfg.data['test'], ann_file=args.ann,
                    data_root=args.data_root)
    dataset = build_dataset(data_cfg, args.device)
    if args.max_videos:
        dataset.video_infos = dataset.video_infos[:args.max_videos]
    logger.info('validation dataset: %d videos', len(dataset))
    norm_cfg = device_norm_cfg(data_cfg.get('pipeline'))
    calibrate(model, dataset, args.calib_videos, norm_cfg, args.device,
              logger)
    scores = evaluate_dataset(
        model, dataset, videos_per_gpu=args.videos_per_gpu,
        workers_per_gpu=cfg.data.get('workers_per_gpu', 4), progress=True,
        norm_cfg=norm_cfg, device=args.device)
    labels = [info['label'] for info in dataset.video_infos]
    top1, top5 = top_k_accuracy(scores, labels, k=(1, 5))
    mca = mean_class_accuracy(scores, labels)
    key = os.path.splitext(os.path.basename(args.config))[0]
    expected = (args.expected_top1 if args.expected_top1 is not None
                else EXPECTED_TOP1.get(key))
    return {
        'config': key,
        'checkpoint': os.path.basename(args.checkpoint),
        'quant': args.quant,
        'n_videos': len(dataset),
        'top1': round(top1 * 100, 2),
        'top5': round(top5 * 100, 2),
        'mean_class_acc': round(mca * 100, 2),
        'expected_top1': expected,
        'budget': args.budget,
        'pass': (bool(top1 * 100 >= expected - args.budget)
                 if expected is not None else None),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    result = validate(args)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    return 1 if result['pass'] is False else 0


if __name__ == '__main__':
    sys.exit(main())
