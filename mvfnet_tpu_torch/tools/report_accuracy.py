"""Late score fusion CLI of the port (counterpart of the root
``report_accuracy.py``).

    python -m mvfnet_tpu_torch.tools.report_accuracy --scores A.pkl B.pkl \\
        --coefficients 1 1 --datalist ann.txt [--apply_softmax]

Reads each pickled list of per-video score arrays, applies a softmax to
each first with ``--apply_softmax`` (or ``--apply-softmax``), sums them
with the coefficients (``utils.metrics.get_weighted_score``) and prints
Top-1 / Top-5 / mean-class accuracy against the last column of the
annotation file, in the root CLI's lines. Host code only.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict, Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='Fuse scores and report')
    parser.add_argument('--scores', nargs='+', required=True,
                        help='score pkl files')
    parser.add_argument('--coefficients', nargs='+', type=float,
                        required=True)
    parser.add_argument('--datalist', required=True,
                        help='annotation file with labels')
    # both spellings: the reference CLI uses --apply-softmax
    parser.add_argument('--apply_softmax', '--apply-softmax',
                        action='store_true')
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Fuse, print and return the three accuracies."""
    args = parse_args(argv)
    from ..utils.metrics import (get_weighted_score, mean_class_accuracy,
                                 softmax, top_k_accuracy)
    if len(args.scores) != len(args.coefficients):
        raise ValueError(f'{len(args.scores)} score files but '
                         f'{len(args.coefficients)} coefficients')
    score_list = []
    for path in args.scores:
        with open(path, 'rb') as f:
            scores = [np.asarray(s).reshape(-1) for s in pickle.load(f)]
        score_list.append(scores)
    if args.apply_softmax:
        score_list = [[softmax(s[None])[0] for s in scores]
                      for scores in score_list]
    weighted = np.stack(get_weighted_score(score_list, args.coefficients))
    with open(args.datalist) as f:
        labels = [int(line.split()[-1]) for line in f if line.strip()]
    top1, top5 = top_k_accuracy(weighted, labels, k=(1, 5))
    mca = mean_class_accuracy(weighted, labels)
    print(f'Top-1 Accuracy = {top1 * 100:.02f}')
    print(f'Top-5 Accuracy = {top5 * 100:.02f}')
    print(f'Mean Class Accuracy = {mca * 100:.02f}')
    return dict(top1=top1, top5=top5, mean_class=mca)


if __name__ == '__main__':
    main()
