"""The comparisons that decide ``correct``.

- ``answer_numbers``: dense-test answers (class probabilities) against
  the reference's, on the centred log-probabilities.
- ``leaf_gaps``: each leaf's gap between the program's and the
  reference's norm of a quantity (a gradient, a parameter change), over
  the larger of that leaf's reference norm and the median leaf's.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's are left out of the change: only round-off moves them.
- ``pooled_diff``: the norm of the difference over all leaves together,
  over the reference's norm.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Tuple

import torch


def answer_numbers(pairs) -> Tuple[int, Dict[str, float]]:
    """(failed, numbers) of answers against the reference's: ``pairs`` of
    (class probabilities, reference probabilities). An answer that is not
    finite fails. ``logp_err`` is the worst answer's error of its centred
    log-probabilities, ``||d(log p - mean log p)|| / ||log p_ref -
    mean||``: every class weighs alike, however small its probability."""
    failed, worst = 0, 0.0
    tiny = torch.finfo(torch.float32).tiny
    for p, ref in pairs:
        p, ref = p.double().flatten(), ref.double().flatten()
        if not bool(torch.isfinite(p).all()):
            failed += 1
            continue
        # a probability that underflowed reads as the smallest normal one
        lp, lref = p.clamp(min=tiny).log(), ref.clamp(min=tiny).log()
        lp, lref = lp - lp.mean(), lref - lref.mean()
        worst = max(worst, float((lp - lref).norm() / lref.norm()))
    return failed, dict(logp_err=worst)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep: Optional[set] = None) -> Dict[str, float]:
    """Each leaf's gap between two dicts of per-leaf norms, over the
    larger of its reference norm and the median leaf's."""
    names = [k for k in want if keep is None or k in keep]
    median = statistics.median(want[k] for k in names)
    return {k: abs(got[k] - want[k]) / max(want[k], median) for k in names}


def pooled_diff(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                keep: Optional[set] = None) -> float:
    """The norm of the difference over every leaf together, over the
    reference's norm."""
    names = [k for k in want if keep is None or k in keep]
    num = sum(float((got[k].double() - want[k].double()).pow(2).sum())
              for k in names)
    den = sum(float(want[k].double().pow(2).sum()) for k in names)
    return (num / den) ** 0.5


def moving_leaves(ref_grads: Dict[str, float]) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    median = statistics.median(ref_grads.values())
    return {k for k, v in ref_grads.items() if v >= 1e-3 * median}


def check(value: float, limit: float) -> dict:
    ok = value == value and value <= limit          # NaN fails
    return dict(value=value, limit=limit, ok=bool(ok))
