"""FLOPs CLI of the port (counterpart of the root ``count_flops.py``).

    python -m mvfnet_tpu_torch.tools.count_flops CONFIG [--shape B S H W C]

Builds the config's recognizer (``average_clips=None``, the config's
``compute_dtype``) on the ``meta`` device and prints its parameters and the
MACs and FLOPs of one test forward at the input shape (default ``(1,
clip_len, 224, 224, 3)``, the root CLI's rule, with ``clip_len`` 8 unless
the config sets it; a ``Recognizer3D`` takes one clip of that many frames,
``(1, 1, clip_len, 224, 224, 3)``), counted by ``utils.flops.get_flop_stats``
(``FlopCounterMode``: convolutions and matrix products). The reference's
GFLOPs columns count MACs. Nothing runs on a card.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='Count model FLOPs')
    parser.add_argument('config', help='config file path')
    parser.add_argument('--shape', type=int, nargs='+', default=None,
                        help='input shape B S H W C, or B clips T H W C '
                             'for a 3-D recognizer (default: 1 [1] clip_len '
                             '224 224 3)')
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Count and print; returns ``get_flop_stats``'s dict and the shape."""
    args = parse_args(argv)
    from ..config import Config
    from ..models import build_recognizer
    from ..utils.flops import get_flop_stats

    cfg = Config.fromfile(args.config)
    model = build_recognizer(dict(cfg.model, dtype=cfg.get('compute_dtype')),
                             test_cfg=dict(average_clips=None))
    clip_len = cfg.get('clip_len', 8)
    shape = (1, clip_len, 224, 224, 3)
    if cfg.model['type'] == 'Recognizer3D':
        shape = (1, 1) + shape[1:]
    shape = tuple(args.shape) if args.shape else shape
    stats = get_flop_stats(model, shape)
    print(f'input shape: {shape}')
    print(f'params: {stats["params"] / 1e6:.2f} M')
    print(f'GFLOPs (MAC convention, vs reference): {stats["gmacs"]:.3f}')
    print(f'FlopCounterMode flops: {stats["flops"] / 1e9:.3f} G, '
          'bytes accessed: unavailable (no counterpart of XLA cost '
          'analysis)')
    return dict(stats, shape=shape)


if __name__ == '__main__':
    main()
