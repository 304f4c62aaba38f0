"""Checkpoint converter of the port (counterpart of the root
``tools/convert_checkpoint.py``).

    python -m mvfnet_tpu_torch.tools.convert_checkpoint CONFIG SRC.pth \\
        OUT.msgpack [--modality Flow|RGBDiff]

Builds the config's recognizer (float32 parameters, the JAX package's
initializers seeded with 0 for anything the source lacks), imports the
torch ``.pth`` non-strictly (``utils.checkpoint.import_torch_state_dict``,
the JAX importer's rules) with the stem inflated over ``--modality``'s
input channels (10 for Flow, 15 for RGBDiff; the config's modality by
default), and writes the JAX package's ``.msgpack`` checkpoint
(``save_msgpack_checkpoint``: the variables, an empty optimizer state, a
``.meta.json`` naming the source). Host code only; no device is used.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

_INFLATE = {'Flow': 10, 'RGBDiff': 15}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='.pth -> .msgpack')
    parser.add_argument('config', help='model config (defines the target '
                        'tree)')
    parser.add_argument('src', help='torch .pth checkpoint')
    parser.add_argument('out', help='output .msgpack path')
    parser.add_argument('--modality', default=None,
                        help='override modality for stem inflation '
                             '(Flow/RGBDiff)')
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[str]]:
    """Convert; returns the import report."""
    args = parse_args(argv)
    import torch

    from ..config import Config
    from ..models import build_recognizer
    from ..utils.checkpoint import (import_torch_state_dict,
                                    load_torch_state_dict,
                                    save_msgpack_checkpoint)
    from ..utils.logging import get_root_logger
    logger = get_root_logger()
    cfg = Config.fromfile(args.config)
    model = build_recognizer(dict(cfg.model),
                             test_cfg=cfg.get('test_cfg')
                             or dict(average_clips='prob'))
    model.init_weights(torch.Generator().manual_seed(0))
    modality = args.modality or cfg.model.get('modality', 'RGB')
    report = import_torch_state_dict(
        model, load_torch_state_dict(args.src),
        inflate_in_channels=_INFLATE.get(modality), logger=logger)
    save_msgpack_checkpoint(args.out, model,
                            meta={'converted_from': args.src})
    logger.info('wrote %s', args.out)
    return report


if __name__ == '__main__':
    main()
