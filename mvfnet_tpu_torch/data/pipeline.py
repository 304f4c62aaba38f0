"""Compose — sequential transform runner (counterpart of
``mvfnet_tpu/data/pipeline.py``; reference
``codes/datasets/pipelines/compose.py:9-36``). A transform returning
``None`` aborts the sample (decode-failure signal).

``device_norm_cfg`` reads a pipeline config's ``Normalize(device=True)``
node, which the eval and train steps apply on the device."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from ..registry import build_from_cfg
from ..utils import tracing
from .builder import PIPELINES

# span names of the ops, by type: built once, so that a call allocates none
_OP_SPANS: Dict[type, str] = {}


def _op_span(op) -> str:
    kind = type(op)
    name = _OP_SPANS.get(kind)
    if name is None:
        name = _OP_SPANS[kind] = 'data.op.' + kind.__name__
    return name


class Compose:
    def __init__(self, transforms: Sequence[Union[dict, Callable]]):
        assert isinstance(transforms, Sequence)
        self.transforms: List[Callable] = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(build_from_cfg(t, PIPELINES))
            elif callable(t):
                self.transforms.append(t)
            else:
                raise TypeError(f'transform must be callable or dict, got {t}')

    def __call__(self, results):
        for t in self.transforms:
            with tracing.span(_op_span(t)):
                results = t(results)
            if results is None:
                return None
        return results

    def __repr__(self):
        return f'{type(self).__name__}({self.transforms})'


def dataset_decoder(dataset) -> Optional[str]:
    """What decodes a dataset's frames (a ``RepeatDataset``'s inner one),
    for the CLIs' logs: the ``decoder`` of the first pipeline op that names
    one (``cv2.imdecode``, or cv2's video capture by seek or sequential
    read), or None."""
    dataset = getattr(dataset, 'dataset', dataset)
    return next((t.decoder for t in dataset.pipeline.transforms
                 if hasattr(t, 'decoder')), None)


def decode_counts(dataset) -> Dict[str, int]:
    """How many frames each JPEG decoder has given a dataset so far
    (``FrameSelector.counts``: ``nvjpeg``, and ``cv2.imdecode`` for the
    frames sent to cv2), for the CLIs' logs; {} where no op counts."""
    dataset = getattr(dataset, 'dataset', dataset)
    return next((dict(t.counts) for t in dataset.pipeline.transforms
                 if hasattr(t, 'counts')), {})


def device_norm_cfg(pipeline) -> Optional[Dict[str, Any]]:
    """The constants of a pipeline config's ``Normalize(device=True)`` node
    (without its ``type``), or None when the host normalizes (counterpart
    of ``mvfnet_tpu/engine/train_loop.py::_device_norm_cfg``)."""
    for op in pipeline or []:
        if isinstance(op, dict) and op.get('type') == 'Normalize' \
                and op.get('device'):
            return {k: v for k, v in op.items() if k != 'type'}
    return None
