"""FLOP and parameter counts (counterpart of ``mvfnet_tpu/utils/flops.py``).

The JAX package reads XLA's cost analysis of the compiled forward; the
port counts the forward's operators with ``torch.utils.flop_counter.
FlopCounterMode`` (convolutions and matrix products, a multiply-add as 2
FLOPs; normalization and elementwise work are not counted), on the ``meta``
device by default, where no value is computed. The reference counts MACs
(its configs' GFLOPs column), so ``macs = flops / 2`` comes too.

The count runs through the plain versions of the port's kernels: on the
card, ``FlopCounterMode`` would not see the fused bottleneck's launch (a
``ctypes`` call) and would miss its convolutions, so a model on a CUDA
device is refused. XLA's ``bytes accessed`` has no counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch


def params_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def get_flop_stats(model: torch.nn.Module, input_shape: Tuple[int, ...],
                   device: Union[str, torch.device] = 'meta'
                   ) -> Dict[str, Any]:
    """FLOPs of one dense-test forward (``return_loss=False``, eval mode)
    at ``input_shape`` (B, S, H, W, C), or (B, clips, T, H, W, C) for a
    ``Recognizer3D``: ``flops``, ``macs``, ``gmacs`` and
    ``params``. ``model`` is moved to ``device`` ('meta' or 'cpu')."""
    from torch.utils.flop_counter import FlopCounterMode
    device = torch.device(device)
    if device.type not in ('meta', 'cpu') or any(
            p.device.type not in ('meta', 'cpu') for p in model.parameters()):
        raise ValueError('FLOPs are counted on the meta device or the CPU: '
                         "FlopCounterMode does not see the card's fused "
                         'kernel')
    model.to(device).eval()
    imgs = torch.zeros(input_shape, device=device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(imgs, None, return_loss=False)
    flops = float(counter.get_total_flops())
    return {'flops': flops, 'macs': flops / 2.0, 'gmacs': flops / 2.0e9,
            'params': params_count(model)}
