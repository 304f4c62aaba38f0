"""Dense-test step (counterpart of ``make_eval_step`` in
``mvfnet_tpu/engine/train_step.py``). The train step waits for a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ..ops.normalize import maybe_device_normalize


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``device`` or CUDA; raises when CUDA is asked for and absent. The
    port never falls back to the CPU on its own."""
    device = torch.device(device if device is not None else 'cuda')
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; the port runs on the GPU '
                           "unless the caller passes device='cpu'")
    return device


def make_eval_step(model: torch.nn.Module,
                   norm_cfg: Optional[Dict[str, Any]] = None,
                   device: Union[None, str, torch.device] = None
                   ) -> Callable:
    """Build ``eval_step(model, imgs) -> scores`` for dense testing.

    ``imgs`` is a ``(B, S, H, W, C)`` array or tensor (uint8 when the
    pipeline deferred ``Normalize`` to the device, ``norm_cfg['device']``).
    The frames move to ``device`` (CUDA by default), are normalized there,
    and go through the model in ``eval()`` under ``torch.inference_mode()``.
    """
    device = resolve_device(device)
    model.to(device).eval()

    def eval_step(model, imgs):
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(imgs)
        imgs = imgs.to(device, non_blocking=True)
        with torch.inference_mode():
            imgs = maybe_device_normalize(imgs, norm_cfg,
                                          model.compute_dtype)
            return model(imgs, None, return_loss=False)

    return eval_step
