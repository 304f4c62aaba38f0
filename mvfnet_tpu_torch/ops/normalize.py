"""On-device input normalization (counterpart of ``mvfnet_tpu/ops/normalize.py``).

The host ships uint8 BGR frames; this op runs on the device that holds
them: cast to float32, optional /255, BGR->RGB channel flip, mean/std
affine, then one cast to the compute dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def device_normalize(imgs: torch.Tensor,
                     norm_cfg: Dict[str, Any],
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """imgs: (..., C) uint8 (or float) channels-last; returns the normalized
    tensor in ``compute_dtype`` (float32 when None), on ``imgs.device``."""
    x = imgs.to(torch.float32)
    if norm_cfg.get('div_255'):
        x = x / 255.0
    if norm_cfg.get('to_rgb') and x.shape[-1] == 3:
        x = x.flip(-1)
    mean = torch.tensor(norm_cfg['mean'], dtype=torch.float32, device=x.device)
    std = torch.tensor(norm_cfg['std'], dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(compute_dtype or torch.float32)


def maybe_device_normalize(imgs: torch.Tensor, norm_cfg, compute_dtype=None):
    """Apply only when the pipeline deferred normalization to the device."""
    if norm_cfg and norm_cfg.get('device'):
        return device_normalize(imgs, norm_cfg, compute_dtype)
    if compute_dtype is not None:
        return imgs.to(compute_dtype)
    return imgs
