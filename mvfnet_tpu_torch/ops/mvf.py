"""Multi-View Fusion core op on channels-last tensors.

Counterpart of ``mvfnet_tpu/ops/mvf.py``. Three depthwise 3-taps, one each
along T, H and W of an ``(N, T, H, W, C)`` tensor, summed, with zero
boundaries. Each view's weights are ``(3, C)``: ``w[0]`` multiplies the
previous element, ``w[1]`` the centre, ``w[2]`` the next — torch
``Conv3d(groups=C, kernel_size=3, padding=1)`` semantics.

Plain PyTorch: the op is not a Pallas kernel in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """x * hard_sigmoid(x)."""
    return x * hard_sigmoid(x)


def _shift(x: torch.Tensor, dim: int, delta: int) -> torch.Tensor:
    """out[i] = x[i + delta] along ``dim``, zero-padded at the boundary."""
    n = x.shape[dim]
    if delta == -1:
        pad = (1, 0)
        start = 0
    elif delta == 1:
        pad = (0, 1)
        start = 1
    else:
        raise ValueError(delta)
    # F.pad counts dims from the last one
    spec = [0, 0] * (x.ndim - 1 - dim % x.ndim) + list(pad)
    return F.pad(x, spec).narrow(dim, start, n)


def dw3(x: torch.Tensor, w: torch.Tensor, dim: int) -> torch.Tensor:
    """Depthwise 3-tap conv along ``dim`` of channels-last x.

    x: (..., C); w: (3, C). out[i] = w0*x[i-1] + w1*x[i] + w2*x[i+1].
    """
    w = w.to(x.dtype)
    return (_shift(x, dim, -1) * w[0]
            + x * w[1]
            + _shift(x, dim, 1) * w[2])


def mvf_conv_sum(x: torch.Tensor,
                 w_t: torch.Tensor,
                 w_h: Optional[torch.Tensor],
                 w_w: Optional[torch.Tensor],
                 mode: str = 'THW') -> torch.Tensor:
    """Sum of the per-view depthwise 3-taps on x: (N, T, H, W, C).

    ``mode`` selects the active views; ``share=True`` callers pass the T
    weights for every view.
    """
    if x.ndim != 5:
        raise ValueError(f'expected (N,T,H,W,C), got {tuple(x.shape)}')
    y = dw3(x, w_t, dim=1)
    if mode in ('TH', 'THW'):
        y = y + dw3(x, w_h, dim=2)
    if mode == 'THW':
        y = y + dw3(x, w_w, dim=3)
    return y
