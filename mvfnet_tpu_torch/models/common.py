"""Shared model building blocks (counterpart of ``mvfnet_tpu/models/common.py``).

Params are fp32; each layer computes in the dtype of its input, which the
recognizer sets from the config's ``compute_dtype``. Tensors inside the
models are NCHW in ``torch.channels_last`` memory format, so cuDNN and the
hand kernels both see NHWC bytes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

# torch BatchNorm defaults; flax's momentum 0.9 weighs the OLD statistics,
# torch's 0.1 the new ones: the same update
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class BatchNorm(nn.BatchNorm2d):
    """torch BatchNorm whose statistics and affine run in at least fp32.

    Any input rank with channels on dim 1. In train mode the batch is
    normalized with the biased variance and the running variance stores the
    unbiased one (torch semantics). The output is cast back to the input's
    dtype: bf16 in, bf16 out, with one rounding.
    """

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f'expected at least 2-D input, got {x.dim()}-D')

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat = torch.promote_types(x.dtype, torch.float32)
        return super().forward(x.to(stat)).to(x.dtype)


def make_norm(norm_cfg: Optional[Dict[str, Any]], num_features: int
              ) -> nn.Module:
    """Build a norm layer from a ``dict(type='BN'|'SyncBN'|'BN3d', ...)``
    node. ``requires_grad`` is a training concern and is ignored here."""
    cfg = dict(norm_cfg or {'type': 'BN'})
    norm_type = cfg.pop('type', 'BN')
    cfg.pop('requires_grad', None)
    if norm_type in ('BN', 'BN3d', 'SyncBN'):
        return BatchNorm(num_features, eps=BN_EPS, momentum=BN_MOMENTUM,
                         **cfg)
    raise NotImplementedError(f'norm type {norm_type} is not ported yet')


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that casts its fp32 weight to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv2d(in_channels: int, out_channels: int, kernel_size: int, *,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           bias: bool = False) -> Conv2d:
    """torch-semantics Conv2d, no bias by default (the ResNet convention)."""
    return Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, dilation=dilation, bias=bias)


def max_pool_same_as_torch(window: int = 3, stride: int = 2,
                           padding: int = 1) -> nn.MaxPool2d:
    """``MaxPool2d(window, stride, padding)``: padding never wins the max."""
    return nn.MaxPool2d(window, stride, padding)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> NHWC view."""
    return x.permute(0, 2, 3, 1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """N(0, 1/fan_in) init of a conv kernel, as the JAX package's
    ``lecun_normal`` (untruncated)."""
    fan_in = weight[0].numel()
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator)
                     * fan_in ** -0.5)
