"""Shared model building blocks (counterpart of ``mvfnet_tpu/models/common.py``).

Params are fp32; each layer computes in the dtype of its input, which the
recognizer sets from the config's ``compute_dtype``. Tensors inside the
models are NCHW in ``torch.channels_last`` memory format, so cuDNN and the
hand kernels both see NHWC bytes; the 3-D families' volumes are NCTHW in
``torch.channels_last_3d``, the NTHWC bytes of the JAX package's layout and
of the data pipeline's ``FormatShape('NTHWC')``, so that entering the
backbone is a view and cuDNN picks its channels-last 3-D convolutions.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.mvf import hard_sigmoid

# torch BatchNorm defaults; flax's momentum 0.9 weighs the OLD statistics,
# torch's 0.1 the new ones: the same update
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the batch of every rank of ``group``,
    in the dtype of ``x`` (the caller's statistics dtype), with
    ``all_reduce`` alone (gloo has nothing else for CUDA tensors).

    Forward: one all_reduce of ``[count, sum x]`` gives the global mean,
    one of ``sum (x - mean)^2`` the global M2 (two passes: no
    ``E[x^2] - E[x]^2`` cancellation). The running variance stores the
    unbiased global variance. Backward: one all_reduce of
    ``[sum dy, sum dy * xhat]`` for the input's gradient; the affine's
    gradients are this rank's sums, which the data-parallel average turns
    into the global ones.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, group):
        import torch.distributed as dist
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        view = (1, c) + (1,) * (x.dim() - 2)
        head = torch.cat([x.new_full((1,), x.numel() // c), x.sum(dims)])
        dist.all_reduce(head, group=group)
        count, mean = head[0], head[1:] / head[0]
        xc = x - mean.view(view)
        m2 = (xc * xc).sum(dims)
        dist.all_reduce(m2, group=group)
        invstd = torch.rsqrt(m2 / count + eps)
        xhat = xc * invstd.view(view)
        unbiased = m2 / (count - 1).clamp(min=1)
        with torch.no_grad():      # torch's update: (1 - m) old + m new
            for buf, new in ((running_mean, mean), (running_var, unbiased)):
                buf.mul_(1 - momentum).add_(new.to(buf.dtype) * momentum)
        ctx.save_for_backward(xhat, weight, invstd, count)
        ctx.group = group
        return xhat * weight.to(x.dtype).view(view) \
            + bias.to(x.dtype).view(view)

    @staticmethod
    def backward(ctx, dy):
        import torch.distributed as dist
        xhat, weight, invstd, count = ctx.saved_tensors
        c = xhat.shape[1]
        dims = [0] + list(range(2, xhat.dim()))
        view = (1, c) + (1,) * (xhat.dim() - 2)
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        mean_dy, mean_dy_xhat = (sums / count).view(2, c)
        dx = (dy - mean_dy.view(view) - xhat * mean_dy_xhat.view(view)) \
            * (weight.to(dy.dtype) * invstd).view(view)
        grad_b, grad_w = local.view(2, c)
        return (dx, grad_w.to(weight.dtype), grad_b.to(weight.dtype),
                None, None, None, None, None)


class BatchNorm(nn.BatchNorm2d):
    """torch BatchNorm whose statistics and affine run in at least fp32.

    Any input rank with channels on dim 1. In train mode the batch is
    normalized with the biased variance and the running variance stores the
    unbiased one (torch semantics). The output is cast back to the input's
    dtype: bf16 in, bf16 out, with one rounding.

    With a process group in ``sync_group`` (``set_sync_group``), train mode
    normalizes with the statistics of the whole batch across the group's
    ranks, which is what one process computes on the concatenated batch;
    the state dict and eval are unchanged.
    """

    sync_group = None
    stats_frozen = False        # see frozen_norm_statistics

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f'expected at least 2-D input, got {x.dim()}-D')

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """BatchNorm of ``x``, already in the statistics dtype. Under
        ``frozen_norm_statistics`` the same calls run on copies of the
        running statistics, so that a checkpointed forward's recompute
        saves what its first run saved and updates nothing."""
        mean, var = self.running_mean, self.running_var
        frozen = self.training and self.stats_frozen
        if frozen:
            mean, var = mean.clone(), var.clone()
        if not (self.training and self.sync_group is not None):
            if frozen:
                return F.batch_norm(x, mean, var, self.weight, self.bias,
                                    True, self.momentum, self.eps)
            return super().forward(x)
        if not frozen:
            self.num_batches_tracked.add_(1)
        return _SyncBatchNorm.apply(x, self.weight, self.bias, mean, var,
                                    self.eps, self.momentum, self.sync_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat = torch.promote_types(x.dtype, torch.float32)
        return self.normalize(x.to(stat)).to(x.dtype)


@contextlib.contextmanager
def frozen_norm_statistics(module: nn.Module):
    """Inside: every train-mode ``BatchNorm`` of ``module`` normalizes with
    its batch statistics (all-reduced across the sync group as usual) and
    leaves its running statistics and ``num_batches_tracked`` as they are.
    The recompute context of ``torch.utils.checkpoint``: ``jax.checkpoint``
    recomputes values, never state updates."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.stats_frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.stats_frozen = False


class GroupNorm(nn.GroupNorm):
    """torch GroupNorm whose statistics and affine run in at least fp32,
    cast back to the input's dtype, like ``BatchNorm`` (flax's
    ``GroupNorm`` with ``param_dtype=float32``). No running statistics: it
    normalizes the same way in train and eval."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat = torch.promote_types(x.dtype, torch.float32)
        return super().forward(x.to(stat)).to(x.dtype)


def set_sync_group(model: nn.Module, group) -> int:
    """Set (a process group) or clear (None) the statistics group of every
    ``BatchNorm`` of ``model``, the MVF modules' included; returns how
    many. GroupNorm keeps no batch statistics and is not touched."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.sync_group = group
    return len(norms)


def make_norm(norm_cfg: Optional[Dict[str, Any]], num_features: int
              ) -> nn.Module:
    """Build a norm layer from a ``dict(type='BN'|'SyncBN'|'BN3d'|'GN',
    ...)`` node. ``requires_grad`` is a training concern and is ignored
    here, and so is 'SyncBN': the train step syncs every BatchNorm across
    ranks unless the config asks for per-rank statistics (``local_bn``), as
    the JAX package does. 'GN' takes ``num_groups`` and the BatchNorm eps."""
    cfg = dict(norm_cfg or {'type': 'BN'})
    norm_type = cfg.pop('type', 'BN')
    cfg.pop('requires_grad', None)
    if norm_type in ('BN', 'BN3d', 'SyncBN'):
        return BatchNorm(num_features, eps=BN_EPS, momentum=BN_MOMENTUM,
                         **cfg)
    if norm_type == 'GN':
        return GroupNorm(cfg.pop('num_groups'), num_features, eps=BN_EPS,
                         **cfg)
    raise KeyError(f'Unrecognized norm type {norm_type}')


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


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` that casts its fp32 weight to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv3d(in_channels: int, out_channels: int, kernel: Tuple[int, ...], *,
           stride: Tuple[int, ...] = (1, 1, 1),
           padding: Optional[Tuple[int, ...]] = None,
           dilation: Tuple[int, ...] = (1, 1, 1), groups: int = 1,
           bias: bool = False) -> Conv3d:
    """torch-semantics Conv3d on NCTHW, no bias by default; ``padding``
    defaults to ``(k - 1) // 2`` per axis (the JAX package's ``conv3d``,
    ``backbones/resnet_i3d.py:27-54``)."""
    kernel = tuple(kernel)
    if padding is None:
        padding = tuple((k - 1) // 2 for k in kernel)
    return Conv3d(in_channels, out_channels, kernel, stride=tuple(stride),
                  padding=tuple(padding), dilation=tuple(dilation),
                  groups=groups, bias=bias)


def max_pool3d(x: torch.Tensor, kernel, stride, padding) -> torch.Tensor:
    """``MaxPool3d(kernel, stride, padding)`` on NCTHW; padding never wins
    the max."""
    return F.max_pool3d(x, tuple(kernel), tuple(stride), tuple(padding))


def avg_pool3d(x: torch.Tensor, kernel, stride, padding=(0, 0, 0),
               count_include_pad: bool = True,
               ceil_mode: bool = False) -> torch.Tensor:
    """``AvgPool3d`` on NCTHW, in x's dtype: the avd layer's ``(1, 3, 3)``
    window with padding ``(0, 1, 1)`` and avg_down's ``(1, s, s)`` ceil-mode
    window without the padding in its count. Below the window the ceil-mode
    pool gives one value, as torch does (the JAX package's ``avg_pool3d``
    gives an empty map, as its 2-D pool does)."""
    return F.avg_pool3d(x, tuple(kernel), tuple(stride), tuple(padding),
                        ceil_mode=ceil_mode,
                        count_include_pad=count_include_pad)


class SEModule(nn.Module):
    """Squeeze-and-excitation on NC... input of any spatial rank (the
    reference's SE3D, ``se_module.py:27-67``, and the JAX package's
    ``SEModule``): the mean over every axis after the channels, ``fc1``,
    relu, ``fc2``, a sigmoid (hard with ``use_hs``), and the scale. ``fc1``
    and ``fc2`` keep the reference's 1x1x1 ``Conv3d`` weights with biases;
    they run as matrix products on the pooled vector."""

    def __init__(self, channels: int, reduction: int = 16,
                 use_hs: bool = False):
        super().__init__()
        self.use_hs = use_hs
        self.fc1 = conv3d(channels, channels // reduction, (1, 1, 1),
                          bias=True)
        self.fc2 = conv3d(channels // reduction, channels, (1, 1, 1),
                          bias=True)

    @staticmethod
    def _fc(fc: Conv3d, y: torch.Tensor) -> torch.Tensor:
        return F.linear(y, fc.weight.flatten(1).to(y.dtype),
                        fc.bias.to(y.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=tuple(range(2, x.ndim)))
        y = self._fc(self.fc2, torch.relu(self._fc(self.fc1, y)))
        y = hard_sigmoid(y) if self.use_hs else torch.sigmoid(y)
        return x * y.reshape(y.shape + (1,) * (x.ndim - 2))


def max_pool_same_as_torch(window: int = 3, stride: int = 2,
                           padding: int = 1) -> nn.MaxPool2d:
    """``MaxPool2d(window, stride, padding)``: padding never wins the max."""
    return nn.MaxPool2d(window, stride, padding)


def avg_pool_torch(x: torch.Tensor, window: int, stride: int,
                   padding: int = 0, count_include_pad: bool = True,
                   ceil_mode: bool = False) -> torch.Tensor:
    """``AvgPool2d(window, stride, padding, ceil_mode, count_include_pad)``
    on NCHW x, in its dtype. The two configurations the reference uses: the
    avd layer's ``AvgPool2d(3, s, padding=1)`` and avg_down's
    ``AvgPool2d(s, s, ceil_mode=True, count_include_pad=False)``. On a map
    smaller than the window the ceil-mode pool gives one value, as torch
    does; the JAX package's ``avg_pool_torch`` gives an empty map."""
    return F.avg_pool2d(x, window, stride, padding, ceil_mode=ceil_mode,
                        count_include_pad=count_include_pad)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> NHWC view."""
    return x.permute(0, 2, 3, 1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_ncthw(x: torch.Tensor) -> torch.Tensor:
    """NTHWC -> NCTHW view (channels_last_3d when x is contiguous)."""
    return x.permute(0, 4, 1, 2, 3)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """N(0, 1/fan_in) init of a conv kernel, as the JAX package's
    ``lecun_normal`` (untruncated)."""
    fan_in = weight[0].numel()
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator)
                     * fan_in ** -0.5)
