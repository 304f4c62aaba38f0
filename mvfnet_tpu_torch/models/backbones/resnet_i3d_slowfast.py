"""SlowFast two-pathway I3D ResNet (counterpart of
``mvfnet_tpu/models/backbones/resnet_i3d_slowfast.py``).

Input: (N, C, T, H, W) full-rate frames. The slow pathway takes every
``tau``-th frame, the fast one every ``tau / alpha``-th, with ``1 /
beta_inv`` of the slow channels. Before each slow stage but the first the
fast maps join the slow ones through a (5, 1, 1) conv of temporal stride
``alpha`` (the lateral), concatenated on the channels; the stems' outputs
join the same way. Every temporal stride in the stages is 1. ``slow_only``
and ``fast_only`` run one pathway. Module names are the reference's, so its
checkpoints load: ``slow_path.{conv1,bn1,layer{i}.{j}...}``,
``fast_path...``, and the laterals ``slow_path.conv1_lateral`` and
``slow_path.layer{1,2,3}_lateral``; the reference's ``layer4_lateral``,
which its forward never uses, has no module here, as in the JAX package.

``fast_pack`` (the JAX package's time-to-channel packing of the fast
pathway) and ``stem_s2d`` (its space-to-depth stems) are TPU re-layouts
with the same parameters and the same scores: the port accepts both,
runs the fast pathway plain and takes the stems' space-to-depth form by
the input's size and dtype (``common.takes_space_to_depth``). Activation checkpointing
(``make_train_step(remat=True)``) checkpoints each stage, both pathways
and the lateral after them, while training. ``lateral_type`` and
``lateral_op`` take the one form the JAX module builds, a conv and a
concatenation.

Returns a ``(slow, fast)`` pair per out_index (one map in a one-pathway
mode), which ``I3DSlowFastClsHead`` pools.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..builder import BACKBONES
from ..common import conv3d, make_norm, max_pool3d
from .resnet_i3d import (ARCH_SETTINGS, init_weights_3d, make_res_layer,
                         norm_eval_train, per_block, run_stage)


class Pathway(nn.Module):
    """One pathway's stem (``conv1``, ``bn1``, the pool) and stages
    (``layer{i}``), and on the slow pathway the laterals that bring the
    fast maps in."""

    def __init__(self, in_channels: int, width: int, kernel_t: int,
                 stride_t: int, pool_kernel_t: int, pool_stride_t: int,
                 norm_cfg: Optional[Dict]):
        super().__init__()
        self.conv1 = conv3d(in_channels, width, (kernel_t, 7, 7),
                            stride=(stride_t, 2, 2),
                            padding=((kernel_t - 1) // 2, 3, 3))
        self.bn1 = make_norm(norm_cfg, width)
        self.pool1 = ((pool_kernel_t, 3, 3), (pool_stride_t, 2, 2),
                      (pool_kernel_t // 2, 1, 1))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool3d(torch.relu(self.bn1(self.conv1(x))), *self.pool1)


@BACKBONES.register_module
class ResNet_I3D_SlowFast(nn.Module):

    def __init__(self, depth: int, tau: int = 16,
                 alpha: int = 8, beta_inv: int = 8, num_stages: int = 4,
                 slow_only: bool = False, fast_only: bool = False,
                 lateral_type: str = 'conv', lateral_op: str = 'concat',
                 spatial_strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 slow_conv1_kernel_t: int = 1, slow_conv1_stride_t: int = 1,
                 slow_pool1_kernel_t: int = 1, slow_pool1_stride_t: int = 1,
                 fast_conv1_kernel_t: int = 5, fast_conv1_stride_t: int = 1,
                 fast_pool1_kernel_t: int = 1, fast_pool1_stride_t: int = 1,
                 style: str = 'pytorch', frozen_stages: int = -1,
                 slow_inflate_freq: Union[int, Sequence] = (0, 0, 1, 1),
                 fast_inflate_freq: Union[int, Sequence] = (1, 1, 1, 1),
                 inflate_style: str = '3x1x1',
                 norm_cfg: Optional[Dict] = None, norm_eval: bool = True,
                 pretrained_slow: Optional[str] = None,
                 pretrained_fast: Optional[str] = None, fast_pack: int = 0,
                 stem_s2d: Union[bool, str] = 'train'):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'invalid depth {depth} for resnet_i3d_slowfast')
        if (lateral_type, lateral_op) != ('conv', 'concat'):
            raise NotImplementedError(
                f'lateral {lateral_type}/{lateral_op}: the JAX package '
                'builds conv laterals joined by concatenation only')
        block_cls, stage_blocks = ARCH_SETTINGS[depth]
        self.tau, self.alpha = tau, alpha
        self.num_stages = num_stages
        self.out_indices = tuple(out_indices)
        self.slow_only, self.fast_only = slow_only, fast_only
        self.two_path = not (slow_only or fast_only)
        self.norm_eval = norm_eval
        self.frozen_stages = frozen_stages
        # set by make_train_step(remat=...), as the JAX step's remat
        self.with_cp = False
        beta = beta_inv
        opts = dict(style=style, inflate_style=inflate_style,
                    norm_cfg=norm_cfg)
        lateral_in = 64 * 2 // beta if self.two_path else 0
        slow_inf = per_block(slow_inflate_freq, num_stages)
        fast_inf = per_block(fast_inflate_freq, num_stages)
        slow_in, fast_in = 64, 64 // beta
        if not fast_only:
            self.slow_path = Pathway(3, 64, slow_conv1_kernel_t,
                                     slow_conv1_stride_t,
                                     slow_pool1_kernel_t,
                                     slow_pool1_stride_t, norm_cfg)
        if not slow_only:
            self.fast_path = Pathway(3, 64 // beta,
                                     fast_conv1_kernel_t,
                                     fast_conv1_stride_t,
                                     fast_pool1_kernel_t,
                                     fast_pool1_stride_t, norm_cfg)
        if self.two_path:
            self.slow_path.conv1_lateral = self._lateral(fast_in,
                                                         lateral_in)
        for i, num_blocks in enumerate(stage_blocks[:num_stages]):
            planes = 64 * 2 ** i
            if not fast_only:
                layer, slow_in = make_res_layer(
                    block_cls, slow_in, planes, num_blocks,
                    spatial_strides[i], 1, dilations[i], slow_inf[i],
                    lateral_in=lateral_in, **opts)
                self.slow_path.add_module(f'layer{i + 1}', layer)
            if not slow_only:
                layer, fast_in = make_res_layer(
                    block_cls, fast_in, planes // beta, num_blocks,
                    spatial_strides[i], 1, dilations[i], fast_inf[i],
                    **opts)
                self.fast_path.add_module(f'layer{i + 1}', layer)
            if self.two_path and i != num_stages - 1:
                lateral_in = fast_in * 2
                self.slow_path.add_module(f'layer{i + 1}_lateral',
                                          self._lateral(fast_in, lateral_in))

    def _lateral(self, channels: int, out_channels: int) -> nn.Module:
        return conv3d(channels, out_channels, (5, 1, 1),
                      stride=(self.alpha, 1, 1), padding=(2, 0, 0))

    init_weights = init_weights_3d

    def train(self, mode: bool = True):
        super().train(mode)
        norm_eval_train(self, mode)
        return self

    def _stage(self, i: int, x_slow, x_fast):
        """Stage ``i`` of both pathways, and the lateral after it."""
        name = f'layer{i + 1}'
        if x_slow is not None:
            x_slow = getattr(self.slow_path, name)(x_slow)
        if x_fast is not None:
            x_fast = getattr(self.fast_path, name)(x_fast)
        if self.two_path and i != self.num_stages - 1:
            lateral = getattr(self.slow_path, f'{name}_lateral')(x_fast)
            x_slow = torch.cat([x_slow, lateral], dim=1)
        return x_slow, x_fast

    def forward(self, x: torch.Tensor):
        """x: (N, C, T, H, W), any memory format; returns channels_last_3d
        maps."""
        x = x.contiguous(memory_format=torch.channels_last_3d)
        x_slow = x_fast = None
        if not self.fast_only:
            x_slow = self.slow_path.stem(x[:, :, ::self.tau])
        if not self.slow_only:
            x_fast = self.fast_path.stem(x[:, :, ::self.tau // self.alpha])
        if self.two_path:
            x_slow = torch.cat(
                [x_slow, self.slow_path.conv1_lateral(x_fast)], dim=1)
        remat = self.with_cp and self.training and torch.is_grad_enabled()
        outs = []
        for i in range(self.num_stages):
            x_slow, x_fast = run_stage(
                self, lambda s, f, i=i: self._stage(i, s, f), x_slow, x_fast,
                remat=remat)
            if i in self.out_indices:
                outs.append((x_slow, x_fast) if self.two_path
                            else x_fast if self.fast_only else x_slow)
        return outs[0] if len(outs) == 1 else tuple(outs)
