"""Inflated 3-D ResNet (counterpart of ``mvfnet_tpu/models/backbones/resnet_i3d.py``).

ResNet-18/34 (``BasicBlock3D``) and 50/101/152 (``Bottleneck3D``) on NCTHW
volumes in ``torch.channels_last_3d``. Module names follow the reference
torch I3D, so its checkpoints load as they are: ``conv1``, ``bn1``,
``layer{i}.{j}.{conv1,bn1,conv2,bn2,conv3,bn3,downsample.{0,1}}``, and the
deep stem's ``stem_conv{1,2,3}``/``stem_bn{1,2}``, as in the JAX package.

The options are the JAX module's: the inflate styles ('3x1x1' puts the
temporal taps in conv1, '3x3x3' in conv2) chosen per block by
``inflate_freq``, the stem's ``conv1_kernel``/``conv1_stride_t`` and pool1's
temporal kernel and strides, pool2 (a (2, 1, 1) max pool after stage 1,
off with ``no_pool2``), per-stage spatial and temporal strides and
dilations, the pytorch and caffe styles, ``avg_down``, ``avd``/``avd_first``
and ``deep_stem``. ``with_cp`` checkpoints each res-stage while training, as
the 2-D ``ResNet`` does. ``frozen_stages`` and ``norm_frozen`` freeze
parameters in the optimizer (``engine.optim.frozen_prefixes_from_backbone``)
and ``norm_eval`` keeps every BatchNorm in eval mode while training.
``partial_norm``, ``zero_init_residual`` and ``pretrained2d`` are accepted
and, as in the JAX module, change nothing here: the init is the JAX
package's for every conv, and a 2-D checkpoint is inflated by the importer
(``utils.checkpoint.import_torch_state_dict``, ``w3d[t] = w2d / kT``).
``stem_s2d`` selects the JAX package's space-to-depth form of the stem
conv, a TPU re-layout with the same parameter and the same values: the port
ignores it and takes that form by the input's size and dtype
(``common.takes_space_to_depth``). ``nonlocal_cfg`` puts a non-local block
(``modules.nonlocal_attention.build_nonlocal_block``) after each
bottleneck that ``nonlocal_stages`` and ``nonlocal_freq`` pick, as
``layer{i}.{j}.nonlocal_block``; a ``BasicBlock3D`` accepts and ignores
it, as in the JAX module. ``quant='int8'|'int8_static'`` is the eval-only
int8 path (``common.QuantConv3d``) of the block convs whose type
(``common.quant_conv3d_type``) ``quant_ops`` lists, default the spatial
ones, in the stages ``quant_stages`` selects; shortcuts and the stem stay
in the compute dtype, and training raises.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..builder import BACKBONES
from ..common import (BatchNorm, avg_pool3d, check_quant_stages, conv3d,
                      lecun_normal_, make_norm, max_pool3d,
                      quant_conv3d_type, refuse_quant_training)
from ..modules.nonlocal_attention import build_nonlocal_block
from .resnet import _recompute_contexts
from ...utils import tracing


def quant_for(quant, quant_ops, kernel):
    """The quant mode of a block conv with ``kernel``: ``quant`` where its
    type is in ``quant_ops``, else None."""
    if quant and quant_conv3d_type(tuple(kernel)) in quant_ops:
        return quant
    return None


class Downsample3D(nn.Sequential):
    """The shortcut projection ``(conv 1x1x1, norm)``, stride
    ``(ts, ss, ss)``. With ``avg_down`` an ``AvgPool3d((1, ss, ss),
    ceil_mode=True, count_include_pad=False)`` strides spatially first and
    the conv keeps the temporal stride; at a dilated stage the pool is
    skipped, and so is the spatial stride, as in the JAX module."""

    def __init__(self, inplanes: int, outplanes: int, spatial_stride: int,
                 temporal_stride: int, dilation: int, avg_down: bool,
                 norm_cfg: Optional[Dict]):
        ss, ts = spatial_stride, temporal_stride
        self.pool_stride = ss if (avg_down and dilation == 1) else 1
        stride = (ts, 1, 1) if avg_down else (ts, ss, ss)
        super().__init__(conv3d(inplanes, outplanes, (1, 1, 1),
                                stride=stride),
                         make_norm(norm_cfg, outplanes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_stride > 1:
            s = self.pool_stride
            x = avg_pool3d(x, (1, s, s), (1, s, s), ceil_mode=True,
                           count_include_pad=False)
        return super().forward(x)


class Bottleneck3D(nn.Module):
    """1x1x1 -> 3x3 -> 1x1x1 with the temporal taps where ``inflate_style``
    puts them (none when ``if_inflate`` is off, and then no temporal
    stride). ``avd`` (stride > 1 only): the conv keeps stride 1 and an
    ``AvgPool3d((1, 3, 3), (1, s, s), (0, 1, 1))`` strides after the second
    relu, or after the first with ``avd_first``. ``nonlocal_cfg`` adds a
    non-local block after the residual's relu."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, spatial_stride: int = 1,
                 temporal_stride: int = 1, dilation: int = 1,
                 with_downsample: bool = False, style: str = 'pytorch',
                 if_inflate: bool = True, inflate_style: str = '3x1x1',
                 norm_cfg: Optional[Dict] = None, avg_down: bool = False,
                 avd: bool = False, avd_first: bool = False,
                 nonlocal_cfg: Optional[Dict] = None,
                 quant: Optional[str] = None,
                 quant_ops: Sequence[str] = ('spatial',)):
        super().__init__()
        if style not in ('pytorch', 'caffe'):
            raise ValueError(f'style {style!r}')
        self.nonlocal_block = (build_nonlocal_block(dict(
            nonlocal_cfg, in_channels=planes * self.expansion))
            if nonlocal_cfg is not None else None)
        self.avd = avd and spatial_stride > 1
        self.avd_first = avd_first
        self.spatial_stride = spatial_stride
        ss = 1 if self.avd else spatial_stride
        ts, d = temporal_stride, dilation
        if style == 'pytorch':
            c1_s, c2_s, c1_t, c2_t = 1, ss, 1, ts
        else:
            c1_s, c2_s, c1_t, c2_t = ss, 1, ts, 1
        if if_inflate and inflate_style == '3x1x1':
            k1, p1, k2, p2 = (3, 1, 1), (1, 0, 0), (1, 3, 3), (0, d, d)
        elif if_inflate:                                    # '3x3x3'
            k1, p1, k2, p2 = (1, 1, 1), (0, 0, 0), (3, 3, 3), (1, d, d)
        else:
            k1, p1, k2, p2 = (1, 1, 1), (0, 0, 0), (1, 3, 3), (0, d, d)
            c1_t = c2_t = 1
        self.conv1 = conv3d(inplanes, planes, k1, stride=(c1_t, c1_s, c1_s),
                            padding=p1, quant=quant_for(quant, quant_ops, k1))
        self.bn1 = make_norm(norm_cfg, planes)
        self.conv2 = conv3d(planes, planes, k2, stride=(c2_t, c2_s, c2_s),
                            padding=p2, dilation=(1, d, d),
                            quant=quant_for(quant, quant_ops, k2))
        self.bn2 = make_norm(norm_cfg, planes)
        self.conv3 = conv3d(planes, planes * self.expansion, (1, 1, 1),
                            quant=quant_for(quant, quant_ops, (1, 1, 1)))
        self.bn3 = make_norm(norm_cfg, planes * self.expansion)
        self.downsample = (Downsample3D(inplanes, planes * self.expansion,
                                        spatial_stride, temporal_stride,
                                        dilation, avg_down, norm_cfg)
                           if with_downsample else None)

    def _avd(self, out: torch.Tensor) -> torch.Tensor:
        s = self.spatial_stride
        return avg_pool3d(out, (1, 3, 3), (1, s, s), (0, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        if self.avd and self.avd_first:
            out = self._avd(out)
        out = torch.relu(self.bn2(self.conv2(out)))
        if self.avd and not self.avd_first:
            out = self._avd(out)
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(out + identity)
        if self.nonlocal_block is not None:
            # NCTHW channels_last_3d <-> the module's NTHWC
            out = self.nonlocal_block(out.permute(0, 2, 3, 4, 1)).permute(
                0, 4, 1, 2, 3)
        return out


class BasicBlock3D(nn.Module):
    """3x3x3 (1x3x3 without inflation) twice, + shortcut. The convs are
    padded by ``dilation`` spatially but not dilated, as in the JAX module;
    ``inflate_style``, ``avg_down`` and ``avd`` do not apply."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, spatial_stride: int = 1,
                 temporal_stride: int = 1, dilation: int = 1,
                 with_downsample: bool = False, style: str = 'pytorch',
                 if_inflate: bool = True, inflate_style: str = '3x1x1',
                 norm_cfg: Optional[Dict] = None, avg_down: bool = False,
                 avd: bool = False, avd_first: bool = False,
                 nonlocal_cfg: Optional[Dict] = None,
                 quant: Optional[str] = None,
                 quant_ops: Sequence[str] = ('spatial',)):
        super().__init__()
        ss, ts, d = spatial_stride, temporal_stride, dilation
        k = (3, 3, 3) if if_inflate else (1, 3, 3)
        p = (1, d, d) if if_inflate else (0, d, d)
        q = quant_for(quant, quant_ops, k)
        self.conv1 = conv3d(inplanes, planes, k, stride=(ts, ss, ss),
                            padding=p, quant=q)
        self.bn1 = make_norm(norm_cfg, planes)
        self.conv2 = conv3d(planes, planes, k, padding=p, quant=q)
        self.bn2 = make_norm(norm_cfg, planes)
        self.downsample = (Downsample3D(inplanes, planes, ss, ts, d, False,
                                        norm_cfg)
                           if with_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


ARCH_SETTINGS = {
    18: (BasicBlock3D, (2, 2, 2, 2)),
    34: (BasicBlock3D, (3, 4, 6, 3)),
    50: (Bottleneck3D, (3, 4, 6, 3)),
    101: (Bottleneck3D, (3, 4, 23, 3)),
    152: (Bottleneck3D, (3, 8, 36, 3)),
}


def per_block(freq: Union[int, Sequence], stages: int) -> list:
    """An ``inflate_freq``: one int for every block, or one entry per stage
    that is an int for the stage's blocks or one per block."""
    return list(freq) if not isinstance(freq, int) else [freq] * stages


def make_res_layer(block_cls, inplanes: int, planes: int, num_blocks: int,
                   spatial_stride: int, temporal_stride: int, dilation: int,
                   inflate: Union[int, Sequence[int]], lateral_in: int = 0,
                   nonlocal_cfgs: Optional[Sequence[Optional[Dict]]] = None,
                   **block_opts) -> Tuple[nn.Sequential, int]:
    """One res-stage: the first block strides and projects the shortcut
    when it changes the shape (``lateral_in`` extra input channels come
    from a SlowFast lateral), block j gets ``nonlocal_cfgs[j]``; returns
    the stage and its output channels."""
    if isinstance(inflate, int):
        inflate = (inflate,) * num_blocks
    nonlocal_cfgs = nonlocal_cfgs or (None,) * num_blocks
    blocks = []
    for j in range(num_blocks):
        cur_in = inplanes + (lateral_in if j == 0 else 0)
        ss = spatial_stride if j == 0 else 1
        with_ds = j == 0 and (ss != 1 or
                              cur_in != planes * block_cls.expansion)
        blocks.append(block_cls(
            cur_in, planes, spatial_stride=ss,
            temporal_stride=temporal_stride if j == 0 else 1,
            dilation=dilation, with_downsample=with_ds,
            if_inflate=inflate[j] == 1, nonlocal_cfg=nonlocal_cfgs[j],
            **block_opts))
        inplanes = planes * block_cls.expansion
    return nn.Sequential(*blocks), inplanes


def init_weights_3d(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init: lecun-normal convs (biases zero), norm gamma 1
    beta 0."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.reset_parameters()


def norm_eval_train(backbone: nn.Module, mode: bool) -> None:
    """``backbone.norm_eval``: every BatchNorm of ``backbone`` in eval mode
    while it trains (the JAX modules' ``use_running_average``)."""
    if mode and backbone.norm_eval:
        for m in backbone.modules():
            if isinstance(m, BatchNorm):
                m.eval()


def run_stage(stage: nn.Module, fn, *xs, remat: bool):
    """``fn(*xs)``, checkpointed (recomputed in the backward with the
    stage's norm statistics left alone) when ``remat``."""
    if not remat:
        return fn(*xs)
    return checkpoint(fn, *xs, use_reentrant=False,
                      context_fn=functools.partial(_recompute_contexts,
                                                   stage))


@BACKBONES.register_module
class ResNet_I3D(nn.Module):
    """I3D ResNet on NCTHW volumes; the module docstring lists the
    options. Returns the maps of ``out_indices``, one tensor when there is
    one."""

    def __init__(self, depth: int, in_channels: int = 3, num_stages: int = 4,
                 spatial_strides: Sequence[int] = (1, 2, 2, 2),
                 temporal_strides: Sequence[int] = (1, 1, 1, 1),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 conv1_kernel: Sequence[int] = (5, 7, 7),
                 conv1_stride_t: int = 2, pool1_kernel_t: int = 1,
                 pool1_stride_t: int = 2, pool1_stride_s: int = 2,
                 style: str = 'pytorch', frozen_stages: int = -1,
                 inflate_freq: Union[int, Sequence] = (1, 1, 1, 1),
                 inflate_style: str = '3x1x1',
                 norm_cfg: Optional[Dict] = None,
                 nonlocal_stages: Sequence[int] = (-1,),
                 nonlocal_freq: Union[int, Sequence] = (0, 1, 1, 0),
                 nonlocal_cfg: Optional[Dict] = None, no_pool2: bool = False,
                 norm_eval: bool = True, norm_frozen: bool = False,
                 partial_norm: bool = False, avg_down: bool = False,
                 avd: bool = False, avd_first: bool = False,
                 deep_stem: bool = False, stem_width: int = 64,
                 pretrained: Optional[str] = None, pretrained2d: bool = True,
                 with_cp: bool = False, zero_init_residual: bool = True,
                 quant: Optional[str] = None,
                 quant_stages: Sequence[int] = (1, 1, 1, 1),
                 quant_ops: Sequence[str] = ('spatial',),
                 stem_s2d: Union[bool, str] = False):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'invalid depth {depth} for resnet_i3d')
        check_quant_stages(quant, quant_stages, num_stages)
        self.quant = quant
        block_cls, stage_blocks = ARCH_SETTINGS[depth]
        self.num_stages = num_stages
        self.out_indices = tuple(out_indices)
        self.no_pool2 = no_pool2
        self.norm_eval = norm_eval
        self.frozen_stages = frozen_stages
        self.deep_stem = deep_stem
        self.with_cp = with_cp
        if deep_stem:
            sw = stem_width
            self.stem_conv1 = conv3d(in_channels, sw, (1, 3, 3),
                                     stride=(1, 2, 2))
            self.stem_bn1 = make_norm(norm_cfg, sw)
            self.stem_conv2 = conv3d(sw, sw, (1, 3, 3))
            self.stem_bn2 = make_norm(norm_cfg, sw)
            self.stem_conv3 = conv3d(sw, 2 * sw, (1, 3, 3))
            inplanes = 2 * sw
        else:
            self.conv1 = conv3d(in_channels, 64, tuple(conv1_kernel),
                                stride=(conv1_stride_t, 2, 2))
            inplanes = 64
        self.bn1 = make_norm(norm_cfg, inplanes)
        self.pool1 = ((pool1_kernel_t, 3, 3),
                      (pool1_stride_t, pool1_stride_s, pool1_stride_s),
                      (pool1_kernel_t // 2, 1, 1))
        inflate = per_block(inflate_freq, 4)
        nonlocal_freq = per_block(nonlocal_freq, 4)
        block_opts = dict(style=style, inflate_style=inflate_style,
                          norm_cfg=norm_cfg, avg_down=avg_down, avd=avd,
                          avd_first=avd_first)
        for i, num_blocks in enumerate(stage_blocks[:num_stages]):
            nl = nonlocal_freq[i]
            if isinstance(nl, int):
                nl = (nl,) * num_blocks
            nl_cfg = nonlocal_cfg if i in nonlocal_stages else None
            layer, inplanes = make_res_layer(
                block_cls, inplanes, 64 * 2 ** i, num_blocks,
                spatial_strides[i], temporal_strides[i], dilations[i],
                inflate[i], nonlocal_cfgs=[nl_cfg if f == 1 else None
                                           for f in nl],
                quant=quant if quant and quant_stages[i] else None,
                quant_ops=tuple(quant_ops), **block_opts)
            self.add_module(f'layer{i + 1}', layer)

    init_weights = init_weights_3d

    def train(self, mode: bool = True):
        super().train(mode)
        norm_eval_train(self, mode)
        return self

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 (or the deep stem), bn1, ReLU and pool1; spanned
        ``model.stem`` with tracing on."""
        with tracing.span('model.stem'):
            if self.deep_stem:
                x = torch.relu(self.stem_bn1(self.stem_conv1(x)))
                x = torch.relu(self.stem_bn2(self.stem_conv2(x)))
                x = self.stem_conv3(x)
            else:
                x = self.conv1(x)
            return max_pool3d(torch.relu(self.bn1(x)), *self.pool1)

    def forward(self, x: torch.Tensor):
        """x: (N, C, T, H, W), any memory format; returns channels_last_3d
        maps."""
        refuse_quant_training(self.quant, self.training)
        x = self._stem(x.contiguous(memory_format=torch.channels_last_3d))
        remat = self.with_cp and self.training and torch.is_grad_enabled()
        outs = []
        for i in range(self.num_stages):
            stage = getattr(self, f'layer{i + 1}')
            x = run_stage(stage, stage, x, remat=remat)
            if i in self.out_indices:
                outs.append(x)
            if not self.no_pool2 and i == 0:
                x = max_pool3d(x, (2, 1, 1), (2, 1, 1), (0, 0, 0))
        return outs[0] if len(outs) == 1 else tuple(outs)
