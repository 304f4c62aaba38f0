"""2-D ResNet backbone (counterpart of ``mvfnet_tpu/models/backbones/resnet.py``).

ResNet-18/34 (``BasicBlock``) and 50/101/152 (``Bottleneck``). Module names
follow the reference torch ResNet, so its checkpoints load as they are:
``conv1``, ``bn1``, ``layer{i}.{j}.{conv1,bn1,conv2,bn2,conv3,bn3,
downsample.{0,1}}``, and an MVF-wrapped ``conv1`` as ``conv1.{net,
shift_conv,h_conv,w_conv,bn}``, CoST in place of conv2 as
``conv2.{shift_conv,bn}``, and a block a non-local block follows as
``layer{i}.{j}.{block,nl}`` (the reference's ``NL3DWrapper``); the deep
stem is ``stem_conv{1,2,3}``, ``stem_bn{1,2}`` and ``bn1``, as in the JAX
package. The avg_down shortcut
keeps the names ``downsample.{0,1}`` (conv, norm): its pool has no
parameters and runs inside ``Downsample.forward``. The JAX package's TPU
re-layouts of conv1 (``_SplitPointwiseConv``) and of the stem
(``_SpaceToDepthStem``) are plain convs here; the same parameters load.

In ``eval()`` with no gradient recorded, each stride-1 bottleneck with
BatchNorm and without a downsample or temporal module (MVF, CoST) folds
its three BatchNorms into the conv weights and runs as one fused call,
``ops.fused_block.bottleneck_eval``: the hand-written CUDA kernel on the
card, its plain version on the CPU; a block a non-local block follows
fuses too. Under the same condition every other (plain conv, BatchNorm)
pair runs as one conv with the BN folded into its weight and bias
(``common.fold_conv_bn``, ``common.folded_conv``), its ReLU and residual
add after it, in cuDNN's epilogue for bf16 on the card: the stem (the
deep stem's three pairs), each downsample, the three pairs of every other
Bottleneck (an MVF block's conv1 after the fusion; a CoST block's conv1
and conv3) and BasicBlock's two. The fp32 BatchNorm keeps running for
GroupNorm blocks, the int8 path's quantized convs, a CoST block's
``bn2`` (it follows CoST, not a conv), and in training. The folded
weights are cached per module (``_FoldsNorms``).

``with_cp`` (activation checkpointing) runs each res-stage through
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` while the
backbone trains with gradients on: only the stage boundaries are kept for
the backward, and each stage's forward runs again inside it. Per stage,
not per block, because the JAX package applies its remat to the whole
forward and a stage holds fewer boundaries than its blocks; the extra
compute is one forward either way. The recomputed forward runs under
``common.frozen_norm_statistics``, so BatchNorm (MVF's too) moves its
running statistics once a step, as without checkpointing.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ...ops import fused_block as fb
from ..builder import BACKBONES
from ..common import (BatchNorm, QuantConv2d, avg_pool_torch,
                      bn_affine, check_quant_stages, conv2d, fold_conv_bn,
                      foldable, folded_conv, frozen_norm_statistics,
                      lecun_normal_, make_norm, max_pool_same_as_torch,
                      refuse_quant_training, to_nchw, to_nhwc)
from ..modules.cost import CoST
from ..modules.mvf import MVF
from ..modules.nonlocal_attention import (LocalAttention, NonLocal2D,
                                          nonlocal_block_indices)


class _FoldsNorms(nn.Module):
    """A module whose eval forward folds BatchNorm into the conv before it.

    The folded weights are made once after ``eval()``, a move or a load,
    and again only when one of their source tensors is changed in place
    (its version counter moves) or the dtype changes; ``train()`` and
    ``_apply`` drop them."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._folded = {}

    def train(self, mode: bool = True):
        # BN statistics updated in training bump no version counter
        self._folded.clear()
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self._folded.clear()
        return super()._apply(fn, *args, **kwargs)

    @property
    def folding(self) -> bool:
        """Eval with no gradient recorded: the BatchNorms fold."""
        return not self.training and not torch.is_grad_enabled()

    def _cached(self, name: str, dtype: torch.dtype, tensors, make):
        """``make()``, kept under ``name`` while ``dtype`` and the storage
        and version of each of ``tensors`` stay as they were."""
        key = (dtype,) + tuple((t.data_ptr(), t._version) for t in tensors)
        hit = self._folded.get(name)
        if hit is None or hit[0] != key:
            hit = self._folded[name] = (key, make())
        return hit[1]

    def _conv_norm(self, name: str, conv: nn.Module, norm: nn.Module,
                   x: torch.Tensor, relu: bool = False,
                   shortcut: Optional[Callable[[], torch.Tensor]] = None
                   ) -> torch.Tensor:
        """``norm(conv(x))``, ``+ shortcut()``, then the ReLU if ``relu``.
        While folding, a plain conv (an MVF-wrapped one's after the
        fusion) and a BatchNorm run as one folded conv, its weights cached
        under ``name``, the shortcut computed first; otherwise after the
        norm, as the JAX package orders them."""
        net = conv.net if isinstance(conv, MVF) else conv
        if self.folding and foldable(net, norm):
            if net is not conv:
                x = conv.fuse(x)
            w, b = self._cached(
                name, x.dtype, (net.weight, norm.weight, norm.bias,
                                norm.running_mean, norm.running_var),
                lambda: fold_conv_bn(net, norm, x.dtype))
            return folded_conv(x, net, w, b, relu,
                               None if shortcut is None else shortcut())
        out = norm(conv(x))
        if shortcut is not None:
            out = out + shortcut()
        return torch.relu(out) if relu else out


class Downsample(_FoldsNorms, nn.Sequential):
    """The shortcut projection ``(conv 1x1, norm)``. With ``avg_down`` an
    ``AvgPool2d(s, s, ceil_mode=True, count_include_pad=False)`` runs
    first and the conv has stride 1; at a dilated stage the pool is
    skipped (reference ``make_res_layer``)."""

    def __init__(self, inplanes: int, outplanes: int, stride: int,
                 dilation: int, avg_down: bool, norm_cfg: Optional[Dict],
                 quant: Optional[str] = None):
        self.pool_stride = stride if (avg_down and dilation == 1) else 1
        super().__init__(
            conv2d(inplanes, outplanes, 1,
                   stride=1 if avg_down else stride, quant=quant),
            make_norm(norm_cfg, outplanes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_stride > 1:
            x = avg_pool_torch(x, self.pool_stride, self.pool_stride,
                               ceil_mode=True, count_include_pad=False)
        return self._conv_norm('1', self[0], self[1], x)


def _shortcut(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return x if block.downsample is None else block.downsample(x)


def _is_cost(temporal_cfg: Optional[Dict]) -> bool:
    return bool(temporal_cfg) and temporal_cfg.get('type') == 'CoST'


def _mvf_split(temporal_cfg: Optional[Dict], inplanes: int,
               quant: Optional[str]) -> int:
    """The MVF channels a quantized bottleneck's conv1 scales apart from the
    rest (JAX ``_SplitPointwiseConv``), 0 for an unquantized or MVF-less
    block."""
    if not quant or not temporal_cfg or temporal_cfg.get('type') != 'MVF':
        return 0
    return int(inplanes * temporal_cfg.get('alpha', 0.5))


def _wrap_temporal(conv: nn.Module, temporal_cfg: Optional[Dict],
                   inplanes: int) -> nn.Module:
    """``conv`` wrapped in the temporal module (MVF), the reference's
    ``blocks[i].conv1 = MVF(b.conv1, ...)``; CoST leaves conv1 alone (it
    replaces a bottleneck's conv2)."""
    if temporal_cfg is None or _is_cost(temporal_cfg):
        return conv
    cfg = dict(temporal_cfg)
    kind = cfg.pop('type')
    if kind != 'MVF':
        raise KeyError(f'Unknown temporal module {kind}')
    return MVF(conv, in_channels=inplanes, **cfg)


class BasicBlock(_FoldsNorms):
    """ResNet BasicBlock: 3x3 (stride, dilation) -> norm -> relu -> 3x3 ->
    norm, + shortcut, relu. ``temporal_cfg`` wraps conv1, a 3x3 conv that
    may have stride 2."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, with_downsample: bool = False,
                 style: str = 'pytorch', norm_cfg: Optional[Dict] = None,
                 avg_down: bool = False,
                 temporal_cfg: Optional[Dict] = None,
                 quant: Optional[str] = None):
        super().__init__()
        if style not in ('pytorch', 'caffe'):
            raise ValueError(f'style {style!r}')
        if _is_cost(temporal_cfg):
            raise NotImplementedError(
                'CoST in a BasicBlock: the reference places CoST only in '
                'bottlenecks (ROADMAP.md, section C)')
        self.conv1 = _wrap_temporal(
            conv2d(inplanes, planes, 3, stride=stride, padding=dilation,
                   dilation=dilation, quant=quant), temporal_cfg, inplanes)
        self.bn1 = make_norm(norm_cfg, planes)
        self.conv2 = conv2d(planes, planes, 3, padding=1, quant=quant)
        self.bn2 = make_norm(norm_cfg, planes)
        self.downsample = (Downsample(inplanes, planes, stride, dilation,
                                      avg_down, norm_cfg, quant)
                           if with_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._conv_norm('bn1', self.conv1, self.bn1, x, relu=True)
        return self._conv_norm('bn2', self.conv2, self.bn2, out, relu=True,
                               shortcut=lambda: _shortcut(self, x))


class Bottleneck(_FoldsNorms):
    """ResNet Bottleneck; ``temporal_cfg`` wraps conv1 in MVF, the
    reference's ``blocks[i].conv1 = MVF(b.conv1, ...)``, or replaces conv2
    with CoST.

    ``avd`` (with ``stride > 1`` only): the 3x3 conv keeps stride 1 and an
    ``AvgPool2d(3, stride, padding=1)`` strides instead, after the second
    relu, or after the first with ``avd_first``.

    ``quant`` makes the convs int8 (CoST and MVF's taps stay in the
    compute dtype; an MVF-wrapped conv1 scales the MVF channels apart from
    the rest). ``quant_carry`` with ``int8_static`` runs conv1 -> conv2 ->
    conv3 as the integer carry (``common.IntCarry``) outside calibration,
    in blocks without avd or a temporal module whose norms are
    BatchNorms."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, with_downsample: bool = False,
                 style: str = 'pytorch', norm_cfg: Optional[Dict] = None,
                 avg_down: bool = False, avd: bool = False,
                 avd_first: bool = False,
                 temporal_cfg: Optional[Dict] = None,
                 quant: Optional[str] = None, quant_carry: bool = False):
        super().__init__()
        if style not in ('pytorch', 'caffe'):
            raise ValueError(f'style {style!r}')
        self.quant = quant
        self.quant_carry = quant_carry
        self.stride = stride
        self.dilation = dilation
        self.style = style
        self.avd = avd and stride > 1
        self.avd_first = avd_first
        conv_stride = 1 if self.avd else stride
        conv1_stride, conv2_stride = ((1, conv_stride) if style == 'pytorch'
                                      else (conv_stride, 1))
        self.has_temporal = temporal_cfg is not None
        self.conv1 = _wrap_temporal(
            conv2d(inplanes, planes, 1, stride=conv1_stride, quant=quant,
                   split=_mvf_split(temporal_cfg, inplanes, quant)),
            temporal_cfg, inplanes)
        self.bn1 = make_norm(norm_cfg, planes)
        if _is_cost(temporal_cfg):
            # CoST replaces conv2 (the reference's make_CoST)
            self.conv2 = CoST(temporal_cfg['n_segment'], planes)
        else:
            self.conv2 = conv2d(planes, planes, 3, stride=conv2_stride,
                                padding=dilation, dilation=dilation,
                                quant=quant)
        self.bn2 = make_norm(norm_cfg, planes)
        self.conv3 = conv2d(planes, planes * self.expansion, 1, quant=quant)
        self.bn3 = make_norm(norm_cfg, planes * self.expansion)
        self.downsample = (Downsample(inplanes, planes * self.expansion,
                                      stride, dilation, avg_down, norm_cfg,
                                      quant)
                           if with_downsample else None)

    @property
    def fusable(self) -> bool:
        """Shapes the fused eval kernel computes: stride 1 (so no avd), no
        downsample, no temporal module (MVF or CoST), pytorch style,
        dilation 1, not quantized (the kernel computes in the compute
        dtype), and BatchNorms whose running statistics fold into the
        weights."""
        return (self.stride == 1 and self.downsample is None
                and not self.has_temporal and self.style == 'pytorch'
                and self.dilation == 1 and self.quant is None
                and all(isinstance(bn, BatchNorm)
                        for bn in (self.bn1, self.bn2, self.bn3)))

    def _avd(self, out: torch.Tensor) -> torch.Tensor:
        return avg_pool_torch(out, 3, self.stride, padding=1)

    @property
    def uses_carry(self) -> bool:
        """Whether this block runs the integer carry (JAX
        ``resnet.py:131-134``)."""
        return (self.quant == 'int8_static' and self.quant_carry
                and not self.avd and not self.has_temporal
                and not self.conv1.calibrating
                and all(isinstance(bn, BatchNorm)
                        for bn in (self.bn1, self.bn2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fusable and self.folding:
            return self._forward_fused(x)
        if self.uses_carry:
            return self._forward_carry(x)
        out = self._conv_norm('bn1', self.conv1, self.bn1, x, relu=True)
        if self.avd and self.avd_first:
            out = self._avd(out)
        out = self._conv_norm('bn2', self.conv2, self.bn2, out, relu=True)
        if self.avd and not self.avd_first:
            out = self._avd(out)
        return self._conv_norm('bn3', self.conv3, self.bn3, out, relu=True,
                               shortcut=lambda: _shortcut(self, x))

    def _forward_carry(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 -> conv2 -> conv3 exchanging int8: each BN affine and ReLU
        folded into the next conv's requantization."""
        out = self.conv1(x, carry_out=True)
        out = self.conv2(out, prev_affine=bn_affine(self.bn1),
                         carry_out=True)
        out = self.bn3(self.conv3(out, prev_affine=bn_affine(self.bn2)))
        return torch.relu(out + _shortcut(self, x))

    def _fused_weights(self, dtype: torch.dtype):
        """The three BNs folded into the weights (in fp32, then cast), stored
        output-channel-major for the kernel, cached as ``_FoldsNorms``
        caches."""
        pairs = ((self.conv1, self.bn1), (self.conv2, self.bn2),
                 (self.conv3, self.bn3))
        tensors = [t for conv, bn in pairs for t in (
            conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)]

        def fold():
            # kernels with the output channel last, as fold_bn expects
            kernels = (self.conv1.weight[:, :, 0, 0].t(),        # (Cin, Cm)
                       self.conv2.weight.permute(2, 3, 1, 0),    # HWIO
                       self.conv3.weight[:, :, 0, 0].t())        # (Cm, Cin)
            folded = []
            with torch.no_grad():
                for k, (_, bn) in zip(kernels, pairs):
                    w, b = fb.fold_bn(k, bn.weight, bn.bias, bn.running_mean,
                                      bn.running_var, bn.eps)
                    folded += [fb.out_major(w.to(dtype)), b.reshape(1, -1)]
            return folded

        return self._cached('fused', dtype, tensors, fold)

    def _forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        folded = self._fused_weights(x.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        return to_nchw(fb.bottleneck_eval(to_nhwc(x), *folded))


@BACKBONES.register_module
class ResNet(_FoldsNorms):
    """ResNet-18/34 (BasicBlock) and 50/101/152 (Bottleneck), torch
    state-dict names.

    ``temporal_cfg``: e.g. ``dict(type='MVF', n_segment=8, alpha=0.125,
    mode='THW')`` or ``dict(type='CoST', n_segment=8)``;
    ``temporal_freq``: per-stage 0/1 mask (the reference's ``mvf_freq`` /
    ``shift_freq``): MVF takes every block of a selected stage, CoST every
    block after the first. ``nonlocal_cfg=dict(n_segment=T)`` puts a
    non-local block after layer2's and layer3's blocks that
    ``nonlocal_block_indices`` picks (2 and 3 a stage).
    ``avg_down``, ``avd``/``avd_first`` (Bottleneck only), ``deep_stem``
    with ``stem_width`` and ``norm_cfg=dict(type='GN', num_groups=G)`` are
    the reference's options; ``with_cp`` checkpoints each res-stage while
    training (module docstring). ``stem_s2d`` and ``pretrained`` are
    accepted for config compatibility: the stem is the plain 7x7/s2/p3
    conv, and weights come from the checkpoint loader. ``frozen_stages``
    and ``norm_frozen`` freeze parameters in the optimizer, not here
    (``engine.optim.frozen_prefixes_from_backbone``); ``frozen_stages`` also
    picks the stages that ``partial_norm`` keeps in eval mode.

    ``quant='int8'|'int8_static'`` is the eval-only int8 path of the block
    convs (``common.QuantConv2d``) in the stages ``quant_stages`` selects;
    ``quant_carry`` runs the integer carry in ``int8_static`` bottlenecks
    and ``quant_stem`` quantizes the 7x7 stem too (with ``stem_s2d``, as
    the JAX package quantizes only its space-to-depth stem). The state
    dict is the unquantized model's; training raises.
    """
    arch_settings = {
        18: (BasicBlock, (2, 2, 2, 2)),
        34: (BasicBlock, (3, 4, 6, 3)),
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
        152: (Bottleneck, (3, 8, 36, 3)),
    }

    def __init__(self, depth: int, in_channels: int = 3, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 style: str = 'pytorch', frozen_stages: int = -1,
                 norm_cfg: Optional[Dict] = None, norm_eval: bool = True,
                 norm_frozen: bool = False,
                 partial_norm: bool = False, avg_down: bool = False,
                 avd: bool = False, avd_first: bool = False,
                 deep_stem: bool = False, stem_width: int = 64,
                 stem_s2d: bool = True,
                 temporal_cfg: Optional[Dict] = None,
                 temporal_freq: Sequence[int] = (0, 0, 0, 0),
                 nonlocal_cfg: Optional[Dict] = None,
                 pretrained: Optional[str] = None, with_cp: bool = False,
                 quant: Optional[str] = None,
                 quant_stages: Sequence[int] = (1, 1, 1, 1),
                 quant_carry: bool = False, quant_stem: bool = False):
        super().__init__()
        if depth not in self.arch_settings:
            raise KeyError(f'invalid depth {depth} for resnet')
        check_quant_stages(quant, quant_stages, num_stages)
        self.quant = quant
        block_cls, stage_blocks = self.arch_settings[depth]
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.partial_norm = partial_norm
        self.frozen_stages = frozen_stages
        self.deep_stem = deep_stem
        self.with_cp = with_cp
        if deep_stem:
            sw = stem_width
            self.stem_conv1 = conv2d(in_channels, sw, 3, stride=2,
                                     padding=1)
            self.stem_bn1 = make_norm(norm_cfg, sw)
            self.stem_conv2 = conv2d(sw, sw, 3, padding=1)
            self.stem_bn2 = make_norm(norm_cfg, sw)
            self.stem_conv3 = conv2d(sw, 2 * sw, 3, padding=1)
            inplanes = 2 * sw
        elif quant and quant_stem and stem_s2d:
            self.conv1 = QuantConv2d(in_channels, 64, 7, stride=2,
                                     padding=3, bias=False, quant=quant,
                                     stem=True)
            inplanes = 64
        else:
            self.conv1 = conv2d(in_channels, 64, 7, stride=2, padding=3)
            inplanes = 64
        self.bn1 = make_norm(norm_cfg, inplanes)
        self.maxpool = max_pool_same_as_torch(3, 2, 1)
        self.num_stages = num_stages
        block_opts = (dict(avd=avd, avd_first=avd_first,
                           quant_carry=quant_carry)
                      if block_cls is Bottleneck else {})
        for i, num_blocks in enumerate(stage_blocks[:num_stages]):
            planes = 64 * 2 ** i
            stage_temporal = (temporal_cfg
                              if temporal_cfg and temporal_freq[i] else None)
            nl_blocks = (nonlocal_block_indices(num_blocks, 2 if i == 1
                                                else 3)
                         if nonlocal_cfg and i in (1, 2) else ())
            blocks = []
            for j in range(num_blocks):
                stride = strides[i] if j == 0 else 1
                with_ds = j == 0 and (strides[i] != 1 or
                                      inplanes != planes * block_cls.expansion)
                # CoST skips a stage's first block; MVF takes every block
                block = block_cls(
                    inplanes, planes, stride=stride, dilation=dilations[i],
                    with_downsample=with_ds, style=style, norm_cfg=norm_cfg,
                    avg_down=avg_down,
                    temporal_cfg=(None if j == 0 and _is_cost(stage_temporal)
                                  else stage_temporal),
                    quant=quant if quant and quant_stages[i] else None,
                    **block_opts)
                inplanes = planes * block_cls.expansion
                if j in nl_blocks:
                    block = NonLocal2D(block, inplanes,
                                       nonlocal_cfg['n_segment'])
                blocks.append(block)
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))

    def init_weights(self, generator: torch.Generator) -> None:
        """JAX-package init: lecun-normal convs, norm gamma 1 beta 0, MVF
        taps N(0, sqrt(2/(3*cs))), CoST kernels N(0, sqrt(2/(9*C))), the
        non-local blocks' lecun-normal convs with zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
            elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
                m.reset_parameters()
            elif isinstance(m, (MVF, CoST)):
                m.reset_taps(generator)
            elif isinstance(m, LocalAttention):
                m.reset_parameters(generator)

    def train(self, mode: bool = True):
        """``norm_eval`` keeps every BatchNorm (MVF's and the deep stem's
        too) in eval mode while training; ``partial_norm`` does so for
        stages 1..frozen_stages. GroupNorm has no mode."""
        super().train(mode)
        if mode:
            stages = [getattr(self, f'layer{i + 1}')
                      for i in range(self.num_stages)
                      if self.norm_eval or (self.partial_norm
                                            and i + 1 <= self.frozen_stages)]
            if self.norm_eval:
                stages.append(self.bn1)
                if self.deep_stem:
                    stages += [self.stem_bn1, self.stem_bn2]
            for stage in stages:
                for m in stage.modules():
                    if isinstance(m, nn.BatchNorm2d):
                        m.eval()
        return self

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        if self.deep_stem:
            x = self._conv_norm('stem_bn1', self.stem_conv1, self.stem_bn1,
                                x, relu=True)
            x = self._conv_norm('stem_bn2', self.stem_conv2, self.stem_bn2,
                                x, relu=True)
            conv = self.stem_conv3
        else:
            conv = self.conv1
        return self.maxpool(self._conv_norm('bn1', conv, self.bn1, x,
                                            relu=True))

    def forward(self, x: torch.Tensor):
        """x: (N, C, H, W), any memory format; returns channels_last maps."""
        refuse_quant_training(self.quant, self.training)
        x = self._stem(x.contiguous(memory_format=torch.channels_last))
        remat = self.with_cp and self.training and torch.is_grad_enabled()
        outs = []
        for i in range(self.num_stages):
            stage = getattr(self, f'layer{i + 1}')
            if remat:
                x = checkpoint(stage, x, use_reentrant=False,
                               context_fn=functools.partial(
                                   _recompute_contexts, stage))
            else:
                x = stage(x)
            if i in self.out_indices:
                outs.append(x)
        if len(outs) == 1:
            return outs[0]
        return tuple(outs)


def _recompute_contexts(stage: nn.Module):
    """``checkpoint``'s (forward, recompute) contexts: the recompute leaves
    the stage's norm statistics alone."""
    return contextlib.nullcontext(), frozen_norm_statistics(stage)
