"""Shared model building blocks (counterpart of ``mvfnet_tpu/models/common.py``).

Params are fp32; each layer computes in the dtype of its input, which the
recognizer sets from the config's ``compute_dtype``. Tensors inside the
models are NCHW in ``torch.channels_last`` memory format, so cuDNN and the
hand kernels both see NHWC bytes; the 3-D families' volumes are NCTHW in
``torch.channels_last_3d``, the NTHWC bytes of the JAX package's layout and
of the data pipeline's ``FormatShape('NTHWC')``, so that entering the
backbone is a view and cuDNN picks its channels-last 3-D convolutions.

The eval-only int8 path (the JAX module's ``QuantConv2d``, ``QuantConv3d``,
``IntCarry``, ``check_quant_calibrated``) keeps the parameters of the
plain convs: ``conv2d``/``conv3d`` with ``quant`` build the quantized
ones, whose convolutions run in ``ops.int8_conv``; ``quant_calibration``
records their activation scales.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import fused_block as fb
from ..ops import int8_conv as q8
from ..ops.mvf import hard_sigmoid
from ..utils import tracing

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

    This forward runs in train mode, under gradients, and in eval where no
    plain conv precedes the norm: the 3-D backbones, MVF's and CoST's own
    BNs, a CoST block's ``bn2``, the int8 path's quantized convs. In eval
    with no gradient the 2-D ResNet folds every other BatchNorm into the
    conv before it (``fold_conv_bn``, ``folded_conv``) or into the fused
    bottleneck, and this forward does not run there. MVF applies its own
    BN inline in eval and through ``normalize`` in training, not here.
    Each forward counts in ``BatchNorm.counts['forward']`` and, with
    tracing on, is spanned ``model.norm``.

    With a process group in ``sync_group`` (``set_sync_group``), train mode
    normalizes with the statistics of the whole batch across the group's
    ranks, which is what one process computes on the concatenated batch;
    the state dict and eval are unchanged.
    """

    sync_group = None
    stats_frozen = False        # see frozen_norm_statistics
    # forwards run (``'forward'``), every instance's: the BatchNorms that
    # no fold took
    counts = collections.Counter()

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
        BatchNorm.counts['forward'] += 1
        with tracing.span('model.norm'):
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


def foldable(conv: nn.Module, norm: nn.Module) -> bool:
    """Whether eval folds ``norm`` into ``conv``: a plain bias-free
    :class:`Conv2d` (not the int8 path's, which folds its own way) and a
    :class:`BatchNorm`, whose running statistics make it an affine."""
    return (isinstance(conv, Conv2d) and not isinstance(conv, QuantConv2d)
            and conv.bias is None and isinstance(norm, BatchNorm))


def fold_conv_bn(conv: Conv2d, bn: BatchNorm, dtype: torch.dtype):
    """``bn(conv(x)) == conv'(x) + b'``: the eval BatchNorm folded into the
    conv's weight in the parameters' dtype (``fused_block.fold_bn``, the
    fused kernel's fold), then ``(W', b')`` cast to ``dtype``, the weight
    ``channels_last`` as the activations are. Counted in
    ``folded_conv.counts['folds']``."""
    with torch.no_grad():
        w, b = fb.fold_bn(conv.weight.permute(1, 2, 3, 0), bn.weight,
                          bn.bias, bn.running_mean, bn.running_var, bn.eps)
        w = w.permute(3, 0, 1, 2).to(dtype).contiguous(
            memory_format=torch.channels_last)
    folded_conv.counts['folds'] += 1
    return w, b.to(dtype)


def folded_conv(x: torch.Tensor, conv: Conv2d, weight: torch.Tensor,
                bias: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv``'s geometry with a folded weight and bias, ``+ residual``,
    then the ReLU if ``relu``. bf16 with a ReLU on the card takes cuDNN's
    fused epilogue, one call (``cudnn_convolution_relu``, or
    ``cudnn_convolution_add_relu`` with the residual as ``z``); anything
    else, the CPU's f64 included, runs ``F.conv2d`` with the bias and
    in-place add and ReLU. Counts each call in
    ``folded_conv.counts['calls']``."""
    folded_conv.counts['calls'] += 1
    geometry = (conv.stride, conv.padding, conv.dilation, conv.groups)
    if relu and x.device.type == 'cuda' and x.dtype == torch.bfloat16:
        if residual is None:
            return torch.cudnn_convolution_relu(x, weight, bias, *geometry)
        return torch.cudnn_convolution_add_relu(x, weight, residual, 1.0,
                                                bias, *geometry)
    out = F.conv2d(x, weight, bias, *geometry)
    if residual is not None:
        out.add_(residual)
    return out.relu_() if relu else out


folded_conv.counts = collections.Counter()


QUANT_MODES = ('int8', 'int8_static')


def check_quant_mode(quant: Optional[str]) -> None:
    if quant is not None and quant not in QUANT_MODES:
        raise ValueError(f'unknown quant mode {quant!r}')


def conv2d(in_channels: int, out_channels: int, kernel_size: int, *,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           bias: bool = False, quant: Optional[str] = None,
           carry_out: bool = False, split: int = 0) -> Conv2d:
    """torch-semantics Conv2d, no bias by default (the ResNet convention).
    ``quant='int8'|'int8_static'`` gives a :class:`QuantConv2d` (the same
    state-dict entries); ``carry_out`` (quant only) makes it return the
    :class:`IntCarry` accumulator, ``split`` quantizes its first ``split``
    input channels and the rest with separate scales (the MVF block's
    conv1)."""
    if quant in QUANT_MODES:
        return QuantConv2d(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding, dilation=dilation,
                           bias=bias, quant=quant, carry_out=carry_out,
                           split=split)
    if carry_out:
        raise ValueError('carry_out requires a quant mode')
    check_quant_mode(quant)
    return Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, dilation=dilation, bias=bias)


# A bf16 3-D conv with a stem's few input channels (3 RGB, 2 flow) and 64
# outputs takes cuDNN's fp32 NCHW FFMA kernel behind layout conversions,
# and still does with its input channels zero-padded to 8 or 16 (PERF.md
# §6). Folded into channels, 2x2 pixel blocks make a spatial stride-2 conv
# a stride-1 one over 4x the channels (16 for 3: the JAX package's
# ``_SpaceToDepthStem3D``), which takes a bf16 tensor-core kernel and
# beats the plain conv with 8, 24 or 45 outputs too. The floor on K = Cin
# * kt * kh * kw and on the output count (N * Cout * T' * H' * W') comes
# from the stems' times on the H100, forward and with the weight gradient
# (PERF.md §6): every stem measured at 25.2 M outputs or more wins both
# ways, from K 147 (the 1x7x7 stems, the least measured) to 1029; below
# 18.1 M outputs the K 147 and 441 stems lose one way or both.
S2D_MIN_K = 147
S2D_MIN_OUTPUTS = 20_000_000


def _s2d_axis(size: int, k: int, pad: int) -> Tuple[int, int, int]:
    """One spatial axis of a stride-2 conv's space-to-depth form: the
    padding put before the image (``pad`` made even, so that blocks start
    on the image's even rows), the kernel's taps over 2-pixel blocks, and
    the blocks the conv reads."""
    lead = pad + pad % 2
    taps = (k + lead - pad + 1) // 2
    return lead, taps, (size + 2 * pad - k) // 2 + taps


def takes_space_to_depth(conv: nn.Conv3d, shape: Sequence[int],
                         dtype: torch.dtype, device: torch.device) -> bool:
    """Whether ``conv`` on an input of ``shape``, ``dtype`` and ``device``
    runs as :func:`conv3d_space_to_depth`: bf16 on the card, no groups,
    fewer than 8 input channels (a stem), spatial stride 2 and dilation 1,
    even height and width, and its K and output count at or above
    ``S2D_MIN_K`` and ``S2D_MIN_OUTPUTS``."""
    if not (device.type == 'cuda' and dtype == torch.bfloat16
            and conv.groups == 1 and conv.in_channels < 8
            and tuple(conv.stride[1:]) == (2, 2)
            and tuple(conv.dilation[1:]) == (1, 1)
            and shape[3] % 2 == 0 and shape[4] % 2 == 0):
        return False
    kt, kh, kw = conv.kernel_size
    t_out = (shape[2] + 2 * conv.padding[0] - conv.dilation[0] * (kt - 1)
             - 1) // conv.stride[0] + 1
    outputs = shape[0] * conv.out_channels * t_out * math.prod(
        (size + 2 * pad - k) // 2 + 1
        for size, pad, k in zip(shape[3:], conv.padding[1:], (kh, kw)))
    return (conv.in_channels * kt * kh * kw >= S2D_MIN_K
            and outputs >= S2D_MIN_OUTPUTS)


def conv3d_space_to_depth(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor], stride, padding,
                          dilation) -> torch.Tensor:
    """``F.conv3d(x, weight, bias, stride, padding, dilation)``, no groups,
    spatial stride 2 and dilation 1, even H and W, as a spatial stride-1
    conv over 2x2 pixel blocks folded into channels (dy, dx, c), c the
    input channels made even. One copy writes the padded, folded input
    into a zeroed buffer; the weight's taps are zero-padded and folded the
    same way. The zeros add exact zeros: the same sums in another order.
    Differentiable in ``x`` and ``weight``; the output is channels_last_3d."""
    n, c, t, h, w = x.shape
    f, _, kt, kh, kw = weight.shape
    lh, th, hb = _s2d_axis(h, kh, padding[1])
    lw, tw, wb = _s2d_axis(w, kw, padding[2])
    cp = c + c % 2
    rows, cols = min(h, 2 * hb - lh), min(w, 2 * wb - lw)
    blocks = x.new_zeros((n, t, hb, wb, 2, 2, cp))
    src = x.permute(0, 2, 3, 4, 1)[:, :, :rows, :cols]
    blocks[:, :, lh // 2:(lh + rows) // 2, lw // 2:(lw + cols) // 2, ...,
           :c] = src.reshape(n, t, rows // 2, 2, cols // 2, 2, c).permute(
               0, 1, 2, 4, 3, 5, 6)
    xs = blocks.view(n, t, hb, wb, 4 * cp).permute(0, 4, 1, 2, 3)
    ws = F.pad(weight, (lw - padding[2], 2 * tw - kw - lw + padding[2],
                        lh - padding[1], 2 * th - kh - lh + padding[1],
                        0, 0, 0, cp - c))
    ws = ws.reshape(f, cp, kt, th, 2, tw, 2).permute(
        0, 4, 6, 1, 2, 3, 5).reshape(f, 4 * cp, kt, th, tw)
    return F.conv3d(xs, ws.contiguous(memory_format=torch.channels_last_3d),
                    bias, (stride[0], 1, 1), (padding[0], 0, 0),
                    (dilation[0], 1, 1))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` that casts its fp32 weight to the input's dtype.

    A bf16 stem on the card (``takes_space_to_depth``) runs in the
    space-to-depth form of :func:`conv3d_space_to_depth`, its input
    channels folded and zero-padded: each such forward counts in
    ``Conv3d.counts['channels_padded']``, 1 a dense I3D video, 0 in any
    2-D model."""

    counts = collections.Counter()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        weight = self.weight.to(x.dtype)
        if takes_space_to_depth(self, x.shape, x.dtype, x.device):
            Conv3d.counts['channels_padded'] += 1
            return conv3d_space_to_depth(x, weight, bias, self.stride,
                                         self.padding, self.dilation)
        return self._conv_forward(x, weight, bias)


def conv3d(in_channels: int, out_channels: int, kernel: Tuple[int, ...], *,
           stride: Tuple[int, ...] = (1, 1, 1),
           padding: Optional[Tuple[int, ...]] = None,
           dilation: Tuple[int, ...] = (1, 1, 1), groups: int = 1,
           bias: bool = False, quant: Optional[str] = None) -> Conv3d:
    """torch-semantics Conv3d on NCTHW, no bias by default; ``padding``
    defaults to ``(k - 1) // 2`` per axis (the JAX package's ``conv3d``,
    ``backbones/resnet_i3d.py:27-54``); ``quant`` gives a
    :class:`QuantConv3d`, whose callers choose it by conv type
    (``quant_conv3d_type``)."""
    kernel = tuple(kernel)
    if padding is None:
        padding = tuple((k - 1) // 2 for k in kernel)
    check_quant_mode(quant)
    cls = QuantConv3d if quant else Conv3d
    extra = dict(quant=quant) if quant else {}
    return cls(in_channels, out_channels, kernel, stride=tuple(stride),
               padding=tuple(padding), dilation=tuple(dilation),
               groups=groups, bias=bias, **extra)


# ------------------------------------------------------------ int8 eval path

class IntCarry(NamedTuple):
    """An int32 conv accumulator carried to the next quantized conv (the
    JAX package's ``IntCarry``): ``acc`` int32 NHWC, ``scale`` its
    per-output-channel dequantization factor ``sx * sw``, and the compute
    dtype the chain returns to."""
    acc: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype


def bn_affine(bn: nn.BatchNorm2d):
    """Eval-mode BatchNorm as a per-channel affine ``y = a * x + b``."""
    a = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return a, bn.bias - a * bn.running_mean


class _QuantStats:
    """The calibration state of an int8 conv, one buffer per statistic:
    the activation abs-max (``act_amax``; the split conv keeps
    ``act_amax_y`` and ``act_amax_x``) and its ``*_calibrated`` marker, the
    JAX package's ``quant_stats`` collection. The buffers are not
    persistent: the state dict holds the unquantized model's entries only.

    ``static`` (``int8_static``) quantizes activations with the recorded
    abs-max; ``int8`` with each call's own. Inside ``quant_calibration``
    (``calibrating``) every call quantizes with its own abs-max, raises the
    recorded one to it and marks it calibrated, in both modes."""

    def _init_quant(self, quant: str, stats: Sequence[str]) -> None:
        check_quant_mode(quant)
        self.quant = quant
        self.static = quant == 'int8_static'
        self.calibrating = False
        self.bypass = False     # compute unquantized (X3D's s2d stages)
        self.in_s2d_stage = False   # such a stage: no calibration state
        for name in stats:
            self.register_buffer(name, torch.zeros(()), persistent=False)
            self.register_buffer(name + '_calibrated', torch.zeros(()),
                                 persistent=False)

    def _act_scale(self, xf: torch.Tensor, stat: str) -> torch.Tensor:
        """The per-tensor scale of float32 ``xf``, recording its abs-max
        while calibrating."""
        if self.calibrating:
            amax = xf.abs().amax()
            buf = getattr(self, stat)
            with torch.no_grad():
                buf.copy_(torch.maximum(buf, amax.to(buf.dtype)))
                getattr(self, stat + '_calibrated').fill_(1)
            return q8.activation_scale(amax)
        if self.static:
            return q8.activation_scale(getattr(self, stat).float())
        return q8.activation_scale(xf.abs().amax())

    def _quant_input(self, x: torch.Tensor, stat: str):
        """``(sx, int8 x)`` with channels last, x NC... of any rank."""
        with tracing.span('int8_quantize'):
            xf = x.float()
            sx = self._act_scale(xf, stat)
            xq = q8.quantize_activation(xf, sx)
        return sx, xq.permute((0,) + tuple(range(2, x.ndim)) + (1,))

    def _quant_weight(self, w: torch.Tensor):
        with tracing.span('int8_weights'):
            return q8.quantize_weight(w)


def _packed(wq: torch.Tensor) -> torch.Tensor:
    """An int8 ``(O, I, [kt,] kh, kw)`` weight in the int8 kernel's layout
    ``(Cout, kt, kh, kw, Cin)``, contiguous: the one copy of the quantized
    weight a call makes."""
    with tracing.span('int8_weights'):
        wp = wq.permute(0, *range(2, wq.ndim), 1)
        return (wp[:, None] if wq.ndim == 4 else wp).contiguous()


def _pairs(padding) -> Tuple[Tuple[int, int], ...]:
    return tuple((p, p) for p in padding)


class QuantConv2d(Conv2d, _QuantStats):
    """Int8 eval conv with the parameters of ``Conv2d`` (the JAX package's
    ``QuantConv2d``): per-output-channel symmetric weight scales computed
    from the fp32 weight at each call, a per-tensor activation scale
    (``_QuantStats``), exact int32 accumulation in ``ops.int8_conv`` and the
    result rescaled by ``sx * sw`` (+ bias) to the input's dtype.

    ``carry_out`` (per call, or the default given here) returns the
    :class:`IntCarry` instead; an ``IntCarry`` input, with the previous
    BN's affine as ``prev_affine``, folds that affine, the ReLU and this
    conv's input quantization into one int32 -> int8 pass with the recorded
    abs-max (``int8_static`` only). ``split`` > 0 quantizes the first
    ``split`` input channels and the rest with their own activation scales
    and one weight scale over the whole kernel, and adds the two rescaled
    products (the MVF block's conv1, JAX ``_SplitPointwiseConv``).
    ``stem`` quantizes the weight after its cast to the input's dtype, as
    the JAX package's quantized space-to-depth stem does, which this conv
    computes directly (the two forms are the same sum term for term).
    Eval only: the owning backbone refuses training."""

    def __init__(self, *args, quant: str = 'int8', carry_out: bool = False,
                 split: int = 0, stem: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        if self.groups != 1:
            raise ValueError('QuantConv2d has no groups')
        self._init_quant(quant, ('act_amax_y', 'act_amax_x') if split
                         else ('act_amax',))
        self.carry_out = carry_out
        self.split = split
        self.stem = stem

    def _geometry(self):
        return ((1,) + tuple(self.stride), ((0, 0),) + _pairs(self.padding),
                (1,) + tuple(self.dilation))

    def forward(self, x, prev_affine=None, carry_out: Optional[bool] = None):
        carry_out = self.carry_out if carry_out is None else carry_out
        w = self.weight
        if self.stem:
            w = w.to(x.dtype).float()
        wq, sw = self._quant_weight(w)
        stride, padding, dilation = self._geometry()
        if self.split:
            if carry_out or isinstance(x, IntCarry):
                raise ValueError('the split conv takes no integer carry')
            return self._forward_split(x, wq, sw)
        if isinstance(x, IntCarry):
            if not self.static or prev_affine is None:
                raise ValueError('IntCarry input needs static=True and the '
                                 'previous BN affine')
            with tracing.span('int8_requantize'):
                sx = q8.activation_scale(self.act_amax.float())
                xq = q8.requantize_carry(x.acc, x.scale, *prev_affine, sx)
            dtype = x.dtype
        else:
            sx, xq = self._quant_input(x, 'act_amax')
            dtype = x.dtype
        scale = sx * sw
        wp = _packed(wq)
        if carry_out:
            if self.bias is not None:
                raise ValueError('carry_out with bias is unsupported')
            acc = q8.int8_conv_packed(xq[:, None], wp, stride, padding,
                                      dilation)
            return IntCarry(acc[:, 0], scale, dtype)
        out = q8.int8_conv_packed(xq[:, None], wp, stride, padding, dilation,
                                  scale=scale, bias=self.bias,
                                  out_dtype=dtype)
        return to_nchw(out[:, 0])

    def _forward_split(self, x, wq, sw):
        stride, padding, dilation = self._geometry()
        out = None
        for v, part, stat in ((x[:, :self.split], wq[:, :self.split],
                               'act_amax_y'),
                              (x[:, self.split:], wq[:, self.split:],
                               'act_amax_x')):
            sx, vq = self._quant_input(v, stat)
            scale = sx * sw
            y = q8.int8_conv_packed(
                vq[:, None], _packed(part), stride, padding, dilation,
                scale=scale, out_dtype=torch.promote_types(torch.float32,
                                                           scale.dtype))
            if out is None:
                out = y
            else:
                with tracing.span('int8_split_sum'):
                    out = (out + y).to(x.dtype)
        return to_nchw(out[:, 0])


class QuantConv3d(Conv3d, _QuantStats):
    """Int8 eval Conv3d with the parameters of ``Conv3d`` (the JAX
    package's ``QuantConv3d``): the scheme of :class:`QuantConv2d` on NCTHW
    volumes, whatever the kernel; the backbones choose which conv types
    take it (``quant_ops``)."""

    def __init__(self, *args, quant: str = 'int8', **kwargs):
        super().__init__(*args, **kwargs)
        if self.groups != 1:
            raise ValueError('QuantConv3d has no groups')
        self._init_quant(quant, ('act_amax',))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bypass:
            return super().forward(x)
        wq, sw = self._quant_weight(self.weight)
        sx, xq = self._quant_input(x, 'act_amax')
        out = q8.int8_conv_packed(xq, _packed(wq), tuple(self.stride),
                                  _pairs(self.padding), tuple(self.dilation),
                                  scale=sx * sw, bias=self.bias,
                                  out_dtype=x.dtype)
        return out.permute(0, 4, 1, 2, 3)


def quant_conv3d_type(kernel: Tuple[int, int, int]) -> str:
    """A conv3d kernel's type for the per-type quant masks: 'temporal'
    (kt > 1), 'spatial' (kt == 1 with a spatial extent > 1) or
    'pointwise' (1x1x1)."""
    kt, kh, kw = kernel
    if kt > 1:
        return 'temporal'
    if max(kh, kw) > 1:
        return 'spatial'
    return 'pointwise'


def quant_modules(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, _QuantStats)]


def quant_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every int8 conv's calibration buffers by state-dict-style name
    (``backbone.layer1.0.conv1.act_amax``), the JAX package's
    ``quant_stats`` collection; X3D's space-to-depth stages, which JAX
    builds unquantized, have none."""
    mods = {id(m) for m in quant_modules(model) if not m.in_s2d_stage}
    return {f'{name}.{b}' if name else b: t
            for name, m in model.named_modules() if id(m) in mods
            for b, t in m.named_buffers(recurse=False)
            if b.startswith('act_amax')}


@contextlib.contextmanager
def quant_calibration(model: nn.Module):
    """Inside, every int8 conv of ``model`` calibrates: the counterpart of
    applying the JAX model with ``mutable=['quant_stats']``. The recorded
    abs-max only grows, from what the model holds (zeros when built, as
    the JAX init pass on zeros records)."""
    mods = quant_modules(model)
    for m in mods:
        m.calibrating = True
    try:
        yield model
    finally:
        for m in mods:
            m.calibrating = False


def check_quant_calibrated(model: nn.Module) -> None:
    """Refuse an ``int8_static`` eval on uncalibrated activation scales
    (every ``*_calibrated`` marker must be set); nothing for a model that
    is not ``int8_static``."""
    if getattr(getattr(model, 'backbone', None), 'quant',
               None) != 'int8_static':
        return
    markers = [v for k, v in quant_buffers(model).items()
               if k.endswith('calibrated')]
    if not markers or not all(float(m) > 0 for m in markers):
        raise ValueError(
            "quant='int8_static' needs calibrated activation scales: run "
            "apply(..., mutable=['quant_stats']) on representative batches "
            'first (test_recognizer.py does this automatically via '
            '--calib_videos) and pass the updated quant_stats collection')


def refuse_quant_training(quant: Optional[str], training: bool) -> None:
    if quant and training:
        raise ValueError('quant={!r} is an eval-only path; gradients '
                         'through int8 rounding are meaningless'
                         .format(quant))


def check_quant_stages(quant: Optional[str], quant_stages: Sequence[int],
                       num_stages: int) -> None:
    if quant and len(quant_stages) < num_stages:
        raise ValueError(
            f'quant_stages needs one entry per stage: got '
            f'{len(quant_stages)} for num_stages={num_stages}')


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


def round_width(width: float, multiplier: float, min_width: int = 8,
                divisor: int = 8) -> int:
    """PySlowFast's ``round_width``: ``width * multiplier`` to the nearest
    multiple of ``divisor``, at least ``min_width``, one ``divisor`` more
    where that falls under 90% of it (X3D's SE widths: 8 for 54 and 108
    channels at 1/16, 16 for 216, 32 for 432)."""
    width *= multiplier
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


class SEModule(nn.Module):
    """Squeeze-and-excitation on NC... input of any spatial rank (the
    reference's SE3D, ``se_module.py:27-67``, and the JAX package's
    ``SEModule``): the mean over every axis after the channels, ``fc1``,
    relu, ``fc2``, a sigmoid (hard with ``use_hs``), and the scale. ``fc1``
    and ``fc2`` keep the reference's 1x1x1 ``Conv3d`` weights with biases;
    they run as matrix products on the pooled vector. ``hidden`` sets
    their inner width, ``channels // reduction`` when None. With tracing
    on, its forward and its backward are each spanned ``model.se``.

    With ``fp32_gate`` a bf16 input keeps the gate in fp32: the mean, both
    FCs and the sigmoid run in fp32, and the scale multiplies the input
    by the fp32 gate and rounds the product once, so that the backward
    sums the gate's gradient over fp32 products. A gate rounded to bf16
    scales a whole channel of a clip by the same wrong factor, which no
    later sum averages away. An fp32 or fp64 input computes as without
    it."""

    def __init__(self, channels: int, reduction: int = 16,
                 use_hs: bool = False, hidden: Optional[int] = None,
                 fp32_gate: bool = False):
        super().__init__()
        self.use_hs = use_hs
        self.fp32_gate = fp32_gate
        hidden = channels // reduction if hidden is None else hidden
        self.fc1 = conv3d(channels, hidden, (1, 1, 1), bias=True)
        self.fc2 = conv3d(hidden, channels, (1, 1, 1), bias=True)

    @staticmethod
    def _fc(fc: Conv3d, y: torch.Tensor) -> torch.Tensor:
        return F.linear(y, fc.weight.flatten(1).to(y.dtype),
                        fc.bias.to(y.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(2, x.ndim))
        with tracing.span('model.se'):
            stat = (torch.promote_types(x.dtype, torch.float32)
                    if self.fp32_gate else x.dtype)
            pooled = x.mean(dim=dims, dtype=stat)
            y = self._fc(self.fc2, torch.relu(self._fc(self.fc1, pooled)))
            y = hard_sigmoid(y) if self.use_hs else torch.sigmoid(y)
            # an fp32 gate promotes the product to fp32, rounded once
            out = (x * y.reshape(y.shape + (1,) * len(dims))).to(x.dtype)
        tracing.span_backward('model.se', out, pooled)
        return out


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
