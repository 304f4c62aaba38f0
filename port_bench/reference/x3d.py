"""Plain float32 reference of X3D-M and of its train step.

X3D-M (Feichtenhofer, "X3D: Expanding Architectures for Efficient Video
Recognition", CVPR 2020, arXiv:2004.04730), written from the layer
equations of PySlowFast's ``X3DStem``, ``X3DTransform`` and ``X3DHead``
(``configs/Kinetics/X3D_M.yaml``) in plain ``torch`` operations, with no
kernel, folding or layout trick and nothing imported from the program
under test. NCTHW volumes.

- Stem: ``conv_xy`` 1x3x3, 3 -> 24, stride (1, 2, 2); ``conv_t`` 5x1x1
  depthwise; BatchNorm; ReLU. No norm between the two convs.
- Four stages of 3 / 5 / 11 / 7 blocks (ceil(2.2 x [1, 2, 5, 3])), 24 /
  48 / 96 / 192 channels out, 2.25 times that inside; the first block of
  each stage has spatial stride 2 (on its 3x3x3 conv and its shortcut),
  no stage strides or pools in time. A block: 1x1x1 -> BN -> ReLU; 3x3x3
  depthwise -> BN; squeeze-excite on blocks 0, 2, 4, ... (the mean over
  (T, H, W), FC, ReLU, FC, sigmoid, the scale; ``round_width(inner,
  1/16)`` = 8 / 8 / 16 / 32 wide, with biases); swish x * sigmoid(x);
  1x1x1 -> BN; a 1x1x1 conv and BN on the shortcut of each first block;
  add, ReLU.
- Head: ``conv_5`` 1x1x1 192 -> 432, BN, ReLU; the mean over (T, H, W);
  ``lin_5`` 432 -> 2048 without bias, ReLU; dropout; the FC 2048 ->
  classes.

Departures from PySlowFast, none of which changes a layer's equation:

- Parameter names are the port's (the reference torch state-dict names
  of mmaction's X3D): ``conv1`` and ``conv1_3x1.{0,1}`` for the stem's
  ``conv_xy``, ``conv`` and ``bn``; ``layer{i}.{j}.{conv1,bn1,conv2,bn2,
  se.fc1,se.fc2,conv3,bn3,downsample.0,downsample.1}`` for ``a``, ``a_bn``,
  ``b``, ``b_bn``, the SE's convs, ``c``, ``c_bn`` and ``branch1{,_bn}``;
  ``conv5``, ``conv5_bn`` and ``fc1`` for ``conv_5``, ``conv_5_bn`` and
  ``lin_5``; ``cls_head.fc_cls`` for the projection.
- The input is normalized as the port's configuration says (mean and std
  on 0-255 values, BGR flipped to RGB), not PySlowFast's /255 with mean
  0.45 and std 0.225.
- The dropout mask is given (its kept entries), not drawn; the eval
  forward returns logits, not PySlowFast's softmax.
- The weights are whatever state is given (the benchmark's seeded ones),
  not PySlowFast's initialization (which zeroes each ``c_bn`` weight).
- BatchNorm: the batch's mean and biased variance in training, which
  leaves the running statistics alone; the running statistics in eval.

``train_steps`` is the arithmetic of ``reference/train.py`` (mean
cross-entropy, autograd, the clip by the global norm, SGD with coupled
weight decay, momentum and nesterov) over this model's logits.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .models import Counter, Ops, Precision, _bn_spec, normalize
from .train import PARAM_KINDS

STEM = 24
STAGE_BLOCKS = (3, 5, 11, 7)
STAGE_WIDTHS = (24, 48, 96, 192)
BOTTLENECK = 2.25
STEM_T = 5
CONV5 = 432
LIN5 = 2048


def round_width(width: float, multiplier: float, min_width: int = 8,
                divisor: int = 8) -> int:
    """PySlowFast's ``_round_width`` of the SE's hidden width."""
    width *= multiplier
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


def stages() -> List[Tuple[int, int, int, int]]:
    """(stage index, blocks, channels out, channels inside)."""
    return [(i, n, c, int(BOTTLENECK * c))
            for i, (n, c) in enumerate(zip(STAGE_BLOCKS, STAGE_WIDTHS))]


def spec(model: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every state-dict entry of the X3D-M
    recognizer ``model`` (the config's model dict, which gives the
    classes)."""
    classes = model['cls_head']['num_classes']
    out = [('backbone.conv1.weight', (STEM, 3, 1, 3, 3), 'conv'),
           ('backbone.conv1_3x1.0.weight', (STEM, 1, STEM_T, 1, 1), 'conv')]
    out += _bn_spec('backbone.conv1_3x1.1', STEM)
    cin = STEM
    for i, blocks, cout, inner in stages():
        for j in range(blocks):
            pre = f'backbone.layer{i + 1}.{j}'
            out.append((f'{pre}.conv1.weight', (inner, cin, 1, 1, 1), 'conv'))
            out += _bn_spec(f'{pre}.bn1', inner)
            out.append((f'{pre}.conv2.weight', (inner, 1, 3, 3, 3), 'conv'))
            out += _bn_spec(f'{pre}.bn2', inner)
            if j % 2 == 0:
                hid = round_width(inner, 1 / 16)
                out += [(f'{pre}.se.fc1.weight', (hid, inner, 1, 1, 1),
                         'conv'),
                        (f'{pre}.se.fc1.bias', (hid,), 'fc_bias'),
                        (f'{pre}.se.fc2.weight', (inner, hid, 1, 1, 1),
                         'conv'),
                        (f'{pre}.se.fc2.bias', (inner,), 'fc_bias')]
            out.append((f'{pre}.conv3.weight', (cout, inner, 1, 1, 1),
                        'conv'))
            out += _bn_spec(f'{pre}.bn3', cout)
            if j == 0:
                out.append((f'{pre}.downsample.0.weight',
                            (cout, cin, 1, 1, 1), 'conv'))
                out += _bn_spec(f'{pre}.downsample.1', cout)
            cin = cout
    out.append(('backbone.conv5.weight', (CONV5, cin, 1, 1, 1), 'conv'))
    out += _bn_spec('backbone.conv5_bn', CONV5)
    out += [('backbone.fc1.weight', (LIN5, CONV5, 1, 1, 1), 'conv'),
            ('cls_head.fc_cls.weight', (classes, LIN5), 'fc'),
            ('cls_head.fc_cls.bias', (classes,), 'fc_bias')]
    return out


def _se(ops: Ops, x, pre: str):
    """Squeeze-excite of x (N, C, T, H, W)."""
    def fc(y, name):
        return ops.conv(y, f'{name}.weight') + ops.p[
            f'{name}.bias'].view(1, -1, 1, 1, 1)
    y = x.mean(dim=(2, 3, 4), keepdim=True)
    y = torch.sigmoid(fc(torch.relu(fc(y, f'{pre}.fc1')), f'{pre}.fc2'))
    return x * y


def backbone(ops: Ops, x):
    """(N, 3, T, H, W) -> (N, 2048): the stem, the stages, ``conv_5``
    and ``lin_5`` after the mean."""
    x = ops.conv(x, 'backbone.conv1.weight', (1, 2, 2), (0, 1, 1))
    x = ops.conv(x, 'backbone.conv1_3x1.0.weight', 1, (STEM_T // 2, 0, 0),
                 groups=STEM)
    x = torch.relu(ops.bn(x, 'backbone.conv1_3x1.1'))
    for i, blocks, _, inner in stages():
        for j in range(blocks):
            pre = f'backbone.layer{i + 1}.{j}'
            s = 2 if j == 0 else 1
            y = torch.relu(ops.bn(ops.conv(x, f'{pre}.conv1.weight'),
                                  f'{pre}.bn1'))
            y = ops.bn(ops.conv(y, f'{pre}.conv2.weight', (1, s, s), 1,
                                groups=inner), f'{pre}.bn2')
            if j % 2 == 0:
                y = _se(ops, y, f'{pre}.se')
            y = y * torch.sigmoid(y)                       # swish
            y = ops.bn(ops.conv(y, f'{pre}.conv3.weight'), f'{pre}.bn3')
            if j == 0:
                x = ops.bn(ops.conv(x, f'{pre}.downsample.0.weight',
                                    (1, s, s)), f'{pre}.downsample.1')
            x = torch.relu(y + x)
    x = torch.relu(ops.bn(ops.conv(x, 'backbone.conv5.weight'),
                          'backbone.conv5_bn'))
    x = x.mean(dim=(2, 3, 4), keepdim=True)
    return torch.relu(ops.conv(x, 'backbone.fc1.weight')).flatten(1)


def logits(ops: Ops, clips, model: dict, keep=None):
    """clips (N, 3, T, H, W) -> (N, classes); ``keep``, the dropout
    mask's kept entries (N, 2048), applies dropout (train). Turns TF32
    off, so that float32 is float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    feat = backbone(ops, clips)
    if keep is not None:
        p = model['cls_head']['dropout_ratio']
        feat = torch.where(keep, feat / (1 - p), torch.zeros_like(feat))
    return ops.fc(feat, 'cls_head.fc_cls')


def clips_of(imgs, norm: dict, dtype: torch.dtype):
    """uint8 (B, clips, T, H, W, 3) -> normalized (B * clips, 3, T, H, W)
    in ``dtype``."""
    x = normalize(imgs, norm, dtype)
    return x.reshape((-1,) + tuple(x.shape[2:])).permute(0, 4, 1, 2, 3)


def count_flops(model: dict, shape, train: bool = False) -> int:
    """FLOPs of one forward (``train``: forward and backward) on clips of
    ``shape`` ``(N, T, H, W, 3)``, counted on the ``meta`` device, 2 a
    multiply-add of the convolutions and FCs (the SE's included). The
    backward is twice the forward, less the input gradient of the first
    conv."""
    p = {name: torch.empty(s, device='meta') for name, s, _ in spec(model)}
    counter = Counter()
    x = torch.empty(shape, device='meta').permute(0, 4, 1, 2, 3)
    logits(Ops(p, train=train, counter=counter), x, model)
    if not train:
        return counter.flops
    return 3 * counter.flops - counter.stem_flops


def train_steps(state: Dict[str, torch.Tensor], kinds: Dict[str, str],
                batches: Sequence, keeps: Sequence, lrs: Sequence[float],
                model: dict, norm: dict, optimizer: dict, max_norm: float,
                precision: Optional[Precision] = None,
                batch_filter: Optional[Callable] = None):
    """Run ``len(batches)`` steps from ``state``.

    ``batches``: (uint8 (B, clips, T, H, W, 3), (B,) labels) on the
    device; ``keeps``: each step's dropout mask, bool (B * clips, 2048);
    ``batch_filter(imgs, labels, keep)`` may drop rows (a planted fault).
    Returns each step's loss, each parameter's clipped gradient of the
    first step, the parameters after the last step, and each step's
    global gradient norm before the clip."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in state.items() if kinds[k] in PARAM_KINDS}
    rest = {k: v for k, v in state.items() if kinds[k] not in PARAM_KINDS}
    names = list(params)
    wd = optimizer.get('weight_decay', 0.0)
    momentum = optimizer.get('momentum', 0.0)
    nesterov = optimizer.get('nesterov', False)
    dtype = params['backbone.conv1.weight'].dtype
    bufs: Dict[str, torch.Tensor] = {}
    losses: List[float] = []
    norms: List[float] = []
    first_grads = None
    for (imgs, labels), keep, lr in zip(batches, keeps, lrs):
        if batch_filter is not None:
            imgs, labels, keep = batch_filter(imgs, labels, keep)
        ops = Ops({**params, **rest}, train=True, precision=precision)
        out = logits(ops, clips_of(imgs, norm, dtype), model, keep)
        loss = F.cross_entropy(out, labels.reshape(-1))
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        total = torch.sqrt(sum(g.double().pow(2).sum() for g in grads))
        norms.append(float(total))
        scale = torch.clamp(max_norm / (total + 1e-6), max=1.0).to(dtype)
        grads = [g * scale for g in grads]
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = params[k]
                d = g + wd * p
                if momentum:
                    if k in bufs:
                        bufs[k].mul_(momentum).add_(d)
                    else:
                        bufs[k] = d.clone()
                    d = d + momentum * bufs[k] if nesterov else bufs[k]
                p.sub_(lr * d)
        losses.append(float(loss.detach()))
        del grads, out, loss
    final = {k: v.detach() for k, v in params.items()}
    return losses, first_grads, final, norms
