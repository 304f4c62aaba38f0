"""Plain float32 reference models of the benchmark's configurations.

Written from the models' equations, in plain ``torch`` operations, with no
kernel, folding or layout trick and nothing imported from the program
under test. Each model is a set of functions over a flat parameter dict
whose names are the reference torch state-dict names (mmaction / MVFNet),
so one state dict loads into the program and into this file alike.

- ``mvf_resnet``: MVFNet ResNet (Wu et al., AAAI 2021): a ResNet
  bottleneck trunk in which conv1 of every block of the stages that
  ``mvf_freq`` selects is preceded by Multi-View Fusion: the first
  ``int(alpha * C)`` channels pass through three depthwise 3-taps (along T,
  H and W of each clip of ``n_segment`` frames), summed, BatchNorm and
  hardswish, and are concatenated with the untouched channels. TSN head:
  spatial mean, dropout (train), FC, mean over the segments; in the dense
  test (``fcn_testing``) each clip's maps are averaged over (T, H, W)
  before the FC.
- ``i3d_resnet``: I3D ResNet-50 with 3x1x1 inflation (Carreira and
  Zisserman 2017; the ResNet form of Wang et al. 2018): a 5x7x7 stem with
  temporal stride 2, a (1, 3, 3) max pool with temporal stride 2, every
  bottleneck's conv1 a 3x1x1 conv, a (2, 1, 1) max pool after stage 1,
  the mean over (T, H, W) and an FC.

``Counter`` counts the multiply-adds of the convolutions and the FC (two
FLOPs each) from the shapes alone: run a model on the ``meta`` device with
one to count a configuration's FLOPs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class Counter:
    """FLOPs of the convolutions and FCs a forward ran (2 per
    multiply-add), and those of the first conv, whose input gradient a
    backward pass does not compute."""

    def __init__(self):
        self.flops = 0
        self.stem_flops = None

    def add(self, out: torch.Tensor, w: torch.Tensor):
        # out (N, Cout, ...), w (Cout, Cin/groups, k...): one MAC per
        # output value and weight tap of its group
        n = 2 * out.numel() * w[0].numel()
        if self.stem_flops is None:
            self.stem_flops = n
        self.flops += n


class _Round(torch.autograd.Function):
    """Round to a lower precision in the forward and the gradient in the
    backward."""

    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return precision.round(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.precision.round(g), None


class Precision:
    """How a reference computes: float32 (``None``), or every tensor that
    a program computing in ``dtype`` would hold in it rounded to
    ``dtype``: each conv's and FC's input, weight and output and each
    BatchNorm's output, forward and their gradients backward, with a
    per-tensor scale for the float8 types (the usual float8 recipe). The
    accumulation stays float32. Such a reference in the program's place is
    the control that a lower precision than the configuration's reads."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        self.dtype = dtype

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            top = torch.finfo(self.dtype).max
            scale = top / t.abs().amax().clamp(min=1e-30)
            return (t * scale).to(self.dtype).to(t.dtype) / scale
        return t.to(self.dtype).to(t.dtype)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return t
        return _Round.apply(t, self)


class Ops:
    """Convolution, FC and BatchNorm over the parameter dict ``p``."""

    def __init__(self, p: Dict[str, torch.Tensor], train: bool = False,
                 counter: Optional[Counter] = None,
                 precision: Optional[Precision] = None):
        self.p = p
        self.train = train
        self.counter = counter
        self.q = precision or Precision()

    def conv(self, x, name, stride=1, padding=0, groups=1):
        w = self.p[name]
        fn = F.conv3d if w.dim() == 5 else F.conv2d
        out = self.q(fn(self.q(x), self.q(w), None, stride, padding, 1,
                        groups))
        if self.counter is not None:
            self.counter.add(out, w)
        return out

    def fc(self, x, name):
        w = self.p[name + '.weight']
        out = self.q(self.q(x) @ self.q(w).t() + self.p[name + '.bias'])
        if self.counter is not None:
            self.counter.add(out, w)
        return out

    def bn(self, x, name):
        """BatchNorm over channel dim 1: the batch's mean and biased
        variance in training, the running statistics in eval."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.train:
            dims = [0] + list(range(2, x.dim()))
            mean = x.mean(dims)
            var = x.var(dims, unbiased=False)
        else:
            mean = self.p[name + '.running_mean']
            var = self.p[name + '.running_var']
        inv = torch.rsqrt(var + BN_EPS) * self.p[name + '.weight']
        return self.q((x - mean.view(shape)) * inv.view(shape)
                      + self.p[name + '.bias'].view(shape))


def _bn_spec(name: str, c: int) -> List[Tuple[str, tuple, str]]:
    return [(f'{name}.weight', (c,), 'bn_weight'),
            (f'{name}.bias', (c,), 'bn_bias'),
            (f'{name}.running_mean', (c,), 'bn_mean'),
            (f'{name}.running_var', (c,), 'bn_var'),
            (f'{name}.num_batches_tracked', (), 'count')]


def _stages(depth: int):
    """(stage index, blocks, planes, stride) of a ResNet-50/101."""
    return [(i, n, 64 * 2 ** i, 1 if i == 0 else 2)
            for i, n in enumerate(STAGE_BLOCKS[depth])]


# ----------------------------------------------------------- MVFNet ResNet

def mvf_resnet_spec(model: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every state-dict entry of an MVFNet ResNet
    recognizer ``model`` (the config's model dict)."""
    bb, mc, head = model['backbone'], model['module_cfg'], model['cls_head']
    spec = [('backbone.conv1.weight', (64, 3, 7, 7), 'conv')]
    spec += _bn_spec('backbone.bn1', 64)
    inplanes = 64
    for i, blocks, planes, _ in _stages(bb['depth']):
        for j in range(blocks):
            pre = f'backbone.layer{i + 1}.{j}'
            if mc['mvf_freq'][i]:
                cs = int(inplanes * mc['alpha'])
                spec += [(f'{pre}.conv1.net.weight', (planes, inplanes, 1, 1),
                          'conv'),
                         (f'{pre}.conv1.shift_conv.weight', (cs, 1, 3, 1, 1),
                          'tap'),
                         (f'{pre}.conv1.h_conv.weight', (cs, 1, 1, 3, 1),
                          'tap'),
                         (f'{pre}.conv1.w_conv.weight', (cs, 1, 1, 1, 3),
                          'tap')]
                spec += _bn_spec(f'{pre}.conv1.bn', cs)
            else:
                spec.append((f'{pre}.conv1.weight', (planes, inplanes, 1, 1),
                             'conv'))
            spec += _bn_spec(f'{pre}.bn1', planes)
            spec.append((f'{pre}.conv2.weight', (planes, planes, 3, 3),
                         'conv'))
            spec += _bn_spec(f'{pre}.bn2', planes)
            spec.append((f'{pre}.conv3.weight', (4 * planes, planes, 1, 1),
                         'conv'))
            spec += _bn_spec(f'{pre}.bn3', 4 * planes)
            if j == 0:
                spec.append((f'{pre}.downsample.0.weight',
                             (4 * planes, inplanes, 1, 1), 'conv'))
                spec += _bn_spec(f'{pre}.downsample.1', 4 * planes)
            inplanes = 4 * planes
    spec += [('cls_head.new_fc.weight', (head['num_classes'], inplanes),
              'fc'),
             ('cls_head.new_fc.bias', (head['num_classes'],), 'fc_bias')]
    return spec


def _mvf(ops: Ops, x, pre, n_seg, alpha):
    """Multi-View Fusion of conv1's input, then conv1. x: (N*T, C, H, W)."""
    nt, c, h, w = x.shape
    cs = int(c * alpha)
    xs = x[:, :cs].reshape(nt // n_seg, n_seg, cs, h, w).transpose(1, 2)
    y = (ops.conv(xs, f'{pre}.shift_conv.weight', padding=(1, 0, 0),
                  groups=cs)
         + ops.conv(xs, f'{pre}.h_conv.weight', padding=(0, 1, 0),
                    groups=cs)
         + ops.conv(xs, f'{pre}.w_conv.weight', padding=(0, 0, 1),
                    groups=cs))
    y = y.transpose(1, 2).reshape(nt, cs, h, w)
    y = ops.bn(y, f'{pre}.bn')
    y = y * torch.clamp(y + 3, 0, 6) / 6                 # hardswish
    return ops.conv(torch.cat([y, x[:, cs:]], 1), f'{pre}.net.weight')


def mvf_resnet_backbone(ops: Ops, x, model: dict):
    """(N*T, 3, H, W) float32 -> (N*T, 2048, H/32, W/32)."""
    bb, mc = model['backbone'], model['module_cfg']
    x = torch.relu(ops.bn(ops.conv(x, 'backbone.conv1.weight', 2, 3),
                          'backbone.bn1'))
    x = F.max_pool2d(x, 3, 2, 1)
    for i, blocks, _, stride in _stages(bb['depth']):
        for j in range(blocks):
            pre = f'backbone.layer{i + 1}.{j}'
            s = stride if j == 0 else 1
            if mc['mvf_freq'][i]:
                out = _mvf(ops, x, f'{pre}.conv1', mc['n_segment'],
                           mc['alpha'])
            else:
                out = ops.conv(x, f'{pre}.conv1.weight')
            out = torch.relu(ops.bn(out, f'{pre}.bn1'))
            out = torch.relu(ops.bn(ops.conv(out, f'{pre}.conv2.weight', s,
                                             1), f'{pre}.bn2'))
            out = ops.bn(ops.conv(out, f'{pre}.conv3.weight'), f'{pre}.bn3')
            if j == 0:
                x = ops.bn(ops.conv(x, f'{pre}.downsample.0.weight', s),
                           f'{pre}.downsample.1')
            x = torch.relu(out + x)
    return x


def mvf_resnet_dense_logits(ops: Ops, frames, model: dict):
    """Dense-test logits of clips: frames (V*T, 3, H, W) float32, T =
    ``n_segment`` consecutive frames a clip -> (V, classes)."""
    t = model['module_cfg']['n_segment']
    x = mvf_resnet_backbone(ops, frames, model)
    x = x.reshape((-1, t) + tuple(x.shape[1:]))
    return ops.fc(x.mean(dim=(1, 3, 4)), 'cls_head.new_fc')


def mvf_resnet_train_logits(ops: Ops, frames, batch: int, keep, model):
    """TSN train logits: frames (B*T, 3, H, W), ``keep`` the dropout
    mask's kept entries (B*T, C) -> (B, classes), the mean over the T
    segments of each frame's FC."""
    p = model['cls_head']['dropout_ratio']
    x = mvf_resnet_backbone(ops, frames, model).mean(dim=(2, 3))
    if keep is not None:
        x = torch.where(keep, x / (1 - p), torch.zeros_like(x))
    score = ops.fc(x, 'cls_head.new_fc')
    return score.reshape(batch, -1, score.shape[-1]).mean(dim=1)


# -------------------------------------------------------------- I3D ResNet

def i3d_resnet_spec(model: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every state-dict entry of an I3D ResNet
    recognizer with 3x1x1 inflation in every block."""
    bb, head = model['backbone'], model['cls_head']
    kt, kh, kw = bb['conv1_kernel']
    spec = [('backbone.conv1.weight', (64, 3, kt, kh, kw), 'conv')]
    spec += _bn_spec('backbone.bn1', 64)
    inplanes = 64
    for i, blocks, planes, _ in _stages(bb['depth']):
        for j in range(blocks):
            pre = f'backbone.layer{i + 1}.{j}'
            spec.append((f'{pre}.conv1.weight', (planes, inplanes, 3, 1, 1),
                         'conv'))
            spec += _bn_spec(f'{pre}.bn1', planes)
            spec.append((f'{pre}.conv2.weight', (planes, planes, 1, 3, 3),
                         'conv'))
            spec += _bn_spec(f'{pre}.bn2', planes)
            spec.append((f'{pre}.conv3.weight',
                         (4 * planes, planes, 1, 1, 1), 'conv'))
            spec += _bn_spec(f'{pre}.bn3', 4 * planes)
            if j == 0:
                spec.append((f'{pre}.downsample.0.weight',
                             (4 * planes, inplanes, 1, 1, 1), 'conv'))
                spec += _bn_spec(f'{pre}.downsample.1', 4 * planes)
            inplanes = 4 * planes
    spec += [('cls_head.fc_cls.weight', (head['num_classes'], inplanes),
              'fc'),
             ('cls_head.fc_cls.bias', (head['num_classes'],), 'fc_bias')]
    return spec


def i3d_resnet_backbone(ops: Ops, x, model: dict):
    """(N, 3, T, H, W) float32 -> (N, 2048, T/8, H/32, W/32)."""
    bb = model['backbone']
    kt, kh, kw = bb['conv1_kernel']
    x = ops.conv(x, 'backbone.conv1.weight', (bb['conv1_stride_t'], 2, 2),
                 ((kt - 1) // 2, (kh - 1) // 2, (kw - 1) // 2))
    x = torch.relu(ops.bn(x, 'backbone.bn1'))
    x = F.max_pool3d(x, (1, 3, 3), (bb['pool1_stride_t'], 2, 2), (0, 1, 1))
    for i, blocks, _, stride in _stages(bb['depth']):
        for j in range(blocks):
            pre = f'backbone.layer{i + 1}.{j}'
            s = stride if j == 0 else 1
            out = torch.relu(ops.bn(ops.conv(x, f'{pre}.conv1.weight', 1,
                                             (1, 0, 0)), f'{pre}.bn1'))
            out = torch.relu(ops.bn(ops.conv(out, f'{pre}.conv2.weight',
                                             (1, s, s), (0, 1, 1)),
                                    f'{pre}.bn2'))
            out = ops.bn(ops.conv(out, f'{pre}.conv3.weight'), f'{pre}.bn3')
            if j == 0:
                x = ops.bn(ops.conv(x, f'{pre}.downsample.0.weight',
                                    (1, s, s)), f'{pre}.downsample.1')
            x = torch.relu(out + x)
        if i == 0:
            x = F.max_pool3d(x, (2, 1, 1), (2, 1, 1))
    return x


def i3d_resnet_dense_logits(ops: Ops, clips, model: dict):
    """clips (V, 3, T, H, W) float32 -> (V, classes)."""
    x = i3d_resnet_backbone(ops, clips, model)
    return ops.fc(x.mean(dim=(2, 3, 4)), 'cls_head.fc_cls')


# ------------------------------------------------------------------ common

FAMILIES = {
    'Recognizer2D': (mvf_resnet_spec, mvf_resnet_dense_logits),
    'Recognizer3D': (i3d_resnet_spec, i3d_resnet_dense_logits),
}


def spec(model: dict):
    return FAMILIES[model['type']][0](model)


def normalize(video: torch.Tensor, norm: dict,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (..., 3) BGR frames -> float32, channels flipped to RGB when
    ``to_rgb``, (x - mean) / std, then cast to ``dtype``: the
    normalization is float32 arithmetic whatever the model computes in."""
    x = video.to(torch.float32)
    if norm.get('to_rgb'):
        x = x.flip(-1)
    mean = torch.tensor(norm['mean'], dtype=torch.float32, device=x.device)
    std = torch.tensor(norm['std'], dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def dense_clip_logits(p, video, model: dict, norm: dict,
                      clips_per_block: int = 5,
                      precision: Optional[Precision] = None):
    """Per-clip logits of one dense-test video, in blocks of clips.

    ``video``: uint8 ``(V*T, H, W, 3)`` for a 2-D recognizer (V clips of
    T frames in order) or ``(V, T, H, W, 3)`` for a 3-D one. Computes in
    the parameters' dtype."""
    ops = Ops(p, precision=precision)
    dtype = p['backbone.conv1.weight'].dtype
    fn = FAMILIES[model['type']][1]
    outs = []
    if model['type'] == 'Recognizer2D':
        t = model['module_cfg']['n_segment']
        step = clips_per_block * t
        for k in range(0, video.shape[0], step):
            x = normalize(video[k:k + step], norm, dtype).permute(0, 3, 1, 2)
            outs.append(fn(ops, x, model))
    else:
        for k in range(0, video.shape[0], clips_per_block):
            x = normalize(video[k:k + clips_per_block], norm, dtype)
            outs.append(fn(ops, x.permute(0, 4, 1, 2, 3), model))
    return torch.cat(outs)


def prob_average(logits: torch.Tensor) -> torch.Tensor:
    """The 'prob' clip average: softmax of each clip's logits, then the
    mean over the clips."""
    return torch.softmax(logits, dim=-1).mean(dim=0)


def count_flops(model: dict, shape, train: bool = False) -> int:
    """FLOPs of one forward (``train``: forward and backward) of
    ``model`` on a batch of ``shape``: ``(V*T, H, W, 3)`` frames for a 2-D
    recognizer, ``(V, T, H, W, 3)`` clips for a 3-D one, counted on the
    ``meta`` device. The backward is twice the forward (the gradients of
    the inputs and of the weights), less the input gradient of the first
    conv, which no one needs."""
    p = {name: torch.empty(s, device='meta') for name, s, _ in spec(model)}
    counter = Counter()
    ops = Ops(p, train=train, counter=counter)
    x = torch.empty(shape, device='meta')
    if model['type'] == 'Recognizer2D':
        if train:
            mvf_resnet_train_logits(ops, x.permute(0, 3, 1, 2),
                                    1, None, model)
        else:
            mvf_resnet_dense_logits(ops, x.permute(0, 3, 1, 2), model)
    else:
        i3d_resnet_dense_logits(ops, x.permute(0, 4, 1, 2, 3), model)
    if not train:
        return counter.flops
    return 3 * counter.flops - counter.stem_flops
