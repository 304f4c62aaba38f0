"""Optimizer and LR schedule (counterpart of ``mvfnet_tpu/engine/optim.py``).

The same semantics, on the port's parameter names (the reference's torch
names) and with ``torch.optim.SGD`` in place of an optax chain:

- torch SGD: coupled weight decay (``g + wd*p`` before the momentum
  buffer), momentum, nesterov
- paramwise options (``bias_lr_mult``, ``bias_decay_mult``,
  ``norm_decay_mult``), with the reference's norm regex
  ``(bn|gn)(\\d+)?.(weight|bias)``, which takes the deep stem's
  ``stem_bn*`` and a GroupNorm's affine (named ``bn*`` as a BatchNorm's) and
  misses a residual downsample's norm (``downsample.1.*``, the avg_down
  shortcut's too): that norm gets full weight decay, as in the reference;
  X3D's temporal stem norm ``conv1_3x1.1.*``, which the regex misses too,
  is a norm parameter, as the JAX package labels its ``conv1_3x1_bn``, and
  so are MobileNetV2's norms at d-li14's Sequential indices
  (``features.0.1``, ``features.K.conv.{1,4,7}``, ``conv.1``), the JAX
  package's ``*_bn`` modules
- frozen parameters: in no group, so no update, no momentum and no decay;
  they keep their gradients, and the clip counts them, as the JAX chain
  clips before it freezes
- the clip by global L2 norm, ``torch.nn.utils.clip_grad_norm_`` semantics
  (``max_norm / (norm + 1e-6)``, clamped at 1)
- step LR with gamma at epoch milestones, or cosine, after a linear
  iteration warmup (mmcv ``LrUpdaterHook``); a schedule is a plain function
  of the integer step, counted from 0
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import torch

_NORM = re.compile(r'(bn|gn)(\d+)?.(weight|bias)|\.conv1_3x1\.1\.'
                   r'|\.features\.0\.1\.|\.features\.\d+\.conv\.[147]\.'
                   r'|^backbone\.conv\.1\.')
NORM_FROZEN = '__norm_frozen__:'
# a 2-D non-local block, which the JAX package keeps beside its stage's
# blocks (``nonlocal{i}_{j}``), outside the stage's frozen prefix
_NONLOCAL_2D = re.compile(r'backbone\.layer\d+\.\d+\.nl\.')


def make_step_lr_schedule(base_lr: float,
                          milestones_epochs: Sequence[int],
                          iters_per_epoch: int,
                          gamma: float = 0.1,
                          warmup: Optional[str] = 'linear',
                          warmup_iters: int = 0,
                          warmup_ratio: float = 0.1) -> Callable[[int], float]:
    """mmcv 'step' policy and linear warmup. The warmup factor multiplies
    the already-decayed LR, so a milestone inside the warmup decays first."""
    milestones = [m * iters_per_epoch for m in milestones_epochs]

    def schedule(step: int) -> float:
        lr = base_lr * gamma ** float(sum(step >= m for m in milestones))
        if warmup == 'linear' and warmup_iters > 0 and step < warmup_iters:
            k = (1 - step / warmup_iters) * (1 - warmup_ratio)
            lr = lr * (1 - k)
        return lr

    return schedule


def build_lr_schedule(lr_config: Dict[str, Any], base_lr: float,
                      iters_per_epoch: int,
                      total_epochs: int) -> Callable[[int], float]:
    """The config's ``lr_config`` as a function of the step. 'cosine' is
    optax's ``cosine_decay_schedule`` over ``total_epochs*iters_per_epoch``
    steps, joined after a linear warmup from ``warmup_ratio*base_lr``: past
    the warmup it counts from ``step - warmup_iters``."""
    policy = lr_config.get('policy', 'step')
    warmup = lr_config.get('warmup')
    warmup_iters = lr_config.get('warmup_iters', 0)
    warmup_ratio = lr_config.get('warmup_ratio', 0.1)
    if policy == 'step':
        return make_step_lr_schedule(
            base_lr, lr_config['step'], iters_per_epoch,
            gamma=lr_config.get('gamma', 0.1), warmup=warmup,
            warmup_iters=warmup_iters, warmup_ratio=warmup_ratio)
    if policy != 'cosine':
        raise NotImplementedError(f'lr policy {policy}')
    decay_steps = total_epochs * iters_per_epoch
    alpha = lr_config.get('min_lr_ratio', 0.0)

    def cosine(step: int) -> float:
        t = min(step, decay_steps)
        return base_lr * ((1 - alpha) * 0.5
                          * (1 + math.cos(math.pi * t / decay_steps)) + alpha)

    if warmup != 'linear' or warmup_iters <= 0:
        return cosine
    start = base_lr * warmup_ratio

    def schedule(step: int) -> float:
        if step < warmup_iters:
            frac = 1 - step / warmup_iters
            return (start - base_lr) * frac + base_lr
        return cosine(step - warmup_iters)

    return schedule


def param_label(name: str, frozen_prefixes: Sequence[str] = ()) -> str:
    """'frozen' | 'norm' | 'bias' | 'default' for a parameter name. A prefix
    ``NORM_FROZEN + root`` freezes every norm parameter under ``root``. The
    norm test is the reference's regex (``codes/core/train.py:143``), quirk
    included: ``downsample.1.weight`` has no 'bn' in it. A stage's prefix
    leaves its 2-D non-local blocks alone, as the JAX package's does."""
    norm = _NORM.search(name) is not None
    for pref in frozen_prefixes:
        if pref.startswith(NORM_FROZEN):
            if norm and name.startswith(pref[len(NORM_FROZEN):]):
                return 'frozen'
        elif name.startswith(pref) and not (
                pref.startswith('backbone.layer')
                and _NONLOCAL_2D.match(name)):
            return 'frozen'
    if norm:
        return 'norm'
    if name.endswith('.bias'):
        return 'bias'
    return 'default'


def frozen_prefixes_from_backbone(backbone_cfg: Dict[str, Any]) -> tuple:
    """The reference's ``frozen_stages`` (stem, the deep stem's and X3D's
    temporal stem too, and stages 1..k) and ``norm_frozen`` (every
    backbone norm's affine) as name prefixes. They are the JAX package's
    prefixes on its names: SlowFast's pathway modules (``slow_path.``,
    ``fast_path.``) match none of them there either."""
    prefixes = []
    frozen_stages = backbone_cfg.get('frozen_stages', -1)
    if frozen_stages is not None and frozen_stages >= 0:
        prefixes += ['backbone.conv1.', 'backbone.bn1.', 'backbone.stem_',
                     'backbone.conv1_3x1.']
        prefixes += [f'backbone.layer{i}.'
                     for i in range(1, frozen_stages + 1)]
    if backbone_cfg.get('norm_frozen'):
        prefixes.append(NORM_FROZEN + 'backbone.')
    return tuple(prefixes)


class ClippedSGD(torch.optim.SGD):
    """``torch.optim.SGD`` whose groups carry ``label`` and ``lr_mult``, and
    which clips the gradients of ``clip_params`` before its step.
    ``label_weight_decay`` is each trained label's weight decay, a label
    without parameters included: the JAX package's chain has a state for
    every label (``utils.checkpoint.optax_state_from_optimizer``)."""

    def __init__(self, groups, clip_params: Iterable[torch.nn.Parameter],
                 max_norm: Optional[float],
                 label_weight_decay: Dict[str, float], **defaults):
        super().__init__(groups, **defaults)
        self.clip_params = list(clip_params)
        self.max_norm = max_norm
        self.label_weight_decay = dict(label_weight_decay)

    def clip_grads(self) -> torch.Tensor:
        """Scale every gradient by ``min(1, max_norm / (norm + 1e-6))``
        (no clip without ``max_norm``); returns the norm before the clip."""
        params = [p for p in self.clip_params if p.grad is not None]
        max_norm = math.inf if self.max_norm is None else self.max_norm
        return torch.nn.utils.clip_grad_norm_(params, max_norm)

    def set_lr(self, lr: float) -> None:
        """Each group's LR to ``lr * lr_mult``."""
        for group in self.param_groups:
            group['lr'] = lr * group['lr_mult']


def build_optimizer(model: torch.nn.Module,
                    optimizer_cfg: Dict[str, Any],
                    lr_schedule: Callable[[int], float],
                    grad_clip: Optional[Dict[str, Any]] = None,
                    frozen_prefixes: Sequence[str] = ()) -> ClippedSGD:
    """SGD with one group per label (frozen parameters in none), its LR set
    to ``lr_schedule(0)``; ``grad_clip`` is ``dict(max_norm, norm_type=2)``."""
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop('type', 'SGD')
    if opt_type != 'SGD':
        raise NotImplementedError(f'optimizer {opt_type}')
    paramwise = cfg.pop('paramwise_options', None) or {}
    weight_decay = cfg.get('weight_decay', 0.0)
    mults = {  # label: (lr_mult, decay_mult)
        'default': (1.0, 1.0),
        'bias': (paramwise.get('bias_lr_mult', 1.0),
                 paramwise.get('bias_decay_mult', 1.0)),
        'norm': (1.0, paramwise.get('norm_decay_mult', 1.0)),
    }
    by_label: Dict[str, list] = {k: [] for k in mults}
    for name, p in model.named_parameters():
        label = param_label(name, frozen_prefixes)
        if label != 'frozen':
            by_label[label].append(p)
    groups = [dict(params=ps, label=label, lr_mult=mults[label][0],
                   weight_decay=weight_decay * mults[label][1],
                   lr=lr_schedule(0) * mults[label][0])
              for label, ps in by_label.items() if ps]
    max_norm = None
    if grad_clip:
        if grad_clip.get('norm_type', 2) != 2:
            raise NotImplementedError('only the L2 norm clip is ported')
        max_norm = grad_clip['max_norm']
    return ClippedSGD(groups, model.parameters(), max_norm,
                      {label: weight_decay * mult[1]
                       for label, mult in mults.items()},
                      lr=lr_schedule(0), momentum=cfg.get('momentum', 0.0),
                      weight_decay=weight_decay,
                      nesterov=cfg.get('nesterov', False))
