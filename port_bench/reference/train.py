"""Plain float32 reference of the MVFNet train step.

Train-mode forward with the batch's BatchNorm statistics, TSN dropout with
the mask's kept entries given, mean cross-entropy, the backward by
autograd, the clip of every gradient by the global L2 norm
(``max_norm / (norm + 1e-6)``, at most 1), and torch's SGD with coupled
weight decay, momentum and nesterov at the step's LR. Imports nothing of
the program under test.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .models import Ops, Precision, mvf_resnet_train_logits, normalize

PARAM_KINDS = ('conv', 'tap', 'bn_weight', 'bn_bias', 'fc', 'fc_bias')


def train_steps(state: Dict[str, torch.Tensor], kinds: Dict[str, str],
                batches: Sequence, keeps: Sequence, lrs: Sequence[float],
                model: dict, norm: dict, optimizer: dict, max_norm: float,
                precision: Optional[Precision] = None,
                batch_filter: Optional[Callable] = None):
    """Run ``len(batches)`` steps from ``state``.

    ``batches``: (uint8 (B, T, H, W, 3) frames, (B,) labels) on the
    device; ``keeps``: each step's dropout mask, bool (B*T, C);
    ``batch_filter(imgs, labels, keep)`` may drop rows (a planted fault).
    Returns each step's loss, each parameter's clipped gradient of the
    first step, the parameters after the last step, and each step's
    global gradient norm before the clip."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in state.items() if kinds[k] in PARAM_KINDS}
    rest = {k: v for k, v in state.items() if kinds[k] not in PARAM_KINDS}
    names = list(params)
    lr_wd = optimizer.get('weight_decay', 0.0)
    momentum = optimizer.get('momentum', 0.0)
    nesterov = optimizer.get('nesterov', False)
    bufs: Dict[str, torch.Tensor] = {}
    losses: List[float] = []
    norms: List[float] = []
    first_grads = None
    for (imgs, labels), keep, lr in zip(batches, keeps, lrs):
        if batch_filter is not None:
            imgs, labels, keep = batch_filter(imgs, labels, keep)
        b = imgs.shape[0]
        x = normalize(imgs, norm, params['backbone.conv1.weight'].dtype)
        x = x.reshape((-1,) + tuple(x.shape[2:])).permute(0, 3, 1, 2)
        ops = Ops({**params, **rest}, train=True, precision=precision)
        logits = mvf_resnet_train_logits(ops, x, b, keep, model)
        loss = F.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        total = torch.sqrt(sum(g.double().pow(2).sum() for g in grads))
        norms.append(float(total))
        scale = torch.clamp(max_norm / (total + 1e-6), max=1.0).to(grads[0].dtype)
        grads = [g * scale for g in grads]
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = params[k]
                d = g + lr_wd * p
                if momentum:
                    if k in bufs:
                        bufs[k].mul_(momentum).add_(d)
                    else:
                        bufs[k] = d.clone()
                    d = d + momentum * bufs[k] if nesterov else bufs[k]
                p.sub_(lr * d)
        losses.append(float(loss.detach()))
        del grads, logits, loss
    final = {k: v.detach() for k, v in params.items()}
    return losses, first_grads, final, norms
