"""Train and dense-test steps (counterpart of
``mvfnet_tpu/engine/train_step.py`` without a mesh or remat).

A train step is forward, cross-entropy, backward, the clip by global norm,
the LR of the step and one SGD update, as the JAX package's jitted step
computes them; here they are eager PyTorch calls on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from ..ops.normalize import maybe_device_normalize


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``device`` or CUDA; raises when CUDA is asked for and absent. The
    port never falls back to the CPU on its own."""
    device = torch.device(device if device is not None else 'cuda')
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; the port runs on the GPU '
                           "unless the caller passes device='cpu'")
    return device


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device, non_blocking=True)


def make_eval_step(model: torch.nn.Module,
                   norm_cfg: Optional[Dict[str, Any]] = None,
                   device: Union[None, str, torch.device] = None
                   ) -> Callable:
    """Build ``eval_step(model, imgs) -> scores`` for dense testing.

    ``imgs`` is a ``(B, S, H, W, C)`` array or tensor (uint8 when the
    pipeline deferred ``Normalize`` to the device, ``norm_cfg['device']``).
    The frames move to ``device`` (CUDA by default), are normalized there,
    and go through the model in ``eval()`` under ``torch.inference_mode()``.
    """
    device = resolve_device(device)
    model.to(device).eval()

    def eval_step(model, imgs):
        imgs = _to_device(imgs, device)
        with torch.inference_mode():
            imgs = maybe_device_normalize(imgs, norm_cfg,
                                          model.compute_dtype)
            return model(imgs, None, return_loss=False)

    return eval_step


@dataclass
class TrainState:
    """What the train step carries between calls besides the model and the
    optimizer: the number of steps taken, which indexes the LR schedule."""
    step: int = 0


def make_train_step(model: torch.nn.Module,
                    optimizer,
                    lr_schedule: Callable[[int], float],
                    norm_cfg: Optional[Dict[str, Any]] = None,
                    device: Union[None, str, torch.device] = None
                    ) -> Callable:
    """Build ``train_step(imgs, labels, generator=None) -> metrics``.

    ``optimizer`` is ``engine.optim.build_optimizer``'s. ``imgs`` is a
    ``(B, S, H, W, C)`` array or tensor (uint8 when ``norm_cfg['device']``
    defers normalization to the device), ``labels`` ``(B,)`` class indices,
    ``generator`` the dropout mask's generator on ``device`` (CUDA by
    default). The frames are normalized on the device into the model's
    compute dtype. The LR of step t is
    ``lr_schedule(t)``, t counted from 0 in ``train_step.state``.

    ``metrics``: the head's losses, ``loss`` (the sum of every entry whose
    key holds 'loss'), ``grad_norm`` (the global L2 norm of every gradient,
    frozen parameters' too, before the clip), as 0-d tensors on the device,
    and ``lr``, a float.
    """
    device = resolve_device(device)
    model.to(device)
    state = TrainState()

    def train_step(imgs, labels, generator=None) -> Dict[str, Any]:
        imgs = maybe_device_normalize(_to_device(imgs, device), norm_cfg,
                                      model.compute_dtype)
        labels = _to_device(labels, device)
        model.train()
        model.zero_grad(set_to_none=True)
        losses = model(imgs, labels, return_loss=True, generator=generator)
        total = sum(v for k, v in losses.items() if 'loss' in k)
        total.backward()
        grad_norm = optimizer.clip_grads()
        lr = lr_schedule(state.step)
        optimizer.set_lr(lr)
        optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(loss=total.detach(), grad_norm=grad_norm, lr=lr)
        return metrics

    train_step.state = state
    return train_step
