"""Train and dense-test steps (counterpart of
``mvfnet_tpu/engine/train_step.py``).

A train step is forward, cross-entropy, backward, the clip by global norm,
the LR of the step and one SGD update, as the JAX package's jitted step
computes them; here they are eager PyTorch calls on the device. Over more
than one process (``parallel.init_distributed``) each rank takes its share
of the global batch through ``DistributedDataParallel``, with BatchNorm
over the global batch (the JAX default) or per rank (``local_bn``). With
``remat`` the backbone checkpoints its activations per res-stage
(``models/backbones/resnet.py``), the JAX step's ``jax.checkpoint``: the
same losses, gradients, parameters and BatchNorm statistics, less memory.
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
                   device: Union[None, str, torch.device] = None,
                   extract_feat: bool = False) -> Callable:
    """Build ``eval_step(model, imgs) -> scores`` for dense testing, or
    ``-> features`` (``model.forward_extract_feat``) with ``extract_feat``.

    ``imgs`` is a ``(B, S, H, W, C)`` array or tensor, ``(B, clips, T, H,
    W, C)`` for a ``Recognizer3D`` (uint8 when the pipeline deferred
    ``Normalize`` to the device, ``norm_cfg['device']``).
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
            if extract_feat:
                return model.forward_extract_feat(imgs)
            return model(imgs, None, return_loss=False)

    return eval_step


@dataclass
class TrainState:
    """What the train step carries between calls besides the model and the
    optimizer: the number of steps taken, which indexes the LR schedule."""
    step: int = 0


def dropout_seed(seed: int, step: int, rank: Optional[int] = None) -> int:
    """The dropout generator's seed for ``step`` of a run seeded ``seed``:
    the counterpart of ``jax.random.fold_in(PRNGKey(seed + 1), step)`` in
    the JAX package's loop and step, a function of the pair alone; with
    ``rank``, folded in too (``fold_in(..., axis_index)`` of the JAX
    step's per-shard BatchNorm)."""
    entropy = [seed + 1, step] + ([] if rank is None else [rank])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def _ddp(model: torch.nn.Module, device: torch.device):
    """``model`` in ``DistributedDataParallel`` without buffer broadcasts:
    global BatchNorm keeps the buffers equal by itself and per-rank
    BatchNorm averages them after the step. Newer torch spells the switch
    ``forward_sync_buffers`` and warns at ``broadcast_buffers``."""
    import inspect
    from torch.nn.parallel import DistributedDataParallel
    params = inspect.signature(DistributedDataParallel.__init__).parameters
    off = ('forward_sync_buffers' if 'forward_sync_buffers' in params
           else 'broadcast_buffers')
    ids = dict(device_ids=[device.index if device.index is not None
                           else torch.cuda.current_device()]) \
        if device.type == 'cuda' else {}
    return DistributedDataParallel(model, **ids, **{off: False})


def _bn_buffers(model: torch.nn.Module):
    from ..models.common import BatchNorm
    return [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]


def make_train_step(model: torch.nn.Module,
                    optimizer,
                    lr_schedule: Callable[[int], float],
                    norm_cfg: Optional[Dict[str, Any]] = None,
                    device: Union[None, str, torch.device] = None,
                    seed: Optional[int] = None,
                    local_bn: bool = False,
                    remat: bool = False) -> Callable:
    """Build ``train_step(imgs, labels, generator=None) -> metrics``.

    ``optimizer`` is ``engine.optim.build_optimizer``'s. ``imgs`` is a
    ``(B, S, H, W, C)`` array or tensor, ``(B, clips, T, H, W, C)`` for a
    ``Recognizer3D`` (uint8 when ``norm_cfg['device']``
    defers normalization to the device), ``labels`` ``(B,)`` class indices,
    ``generator`` the dropout mask's generator on ``device`` (CUDA by
    default). Without one, and with ``seed``, step t draws its mask from a
    generator on the device seeded with ``dropout_seed(seed, t)``, so a run
    resumed at step t draws the masks of an unbroken one; with neither, the
    device's default generator draws it. The frames are normalized on the
    device into the model's compute dtype. The LR of step t is
    ``lr_schedule(t)``, t counted from 0 in ``train_step.state``.

    ``metrics``: the head's losses, ``loss`` (the sum of every entry whose
    key holds 'loss'), ``grad_norm`` (the global L2 norm of every gradient,
    frozen parameters' too, before the clip), as 0-d tensors on the device,
    and ``lr``, a float.

    In a process group of world W > 1, ``imgs`` is this rank's B videos of
    the global W·B batch. The model is wrapped in
    ``DistributedDataParallel``, so the gradients, and with them the clip
    and ``grad_norm``, are the global batch's; the losses are averaged over
    the ranks. BatchNorm normalizes with the global batch's statistics
    (``models.common.set_sync_group``), and every rank draws the dropout
    mask of the global batch from the same seed and keeps its own rows, so
    the step computes what one process computes on the concatenated batch.
    With ``local_bn`` each rank normalizes with its own statistics, the
    running statistics are averaged over the ranks after the step (the JAX
    step stores the mean of the per-shard averages), and each rank draws
    its own mask (the seed folds in the rank). At world 1 neither applies.

    ``remat`` (the config's ``backbone.with_cp``) sets the backbone's
    ``with_cp``: each res-stage's activations (each stage of both
    SlowFast pathways) are recomputed in the backward instead of kept,
    with BatchNorm's running statistics moved once.
    """
    from ..models.common import set_sync_group
    from ..parallel import all_reduce_mean, world_rank
    device = resolve_device(device)
    model.to(device)
    model.backbone.with_cp = remat
    state = TrainState()
    step_generator = (torch.Generator(device=device) if seed is not None
                      else None)
    world, rank = world_rank()
    forward = model
    if world > 1:
        import torch.distributed as dist
        set_sync_group(model, None if local_bn else dist.group.WORLD)
        forward = _ddp(model, device)
    # the head keeps rows rank*B.. of the global batch's dropout mask
    model.cls_head.dropout_shard = (1, 0) if local_bn else (world, rank)
    mask_rank = rank if world > 1 and local_bn else None

    def train_step(imgs, labels, generator=None) -> Dict[str, Any]:
        if generator is None and step_generator is not None:
            generator = step_generator.manual_seed(
                dropout_seed(seed, state.step, mask_rank))
        imgs = maybe_device_normalize(_to_device(imgs, device), norm_cfg,
                                      model.compute_dtype)
        labels = _to_device(labels, device)
        forward.train()
        model.zero_grad(set_to_none=True)
        losses = forward(imgs, labels, return_loss=True, generator=generator)
        total = sum(v for k, v in losses.items() if 'loss' in k)
        total.backward()
        grad_norm = optimizer.clip_grads()
        lr = lr_schedule(state.step)
        optimizer.set_lr(lr)
        optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics['loss'] = total.detach()
        if world > 1:
            # one all_reduce for the losses, one for the BN statistics
            keys = list(metrics)
            mean = all_reduce_mean(torch.stack([metrics[k] for k in keys]))
            metrics = dict(zip(keys, mean.unbind()))
            if local_bn:
                with torch.no_grad():
                    bufs = _bn_buffers(model)
                    flat = all_reduce_mean(torch.cat(
                        [b.reshape(-1) for b in bufs]))
                    for b, v in zip(bufs, flat.split(
                            [b.numel() for b in bufs])):
                        b.copy_(v.view_as(b))
        metrics.update(grad_norm=grad_norm, lr=lr)
        return metrics

    train_step.state = state
    return train_step
