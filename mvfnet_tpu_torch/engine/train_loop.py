"""Training loop of the port (counterpart of
``mvfnet_tpu/engine/train_loop.py``).

An eager train step (``train_step.make_train_step``) in a plain epoch loop
with the JAX package's host-side hooks: iteration logging in the same line
format, TensorBoard scalars, ``.pth`` checkpoints and mid-train top-k
evaluation through ``engine.eval.evaluate_dataset``. One process drives one
card: the threaded loader decodes and augments on the host, each batch's
frames go up through one ``prefetch.PinnedStager`` (reused across epochs)
while the step before computes (the labels through the step's own), and
the LR schedule and the clip live in the step.

In a process group (``parallel.init_distributed``) each rank loads its
shard of every epoch, ``videos_per_gpu`` videos a step, so the global
batch is world × ``videos_per_gpu`` as in the JAX package; the step syncs
BatchNorm across ranks unless ``cfg.local_bn``. Every rank resumes from the
same file and evaluates its shard; rank 0 alone writes checkpoints and
TensorBoard scalars and logs (the logger of other ranks is silenced), and
every rank waits at a barrier after each checkpoint.

``resume_from`` and ``load_from`` take the port's ``.pth`` checkpoints and
the JAX package's ``.msgpack`` ones (weights, optax state and the
``.meta.json`` sidecar). The backbone's ``with_cp`` reaches the step as
``make_train_step(remat=...)``, where the JAX loop reads it.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..data import build_dataloader, build_dataset, device_norm_cfg
from ..parallel import barrier, is_main_process, world_rank
from ..utils.checkpoint import (import_torch_state_dict, is_quant_stat,
                                load_checkpoint, load_optax_state,
                                load_torch_state_dict, load_weights,
                                save_checkpoint)
from ..utils.logging import get_root_logger
from ..utils.metrics import top_k_accuracy
from .optim import (build_lr_schedule, build_optimizer,
                    frozen_prefixes_from_backbone)
from .prefetch import PinnedStager, prefetch_to_device
from .train_step import make_train_step, resolve_device


class Hook:
    def before_run(self, loop): ...
    def before_epoch(self, loop): ...
    def after_iter(self, loop, metrics): ...
    def after_epoch(self, loop): ...
    def after_run(self, loop): ...


class TextLoggerHook(Hook):
    """Iteration logging, every ``interval`` iterations, in the JAX loop's
    format: ``Epoch [e][i/n] lr: %.5f, time: %.3fs/iter, k: v, ...``."""

    def __init__(self, interval: int = 20):
        self.interval = interval
        self._t0 = None
        self._count = 0

    def before_epoch(self, loop):
        self._t0 = time.time()
        self._count = 0

    def after_iter(self, loop, metrics):
        self._count += 1
        if loop.iter % self.interval == 0:
            dt = (time.time() - self._t0) / max(self._count, 1)
            self._t0, self._count = time.time(), 0
            msg = ', '.join(f'{k}: {float(v):.4f}'
                            for k, v in metrics.items() if k != 'lr')
            loop.logger.info(
                'Epoch [%d][%d/%d] lr: %.5f, time: %.3fs/iter, %s',
                loop.epoch + 1, loop.inner_iter + 1, loop.iters_per_epoch,
                metrics['lr'], dt, msg)


class TensorboardLoggerHook(Hook):
    """TensorBoard scalars through ``torch.utils.tensorboard``, under
    ``train/``; disabled with a warning when it does not import."""

    def __init__(self, interval: int = 20, log_dir: Optional[str] = None):
        self.interval = interval
        self.log_dir = log_dir
        self._writer = None

    def before_run(self, loop):
        if not is_main_process():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            loop.logger.warning('torch.utils.tensorboard unavailable; '
                                'TensorboardLoggerHook disabled')
            return
        self._writer = SummaryWriter(
            self.log_dir or os.path.join(loop.work_dir, 'tf_logs'))

    def after_iter(self, loop, metrics):
        if self._writer is None or loop.iter % self.interval != 0:
            return
        for k, v in metrics.items():
            self._writer.add_scalar(f'train/{k}', float(v), loop.step)

    def after_run(self, loop):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class CheckpointHook(Hook):
    """``epoch_{n}.pth`` and ``latest.pth`` every ``interval`` epochs and
    at the last one, written by rank 0; every rank waits for them."""

    def __init__(self, interval: int = 10, out_dir: Optional[str] = None):
        self.interval = interval
        self.out_dir = out_dir

    def after_epoch(self, loop):
        if (loop.epoch + 1) % self.interval != 0 \
                and (loop.epoch + 1) != loop.total_epochs:
            return
        out = self.out_dir or loop.work_dir
        meta = {'epoch': loop.epoch + 1, 'iter': loop.step}
        path = os.path.join(out, f'epoch_{loop.epoch + 1}.pth')
        if is_main_process():
            for p in (path, os.path.join(out, 'latest.pth')):
                save_checkpoint(p, loop.model, loop.optimizer, meta)
            loop.logger.info('saved checkpoint %s', path)
        barrier()


class EvalHook(Hook):
    """Mid-train top-k evaluation of ``dataset_cfg`` every ``interval``
    epochs, each rank on its shard. Each pass appends ``{'epoch', 'top1',
    'top5', 'scores'}`` to ``loop.eval_history`` on every rank (the JAX
    loop's entry, and the scores)."""

    def __init__(self, dataset_cfg: Dict, interval: int = 10,
                 k=(1, 5), videos_per_gpu: int = 1,
                 workers_per_gpu: int = 2):
        self.dataset_cfg = dataset_cfg
        self.interval = interval
        self.k = k
        self.videos_per_gpu = videos_per_gpu
        self.workers_per_gpu = workers_per_gpu
        self._dataset = None

    def after_epoch(self, loop):
        if (loop.epoch + 1) % self.interval != 0:
            return
        from .eval import evaluate_dataset
        if self._dataset is None:
            self._dataset = build_dataset(self.dataset_cfg, loop.device)
        dataset = self._dataset
        scores = evaluate_dataset(
            loop.model, dataset, videos_per_gpu=self.videos_per_gpu,
            workers_per_gpu=self.workers_per_gpu,
            norm_cfg=device_norm_cfg(self.dataset_cfg.get('pipeline')),
            device=loop.device)
        labels = [info['label'] for info in dataset.video_infos]
        accs = top_k_accuracy(scores, labels, k=self.k)
        for kk, acc in zip(self.k, accs):
            loop.logger.info('Eval epoch %d: top-%d acc: %.4f',
                             loop.epoch + 1, kk, acc)
        loop.eval_history.append(
            {'epoch': loop.epoch + 1,
             **{f'top{kk}': a for kk, a in zip(self.k, accs)},
             'scores': scores})


class TrainLoop:
    """The JAX ``TrainLoop`` on this rank's card (``device``, CUDA by
    default).

    Weights come from ``model.init_weights`` with a CPU generator seeded
    ``seed``, then the backbone's ``pretrained`` ``.pth`` through the
    non-strict importer when the file exists; ``cfg.resume_from`` (weights,
    SGD state, epoch and step) or else ``cfg.load_from`` (weights, through
    the importer) follow. ``cfg.frozen_param_prefixes`` are port parameter
    names. Dropout masks come from ``(seed + 1, step)``.
    """

    def __init__(self, model: torch.nn.Module, dataset, cfg,
                 work_dir: Optional[str] = None, logger=None, seed: int = 0,
                 device: Union[None, str, torch.device] = None):
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.work_dir = work_dir or cfg.get('work_dir') or './work_dir'
        self.logger = logger or get_root_logger(cfg.get('log_level', 'INFO'))
        self.seed = seed
        self.eval_history: List[Dict[str, Any]] = []

        self.loader = build_dataloader(
            dataset, cfg.data['videos_per_gpu'], cfg.data['workers_per_gpu'],
            dist=world_rank()[0] > 1, shuffle=True, seed=seed)
        self.iters_per_epoch = len(self.loader)
        self.total_epochs = cfg['total_epochs']
        self.lr_schedule = build_lr_schedule(
            dict(cfg.lr_config), cfg.optimizer['lr'], self.iters_per_epoch,
            self.total_epochs)
        grad_clip = (cfg.get('optimizer_config') or {}).get('grad_clip')
        backbone_cfg = (cfg.get('model') or {}).get('backbone') or {}
        frozen = tuple(cfg.get('frozen_param_prefixes', ()) or ())
        frozen += frozen_prefixes_from_backbone(backbone_cfg)

        model.init_weights(torch.Generator().manual_seed(seed))
        pretrained = backbone_cfg.get('pretrained')
        if pretrained and os.path.exists(pretrained):
            modality = (cfg.get('model') or {}).get('modality', 'RGB')
            import_torch_state_dict(
                model, load_torch_state_dict(pretrained),
                inflate_in_channels={'Flow': 10, 'RGBDiff': 15}.get(modality),
                logger=self.logger)
            self.logger.info('imported pretrained backbone from %s',
                             pretrained)
        elif pretrained:
            self.logger.info('pretrained backbone %s not found; training '
                             'from the random init', pretrained)
        model.to(self.device)
        self.optimizer = build_optimizer(model, dict(cfg.optimizer),
                                         self.lr_schedule, grad_clip, frozen)
        norm_cfg = device_norm_cfg(
            (cfg.data.get('train') or {}).get('pipeline', []))
        if norm_cfg:
            self.logger.info('device-side normalization enabled '
                             '(uint8 host->device transfer)')
        self.train_step = make_train_step(model, self.optimizer,
                                          self.lr_schedule, norm_cfg=norm_cfg,
                                          device=self.device, seed=seed,
                                          local_bn=bool(cfg.get('local_bn')),
                                          remat=bool(backbone_cfg.get(
                                              'with_cp')))
        self.stager = (PinnedStager(self.device)
                       if self.device.type == 'cuda' else None)
        self.hooks: List[Hook] = []
        self.epoch = 0
        self.inner_iter = 0
        self.iter = 0

        resume_from = cfg.get('resume_from')
        load_from = cfg.get('load_from')
        if resume_from and os.path.exists(resume_from):
            self.resume(resume_from)
        elif load_from and os.path.exists(load_from):
            self.load_weights(load_from)

    @property
    def step(self) -> int:
        """Train steps taken, the resumed ones included."""
        return self.train_step.state.step

    # ------------------------------------------------------------- plumbing
    def register_hook(self, hook: Hook) -> None:
        self.hooks.append(hook)

    def register_default_hooks(self) -> None:
        log_cfg = self.cfg.get('log_config') or {}
        interval = log_cfg.get('interval', 20)
        hook_types = [h.get('type') for h in log_cfg.get('hooks', [])]
        if not hook_types or 'TextLoggerHook' in hook_types:
            self.register_hook(TextLoggerHook(interval))
        if 'TensorboardLoggerHook' in hook_types:
            self.register_hook(TensorboardLoggerHook(interval))
        ckpt_cfg = self.cfg.get('checkpoint_config') or {}
        self.register_hook(CheckpointHook(ckpt_cfg.get('interval', 10)))

    def _call(self, name: str, *args) -> None:
        for h in self.hooks:
            getattr(h, name)(self, *args)

    def resume(self, path: str) -> None:
        """Weights (every key), SGD state, epoch and step of a checkpoint
        this loop wrote (``.pth``) or the JAX package's loop wrote
        (``.msgpack``: the optax state's momentum traces, epoch and step
        from the sidecar, as ``mvfnet_tpu/engine/train_loop.py:296-309``
        resumes)."""
        state_dict, opt_state, meta = load_checkpoint(path)
        # a .msgpack's quant_stats are not training state: the JAX loop
        # restores params and batch_stats alone
        self.model.load_state_dict({k: v for k, v in state_dict.items()
                                    if not is_quant_stat(k)}, strict=True)
        step = meta.get('iter', 0)
        if opt_state and path.endswith('.msgpack'):
            load_optax_state(self.model, self.optimizer, opt_state, step)
        elif opt_state:
            self.optimizer.load_state_dict(opt_state)
        self.epoch = meta.get('epoch', 0)
        self.iter = self.train_step.state.step = step
        self.logger.info('resumed from %s (epoch %d, iter %d)', path,
                         self.epoch, self.step)

    def load_weights(self, path: str) -> None:
        load_weights(self.model, path, logger=self.logger)
        self.logger.info('loaded weights from %s', path)

    # ------------------------------------------------------------------ run
    def run(self):
        """Train from ``self.epoch`` to ``total_epochs``; returns the step's
        ``TrainState``."""
        os.makedirs(self.work_dir, exist_ok=True)
        self._call('before_run')
        for epoch in range(self.epoch, self.total_epochs):
            self.epoch = epoch
            self.loader.set_epoch(epoch)   # the loader sets the dataset's
            self._call('before_epoch')
            labels: deque = deque()

            def frames():
                for batch in self.loader:
                    labels.append(np.asarray(batch['label']))
                    yield batch['img_group']

            for i, imgs in enumerate(prefetch_to_device(
                    frames(), self.device, self.stager)):
                self.inner_iter = i
                metrics = self.train_step(imgs, labels.popleft())
                self.iter += 1
                self._call('after_iter', metrics)
            self._call('after_epoch')
        self._call('after_run')
        return self.train_step.state


def train_network(model, dataset, cfg, validate: bool = False,
                  logger=None, extra_hooks=None, **kwargs) -> TrainLoop:
    """Build the loop with its default hooks, the extra ones and, with
    ``validate``, an ``EvalHook`` on ``cfg.data.val``; run it; return it."""
    loop = TrainLoop(model, dataset, cfg, logger=logger, **kwargs)
    loop.register_default_hooks()
    for h in (extra_hooks or []):
        loop.register_hook(h)
    if validate and cfg.get('data') and cfg.data.get('val'):
        loop.register_hook(EvalHook(dict(cfg.data.val),
                                    interval=cfg.get('eval_interval', 10)))
    loop.run()
    return loop
