"""Train-step driver: the port's ``make_train_step`` back to back.

Set-up makes the weights and a pool of uint8 batches with labels from the
seed, builds the port's recognizer, the config's optimizer (SGD with
nesterov and coupled weight decay, the clip by global norm) and LR
schedule, and the train step: one object that the first ``check_steps``
steps drive on the first pool batches (rows that all differ) and that the
window then drives on. Every step draws its dropout mask from a
generator on the device seeded from the run's seed and the step. The
window reads the metrics every ``log_interval`` steps, as the train
loop's logger does, and ends at a ``synchronize`` after its last step.

The check follows the first ``check_steps`` steps with the float32
reference from the same weights, batches and masks: each step's loss,
the first step's clipped gradient as the optimizer got it (worked out
from its momentum buffer: ``buf = g + wd * p0``) and the parameters'
change over the steps, leaf by leaf.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

from port_bench.lib import compare, trace, weights
from port_bench.lib.port import build_model, device_norm
from port_bench.reference import models as ref
from port_bench.reference.train import PARAM_KINDS, train_steps


class Bench:
    kind = 'train'

    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config = config
        self.workload = workload
        self.seed = seed
        self.device = torch.device(device)
        self.model_cfg = config['model']
        self.losses: List[float] = []
        self.grad_norms: List[float] = []
        self.steps = 0
        self.failed = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from mvfnet_tpu_torch.engine.optim import (
            build_lr_schedule, build_optimizer, frozen_prefixes_from_backbone)
        from mvfnet_tpu_torch.engine.train_step import make_train_step
        c, w = self.config, self.workload
        self.spec = ref.spec(self.model_cfg)
        self.state = weights.make_state(self.spec, self.seed, self.device,
                                        w.get('residual_gamma', 1.0))
        self.model = build_model(c, self.state, self.device)
        self.schedule = build_lr_schedule(
            c['lr_config'], c['optimizer']['lr'], c['iters_per_epoch'],
            c['total_epochs'])
        self.optimizer = build_optimizer(
            self.model, c['optimizer'], self.schedule,
            grad_clip=c['optimizer_config']['grad_clip'],
            frozen_prefixes=frozen_prefixes_from_backbone(
                self.model_cfg['backbone']))
        self.step = make_train_step(self.model, self.optimizer,
                                    self.schedule,
                                    norm_cfg=device_norm(c),
                                    device=self.device)
        shape = tuple(w['batch_shape'])
        self.pool = list(zip(
            weights.uint8_frames(shape, w['pool'], self.seed, 2, self.device),
            weights.labels(w['pool'], shape[0],
                           self.model_cfg['cls_head']['num_classes'],
                           self.seed, 3)))
        self.generator = torch.Generator(device=self.device)
        names = dict(self.model.named_parameters())
        self.param_names = {p: n for n, p in names.items()}
        for t in range(w['check_steps']):
            m = self.train(t)
            if t == 0:
                self.first_buffers = {
                    self.param_names[p]: s['momentum_buffer'].detach().clone()
                    for p, s in self.optimizer.state.items()}
            self.losses.append(float(m['loss']))
            self.grad_norms.append(float(m['grad_norm']))
        self.after_checked = {n: p.detach().clone()
                              for n, p in self.model.named_parameters()}
        self.sync()

    def sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def mask_seed(self, t: int) -> int:
        return weights.derived_seed(self.seed, 4, t)

    def train(self, t: int):
        """Step ``t`` on pool batch ``t``: the same call and feed in
        set-up and in the window."""
        imgs, labels = self.pool[t % len(self.pool)]
        self.generator.manual_seed(self.mask_seed(t))
        with record_function('bench.train_step'):
            return self.step(imgs, labels, self.generator)

    def _run(self, count=None, seconds=None) -> Tuple[int, float]:
        interval = self.workload['log_interval']
        n = 0
        t0 = time.perf_counter()
        while True:
            if count is not None and n >= count:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
            m = self.train(self.steps + self.workload['check_steps'])
            self.steps += 1
            n += 1
            if self.steps % interval == 0:
                with record_function('bench.metrics_read'):
                    loss = float(m['loss'])
                    float(m['grad_norm'])
                if loss != loss or abs(loss) == float('inf'):
                    self.failed += 1
        self.sync()
        return n, time.perf_counter() - t0

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> Dict[str, float]:
        n, total = self._run(seconds=seconds)
        self.served = (n, total)
        clips = self.workload['batch_shape'][0]
        return dict(train_clips_per_s=n * clips / total)

    def traced(self, seconds: float) -> dict:
        self.window(seconds)
        n, total = self.served
        k = self.workload['profiled_steps']
        prof = trace.profile(lambda: self._run(count=k))
        shape = self.workload['batch_shape']
        frames = (shape[0] * shape[1],) + tuple(shape[2:])
        return dict(
            kind=self.kind, items_unprofiled=n, wall_unprofiled_s=total,
            items_profiled=k, busy_s=trace.busy_us(prof['device']) / 1e6,
            window_s=prof['wall_s'],
            flops_per_item=ref.count_flops(self.model_cfg, frames,
                                           train=True),
            by_kind_s=trace.by_kind_s(prof['device']),
            breakdown=dict(device_ops=trace.top_ops(prof['device']),
                           idle_gaps=trace.idle_gaps(prof['device'],
                                                     prof['host'])))

    # ------------------------------------------------------------- check
    def release(self) -> None:
        del self.model, self.step, self.optimizer
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, precision=None, batch_filter=None):
        """The reference's first ``check_steps`` steps."""
        c, w = self.config, self.workload
        n = w['check_steps']
        batches, keeps = [], []
        rows = w['batch_shape'][0] * w['batch_shape'][1]
        width = self.model_cfg['cls_head']['in_channels']
        p = self.model_cfg['cls_head']['dropout_ratio']
        for t in range(n):
            imgs, labels = self.pool[t]
            batches.append((torch.from_numpy(imgs).to(self.device),
                            torch.from_numpy(labels).to(self.device)))
            g = torch.Generator(device=self.device).manual_seed(
                self.mask_seed(t))
            keeps.append(torch.rand((rows, width), generator=g,
                                    device=self.device) >= p)
        return train_steps(
            self.state, weights.kinds(self.spec), batches, keeps,
            [self.schedule(t) for t in range(n)], self.model_cfg,
            c['img_norm_cfg'], c['optimizer'],
            c['optimizer_config']['grad_clip']['max_norm'], precision,
            batch_filter)

    def params(self) -> List[str]:
        return [k for k, kind in weights.kinds(self.spec).items()
                if kind in PARAM_KINDS]

    def program_steps(self):
        """The program's first steps as a reference reports its own: each
        step's loss, the first step's clipped gradient (its momentum
        buffer less the weight decay, ``buf = g + wd * p0``), the
        parameters after the last checked step and each step's gradient
        norm before the clip (the step's ``grad_norm``)."""
        wd = self.config['optimizer']['weight_decay']
        # a parameter the step never updated has no buffer: its gradient
        # reads as zero
        grads = {k: self.first_buffers.get(
                     k, torch.zeros_like(self.state[k])) - wd * self.state[k]
                 for k in self.params()}
        return self.losses, grads, self.after_checked, self.grad_norms

    def numbers(self, got, want) -> Dict[str, float]:
        """The compared numbers of one run of the first steps (``got``:
        losses, first clipped gradients, final parameters, gradient norms
        before the clip) against another's (``want``): the worst step's
        relative gap of the loss and of the gradient norm; the worst
        leaf's gap of the first gradient's norm and of the parameters'
        change (``compare.leaf_gaps``); and the relative norm of the
        difference of the first gradient and of the change over all
        leaves together (``compare.pooled_diff``), which a lower precision
        moves where the norms hardly move."""
        got_losses, got_grads, got_final, got_norms = got
        want_losses, want_grads, want_final, want_norms = want
        params = self.params()
        grad_norms = compare.leaf_norms(want_grads)
        moving = compare.moving_leaves(grad_norms)
        change = {k: got_final[k] - self.state[k] for k in params}
        want_change = {k: want_final[k] - self.state[k] for k in params}
        return dict(
            loss_gap=max(abs(a - b) / abs(b)
                         for a, b in zip(got_losses, want_losses)),
            grad_norm_gap=max(abs(a - b) / abs(b)
                              for a, b in zip(got_norms, want_norms)),
            grad_gap=max(compare.leaf_gaps(compare.leaf_norms(got_grads),
                                           grad_norms).values()),
            change_gap=max(compare.leaf_gaps(
                compare.leaf_norms(change), compare.leaf_norms(want_change),
                moving).values()),
            grad_diff=compare.pooled_diff(got_grads, want_grads),
            change_diff=compare.pooled_diff(change, want_change, moving))

    def check(self) -> Tuple[int, int, Dict[str, dict]]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        numbers = self.numbers(self.program_steps(), self.reference())
        limits = self.workload['checks']
        bad = sum(1 for x in self.losses if x != x)
        return (self.steps + len(self.losses), self.failed + bad,
                {k: compare.check(numbers[k], v) for k, v in limits.items()})
