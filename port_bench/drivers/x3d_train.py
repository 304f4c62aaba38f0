"""Train-step driver of X3D-M: ``train.Bench`` on a 3-D recognizer.

The steps, window and check of ``train.Bench`` (the port's
``make_train_step`` back to back, each step's dropout mask from a
generator on the device seeded from the run's seed and the step), with
the state dict, the float32 reference and the FLOPs of
``reference/x3d.py``. A batch is ``(B, clips, T, H, W, 3)`` uint8; the
head draws its mask per (B * clips, 2048) features, and the reference's
masks are drawn from the same seeds at that shape.

A traced run adds one more stretch of ``profiled_steps`` steps under
``lib.spans.profile`` (spans on, torch.profiler on): the device time a
step of the work launched inside the program's ``model.dwconv`` and
``model.se`` spans, forward and backward (``busy_ms_within``). Each reads
None where the program has no such span.
"""

from __future__ import annotations

import bisect
from typing import Optional

import torch

from port_bench.drivers import train
from port_bench.lib import spans, trace, weights
from port_bench.lib.port import build_model, device_norm
from port_bench.reference import x3d


def busy_ms_within(prof: Optional[dict], name: str) -> Optional[float]:
    """The device's busy ms that the kernels and copies launched inside a
    span named ``name`` add: each device event, in order of start, counts
    the part of its interval past the ends of all the events that started
    before it, so that the parts of all the events sum to the busy
    time. cuDNN computes a depthwise conv's weight gradient on eight
    streams of its own at once, so the summed durations of its kernels
    (``spans.device_ms_within``) come to about four times an X3D-M step
    on an H100. None where the clock check fails or no such span was
    recorded."""
    if not spans.clock_ok(prof):
        return None
    within = sorted((sp['s'], sp['e'])
                    for sp in spans.named(prof['spans'], name))
    if not within:
        return None
    starts = [s for s, _ in within]
    inside = set()
    for s, _, _, corr in prof['launches']:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= within[i][1]:
            inside.add(corr)
    total, end = 0.0, None
    for s, e, _, corr in prof['device']:
        part = e - s if end is None else max(0.0, e - max(s, end))
        end = e if end is None else max(end, e)
        if corr in inside:
            total += part
    return total / 1e3


class Bench(train.Bench):
    def setup(self) -> None:
        from mvfnet_tpu_torch.engine.optim import (
            build_lr_schedule, build_optimizer, frozen_prefixes_from_backbone)
        from mvfnet_tpu_torch.engine.train_step import make_train_step
        c, w = self.config, self.workload
        self.spec = x3d.spec(self.model_cfg)
        self.state = weights.make_state(self.spec, self.seed, self.device,
                                        w.get('residual_gamma', 1.0))
        self.model = build_model(c, self.state, self.device)
        # ``build_model`` builds the dense test's head, which skips dropout;
        # training takes the head's standard path
        self.model.cls_head.fcn_testing = False
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
        self.param_names = {p: n for n, p in self.model.named_parameters()}
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

    # ------------------------------------------------------------ traced
    def span_readings(self) -> dict:
        """``profiled_steps`` steps with spans on under the profiler; the
        device ms a step inside ``model.dwconv`` and ``model.se``."""
        k = self.workload['profiled_steps']
        prof = spans.profile(lambda: self._run(count=k))

        def per_step(name: str) -> Optional[float]:
            ms = busy_ms_within(prof, name)
            return None if ms is None else ms / k
        return dict(dwconv_device_ms=per_step('model.dwconv'),
                    se_device_ms=per_step('model.se'))

    def traced(self, seconds: float) -> dict:
        self.window(seconds)
        n, total = self.served
        k = self.workload['profiled_steps']
        prof = trace.profile(lambda: self._run(count=k))
        b, clips, *frame = self.workload['batch_shape']
        data = dict(
            kind=self.kind, items_unprofiled=n, wall_unprofiled_s=total,
            items_profiled=k, busy_s=trace.busy_us(prof['device']) / 1e6,
            window_s=prof['wall_s'],
            flops_per_item=x3d.count_flops(self.model_cfg,
                                           [b * clips] + frame, train=True),
            by_kind_s=trace.by_kind_s(prof['device']),
            breakdown=dict(device_ops=trace.top_ops(prof['device']),
                           idle_gaps=trace.idle_gaps(prof['device'],
                                                     prof['host'])))
        data.update(self.span_readings())
        return data

    # ------------------------------------------------------------- check
    def reference(self, precision=None, batch_filter=None):
        """The reference's first ``check_steps`` steps, on the masks that
        the head drew."""
        c, w = self.config, self.workload
        n = w['check_steps']
        rows = w['batch_shape'][0] * w['batch_shape'][1]
        width = self.model_cfg['cls_head']['in_channels']
        p = self.model_cfg['cls_head']['dropout_ratio']
        batches, keeps = [], []
        for t in range(n):
            imgs, labels = self.pool[t]
            batches.append((torch.from_numpy(imgs).to(self.device),
                            torch.from_numpy(labels).to(self.device)))
            g = torch.Generator(device=self.device).manual_seed(
                self.mask_seed(t))
            keeps.append(torch.rand((rows, width), generator=g,
                                    device=self.device) >= p)
        return x3d.train_steps(
            self.state, weights.kinds(self.spec), batches, keeps,
            [self.schedule(t) for t in range(n)], self.model_cfg,
            c['img_norm_cfg'], c['optimizer'],
            c['optimizer_config']['grad_clip']['max_norm'], precision,
            batch_filter)
