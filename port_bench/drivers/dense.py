"""Dense-test driver: one client scoring one video a request, back to back.

Set-up makes the weights and a pool of uint8 videos from the seed, builds
the port's recognizer with them and its eval step (``make_eval_step``,
device ``Normalize``, the config's ``test_cfg``), and scores ``warmup``
videos. A request hands one pool video, in host memory as a loader
would hold it, to the eval step and ends when its scores are on the host:
a closed loop. The window cycles through the pool until ``--seconds``
have passed. Every answer of the window is kept and, once the window has
closed and the program is freed, compared with the float32 reference's
'prob' average of the same video.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from port_bench.lib import compare, trace, weights
from port_bench.lib.peaks import fused_bottleneck_bound_s
from port_bench.lib.port import build_model, device_norm
from port_bench.reference import models as ref

PROFILE_TRIES = 4


class Bench:
    kind = 'dense'

    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config = config
        self.workload = workload
        self.seed = seed
        self.device = torch.device(device)
        self.model_cfg = config['model']
        self.answers: List[Tuple[int, np.ndarray]] = []
        self.requests = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from mvfnet_tpu_torch.engine.train_step import make_eval_step
        w = self.workload
        self.state = weights.make_state(ref.spec(self.model_cfg), self.seed,
                                        self.device)
        self.model = build_model(self.config, self.state, self.device,
                                 w.get('quant'))
        self.step = make_eval_step(self.model,
                                   norm_cfg=device_norm(self.config),
                                   device=self.device)
        self.pool = weights.uint8_frames(tuple(w['video_shape']), w['pool'],
                                         self.seed, 2, self.device)
        for i in range(w['warmup']):
            self.request(i)
        self.sync()

    def sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------- requests
    def request(self, i: int) -> Tuple[torch.Tensor, float]:
        """Score pool video ``i``; its scores on the host and the
        seconds from hand-over to scores."""
        video = self.pool[i % len(self.pool)]
        t0 = time.perf_counter()
        with record_function('bench.eval_step'):
            out = self.step(self.model, video)
        with record_function('bench.scores_to_host'):
            scores = out.float().cpu()
        return scores, time.perf_counter() - t0

    def _serve(self, count=None, seconds=None) -> Tuple[int, float, list]:
        """Requests back to back, ``count`` of them or until ``seconds``
        have passed; every answer is kept for the check."""
        latencies = []
        t0 = time.perf_counter()
        while True:
            if count is not None and len(latencies) >= count:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
            scores, dt = self.request(self.requests)
            self.answers.append((self.requests % len(self.pool),
                                 scores.numpy()))
            self.requests += 1
            latencies.append(dt)
        return len(latencies), time.perf_counter() - t0, latencies

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> Dict[str, float]:
        n, total, latencies = self._serve(seconds=seconds)
        self.served = (n, total)
        return dict(dense_videos_per_s=n / total,
                    dense_video_p95_ms=float(np.percentile(latencies, 95))
                    * 1e3)

    def traced(self, seconds: float) -> dict:
        """An unprofiled window for the wall time a video, then a
        profiled stretch of whole requests for the device's. Profiled
        again where the profiler dropped fused-kernel launches that the
        program's counter saw."""
        from mvfnet_tpu_torch.ops import fused_block as fb
        self.window(seconds)
        n, total = self.served
        k = self.workload['profiled_requests']
        counter = fb.bottleneck_eval_cuda.launches_by_shape
        for _ in range(PROFILE_TRIES):
            before = dict(counter)
            prof = trace.profile(lambda: self._serve(count=k))
            launches = {s: c - before.get(s, 0) for s, c in counter.items()
                        if c - before.get(s, 0)}
            seen, fused_us = trace.kernel_us(prof['device'],
                                             'fused_bottleneck')
            if seen == sum(launches.values()):
                break
        else:
            raise RuntimeError(f'the profiler saw {seen} fused-kernel '
                               f'launches of {sum(launches.values())} in '
                               f'{PROFILE_TRIES} tries')
        video = self.workload['video_shape'][1:]
        return dict(
            kind=self.kind, items_unprofiled=n, wall_unprofiled_s=total,
            items_profiled=k, busy_s=trace.busy_us(prof['device']) / 1e6,
            window_s=prof['wall_s'],
            flops_per_item=ref.count_flops(self.model_cfg, video),
            fused_bottleneck=(dict(
                launches=seen, device_s=fused_us / 1e6,
                bound_s=fused_bottleneck_bound_s(launches))
                if seen else None),
            by_kind_s=trace.by_kind_s(prof['device']),
            breakdown=dict(device_ops=trace.top_ops(prof['device']),
                           idle_gaps=trace.idle_gaps(prof['device'],
                                                     prof['host'])))

    # ------------------------------------------------------------- check
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.model, self.step
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference_probs(self, index: int, precision=None) -> torch.Tensor:
        video = torch.from_numpy(self.pool[index][0]).to(self.device)
        logits = ref.dense_clip_logits(
            self.state, video, self.model_cfg, self.config['img_norm_cfg'],
            self.workload['clips_per_block'], precision)
        return ref.prob_average(logits).cpu()

    def numbers(self) -> Tuple[int, int, Dict[str, float]]:
        """(attempted, failed, numbers): every answer of the run against
        the reference's probabilities of its video
        (``compare.answer_numbers``)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        refs = {i: self.reference_probs(i)
                for i in sorted({i for i, _ in self.answers})}
        failed, numbers = compare.answer_numbers(
            (torch.from_numpy(scores), refs[i]) for i, scores in self.answers)
        return len(self.answers), failed, numbers

    def check(self) -> Tuple[int, int, Dict[str, dict]]:
        """(attempted, failed, the compared numbers with their limits)."""
        attempted, failed, numbers = self.numbers()
        return attempted, failed, {
            k: compare.check(numbers[k], limit)
            for k, limit in self.workload['checks'].items()}
