"""Test-CLI driver: whole ``evaluate_dataset`` passes over a rawframe set.

Set-up makes the weights from the seed and builds the port's recognizer,
writes ``videos`` rawframe videos of ``frames`` JPEG frames (smooth seeded
content, so that the JPEG sizes stay those of real frames) under
``TMPDIR``, with an annotation file that lists each video ``repeats``
times, builds the dataset with the configuration's test pipeline for the
card (nvJPEG frames, ``Normalize`` deferred to the device), and runs one
pass to warm up. The window runs passes of ``evaluate_dataset`` (one video
a batch, ``workers`` loader threads) until ``--seconds`` have passed: the
rate the test CLI gives its users. A thin wrapper around the dataset
times each ``__getitem__`` on the loader threads.

The check holds every score of the window against the float32 reference
run over the same JPEG files, decoded with cv2: the test sampling, the
short-edge resize, the three crops, the normalization and the model. It
also requires that nvJPEG decoded every frame.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from port_bench.lib import compare, trace, weights
from port_bench.lib.peaks import bound_s, ycc_to_bgr_bytes
from port_bench.lib.port import build_model, device_norm
from port_bench.reference import models as ref
from port_bench.reference import pipeline as ref_pipeline


def _pipeline(config: dict) -> List[dict]:
    """The configuration's test pipeline with ``Normalize`` on the device
    (the JSON file spells an infinite scale ``"inf"``)."""
    ops = []
    for op in config['test_pipeline']:
        op = dict(op)
        if op['type'] == 'Resize':
            op['scale'] = tuple(float(s) for s in op['scale'])
        if op['type'] == 'Normalize':
            op['device'] = True
        ops.append(op)
    return ops


def synthetic_frames(rng: np.random.Generator, count: int, h: int, w: int):
    """``count`` frames of smooth content fading between two coarse
    fields, with mid-frequency texture and mild noise (white noise would
    encode at many times a real frame's size)."""
    import cv2
    a, b = (rng.random((6, 10, 3), dtype=np.float32) * 255 for _ in range(2))
    mid = cv2.resize((rng.standard_normal((32, 57, 3)) * 20).astype(
        np.float32), (w, h))
    noise = [(rng.standard_normal((h, w, 3)) * 2).astype(np.float32)
             for _ in range(4)]
    for t in range(count):
        s = t / max(count - 1, 1)
        img = cv2.resize(a * (1 - s) + b * s, (w, h),
                         interpolation=cv2.INTER_CUBIC)
        yield np.clip(img + mid + noise[t % 4], 0, 255).astype(np.uint8)


class TimedDataset:
    """The dataset, with the wall time of each ``__getitem__``."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.lock = threading.Lock()
        self.ms: List[float] = []

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        t0 = time.perf_counter()
        item = self.dataset[idx]
        with self.lock:
            self.ms.append((time.perf_counter() - t0) * 1e3)
        return item


class Bench:
    kind = 'cli'

    def __init__(self, config: dict, workload: dict, seed: int, device):
        self.config = config
        self.workload = workload
        self.seed = seed
        self.device = torch.device(device)
        self.model_cfg = config['model']
        self.passes: List[np.ndarray] = []
        self.root = None

    # ------------------------------------------------------------ set-up
    def write_videos(self) -> str:
        """The rawframe videos under a new directory of ``TMPDIR``; the
        annotation file."""
        import cv2
        w = self.workload
        h, wd = w['frame_hw']
        self.root = tempfile.mkdtemp(prefix='port_bench_frames_')

        def video(i):
            path = os.path.join(self.root, f'video_{i}')
            os.makedirs(path)
            rng = np.random.default_rng(weights.derived_seed(self.seed, 5, i))
            for t, img in enumerate(synthetic_frames(rng, w['frames'], h,
                                                     wd)):
                if not cv2.imwrite(os.path.join(path, f'img_{t + 1:05}.jpg'),
                                   img):
                    raise RuntimeError(f'cv2.imwrite failed under {path}')

        with ThreadPoolExecutor(w['writers']) as pool:
            list(pool.map(video, range(w['videos'])))
        rng = np.random.default_rng(weights.derived_seed(self.seed, 6))
        labels = rng.integers(0, self.model_cfg['cls_head']['num_classes'],
                              w['videos'])
        ann = os.path.join(self.root, 'test_list.txt')
        with open(ann, 'w') as f:
            for _ in range(w['repeats']):
                f.writelines(f'video_{i} {w["frames"]} {labels[i]}\n'
                             for i in range(w['videos']))
        return ann

    def setup(self) -> None:
        from mvfnet_tpu_torch.data import build_dataset
        self.state = weights.make_state(ref.spec(self.model_cfg), self.seed,
                                        self.device)
        self.model = build_model(self.config, self.state, self.device,
                                 self.workload.get('quant'))
        ann = self.write_videos()
        self.dataset = build_dataset(dict(
            type='RawFramesDataset', ann_file=ann, data_root=self.root,
            pipeline=_pipeline(self.config), test_mode=True, modality='RGB',
            filename_tmpl='img_{:05}.jpg'), self.device)
        self.timed = TimedDataset(self.dataset)
        self.evaluate()                                    # warm-up pass
        self.timed.ms.clear()

    def evaluate(self) -> np.ndarray:
        from mvfnet_tpu_torch.engine.eval import evaluate_dataset
        w = self.workload
        with record_function('bench.eval_pass'):
            return evaluate_dataset(self.model, self.timed,
                                    videos_per_gpu=1,
                                    workers_per_gpu=w['workers'],
                                    norm_cfg=device_norm(self.config),
                                    device=self.device)

    def _passes(self, count=None, seconds=None) -> Tuple[int, float]:
        n = 0
        t0 = time.perf_counter()
        while True:
            if count is not None and n >= count:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
            self.passes.append(self.evaluate())
            n += 1
        return n, time.perf_counter() - t0

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> Dict[str, float]:
        n, total = self._passes(seconds=seconds)
        self.served = (n * len(self.dataset), total)
        return dict(cli_videos_per_s=self.served[0] / total)

    def traced(self, seconds: float) -> dict:
        from mvfnet_tpu_torch.data import native_io
        self.window(seconds)
        n, total = self.served
        item_ms = float(np.mean(self.timed.ms))
        ycc = native_io.ycc_to_bgr
        launches, frames = ycc.launches, ycc.frames
        prof = trace.profile(lambda: (self._passes(count=1),
                                      torch.cuda.synchronize()))
        launches = ycc.launches - launches
        frames = ycc.frames - frames
        seen, ycc_us = trace.kernel_us(prof['device'], 'ycc')
        h, w = self.workload['frame_hw']
        shape = self.workload['video_shape'][1:]
        return dict(
            kind=self.kind, items_unprofiled=n, wall_unprofiled_s=total,
            items_profiled=len(self.dataset),
            busy_s=trace.busy_us(prof['device']) / 1e6,
            window_s=prof['wall_s'],
            flops_per_item=ref.count_flops(self.model_cfg, shape),
            host_item_ms=item_ms,
            ycc_to_bgr=(dict(launches=seen, device_s=ycc_us / 1e6,
                             bound_s=bound_s(0, ycc_to_bgr_bytes(frames, h,
                                                                 w)))
                        if seen and seen == launches else None),
            by_kind_s=trace.by_kind_s(prof['device']),
            breakdown=dict(device_ops=trace.top_ops(prof['device']),
                           idle_gaps=trace.idle_gaps(prof['device'],
                                                     prof['host'])))

    # ------------------------------------------------------------- check
    def release(self) -> None:
        from mvfnet_tpu_torch.engine import eval as port_eval
        del self.model
        # the entry caches its eval step, and with it the model
        port_eval._EVAL_STEP_CACHE.clear()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference_probs(self, index: int, precision=None) -> torch.Tensor:
        w = self.workload
        video = ref_pipeline.dense_test_frames(
            os.path.join(self.root, f'video_{index}'), w['frames'],
            self.config['test_pipeline'])
        logits = ref.dense_clip_logits(
            self.state, torch.from_numpy(video).to(self.device),
            self.model_cfg, self.config['img_norm_cfg'],
            w['clips_per_block'], precision)
        return ref.prob_average(logits).cpu()

    def numbers(self) -> Tuple[int, int, Dict[str, float]]:
        """(attempted, failed, numbers): every score of the window against
        the reference's probabilities of its video
        (``compare.answer_numbers``), and the frames that another decoder
        than nvJPEG gave."""
        from mvfnet_tpu_torch.data import native_io
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        videos = self.workload['videos']
        refs = {i: self.reference_probs(i) for i in range(videos)}
        pairs = [(p, refs[row % videos]) for scores in self.passes
                 for row, p in enumerate(torch.from_numpy(scores))]
        failed, numbers = compare.answer_numbers(pairs)
        counts = [op.counts for op in self.dataset.pipeline.transforms
                  if hasattr(op, 'counts')][0]
        numbers['frames_not_nvjpeg'] = float(sum(
            c for k, c in counts.items() if k != native_io.DECODER))
        return len(pairs), failed, numbers

    def check(self) -> Tuple[int, int, Dict[str, dict]]:
        try:
            attempted, failed, numbers = self.numbers()
        finally:
            shutil.rmtree(self.root, ignore_errors=True)
        return attempted, failed, {
            k: compare.check(numbers[k], limit)
            for k, limit in self.workload['checks'].items()}
