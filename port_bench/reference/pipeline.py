"""Plain reference of the dense-test data pipeline on rawframe JPEGs.

From the reference recipe's definitions (mmaction's ``SampleFrames`` in
test mode, ``Resize`` with ``keep_ratio``, ``ThreeCrop``): ``num_clips``
clip offsets ``int(tick / 2 + tick * x)`` with ``tick = (total - clip_len
* interval + 1) / num_clips``, frames ``offset + k * interval`` capped at
the last, files numbered from 1; each JPEG decoded to BGR with cv2; the
short edge scaled to the scale's short side (long edge bounded by its long
side), ``new = int(old * factor + 0.5)``, bilinear; three crops of the
short side's width along the long side (first, last, middle), crop-major.
Imports nothing of the program under test.
"""

from __future__ import annotations

import os
from typing import List

import cv2
import numpy as np


def test_frame_indices(total: int, clip_len: int, interval: int,
                       num_clips: int) -> np.ndarray:
    span = clip_len * interval
    tick = (total - span + 1) / float(num_clips)
    offsets = ([int(tick / 2.0 + tick * x) for x in range(num_clips)]
               if tick > 0 else [0] * num_clips)
    inds = np.array([o + k * interval for o in offsets
                     for k in range(clip_len)])
    return np.minimum(inds, total - 1)


def rescale(img: np.ndarray, scale) -> np.ndarray:
    h, w = img.shape[:2]
    long_side, short_side = max(scale), min(scale)
    factor = min(long_side / max(h, w), short_side / min(h, w))
    size = (int(w * factor + 0.5), int(h * factor + 0.5))
    return cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)


def three_crops(frames: List[np.ndarray], size: int) -> List[np.ndarray]:
    h, w = frames[0].shape[:2]
    if h == size:
        step = (w - size) // 2
        boxes = [(0, 0), (2 * step, 0), (step, 0)]
    elif w == size:
        step = (h - size) // 2
        boxes = [(0, 0), (0, 2 * step), (0, step)]
    else:
        ws, hs = (w - size) // 4, (h - size) // 4
        boxes = [(0, 2 * hs), (4 * ws, 2 * hs), (2 * ws, 2 * hs)]
    return [f[y:y + size, x:x + size] for x, y in boxes for f in frames]


def dense_test_frames(directory: str, total: int, pipeline: list
                      ) -> np.ndarray:
    """uint8 BGR ``(crops * clips * clip_len, S, S, 3)`` of one video, as
    the test pipeline ``pipeline`` (SampleFrames, FrameSelector, Resize,
    ThreeCrop, ...) defines it."""
    ops = {op['type']: op for op in pipeline}
    sf = ops['SampleFrames']
    inds = test_frame_indices(total, sf['clip_len'], sf['frame_interval'],
                              sf['num_clips'])
    frames = []
    for i in inds:
        with open(os.path.join(directory, f'img_{int(i) + 1:05}.jpg'),
                  'rb') as f:
            data = np.frombuffer(f.read(), np.uint8)
        frames.append(cv2.imdecode(data, cv2.IMREAD_COLOR))
    scale = tuple(float(s) for s in ops['Resize']['scale'])
    frames = [rescale(f, scale) for f in frames]
    return np.stack(three_crops(frames, ops['ThreeCrop']['crop_size']))
