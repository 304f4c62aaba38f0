"""Video container decoding on the host (counterpart of
``mvfnet_tpu/data/video_io.py``).

cv2's FFmpeg-backed ``VideoCapture`` decodes every video container, in the
two modes the reference's decoders expose:

- accurate (``decode_frames_accurate``): sequential decode up to the
  largest requested index (PyAVDecode ``accurate=True`` semantics), exact
  frames; an index past the last frame that decodes takes the last one
- seek (``decode_frames_seek``): a ``CAP_PROP_POS_FRAMES`` seek per index
  (PyAVDecode ``accurate=False`` / OpenCVDecode semantics), stepping back
  up to 30 frames until one decodes; a repeated index decodes once

The JAX package tries its native FFmpeg worker (``native/``) first for the
accurate decode and the probe; the port has no copy of that worker, so it
always takes the JAX package's cv2 branch (with the same results where the
two agree; ``tests/test_torch_video.py``). ``DECODERS`` names what ran, for
the logs. A decode failure returns ``None``, so that the dataset's retry
loop draws another video.
"""

from __future__ import annotations

from typing import List, Optional

import cv2
import numpy as np

DECODERS = {True: 'cv2.VideoCapture (sequential)',
            False: 'cv2.VideoCapture (seek)'}


def probe_num_frames(filename: str) -> int:
    """The container's frame count as cv2 reports it (from its duration and
    rate, which may overstate the frames that decode); ``IOError`` when
    there is none."""
    cap = cv2.VideoCapture(filename)
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
    if n <= 0:
        raise IOError(f'cannot probe frame count of {filename}')
    return n


def decode_frames_accurate(filename: str,
                           frame_inds: np.ndarray) -> Optional[List]:
    """Sequential decode to the largest index, then gather (BGR HWC uint8);
    an index past the last decoded frame takes the last one."""
    cap = cv2.VideoCapture(filename)
    try:
        if not cap.isOpened():
            return None
        max_ind = int(np.max(frame_inds))
        frames = {}
        wanted = set(int(i) for i in frame_inds)
        for i in range(max_ind + 1):
            ok, frame = cap.read()
            if not ok:
                break
            if i in wanted:
                frames[i] = frame
        if not frames:
            return None
        last = max(frames)
        return [frames.get(min(int(i), last), frames[last])
                for i in frame_inds]
    finally:
        cap.release()


def decode_frames_seek(filename: str,
                       frame_inds: np.ndarray) -> Optional[List]:
    """A seek per distinct index, with the reference's back-off
    (OpenCVDecode): on a failed read, step back up to 30 frames until one
    decodes; ``None`` if none does."""
    cap = cv2.VideoCapture(filename)
    try:
        if not cap.isOpened():
            return None
        out = []
        cache = {}
        for idx in frame_inds:
            idx = int(idx)
            if idx in cache:
                out.append(cache[idx])
                continue
            frame = None
            for back in range(30):
                cap.set(cv2.CAP_PROP_POS_FRAMES, max(idx - back, 0))
                ok, f = cap.read()
                if ok and f is not None:
                    frame = f
                    break
            if frame is None:
                return None
            cache[idx] = frame
            out.append(frame)
        return out
    finally:
        cap.release()
