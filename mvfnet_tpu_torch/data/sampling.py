"""Clip index sampling (counterpart of ``mvfnet_tpu/data/sampling.py``).

Direct functional port of the reference's SampleFrames index math
(``codes/datasets/pipelines/loading.py:11-131``) — the math
is pure numpy in the reference and is preserved exactly (it is
accuracy-critical: dense-test offsets determine which frames score).

Randomness is injected through an explicit ``numpy.random.Generator`` when
provided (reproducible pipelines); falls back to the module-global RNG like
the reference otherwise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .builder import PIPELINES


@PIPELINES.register_module
class SampleFrames:
    """Sample ``num_clips`` clips of ``clip_len`` frames, ``frame_interval``
    apart. Adds ``frame_inds`` (flat, clip-major), ``clip_len``,
    ``frame_interval``, ``num_clips`` to the results dict."""

    def __init__(self, clip_len: int, frame_interval: int = 1,
                 num_clips: int = 1, temporal_jitter: bool = False,
                 sth_samples: int = 1):
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.num_clips = num_clips
        self.temporal_jitter = temporal_jitter
        self.sth_samples = sth_samples

    # --- train sampling (loading.py:37-60) ---
    def _sample_clips(self, num_frames: int, rng) -> np.ndarray:
        ori_clip_len = self.clip_len * self.frame_interval
        avg_interval = (num_frames - ori_clip_len + 1) // self.num_clips
        if avg_interval > 0:
            base_offsets = np.arange(self.num_clips) * avg_interval
            clip_offsets = base_offsets + rng.integers(
                0, avg_interval, size=self.num_clips)
        elif num_frames > max(self.num_clips, ori_clip_len):
            clip_offsets = np.sort(rng.integers(
                0, num_frames - ori_clip_len + 1, size=self.num_clips))
        else:
            clip_offsets = np.zeros((self.num_clips,), dtype=np.int64)
        return clip_offsets

    # --- test sampling (loading.py:62-92) ---
    def _test_sample_clips(self, num_frames: int, rng) -> np.ndarray:
        ori_clip_len = self.clip_len * self.frame_interval
        tick = (num_frames - ori_clip_len + 1) / float(self.num_clips)
        if self.sth_samples == 1:
            if tick > 0:
                clip_offsets = np.array(
                    [int(tick / 2.0 + tick * x)
                     for x in range(self.num_clips)])
            else:
                clip_offsets = np.zeros((self.num_clips,), dtype=np.int64)
        elif self.sth_samples == 2:
            clip_offsets = np.array(
                [int(tick / 2.0 + tick * x) for x in range(self.num_clips)]
                + [int(tick * x) for x in range(self.num_clips)])
        elif self.sth_samples == 10:
            offsets = []
            for _ in range(10):
                offsets += self._sample_clips(num_frames, rng).tolist()
            clip_offsets = np.array(offsets)
        else:
            parts = [np.array([int(tick / 2.0 + tick * x)
                               for x in range(self.num_clips)])]
            avg_duration = (num_frames - ori_clip_len + 1) // float(
                self.num_clips)
            for _ in range(self.sth_samples - 1):
                parts.append(
                    np.multiply(list(range(self.num_clips)), avg_duration)
                    + rng.integers(0, avg_duration, size=self.num_clips))
            clip_offsets = np.stack(parts).reshape(-1)
        return clip_offsets

    def get_frame_inds(self, total_frames: int, test_mode: bool,
                       rng: Optional[np.random.Generator] = None
                       ) -> np.ndarray:
        """loading.py:94-113."""
        rng = rng if rng is not None else np.random.default_rng()
        if test_mode:
            clip_offsets = self._test_sample_clips(total_frames, rng)
        else:
            clip_offsets = self._sample_clips(total_frames, rng)
        frame_inds = (clip_offsets[:, None]
                      + np.arange(self.clip_len)[None, :]
                      * self.frame_interval)
        if self.temporal_jitter:
            perframe_offsets = rng.integers(0, self.frame_interval,
                                            size=self.clip_len)
            frame_inds = frame_inds + perframe_offsets[None, :]
        frame_inds = np.concatenate(frame_inds)
        return np.minimum(frame_inds, total_frames - 1).astype(np.int64)

    def __call__(self, results: dict) -> dict:
        if 'total_frames' not in results:
            # the VideoDataset path probes the container for its frame
            # count; an unreadable container gives None, and the dataset
            # draws another video
            from .video_io import probe_num_frames
            try:
                results['total_frames'] = probe_num_frames(
                    results['filename'])
            except (IOError, OSError):
                return None
        total_frames = results['total_frames']
        rng = results.get('rng')
        results['frame_inds'] = self.get_frame_inds(
            total_frames, results['test_mode'], rng)
        results['clip_len'] = self.clip_len
        results['frame_interval'] = self.frame_interval
        results['num_clips'] = self.num_clips
        results['sth_samples'] = self.sth_samples
        return results

    def __repr__(self):
        return (f'{type(self).__name__}(clip_len={self.clip_len}, '
                f'frame_interval={self.frame_interval}, '
                f'num_clips={self.num_clips})')
