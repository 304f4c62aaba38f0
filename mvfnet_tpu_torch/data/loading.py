"""Frame loading pipeline ops (counterpart of ``mvfnet_tpu/data/loading.py``).

``FrameSelector`` (raw JPEG frames) and ``PklLoader`` (pickled JPEG-bytes
lists), from the reference's loader vocabulary
(``codes/datasets/pipelines/loading.py:375-475``). Frames decode with
OpenCV's ``cv2.imdecode`` into HWC uint8 BGR, as in the JAX package. The
video decoders and the native batch decode worker are not ported yet
(``ROADMAP.md``).
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import List, Optional

import cv2
import numpy as np

from .builder import PIPELINES

# the one JPEG decoder of the port's host pipeline, named in logs and in
# chip_smoke.py's output
DECODER = 'cv2.imdecode'


def _imfrombytes(buf: bytes, flag: str = 'color') -> Optional[np.ndarray]:
    arr = np.frombuffer(buf, dtype=np.uint8)
    cv_flag = cv2.IMREAD_COLOR if flag == 'color' else cv2.IMREAD_GRAYSCALE
    return cv2.imdecode(arr, cv_flag)


def _load_image_file(filepath: str, flag: str = 'color'
                     ) -> Optional[np.ndarray]:
    try:
        with open(filepath, 'rb') as f:
            return _imfrombytes(f.read(), flag)
    except (OSError, cv2.error):      # missing, unreadable or empty file
        return None


@PIPELINES.register_module
class FrameSelector:
    """Load raw frames by index (reference ``loading.py:417-475``).

    Frame filenames are 1-based (``filename_tmpl.format(frame_idx + 1)``).
    A corrupt image falls back to the first successfully-loaded frame
    (reference ``loading.py:434-437``). ``use_native`` is accepted for
    config compatibility; every frame decodes with ``DECODER``, fixed here
    at construction.
    """

    def __init__(self, io_backend: str = 'disk', use_native: bool = True,
                 **kwargs):
        from ..utils.file_client import FileClient
        self.io_backend = io_backend
        self.file_client = FileClient(io_backend, **kwargs)
        self.use_native = use_native
        self.decoder = DECODER
        self.backup = None

    def _load(self, filepath: str, flag: str = 'color'):
        if self.io_backend == 'disk':
            img = _load_image_file(filepath, flag)
        else:
            # reference wires FileClient into frame loading
            # (loading.py:425-431): fetch bytes from the backend, decode here
            try:
                img = _imfrombytes(self.file_client.get(filepath), flag)
            except Exception:
                img = None
        if img is None:
            img = self.backup
        return img

    def __call__(self, results):
        directory = results['filename']
        tmpl = results['filename_tmpl']
        inds = np.asarray(results['frame_inds']).reshape(-1)
        imgs: List[np.ndarray] = []
        modality = results.get('modality', 'RGB')
        for frame_idx in inds:
            frame_idx = int(frame_idx)
            if modality in ('RGB', 'RGBDiff'):
                cur = [self._load(osp.join(directory,
                                           tmpl.format(frame_idx + 1)))]
            elif modality == 'Flow':
                x = self._load(osp.join(
                    directory, tmpl.format('x', frame_idx + 1)), 'grayscale')
                y = self._load(osp.join(
                    directory, tmpl.format('y', frame_idx + 1)), 'grayscale')
                cur = [x, y]
            else:
                raise ValueError(f'unsupported modality {modality}')
            if any(c is None for c in cur):
                return None  # unrecoverable; let dataset retry
            imgs.extend(cur)
            if self.backup is None:
                self.backup = cur[0]
        results['img_group'] = imgs
        results['ori_shape'] = imgs[0].shape
        return results


@PIPELINES.register_module
class PklLoader:
    """Decode JPEG bytes from a pickled list (reference ``loading.py:375-414``).
    The pickle is the dataset's own file, unpickled as the reference does."""

    def __call__(self, results):
        with open(results['filename'], 'rb') as f:
            container = pickle.load(f)
        inds = np.asarray(results['frame_inds']).reshape(-1)
        img_group = []
        for frame_idx in inds:
            img = _imfrombytes(container[int(frame_idx)])
            if img is None:
                return None
            img_group.append(img)
        results['img_group'] = img_group
        results['ori_shape'] = img_group[0].shape
        return results
