"""Frame loading pipeline ops (counterpart of ``mvfnet_tpu/data/loading.py``).

``FrameSelector`` (raw JPEG frames), ``PklLoader`` (pickled JPEG-bytes
lists) and the four video decoders ``PyAVDecode``, ``DecordDecode``,
``OpenCVDecode`` and ``PIMSDecode``, from the reference's loader vocabulary
(``codes/datasets/pipelines/loading.py:134-475``). Frames decode with
OpenCV into HWC uint8 BGR, as in the JAX package: JPEGs with
``cv2.imdecode``, video containers with ``cv2.VideoCapture``
(``video_io.py``) under every decoder's config name. Each op's
``decoder`` names what it runs. The native batch decode worker is not
ported yet (``ROADMAP.md``, A3).
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import List, Optional

import cv2
import numpy as np

from .builder import PIPELINES
from .video_io import DECODERS, decode_frames_accurate, decode_frames_seek

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


class _VideoDecodeBase:
    """Video decode op: ``results['frame_inds']`` of ``results['filename']``
    into ``img_group``; any failure or exception gives ``None``, so that
    the dataset draws another video (reference ``loading.py:222-225``)."""

    accurate = True

    @property
    def decoder(self) -> str:
        return DECODERS[self.accurate]

    def __call__(self, results):
        inds = np.asarray(results['frame_inds']).reshape(-1)
        try:
            if self.accurate:
                frames = decode_frames_accurate(results['filename'], inds)
            else:
                frames = decode_frames_seek(results['filename'], inds)
        except Exception:
            frames = None
        if frames is None:
            return None
        results['img_group'] = frames
        results['ori_shape'] = frames[0].shape
        return results


@PIPELINES.register_module
class PyAVDecode(_VideoDecodeBase):
    """The reference's PyAVDecode (``loading.py:134-231``) by name: cv2
    decodes, sequentially with ``accurate``, by seek without."""

    def __init__(self, multi_thread: bool = False, accurate: bool = True):
        self.multi_thread = multi_thread
        self.accurate = accurate


@PIPELINES.register_module
class DecordDecode(_VideoDecodeBase):
    """The reference's DecordDecode (``loading.py:282-334``) by name: cv2
    decodes sequentially."""

    def __init__(self, **kwargs):
        self.accurate = True


@PIPELINES.register_module
class OpenCVDecode(_VideoDecodeBase):
    """The reference's OpenCVDecode (``loading.py:337-372``): by seek."""

    def __init__(self, **kwargs):
        self.accurate = False


@PIPELINES.register_module
class PIMSDecode(_VideoDecodeBase):
    """The reference's PIMSDecode (``loading.py:234-279``) by name: cv2
    decodes sequentially."""

    def __init__(self, **kwargs):
        self.accurate = True


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
