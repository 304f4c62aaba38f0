"""Frame loading pipeline ops (counterpart of ``mvfnet_tpu/data/loading.py``).

``FrameSelector`` (raw JPEG frames), ``PklLoader`` (pickled JPEG-bytes
lists) and the four video decoders ``PyAVDecode``, ``DecordDecode``,
``OpenCVDecode`` and ``PIMSDecode``, from the reference's loader vocabulary
(``codes/datasets/pipelines/loading.py:134-475``). Frames decode with
OpenCV into HWC uint8 BGR, as in the JAX package: JPEGs with
``cv2.imdecode``, video containers with ``cv2.VideoCapture``
(``video_io.py``) under every decoder's config name. On a CUDA device
``FrameSelector`` decodes RGB clips with the native batch worker, nvJPEG
(``native_io.py``), as the JAX one does with its libjpeg worker. Each op's
``decoder`` names what it runs.
"""

from __future__ import annotations

import collections
import os.path as osp
import pickle
import threading
from typing import List, Optional

import cv2
import numpy as np

from . import native_io
from .builder import PIPELINES
from .video_io import DECODERS, decode_frames_accurate, decode_frames_seek

# the JPEG decoder of the port's host pipeline on the CPU (the plain
# version of the native worker), named in logs and in chip_smoke.py's output
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
    (reference ``loading.py:434-437``). Frames decode with ``cv2.imdecode``
    until ``decode_on`` names a CUDA device (the dataset builder passes the
    entry point's): then, with ``use_native`` and frames on disk, one
    nvJPEG call decodes an RGB or RGBDiff clip (the JAX package's native
    path). If the batch fails, frames go one by one; a frame nvJPEG
    refuses for its bitstream decodes with cv2, and failing that takes the
    backup frame. Flow stays on cv2 (grayscale). ``counts`` holds the
    frames each decoder gave.
    """

    def __init__(self, io_backend: str = 'disk', use_native: bool = True,
                 **kwargs):
        from ..utils.file_client import FileClient
        self.io_backend = io_backend
        self.file_client = FileClient(io_backend, **kwargs)
        self.use_native = use_native
        self.decoder = DECODER
        self._native: Optional[native_io.NativeImageLoader] = None
        self.counts = collections.Counter()
        self._counts_lock = threading.Lock()
        self.backup = None

    def decode_on(self, device) -> None:
        """Decode with nvJPEG on ``device`` where it is a CUDA device (and
        ``use_native``, frames on disk); raises if the worker cannot be
        built or the card is missing. Other devices keep cv2."""
        if self.use_native and self.io_backend == 'disk' \
                and str(device).startswith('cuda'):
            self._native = native_io.NativeImageLoader(device)
            self.decoder = native_io.DECODER
        else:
            self._native = None
            self.decoder = DECODER

    def _count(self, counts) -> None:
        with self._counts_lock:
            self.counts.update(counts)

    def _load(self, filepath: str, flag: str, counts: collections.Counter):
        if self._native is not None and flag == 'color':
            img = self._native.load(filepath)
            if img is not None:
                counts[native_io.DECODER] += 1
                return img
        counts[DECODER] += 1
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
        if self._native is not None and modality in ('RGB', 'RGBDiff'):
            # one nvJPEG call decodes the whole clip
            batch = self._native.load_batch(
                [osp.join(directory, tmpl.format(int(i) + 1)) for i in inds])
            if batch is not None:
                self._count({native_io.DECODER: len(batch)})
                results['img_group'] = batch
                results['ori_shape'] = batch[0].shape
                return results
            # frame by frame (a frame nvJPEG refuses goes to cv2)
        counts = collections.Counter()
        try:
            for frame_idx in inds:
                frame_idx = int(frame_idx)
                if modality in ('RGB', 'RGBDiff'):
                    cur = [self._load(osp.join(directory,
                                               tmpl.format(frame_idx + 1)),
                                      'color', counts)]
                elif modality == 'Flow':
                    x = self._load(osp.join(
                        directory, tmpl.format('x', frame_idx + 1)),
                        'grayscale', counts)
                    y = self._load(osp.join(
                        directory, tmpl.format('y', frame_idx + 1)),
                        'grayscale', counts)
                    cur = [x, y]
                else:
                    raise ValueError(f'unsupported modality {modality}')
                if any(c is None for c in cur):
                    return None  # unrecoverable; let dataset retry
                imgs.extend(cur)
                if self.backup is None:
                    self.backup = cur[0]
        finally:
            self._count(counts)
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
