"""nvJPEG against ``cv2.imdecode`` on each kind of JPEG a frame can be, on
the card.

    python -m mvfnet_tpu_torch.tools.jpeg_kinds

Writes the kinds of ``KINDS`` with cv2 into a temporary directory (a 16:9
frame after the short-edge-256 extraction at 4:2:0, 4:4:4 and 4:2:2
chroma, grayscale, an odd size, restart markers, progressive scans), and
prints one JSON line a kind: nvJPEG's decode (one image, and the kind
repeated in one batch) against cv2's, as the largest and mean absolute
difference and the share of values that differ, and whether the batch
equals the single decodes bit for bit. ``chip_smoke.py`` phase 13 and
``tests/test_torch_native_io.py`` use the same kinds and statistics.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, Optional, Sequence

import cv2
import numpy as np

# name: (image shape, cv2.imwrite parameters); quality 90 throughout
KINDS = {
    'yuv420': ((256, 455, 3), []),
    'yuv444': ((256, 455, 3), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    'yuv422': ((256, 455, 3), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    'gray': ((256, 455), []),
    'odd': ((37, 53, 3), []),
    'restart': ((256, 455, 3), [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
    'progressive': ((256, 455, 3), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
}


def frame(shape, seed: int) -> np.ndarray:
    """Smooth random content with mid-frequency texture and mild noise,
    uint8 of ``shape`` (a frame's statistics, not white noise's)."""
    rs = np.random.RandomState(seed)
    h, w = shape[:2]
    c = shape[2] if len(shape) == 3 else 1
    coarse = cv2.resize(rs.rand(6, 10, c).astype(np.float32) * 255, (w, h),
                        interpolation=cv2.INTER_CUBIC)
    mid = cv2.resize((rs.randn(max(h // 8, 2), max(w // 8, 2), c)
                      * 20).astype(np.float32), (w, h))
    img = coarse.reshape(h, w, c) + mid.reshape(h, w, c) \
        + rs.randn(h, w, c).astype(np.float32) * 2
    return np.clip(img, 0, 255).astype(np.uint8).reshape(shape)


def write_kinds(root: str, seed: int = 0) -> Dict[str, str]:
    """Each kind of ``KINDS`` as ``root/<kind>.jpg``; their paths."""
    paths = {}
    for i, (kind, (shape, params)) in enumerate(KINDS.items()):
        path = os.path.join(root, f'{kind}.jpg')
        if not cv2.imwrite(path, frame(shape, seed + i),
                           [cv2.IMWRITE_JPEG_QUALITY, 90] + params):
            raise RuntimeError(f'cv2.imwrite failed for {path}')
        paths[kind] = path
    return paths


def diff(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """Largest and mean absolute difference, and the share of values that
    differ, of two uint8 images of one shape."""
    if got.shape != want.shape:
        raise ValueError(f'shapes {got.shape} and {want.shape}')
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return dict(max_abs=int(d.max()), mean_abs=float(d.mean()),
                share_differ=float((d > 0).mean()))


def cv2_decode(path: str) -> Optional[np.ndarray]:
    """The plain version: ``cv2.imdecode`` in colour, as the pipeline
    calls it."""
    with open(path, 'rb') as f:
        return cv2.imdecode(np.frombuffer(f.read(), np.uint8),
                            cv2.IMREAD_COLOR)


def compare(loader, paths: Dict[str, str], batch: int = 4
            ) -> Dict[str, Dict[str, float]]:
    """For each kind: nvJPEG's single decode against cv2's, and whether a
    batch of ``batch`` copies of the kind equals the single decode."""
    out = {}
    for kind, path in paths.items():
        single = loader.load(path)
        if single is None:
            raise RuntimeError(f'nvJPEG refused {kind} ({path})')
        many = loader.load_batch([path] * batch)
        out[kind] = dict(diff(single, cv2_decode(path)),
                         batch_equal=many is not None and all(
                             np.array_equal(m, single) for m in many))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    from ..data.native_io import NativeImageLoader, nvjpeg_version
    loader = NativeImageLoader(args.device)
    with tempfile.TemporaryDirectory() as root:
        result = compare(loader, write_kinds(root))
    print(json.dumps(dict(nvjpeg=nvjpeg_version(), kinds=result)))
    return result


if __name__ == '__main__':
    main()
